"""Fixture: a file-level waiver silences the whole module (4 suppressed)."""
# firstlint: disable-file=cuda-wrapper-safety -- fixture exercises file waivers


def launch(x, out, fn):
    rc = fn(x.data_ptr(), out.data_ptr())
    _check(rc)
    return out


def _check(rc):
    return rc
