"""Fixture: a wrapper with every guard rail (0 findings)."""
from repro_torch.kernels import _build


def plain(x):
    return x * 2


def wrapper(x, fn):
    _build.forbid_grad("k", x)
    if x.device.type == "cpu":
        return plain(x)
    out = x.new_empty(x.shape)
    rc = fn(x.data_ptr(), out.data_ptr(), x.numel())
    _build.check("lib", "entry", rc)
    _build.LAUNCHES["k"] += 1
    return out


def not_a_launch(pool, ptrs):
    ptrs.add(pool.data_ptr())               # one pointer: bookkeeping
    return len(ptrs)
