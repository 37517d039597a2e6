"""Fixture: kernel launches missing their guard rails (5 findings)."""
from repro_torch.kernels import _build


def no_guards(x, out, fn):                  # no forbid_grad, no CPU branch
    rc = fn(x.data_ptr(), out.data_ptr(), 4)
    _build.check("lib", "entry", rc)
    _build.LAUNCHES["k"] += 1
    return out


def unchecked(x, out, fn):                  # the return code is dropped
    _build.forbid_grad("k", x)
    if x.device.type == "cpu":
        return x
    fn(x.data_ptr(), out.data_ptr())
    _build.LAUNCHES["k"] += 1
    return out


def uncounted(x, out, fn):                  # no LAUNCHES count
    _build.forbid_grad("k", x)
    if x.device.type == "cpu":
        return x
    rc = fn(x.data_ptr(), out.data_ptr())
    _build.check("lib", "entry", rc)
    return out


def late_guard(x, out, fn):                 # forbid_grad after the launch
    if x.device.type == "cpu":
        return x
    rc = fn(x.data_ptr(), out.data_ptr())
    _build.forbid_grad("k", x)
    _build.check("lib", "entry", rc)
    _build.LAUNCHES["k"] += 1
    return out
