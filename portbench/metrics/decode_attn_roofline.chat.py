"""The paged decode attention kernel's share of its roofline: the least
bytes the traced iterations' contexts need (each distinct K/V byte once, a
shared system prompt once per iteration, q read and the output written
once) at the HBM rate, over the kernel's device time. Kernel names:
``paged_decode_kernel`` (``fused_decode_attention``, ``paged_attention``)."""
from harness import work


def read(r):
    if r.trace is None:
        return None
    t = r.trace.kernel_seconds("paged decode attention")
    if not t:
        return None
    need = sum(work.decode_attn_bytes(r.model, it)
               for it in r.decode_iterations())
    return 100.0 * need / work.PEAK_HBM_BYTES_PER_S / t
