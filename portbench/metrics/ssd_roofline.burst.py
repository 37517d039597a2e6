"""The ``ssd`` kernel's share of its roofline over the traced steps: for
each prompt computed there, the family's least bytes and FLOPs of its scans
(``ssd_work``), the larger of bytes at 3.35 TB/s and FLOPs at 989 TFLOP/s,
summed, over the kernel's device time (``ssd_chunk_state_kernel``,
``ssd_state_pass_kernel``, ``ssd_chunk_scan_kernel``, ``ssd_fma_kernel``).
None without a device trace, an ``ssd`` launch or the family's count."""
from harness import spec, work


def read(r):
    count = getattr(spec.family(r.model["family"]), "ssd_work", None)
    if r.trace is None or count is None:
        return None
    t = r.trace.kernel_seconds("ssd")
    if not t:
        return None
    need = 0.0
    for _, n in r.prefill_chunks():
        nbytes, flops = count(r.model, n)
        need += max(nbytes / work.PEAK_HBM_BYTES_PER_S,
                    flops / work.PEAK_BF16_FLOPS)
    return 100.0 * need / t
