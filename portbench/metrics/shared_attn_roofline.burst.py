"""The ``flash_attention`` kernel's share of its roofline over the traced
steps, where it runs the published Zamba2 block's shared attention (heads
of 224 over the stream concatenated with the embeddings, one-shot prefill):
the causal attention FLOPs of every prompt computed there, in every
application of a tied block (the family's ``attn_flops``), at 989 TFLOP/s,
over the kernel's device time (``flash_kernel``, ``flash_tc_kernel``).
None without a device trace or a launch."""
from harness import work


def read(r):
    if r.trace is None:
        return None
    t = r.trace.kernel_seconds("flash_attention")
    if not t:
        return None
    flops = sum(work.attn_flops(r.model, start, n)
                for start, n in r.prefill_chunks())
    return 100.0 * flops / work.PEAK_BF16_FLOPS / t
