"""Plain PyTorch version of the SSD kernel: the chunked-einsum scan of
``repro_torch.models.mamba2`` (itself held against the step recurrence)."""
from repro_torch.models.mamba2 import segsum, ssd_chunked, ssd_decode_step

__all__ = ["segsum", "ssd_chunked", "ssd_decode_step"]
