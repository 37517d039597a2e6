"""firstlint rule registry of the port."""
from __future__ import annotations

from repro_torch.analysis.framework import Rule
from repro_torch.analysis.rules.cache_invalidation import \
    CacheInvalidationRule
from repro_torch.analysis.rules.cuda_wrapper import CudaWrapperSafetyRule
from repro_torch.analysis.rules.host_sync import HostSyncRule
from repro_torch.analysis.rules.wire_schema import WireSchemaRule

ALL_RULES: tuple[type[Rule], ...] = (
    HostSyncRule,
    CacheInvalidationRule,
    CudaWrapperSafetyRule,
    WireSchemaRule,
)

RULES_BY_NAME = {cls.name: cls for cls in ALL_RULES}

# rules of the JAX package with no counterpart here, and why
NOT_PORTED = {
    "donation-safety": "PyTorch has no buffer donation to misuse",
    "pallas-kernel-safety": "the port has no Pallas kernels; "
                            "cuda-wrapper-safety guards its CUDA wrappers",
}


def get_rules(names: list[str] | None = None) -> list[Rule]:
    """Instantiate the selected rules (all of them by default)."""
    if not names:
        return [cls() for cls in ALL_RULES]
    unknown = [n for n in names if n not in RULES_BY_NAME]
    if unknown:
        known = ", ".join(sorted(RULES_BY_NAME))
        raise KeyError(f"unknown rule(s) {unknown}; known rules: {known}")
    return [RULES_BY_NAME[n]() for n in names]
