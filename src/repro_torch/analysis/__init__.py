"""firstlint for the PyTorch/CUDA port -- AST invariant checks of
``src/repro_torch`` (the port of the JAX package's ``repro/analysis``).

The port's hot paths rest on contracts that are cheap to break and
expensive to debug at run time: no device->host sync inside the fused
decode and verify loops (the static twin of ``TRANSFER_STATS``), the
``table_version`` bump at every block-table mutation and the device-table
cache keyed on it, the guard rails of every CUDA kernel wrapper (autograd
refused, the CPU's plain version, the launch's return code checked, the
launch counted), and the typed /v1 wire envelope. Buffer donation has no
PyTorch counterpart, so the reference's donation rule is not ported.

Usage::

    python -m repro_torch.analysis [paths] [--format text|json]
        [--rules a,b] [--list-rules]

Findings are suppressed inline with a reason::

    x.item()  # firstlint: disable=host-sync-in-hot-path -- reason
"""
from repro_torch.analysis.framework import (Finding, ModuleInfo, Rule,
                                            analyze_paths, analyze_source)
from repro_torch.analysis.rules import ALL_RULES, get_rules

__all__ = ["Finding", "ModuleInfo", "Rule", "ALL_RULES", "get_rules",
           "analyze_paths", "analyze_source"]
