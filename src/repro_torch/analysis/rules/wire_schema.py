"""wire-schema: no ad-hoc wire envelopes outside api/schemas.py (the port's
copy of the JAX package's rule; in the port that module is
``src/repro_torch/api/schemas.py``).

Everything that crosses a federation link is versioned: ``to_wire`` wraps
each dataclass as ``{"v": API_VERSION, "kind": ..., "data": ...}`` and
``from_wire`` refuses envelopes from the future. A hand-built dict that
mimics the envelope bypasses that versioning — it keeps working until the
schema evolves, then breaks only against mixed-version peers, the
hardest environment to reproduce.

The rule flags dict literals that look like wire envelopes outside
``api/schemas.py`` itself:

* a ``"v"`` key whose value is a string literal (``{"v": "v1", ...}``)
  or the ``API_VERSION`` constant, or
* both a ``"kind"`` and a ``"data"`` key.

KV-literals like ``{"k": ..., "v": ...}`` (the cache pools) bind ``"v"``
to arrays, not version strings, and are not matched.
"""
from __future__ import annotations

import ast
from pathlib import PurePath
from typing import Iterator

from repro_torch.analysis.framework import Finding, ModuleInfo, Rule

SCHEMAS_SUFFIX = ("api", "schemas.py")


def _is_schemas_module(mod: ModuleInfo) -> bool:
    parts = PurePath(mod.path).parts
    return len(parts) >= 2 and parts[-2:] == SCHEMAS_SUFFIX


def _str_keys(node: ast.Dict) -> dict[str, ast.AST]:
    out: dict[str, ast.AST] = {}
    for k, v in zip(node.keys, node.values):
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            out[k.value] = v
    return out


def _is_version_value(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return True
    if isinstance(node, ast.Name) and node.id == "API_VERSION":
        return True
    return isinstance(node, ast.Attribute) and node.attr == "API_VERSION"


class WireSchemaRule(Rule):
    name = "wire-schema"
    description = ("gateway/endpoint code must build wire payloads via "
                   "api/schemas.py, not ad-hoc dict literals")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if _is_schemas_module(mod):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Dict):
                continue
            keys = _str_keys(node)
            envelope = ("kind" in keys and "data" in keys) or (
                "v" in keys and _is_version_value(keys["v"]))
            if envelope:
                yield self.finding(
                    mod, node,
                    "ad-hoc wire envelope dict bypasses api/schemas.py — "
                    "use to_wire()/a schema helper so the payload carries "
                    "the negotiated API_VERSION and survives schema "
                    "evolution")
