"""Shared AST helpers for the port's firstlint rules (the import-alias
helpers of the JAX package's ``repro/analysis/astutil.py``; its jit
registry has no counterpart in eager PyTorch).

Rules resolve names *canonically* (``np.asarray`` -> ``numpy.asarray``,
``synchronize`` imported from ``torch.cuda`` -> ``torch.cuda.synchronize``)
via :class:`ImportMap`.
"""
from __future__ import annotations

import ast
from typing import Iterator


def dotted(node: ast.AST) -> str | None:
    """Render a Name/Attribute chain as ``a.b.c`` (None for anything else)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class ImportMap:
    """alias -> canonical dotted module/object path for one module."""

    def __init__(self, tree: ast.Module):
        self.aliases: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.aliases[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def resolve(self, name: str | None) -> str | None:
        """Canonicalize a dotted name through the module's import aliases."""
        if name is None:
            return None
        head, _, rest = name.partition(".")
        base = self.aliases.get(head, head)
        return f"{base}.{rest}" if rest else base


def is_self_attr(node: ast.AST, name: str | None = None) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id == "self"
            and (name is None or node.attr == name))


def call_key(func: ast.AST) -> str | None:
    """Bare key a call target is registered under: ``f(...)`` -> "f",
    ``self.f(...)`` / ``self.f[k](...)`` -> "f". None when unresolvable."""
    if isinstance(func, ast.Subscript):
        func = func.value
    if isinstance(func, ast.Name):
        return func.id
    if is_self_attr(func):
        return func.attr
    return None


def collect_functions(tree: ast.Module) -> dict[str, list[ast.FunctionDef]]:
    """Every (possibly nested) function/method in the module, by bare name."""
    out: dict[str, list[ast.FunctionDef]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, []).append(node)
    return out


def called_keys(fn: ast.AST) -> Iterator[str]:
    """Bare keys of every call inside ``fn`` (names and self.X methods)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            key = call_key(node.func)
            if key is not None:
                yield key
