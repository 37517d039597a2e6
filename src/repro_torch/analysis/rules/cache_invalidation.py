"""cache-invalidation: block-table mutations must invalidate the device
tables cached from them (the port's version of the JAX package's rule).

Two contracts:

1. **Allocator version bump** (copied unchanged) -- in a class that
   maintains a ``table_version`` counter (``PagedKVCache`` in
   ``serving/kv_cache.py``), every method that mutates the block tables
   (``self._tables`` -- directly, through a subscript, or through a local
   alias) must bump ``self.table_version`` in the same method. The fused
   decode path caches device-resident tables keyed on that counter; an
   unbumped mutation serves stale tables silently.

2. **Device-table key** (adapted: the port has no ``_ctx_view``) -- in a
   class that caches the device ``(tables, lens)`` pair in
   ``self._dev_tables`` (``PagedBackend``), every method that assigns
   ``self._dev_tables`` must also set ``self._dev_tables_key`` (the
   ``kv.table_version`` the pair was built at) in the same method.
   ``__init__`` is exempt, and so is a method that derives the new pair
   from the old one in place: each assignment's tables entry is a name
   unpacked from ``self._dev_tables`` in that method (``tables_d, lens_d =
   self._dev_tables`` ... ``self._dev_tables = (tables_d, lens_d +
   produced)``, the fused loop's and the verify's contract: the tables
   are the cached ones, only the lengths advance on the device).
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.astutil import is_self_attr
from repro_torch.analysis.framework import Finding, ModuleInfo, Rule

TABLES_ATTR = "_tables"
VERSION_ATTR = "table_version"
DEV_TABLES_ATTR = "_dev_tables"
DEV_KEY_ATTR = "_dev_tables_key"
MUTATOR_METHODS = {"append", "pop", "insert", "extend", "remove", "clear",
                   "setdefault", "update"}


def _assign_targets(stmt: ast.stmt) -> list[ast.AST]:
    """Flattened targets of an assignment statement (tuples unpacked)."""
    targets: list[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    flat: list[ast.AST] = []
    while targets:
        t = targets.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            targets.extend(t.elts)
        else:
            flat.append(t)
    return flat


def _methods(cls: ast.ClassDef) -> list[ast.FunctionDef]:
    return [n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _assignments(method: ast.AST, attr: str) -> list[ast.stmt]:
    """Statements of ``method`` that assign ``self.<attr>``."""
    return [node for node in ast.walk(method)
            if isinstance(node, ast.stmt)
            and any(is_self_attr(t, attr) for t in _assign_targets(node))]


def _rooted_at(node: ast.AST, attr: str, aliases: set[str]) -> bool:
    """Does the access chain bottom out at ``self.<attr>`` or an alias?"""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        if is_self_attr(node, attr):
            return True
        node = node.value
    if isinstance(node, ast.Name):
        return node.id in aliases
    return is_self_attr(node, attr)


def _tables_aliases(method: ast.AST) -> set[str]:
    """Local names bound to ``self._tables`` or an element of it."""
    aliases: set[str] = set()
    for node in ast.walk(method):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            value = node.value
            # table = self._tables[x]  |  t = self._tables.get(x, ...)
            if isinstance(value, ast.Call):
                value = value.func
            if _rooted_at(value, TABLES_ATTR, set()):
                aliases.add(node.targets[0].id)
    return aliases


def _mutates_tables(method: ast.AST) -> ast.AST | None:
    """First node that mutates the block tables, else None."""
    aliases = _tables_aliases(method)
    for node in ast.walk(method):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) \
                        and _rooted_at(t, TABLES_ATTR, aliases):
                    return node
                if is_self_attr(t, TABLES_ATTR):
                    return node
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if _rooted_at(t, TABLES_ATTR, aliases):
                    return node
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in MUTATOR_METHODS \
                and _rooted_at(node.func.value, TABLES_ATTR, aliases):
            # .get() and reads are not mutations; only the mutator set
            return node
    return None


def _cached_table_names(method: ast.AST) -> set[str]:
    """Names bound to the cached pair's tables entry in ``method``:
    ``t, l = self._dev_tables`` or ``t = self._dev_tables[0]``."""
    names: set[str] = set()
    for node in ast.walk(method):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        target, value = node.targets[0], node.value
        if is_self_attr(value, DEV_TABLES_ATTR) \
                and isinstance(target, (ast.Tuple, ast.List)) \
                and target.elts and isinstance(target.elts[0], ast.Name):
            names.add(target.elts[0].id)
        elif isinstance(value, ast.Subscript) \
                and is_self_attr(value.value, DEV_TABLES_ATTR) \
                and isinstance(value.slice, ast.Constant) \
                and value.slice.value == 0 \
                and isinstance(target, ast.Name):
            names.add(target.id)
    return names


def _derives_in_place(method: ast.AST, stores: list[ast.stmt]) -> bool:
    """Every store of ``self._dev_tables`` in ``method`` keeps the cached
    tables: its value is a tuple whose first entry is a name unpacked from
    ``self._dev_tables`` in the same method."""
    cached = _cached_table_names(method)
    for stmt in stores:
        value = getattr(stmt, "value", None)
        if not (isinstance(stmt, ast.Assign)
                and isinstance(value, ast.Tuple) and value.elts
                and isinstance(value.elts[0], ast.Name)
                and value.elts[0].id in cached):
            return False
    return True


class CacheInvalidationRule(Rule):
    name = "cache-invalidation"
    description = ("block-table mutations must bump table_version; a new "
                   "device (tables, lens) pair must set _dev_tables_key")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(mod, node)

    def _check_class(self, mod: ModuleInfo,
                     cls: ast.ClassDef) -> Iterator[Finding]:
        methods = _methods(cls)
        init = next((m for m in methods if m.name == "__init__"), None)

        # contract 1: table_version bump
        if init is not None and _assignments(init, VERSION_ATTR):
            for m in methods:
                if m.name == "__init__":
                    continue
                site = _mutates_tables(m)
                if site is not None and not _assignments(m, VERSION_ATTR):
                    yield self.finding(
                        mod, site,
                        f"{cls.name}.{m.name} mutates self.{TABLES_ATTR} "
                        f"without bumping self.{VERSION_ATTR} -- "
                        "device-resident block tables go stale silently")

        # contract 2: the device-table pair and its key
        for m in methods:
            if m.name == "__init__":
                continue
            stores = _assignments(m, DEV_TABLES_ATTR)
            if not stores or _assignments(m, DEV_KEY_ATTR) \
                    or _derives_in_place(m, stores):
                continue
            yield self.finding(
                mod, stores[0],
                f"{cls.name}.{m.name} assigns self.{DEV_TABLES_ATTR} "
                f"without setting self.{DEV_KEY_ATTR} -- the next call "
                "compares the allocator's table_version with a stale key "
                "and serves stale tables or lengths")
