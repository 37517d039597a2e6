"""host-sync-in-hot-path: no device->host sync inside the device loops.

The fused decode path's contract is that logits (and everything else big)
never cross to the host mid-loop: ``TRANSFER_STATS`` asserts it at run
time for the logits; this rule enforces the whole class statically. The
hot set is the device loops of the serving backends -- the methods named
in :attr:`HostSyncRule.roots` (in ``serving/backends.py``: the fused
decode loop ``_StepGraph.run``, the iteration bodies it runs,
``SlotBackend._iteration`` and ``PagedBackend._kernel_step`` and
``_reference_step``, and ``_verify_forward`` of both backends) -- and
every function or method they reach, transitively: a bare name or a
``self.`` method of the same module (by bare name: conservative), a name
imported from another ``repro_torch`` module (resolved through the
imports, re-exports followed), and ``obj.m(...)`` where ``m`` is a method
of a ``repro_torch`` class imported by a module of the hot set (as the
backends call ``ServeStack``'s methods, and the hybrid stack's serving
loop calls its ``mixer``). A module inside a ``repro_torch`` source tree
is checked against the whole tree's hot set; a file outside one (a
fixture) against its own roots alone. Inside the hot set, none of these:

* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` on anything;
* ``.to("cpu")`` / ``.to(torch.device("cpu"))`` (or ``device="cpu"``);
* ``torch.cuda.synchronize()`` (or any ``.synchronize()``);
* ``int(...)`` / ``float(...)`` of a bare name or a simple subscript,
  which reads a tensor's value on the host (shape arithmetic on
  constants is not matched). The tensor methods ``x.int()`` /
  ``x.float()`` cast on the device and are not flagged.

Each of these waits for the device's queue to drain, so the host stops
issuing the loop's next step. The host wrappers (``fused_decode`` and
``spec_verify`` themselves, ``decode_batch``) are outside the hot set:
that is where the intended token ids cross, once per call.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterator

from repro_torch.analysis.astutil import (ImportMap, call_key, called_keys,
                                          collect_functions, dotted)
from repro_torch.analysis.framework import Finding, ModuleInfo, Rule

_HOST_METHODS = {
    "item": ".item() synchronizes and copies to the host",
    "tolist": ".tolist() synchronizes and copies to the host",
    "cpu": ".cpu() synchronizes and copies to the host",
    "numpy": ".numpy() needs the value on the host",
    "synchronize": ".synchronize() blocks the host on the device",
}
_HOST_CALLS = {
    "torch.cuda.synchronize": "torch.cuda.synchronize() blocks the host on "
                              "the device",
}


def _is_cpu_device(imports: ImportMap, node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.split(":")[0] \
            == "cpu"
    return (isinstance(node, ast.Call)
            and imports.resolve(dotted(node.func)) == "torch.device"
            and len(node.args) >= 1 and _is_cpu_device(imports, node.args[0]))


def _to_cpu(imports: ImportMap, call: ast.Call) -> bool:
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    args = list(call.args[:1]) + [kw.value for kw in call.keywords
                                  if kw.arg == "device"]
    return any(_is_cpu_device(imports, a) for a in args)


def _is_simple_coercion_arg(node: ast.AST) -> bool:
    """int(x) / float(x[i]) style args that plausibly read a tensor."""
    if isinstance(node, ast.Name):
        return True
    return isinstance(node, ast.Subscript) and isinstance(node.value,
                                                          ast.Name)


def _classes(tree: ast.Module) -> dict[str, ast.ClassDef]:
    return {n.name: n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)}


def _defined_roots(roots, functions, classes) -> list[str]:
    """The bare names of the ``roots`` a module defines: a bare root where
    it has a function of that name, ``Class.method`` where its class
    ``Class`` has that method (a root whose bare name is common)."""
    out = []
    for root in roots:
        cls, _, name = root.rpartition(".")
        if name in functions and (not cls or (
                cls in classes and name in collect_functions(classes[cls]))):
            out.append(name)
    return out


def hot_set(tree: ast.Module, roots) -> dict[str, list[ast.FunctionDef]]:
    """Functions reachable from the ``roots`` (bare names, or
    ``Class.method``) through same-module calls, by bare name."""
    table = collect_functions(tree)
    hot: dict[str, list[ast.FunctionDef]] = {}
    frontier = _defined_roots(roots, table, _classes(tree))
    while frontier:
        name = frontier.pop()
        if name in hot:
            continue
        hot[name] = table[name]
        for d in table[name]:
            frontier.extend(k for k in called_keys(d)
                            if k in table and k not in hot)
    return hot


PACKAGE = "repro_torch"


def package_root(path: str) -> Path | None:
    """The ``repro_torch`` package directory that holds ``path``, if any."""
    for parent in Path(path).resolve().parents:
        if parent.name == PACKAGE and (parent / "__init__.py").is_file():
            return parent
    return None


class _Tree:
    """The parsed modules of one ``repro_torch`` source tree, keyed by
    file: (ImportMap, functions by bare name, classes by name)."""

    def __init__(self, root: Path):
        self.root = root
        self.mods: dict[Path, tuple] = {}
        for f in sorted(root.rglob("*.py")):
            if "__pycache__" in f.parts:
                continue
            try:
                tree = ast.parse(f.read_text(encoding="utf-8"))
            except (OSError, SyntaxError):
                continue
            self.mods[f] = (ImportMap(tree), collect_functions(tree),
                            _classes(tree))

    def module_file(self, parts: list[str]) -> Path | None:
        base = self.root.joinpath(*parts)
        for f in (base.with_suffix(".py"), base / "__init__.py"):
            if f in self.mods:
                return f
        return None

    def resolve(self, canonical: str, depth: int = 0):
        """``repro_torch.a.b.name[.method]`` -> (file, the defining
        module's name of it, kind "function" | "class"), following
        re-exports; None when it is not a function or class of the
        tree."""
        parts = canonical.split(".")
        if parts[0] != PACKAGE or depth > 8:
            return None
        for i in range(len(parts) - 1, 0, -1):
            f = self.module_file(parts[1:i])
            if f is None:
                continue
            imports, functions, classes = self.mods[f]
            name, rest = parts[i], parts[i + 1:]
            if name in classes:
                return (f, rest[0], "function") if rest \
                    else (f, name, "class")
            if name in functions and not rest:
                return f, name, "function"
            target = imports.aliases.get(name)
            if target and target != canonical:
                return self.resolve(".".join([target, *rest]), depth + 1)
            return None
        return None

    def hot(self, roots) -> dict[Path, set[str]]:
        """Every function the ``roots`` (as :func:`hot_set` takes them, in
        whichever modules define them) reach, by file and bare name."""
        hot: dict[Path, set[str]] = {}
        methods: dict[str, set[Path]] = {}      # of the classes in reach
        seen_classes: set[tuple[Path, str]] = set()
        frontier = [(f, n) for f, (_, fns, cls) in self.mods.items()
                    for n in _defined_roots(roots, fns, cls)]
        pending: list[tuple[ast.Call, Path]] = []

        def reach_classes(f: Path) -> None:
            for canonical in self.mods[f][0].aliases.values():
                hit = self.resolve(canonical)
                if hit is None or hit[2] != "class" or hit[:2] in seen_classes:
                    continue
                seen_classes.add(hit[:2])
                cls = self.mods[hit[0]][2][hit[1]]
                for node in cls.body:
                    if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        methods.setdefault(node.name, set()).add(hit[0])
                        # calls seen before this class came in reach
                        frontier.extend((hit[0], node.name)
                                        for call, _ in pending
                                        if call.func.attr == node.name)

        while frontier:
            f, name = frontier.pop()
            if name in hot.get(f, ()):
                continue
            if f not in hot:
                hot[f] = set()
                reach_classes(f)
            hot[f].add(name)
            imports, functions, _ = self.mods[f]
            for d in functions.get(name, ()):
                for node in ast.walk(d):
                    if isinstance(node, (ast.Name, ast.Attribute)) \
                            and isinstance(node.ctx, ast.Load):
                        # any reference, not only a call: a wrapper
                        # picked into a local (``fn = a if k else b``)
                        hit = self.resolve(imports.resolve(dotted(node))
                                           or "")
                        if hit is not None and hit[2] == "function":
                            frontier.append(hit[:2])
                    if not isinstance(node, ast.Call):
                        continue
                    key = call_key(node.func)
                    if key in functions:
                        frontier.append((f, key))
                    elif isinstance(node.func, ast.Attribute):
                        pending.append((node, f))
                        frontier.extend(
                            (g, node.func.attr)
                            for g in methods.get(node.func.attr, ()))
        return hot


class HostSyncRule(Rule):
    name = "host-sync-in-hot-path"
    description = ("no .item()/.tolist()/.cpu()/.numpy()/.to('cpu')/"
                   "synchronize/int()/float() host syncs in the backends' "
                   "device loops (_StepGraph.run, _iteration, _kernel_step, "
                   "_reference_step, _verify_forward) and what they call, "
                   "across the port's modules")
    roots = ("_StepGraph.run", "_iteration", "_kernel_step",
             "_reference_step", "_verify_forward")

    def __init__(self):
        # package root -> its hot set by file
        self._trees: dict[Path, dict[Path, set[str]]] = {}

    def _tree_hot(self, path: str) -> set[str]:
        """The names of ``path``'s functions in its source tree's hot
        set (empty outside a ``repro_torch`` tree)."""
        root = package_root(path)
        if root is None:
            return set()
        if root not in self._trees:
            self._trees[root] = _Tree(root).hot(self.roots)
        return self._trees[root].get(Path(path).resolve(), set())

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        imports = ImportMap(mod.tree)
        hot = hot_set(mod.tree, self.roots)
        for name in self._tree_hot(mod.path) - set(hot):
            hot.update(hot_set(mod.tree, (name,)))
        for fname, defs in hot.items():
            for d in defs:
                yield from self._check_function(mod, imports, fname, d)

    def _check_function(self, mod: ModuleInfo, imports: ImportMap,
                        fname: str, fn: ast.AST) -> Iterator[Finding]:
        where = f"device-loop function '{fname}'"
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = imports.resolve(dotted(node.func))
            if callee in _HOST_CALLS:
                yield self.finding(
                    mod, node, f"{_HOST_CALLS[callee]} -- forbidden in "
                    f"{where}")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _HOST_METHODS:
                yield self.finding(
                    mod, node, f"{_HOST_METHODS[node.func.attr]} -- "
                    f"forbidden in {where}")
            elif _to_cpu(imports, node):
                yield self.finding(
                    mod, node, f".to('cpu') copies to the host -- "
                    f"forbidden in {where}")
            elif callee in ("int", "float") and len(node.args) == 1 \
                    and not node.keywords \
                    and _is_simple_coercion_arg(node.args[0]):
                yield self.finding(
                    mod, node, f"{callee}() of a tensor reads it on the "
                    f"host -- forbidden in {where}")
