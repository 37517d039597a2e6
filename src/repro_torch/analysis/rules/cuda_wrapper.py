"""cuda-wrapper-safety: every launch of a CUDA kernel goes through the
wrapper's guard rails (in place of the JAX package's
pallas-kernel-safety: the port's kernels are CUDA C++ behind ``ctypes``).

A launch is a call that passes two or more ``.data_ptr()`` arguments: an
entry of ``csrc/*.cu`` bound by ``kernels/_build.py`` ``bind`` takes its
inputs and outputs as raw pointers, so nothing on the Python side checks
what it reads. In each function that launches, the rule requires, as
``kernels/ssd/ops.py`` ``ssd`` does:

1. ``_build.forbid_grad(...)`` before the launch: the kernels have no
   backward, so a tensor that requires grad must be refused, not given an
   output without a gradient;
2. a ``<tensor>.device.type == "cpu"`` branch that returns (the plain
   version) before the launch: a CPU tensor's pointer handed to a device
   kernel faults or reads garbage;
3. the launch's return code assigned to a name and passed to
   ``_build.check(...)`` after it: the C entries return
   ``cudaGetLastError()``, and an unchecked error surfaces later, at an
   unrelated call;
4. ``_build.LAUNCHES[...] += 1`` after it: the count ``chip_smoke.py``
   reads to show the main path went through the kernel.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.framework import Finding, ModuleInfo, Rule

MIN_POINTERS = 2


def _own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Nodes of ``fn``'s body, not descending into nested functions,
    lambdas or classes (they are checked on their own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


def _is_data_ptr(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "data_ptr" and not node.args)


def _named(func: ast.AST, name: str) -> bool:
    """``name(...)`` or ``<anything>.name(...)``."""
    return (isinstance(func, ast.Name) and func.id == name) or \
        (isinstance(func, ast.Attribute) and func.attr == name)


def _is_cpu_test(test: ast.AST) -> bool:
    """The test holds ``<x>.device.type == "cpu"``."""
    for node in ast.walk(test):
        if not (isinstance(node, ast.Compare) and len(node.ops) == 1
                and isinstance(node.ops[0], ast.Eq)):
            continue
        sides = (node.left, node.comparators[0])
        has_type = any(isinstance(s, ast.Attribute) and s.attr == "type"
                       and isinstance(s.value, ast.Attribute)
                       and s.value.attr == "device" for s in sides)
        has_cpu = any(isinstance(s, ast.Constant) and s.value == "cpu"
                      for s in sides)
        if has_type and has_cpu:
            return True
    return False


def _returns(stmts: list[ast.stmt]) -> bool:
    return any(isinstance(n, ast.Return)
               for s in stmts for n in ast.walk(s))


def _counts_launch(node: ast.AST) -> bool:
    """``<...>LAUNCHES[...] += 1``."""
    if not (isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Add)
            and isinstance(node.target, ast.Subscript)):
        return False
    base = node.target.value
    return (isinstance(base, ast.Name) and base.id == "LAUNCHES") or \
        (isinstance(base, ast.Attribute) and base.attr == "LAUNCHES")


class CudaWrapperSafetyRule(Rule):
    name = "cuda-wrapper-safety"
    description = ("a CUDA kernel launch (a call with .data_ptr() "
                   "arguments) needs forbid_grad and a returning "
                   "device.type == 'cpu' branch before it, its return code "
                   "through _build.check and a LAUNCHES count after it")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for fn in ast.walk(mod.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_function(mod, fn)

    def _check_function(self, mod: ModuleInfo,
                        fn: ast.FunctionDef) -> Iterator[Finding]:
        nodes = list(_own_nodes(fn))
        launches = [n for n in nodes if isinstance(n, ast.Call)
                    and sum(map(_is_data_ptr, n.args)) >= MIN_POINTERS]
        if not launches:
            return
        calls = [n for n in nodes if isinstance(n, ast.Call)]
        rc_names = {}          # launch node -> the name its result binds
        for n in nodes:
            if isinstance(n, ast.Assign) and n.value in launches \
                    and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name):
                rc_names[id(n.value)] = n.targets[0].id
        for call in launches:
            line, where = call.lineno, f"launch in '{fn.name}'"
            if not any(_named(c.func, "forbid_grad") and c.lineno < line
                       for c in calls):
                yield self.finding(
                    mod, call, f"{where} is not preceded by "
                    "_build.forbid_grad(...): a kernel without a backward "
                    "must refuse inputs that require grad")
            if not any(isinstance(n, ast.If) and n.lineno < line
                       and _is_cpu_test(n.test) and _returns(n.body)
                       for n in nodes):
                yield self.finding(
                    mod, call, f"{where} has no earlier "
                    "`if <x>.device.type == \"cpu\": return <plain "
                    "version>` branch: a CPU tensor's pointer would reach "
                    "the device kernel")
            rc = rc_names.get(id(call))
            if rc is None or not any(
                    _named(c.func, "check") and c.lineno > line
                    and any(isinstance(a, ast.Name) and a.id == rc
                            for a in c.args) for c in calls):
                yield self.finding(
                    mod, call, f"{where}: its return code is not assigned "
                    "and passed to _build.check(...) after it: a CUDA "
                    "error would surface at an unrelated later call")
            if not any(_counts_launch(n) and n.lineno > line for n in nodes):
                yield self.finding(
                    mod, call, f"{where} is not counted: no "
                    "_build.LAUNCHES[...] += 1 after it")
