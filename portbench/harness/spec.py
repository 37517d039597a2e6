"""Finds a cell's pieces by the names ``BENCHMARK.json`` gives: the
configuration's file, the traffic mix (``traffic/<mix>.json``), the
correctness limits (``correct/<cell>.json``), the reader of each per-layer
metric (``metrics/<metric>.py``), and by the family a configuration names,
the family's weights and work counts (``families/<family>.py``) and its
plain reference (``reference/<family>.py``). The CPU tests find each cell's
small version by its name too (``small/<cell>.json``). Adding one of these
is adding a file and an entry, never an edit here."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent        # portbench/
ROOT = HERE.parent                                    # the checkout


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(bench: dict, cell_name: str, root: Path = ROOT,
            base: Path = HERE):
    """(cell, configuration file, traffic mix, correctness limits) of a
    cell; the limits are ``correct/<cell>.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no cell {cell_name!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    cell = cells[cell_name]
    confs = {c["name"]: c for c in bench["configs"]}
    conf = json.loads((root / confs[cell["config"]]["file"]).read_text())
    mix = json.loads((base / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((base / "correct" / f"{cell_name}.json").read_text())
    return cell, conf, mix, limits


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metric entries a run of the cell reports: its end-to-end
    metrics (``--trace 0``) or its per-layer ones (``--trace 1``)."""
    e2e = [e for e in bench["end_to_end"]
           if "workloads" not in e or cell_name in e["workloads"]]
    if not trace:
        return e2e
    moved = {e["name"] for e in e2e}
    return [e for e in bench["per_layer"]
            if cell_name in e.get("workloads", ())
            or ("workloads" not in e and e["moves"] in moved)]


def _module(path: Path, prefix: str):
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, base: Path = HERE):
    """The module of ``metrics/<name>.py``."""
    return _module(base / "metrics" / f"{name}.py", "portbench_metric_")


# loaded once: the work counts ask for the family at every decode iteration
_LOADED: dict = {}


def _by_family(sub: str, name: str):
    path = HERE / sub / f"{name}.py"
    if path not in _LOADED:
        if not path.is_file():
            have = sorted(p.stem for p in (HERE / sub).glob("*.py")
                          if p.stem not in ("__init__", "common"))
            raise ValueError(f"no {sub}/{name}.py for family {name!r}; "
                             f"families with one: {have}")
        _LOADED[path] = _module(path, f"portbench_{sub}_")
    return _LOADED[path]


def family(name: str):
    """The module of ``families/<name>.py``: ``draw(dr, m, dt)``, the
    parameter tree; the work counts that follow the family's layers,
    ``token_matmul_flops(m)``, ``attn_flops(m, start, n)`` and
    ``kv_bytes_per_position(m)``; ``SMALL``, its tiny float32 ``model``
    section for the CPU tests. Families and references are found beside
    the harness, in its own ``portbench/``."""
    return _by_family("families", name)


def reference(name: str):
    """The module of ``reference/<name>.py``: ``logits(params, m, seqs,
    precision)``, the family's plain reference."""
    return _by_family("reference", name)
