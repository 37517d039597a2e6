"""The port's boundary rules.

* ``src/repro_torch`` and ``chip_smoke.py`` import nothing of JAX and
  nothing of the JAX package ``repro``: checked on the source (an AST walk
  of every import) and at run time (importing every module of the port in
  a fresh interpreter loads neither).
* Every module of the port imports, and its checkpoints round-trip,
  without ``msgpack`` and ``zstandard``, which the card's machine lacks.
* The entry points run on the CUDA device unless the caller names the
  CPU: without a card and without ``device=`` they raise.
* ``chip_smoke.py`` fails, printing no result, where it cannot run.
"""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import REGISTRY, reduced
from repro_torch.models import make_model
from repro_torch.serving.backends import PagedBackend, SlotBackend
from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    """Top-level module names a file imports, anywhere in its body."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_neither_jax_nor_repro(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_port_modules_load_neither_jax_nor_repro():
    mods = sorted(".".join(p.relative_to(PORT.parent).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"print(sorted(m for m in sys.modules "
            f"if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_port_modules_load_without_msgpack_or_zstandard(tmp_path):
    mods = sorted(".".join(p.relative_to(PORT.parent).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            "sys.modules['msgpack'] = None\n"
            "sys.modules['zstandard'] = None\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import torch\n"
            "from repro_torch.distributed.checkpoint import "
            "load_checkpoint, save_checkpoint\n"
            f"p = {str(tmp_path / 'a.ckpt')!r}\n"
            "x = {'w': torch.arange(4, dtype=torch.bfloat16)}\n"
            "save_checkpoint(p, x, step=2)\n"
            "y, s, _ = load_checkpoint(p, target=x, device='cpu')\n"
            "assert s == 2 and torch.equal(x['w'], y['w'])\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    cfg = reduced(REGISTRY["llama3.2-3b"])
    model = make_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    assert params["embed"].device.type == "cpu"   # the generator's device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(model, params, EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedBackend(model, params, max_slots=2, max_len=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlotBackend(model, params, max_slots=2, max_len=64)
    # naming the CPU is the one way onto it
    eng = ContinuousBatchingEngine(model, params,
                                   EngineConfig(backend="paged"), device="cpu")
    assert eng.backend.pools["k"].device.type == "cpu"


def test_rules_cover_every_package_of_the_port():
    """The walks above reach the API, data and launch modules, the
    serving surfaces of the moe/vlm/audio slice and the training slice."""
    files = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    for f in ("api/schemas.py", "api/client.py", "api/errors.py",
              "api/stream.py", "data/workload.py", "data/tokens.py",
              "launch/serve.py", "models/moe.py", "serving/embedding.py",
              "serving/offline.py", "launch/train.py", "training/train.py",
              "training/optimizer.py", "distributed/checkpoint.py",
              "distributed/_msgpack.py", "distributed/hints.py"):
        assert f in files


def test_new_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from repro_torch.launch import serve
    from repro_torch.serving.embedding import EmbeddingEngine
    from repro_torch.serving.offline import run_batch
    cfg = reduced(REGISTRY["hubert-xlarge"])
    enc = make_model(cfg)
    params = enc.init_params(torch.Generator().manual_seed(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmbeddingEngine(enc, params)
    dec = make_model(reduced(REGISTRY["phi3.5-moe-42b-a6.6b"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_batch(dec, dec.init_params(torch.Generator().manual_seed(0)), [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "1"])
    assert EmbeddingEngine(enc, params, device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    runs = [subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                           capture_output=True, text=True, timeout=120)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run([sys.executable, "chip_smoke.py"],
                                   cwd=REPO, capture_output=True, text=True,
                                   timeout=120))
    for out in runs:
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
