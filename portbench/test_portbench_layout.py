"""The harness is driven by data: a new configuration, traffic mix, cell
(with its limits) and per-layer metric are found by name from new files and
new entries alone;
and nothing the harness imports is JAX or the JAX package."""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT / "src")]

import pytest  # noqa: E402
import torch  # noqa: E402

import smallcells  # noqa: E402
from harness import cell  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread for torch while a test runs: the suite runs in
    several worker processes, and each pool of CPU threads would contend
    with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_new_files_are_found_by_name(tmp_path):
    base = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics", "correct"):
        (base / sub).mkdir(parents=True)
    shutil.copy(HERE / "metrics" / "tokens_per_sync.chat.py", base / "metrics")
    conf = {"name": "tiny-moe", "source": "test", "model": smallcells.MOE,
            "kernels": [],
            **{k: v for k, v in smallcells.CELLS["phi35moe-chat-prefix"].items()
               if k == "engine"}}
    (base / "configs" / "tiny-moe.json").write_text(json.dumps(conf))
    mix = {"kind": "chat", "base_seed": 7,
           "sampling": {"greedy_share": 0.5, "temperature": 1.0, "top_p": 0.9},
           **smallcells.CELLS["phi35moe-chat-prefix"]["mix"]}
    (base / "traffic" / "tiny_mix.json").write_text(json.dumps(mix))
    (base / "correct" / "tiny-moe.tiny.json").write_text(
        json.dumps(smallcells.CORRECT))
    (base / "metrics" / "steps_traced.py").write_text(
        "def read(r):\n    return float(len(r.steps)) or None\n")
    bench = {
        "configs": [{"name": "tiny-moe", "file": "portbench/configs/tiny-moe.json"}],
        "workloads": [{"name": "tiny-moe.tiny", "config": "tiny-moe",
                       "traffic": "tiny_mix", "chips": 1}],
        "end_to_end": [{"name": "ttft_p90_ms", "unit": "ms"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "steps_traced", "unit": "steps", "moves": "ttft_p90_ms"},
                      {"name": "tokens_per_sync.chat", "unit": "tokens",
                       "moves": "tpot_p90_ms", "workloads": ["tiny-moe.tiny"]}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traced = cell.run("tiny-moe.tiny", 4, 3.0, True, time.perf_counter(),
                      device="cpu", root=tmp_path, base=base, log=lambda s: None,
                   clock=smallcells.TickClock())
    assert set(traced["metrics"]) == {"steps_traced", "tokens_per_sync.chat"}
    plain = cell.run("tiny-moe.tiny", 4, 3.0, False, time.perf_counter(),
                     device="cpu", root=tmp_path, base=base, log=lambda s: None,
                   clock=smallcells.TickClock())
    assert set(plain["metrics"]) == {"ttft_p90_ms", "setup_s"}
    assert traced["correct"] and plain["correct"]


def test_nothing_imported_is_jax_or_the_jax_package():
    code = (
        "import sys, pathlib\n"
        f"sys.path[:0] = [{str(HERE)!r}, {str(ROOT / 'src')!r}]\n"
        "import run, calibrate, sweep\n"
        "from harness import cell, check, driver, readings, spec, stats, trace, traffic, weights, work\n"
        "from reference import common, moe\n"
        "for p in sorted(pathlib.Path(spec.HERE, 'metrics').glob('*.py')):\n"
        "    spec.reader(p.stem)\n"
        "import repro_torch.serving.engine, repro_torch.kernels._build\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    names = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "torch" in names and "harness" in names
    assert not names & set(cell.FORBIDDEN), names & set(cell.FORBIDDEN)


def test_run_refuses_without_a_card(tmp_path):
    """No result and a non-zero exit where no CUDA card is, and in a
    checkout of the benchmark's files alone."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    args = ["--workload", "phi35moe-chat-prefix", "--seed", "1", "--seconds", "1"]
    for root in (ROOT, tmp_path):
        if root is tmp_path:
            shutil.copytree(HERE, tmp_path / "portbench",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        out = subprocess.run([sys.executable, "portbench/run.py", *args],
                             cwd=root, capture_output=True, text=True, env=env,
                             timeout=120)
        assert out.returncode != 0
        assert '"correct"' not in out.stdout
