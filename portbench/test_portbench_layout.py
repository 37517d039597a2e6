"""The harness is driven by data: a new configuration, traffic mix, cell
(with its limits and its small version), per-layer metric and model family
(its weights, work counts and reference) are found by name from new files
and new entries alone; and nothing the harness imports is JAX or the JAX
package."""
import hashlib
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


@pytest.mark.parametrize("small", smallcells.names())
def test_new_files_are_found_by_name(tmp_path, small):
    base = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics", "correct"):
        (base / sub).mkdir(parents=True)
    shutil.copy(HERE / "metrics" / "tokens_per_sync.chat.py", base / "metrics")
    cut = smallcells.load(small)
    conf = {"name": "tiny", "source": "test", "model": cut["model"],
            "kernels": [], "engine": cut["engine"]}
    (base / "configs" / "tiny.json").write_text(json.dumps(conf))
    mix = {"kind": "chat", "base_seed": 7,
           "sampling": {"greedy_share": 0.5, "temperature": 1.0, "top_p": 0.9},
           **cut["mix"]}
    (base / "traffic" / "tiny_mix.json").write_text(json.dumps(mix))
    (base / "correct" / "tiny.tiny.json").write_text(json.dumps(cut["correct"]))
    (base / "metrics" / "steps_traced.py").write_text(
        "def read(r):\n    return float(len(r.steps)) or None\n")
    bench = {
        "configs": [{"name": "tiny", "file": "portbench/configs/tiny.json"}],
        "workloads": [{"name": "tiny.tiny", "config": "tiny",
                       "traffic": "tiny_mix", "chips": 1}],
        "end_to_end": [{"name": "ttft_p90_ms", "unit": "ms"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "steps_traced", "unit": "steps", "moves": "ttft_p90_ms"},
                      {"name": "tokens_per_sync.chat", "unit": "tokens",
                       "moves": "tpot_p90_ms", "workloads": ["tiny.tiny"]}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traced = cell.run("tiny.tiny", 4, 3.0, True, time.perf_counter(),
                      device="cpu", root=tmp_path, base=base, log=lambda s: None,
                      clock=smallcells.TickClock())
    assert set(traced["metrics"]) == {"steps_traced", "tokens_per_sync.chat"}
    plain = cell.run("tiny.tiny", 4, 3.0, False, time.perf_counter(),
                     device="cpu", root=tmp_path, base=base, log=lambda s: None,
                     clock=smallcells.TickClock())
    assert set(plain["metrics"]) == {"ttft_p90_ms", "setup_s"}
    assert traced["correct"] and plain["correct"]


DENSE_FAMILY = '''"""The port's ``dense`` family: every layer attends and has one SwiGLU
MLP."""
import math

from harness import weights, work

SMALL = {"family": "dense", "num_layers": 2, "d_model": 64, "num_heads": 4,
         "num_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab_size": 256,
         "rope_theta": 10000.0, "norm_eps": 1e-5, "param_dtype": "float32"}


def draw(dr, m, dt):
    L, d, f = m["num_layers"], m["d_model"], m["d_ff"]
    p = {"embed": dr.normal((m["vocab_size"], d), 1.0, dt)}
    p["layers"] = {
        "norm1": weights.gain(dr, (L, d), dt), "attn": weights.attn(dr, m, L, dt),
        "norm2": weights.gain(dr, (L, d), dt),
        "mlp": {"w1": dr.normal((L, d, f), 1 / math.sqrt(d), dt),
                "w3": dr.normal((L, d, f), 1 / math.sqrt(d), dt),
                "w2": dr.normal((L, f, d), 1 / math.sqrt(f * 2 * L), dt)}}
    return {**p, **weights.head(dr, m, dt)}


def token_matmul_flops(m):
    d, H, KH, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    return 2.0 * m["num_layers"] * (d * H * hd * 2 + 2 * d * KH * hd
                                    + 3 * d * m["d_ff"])


def attn_flops(m, start, n):
    return work.layer_attn_flops(m, start, n) * m["num_layers"]


def kv_bytes_per_position(m):
    return work.layer_kv_bytes(m) * m["num_layers"]
'''

DENSE_REFERENCE = '''"""Plain float32 reference of the port's ``dense`` family."""
import torch

from reference.common import (act, attention_block, exact, head_logits,
                              rms_norm, swiglu)


def logits(params, m, seqs, precision="float32"):
    P = params["layers"]
    dev = params["embed"].device
    with exact():
        hs = [act(params["embed"][torch.as_tensor(t, device=dev)].float(),
                  precision) for t, _ in seqs]
        for i in range(m["num_layers"]):
            aw = {n: w[i] for n, w in P["attn"].items()}
            hs = [act(h + attention_block(h, P["norm1"][i], aw, m, precision),
                      precision) for h in hs]
            hs = [act(h + swiglu(rms_norm(h, P["norm2"][i], m["norm_eps"],
                                          precision),
                                 P["mlp"]["w1"][i], P["mlp"]["w3"][i],
                                 P["mlp"]["w2"][i], precision), precision)
                  for h in hs]
        return [head_logits(h[first:], params["final_norm"], params["lm_head"],
                            m, precision) for h, (_, first) in zip(hs, seqs)]
'''


def _digests(root: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_family_is_added_by_files_alone(tmp_path):
    """A model family and a cell of it with bursty traffic, added to a copy
    of the benchmark as a later change would add them: new files under
    ``portbench/`` and new entries in ``BENCHMARK.json``, and no edit of a
    file there. The copy's own harness runs the cell on the CPU, traced and
    untraced, correct, with the family's work counts read."""
    base = tmp_path / "portbench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(base)
    m = {"family": "dense", "num_layers": 24, "d_model": 2048, "num_heads": 16,
         "num_kv_heads": 8, "head_dim": 128, "d_ff": 5632, "vocab_size": 32000,
         "rope_theta": 10000.0, "norm_eps": 1e-5, "param_dtype": "bfloat16"}
    engine = {"backend": "paged", "use_kernel": True, "page_size": 16,
              "enable_prefix_cache": True, "chunked_prefill_budget": 64,
              "decode_steps_per_sync": 8, "max_slots": 8, "max_seq_len": 512,
              "num_pages": 200}
    name = "tiny-dense.burst"
    added = {
        "families/dense.py": DENSE_FAMILY,
        "reference/dense.py": DENSE_REFERENCE,
        "configs/tiny-dense.json": {"name": "tiny-dense", "model": m,
                                    "kernels": [], "engine": engine},
        "traffic/burst.json": {
            "kind": "chat", "base_seed": 11,
            "arrivals": {"kind": "onoff", "rate": 3.0, "on_s": 8, "off_s": 4},
            "prompt": {"turn": {"mu": 5.1, "sigma": 0.9, "lo": 16, "hi": 1024}},
            "output": {"mu": 5.0, "sigma": 0.8, "lo": 16, "hi": 512},
            "sampling": {"greedy_share": 0.5, "temperature": 1.0, "top_p": 0.9},
            "warmup": {"requests": 2, "max_tokens": 8}, "drain_s": 90,
            "trace": {"start_s": 15.0, "seconds": 3.0}},
        f"small/{name}.json": {
            "model": {**m, "num_layers": 2, "d_model": 64, "num_heads": 4,
                      "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
                      "vocab_size": 256, "param_dtype": "float32"},
            "engine": engine,
            "mix": {"arrivals": {"kind": "onoff", "rate": 8.0, "on_s": 1.0,
                                 "off_s": 0.5},
                    "prompt": {"turn": {"mu": 3.0, "sigma": 0.5, "lo": 4,
                                        "hi": 60}},
                    "output": {"mu": 2.5, "sigma": 0.5, "lo": 4, "hi": 40},
                    "drain_s": 30},
            "correct": {"sample_tokens": 64, "sample_requests": 4,
                        "limits": {"widest_gap": smallcells.CPU_LIMIT,
                                   "mean_gap": smallcells.CPU_LIMIT}}},
        f"correct/{name}.json": {"sample_tokens": 1536, "sample_requests": 16,
                                 "limits": {"mean_gap": 3e-3}},
    }
    for rel, body in added.items():
        path = base / rel
        assert not path.exists(), rel
        path.write_text(body if isinstance(body, str) else json.dumps(body))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-dense", "source": "test",
                             "file": "portbench/configs/tiny-dense.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": "tiny-dense",
                               "traffic": "burst", "chips": 1, "why": "test"})
    for e in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in e:
            e["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(base)!r}, {str(ROOT / 'src')!r}]\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import smallcells\n"
        "from harness import cell\n"
        "out = [cell.run(sys.argv[1], 2 ** 31 + 9, 3.0, traced,\n"
        "                time.perf_counter(), device='cpu',\n"
        "                overrides=smallcells.load(sys.argv[1]),\n"
        "                log=lambda s: None, clock=smallcells.TickClock())\n"
        "       for traced in (False, True)]\n"
        "print(json.dumps(out))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    got = subprocess.run([sys.executable, "-c", code, name], cwd=tmp_path,
                         capture_output=True, text=True, env=env, timeout=300)
    assert got.returncode == 0, got.stderr[-4000:]
    plain, traced = json.loads(got.stdout.strip().splitlines()[-1])
    for out in (plain, traced):
        assert out["correct"], out["checks"]
        assert out["attempted"] > 0 and out["failed"] == 0
    assert set(plain["metrics"]) == {"ttft_p90_ms", "tpot_p90_ms", "setup_s"}
    assert 0.0 < traced["metrics"]["step_mfu.chat"]["value"] <= 100.0
    assert _digests(base) == {**before, **{
        base / rel: hashlib.sha256((base / rel).read_bytes()).hexdigest()
        for rel in added}}


def test_nothing_imported_is_jax_or_the_jax_package():
    code = (
        "import sys, pathlib\n"
        f"sys.path[:0] = [{str(HERE)!r}, {str(ROOT / 'src')!r}]\n"
        "import run, calibrate, sweep\n"
        "from harness import cell, check, driver, readings, spec, stats, trace, traffic, weights, work\n"
        "from reference import common\n"
        "for p in sorted(pathlib.Path(spec.HERE, 'metrics').glob('*.py')):\n"
        "    spec.reader(p.stem)\n"
        "for p in sorted(pathlib.Path(spec.HERE, 'families').glob('*.py')):\n"
        "    spec.family(p.stem), spec.reference(p.stem)\n"
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
