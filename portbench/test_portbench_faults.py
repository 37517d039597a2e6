"""A run with its timed path broken underneath comes out not correct: a
token altered where it is produced, and the cache state a prefill wrote
lost before decode reads it. Each drives the rest of a run on the CPU,
the look for a card skipped."""
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import numpy as np  # noqa: E402
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

CELLS = sorted({w["name"] for w in cell.spec.load_benchmark()["workloads"]}
               & set(smallcells.names()))


def altered_tokens(backend_cls, monkeypatch):
    fused = backend_cls.fused_decode

    def wrong(self, K, host_state=None):
        toks, produced, done = fused(self, K, host_state)
        toks = np.asarray(toks).copy()
        toks[-1] = (toks[-1] + 1) % self.cfg.vocab_size
        return toks, produced, done
    monkeypatch.setattr(backend_cls, "fused_decode", wrong)


def lost_state(backend_cls, monkeypatch):
    chunk = backend_cls.prefill_chunk

    def forget(self, task, budget=None):
        out = chunk(self, task, budget)
        caches = getattr(self, "pool_shards", None) or self.cache_shards
        for c in caches:
            for name, t in c.items():
                if name in ("k", "v", "ssm", "conv"):
                    t.zero_()
        return out
    monkeypatch.setattr(backend_cls, "prefill_chunk", forget)


@pytest.mark.parametrize("fault", [altered_tokens, lost_state])
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(name, fault, monkeypatch):
    from repro_torch.serving import backends
    small = smallcells.load(name)
    cls = (backends.PagedBackend if small["engine"]["backend"] == "paged"
           else backends.SlotBackend)
    fault(cls, monkeypatch)
    out = cell.run(name, 17, 3.0, False, time.perf_counter(), device="cpu",
                   overrides=small, log=lambda s: None,
                   clock=smallcells.TickClock())
    assert not out["correct"]
    assert out["checks"]["widest_gap"]["value"] > smallcells.CPU_LIMIT
