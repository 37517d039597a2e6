"""The window's arithmetic, the work counts and the trace reduction, on
hand-worked cases."""
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import json  # noqa: E402

import pytest  # noqa: E402

from harness import stats, trace, work  # noqa: E402
from harness.stats import Timeline  # noqa: E402


def tl(rid, due, first, gap, n, finished=True):
    t = Timeline(rid, due, 100, n)
    t.frames = [(first + i * gap, 1) for i in range(n)]
    t.finished = t.frames[-1][0] if finished else None
    return t


def test_percentile_interpolates():
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5
    assert stats.percentile(range(11), 90) == 9.0
    assert stats.percentile([5], 90) == 5


def test_stall_inside_the_window_moves_the_tail():
    """Forty requests, two a second; a stall of 4 s at t = 10 delays the
    first token of every request due while it lasts (a fifth of them)."""
    calm = [tl(f"r{i}", i * 0.5, i * 0.5 + 0.1, 0.02, 20) for i in range(40)]
    stalled = []
    for i in range(40):
        due = i * 0.5
        first = due + 0.1
        if 10.0 <= first < 14.0:
            first = 14.0 + 0.1
        stalled.append(tl(f"r{i}", due, first, 0.02, 20))
    a = stats.chat_metrics(calm, 20.0)
    b = stats.chat_metrics(stalled, 20.0)
    assert a["ttft_p90_ms"] == pytest.approx(100.0)
    assert b["ttft_p90_ms"] > 1000.0
    assert a["tpot_p90_ms"] == pytest.approx(20.0)
    assert a["attempted"] == 40 and a["failed"] == 0


def test_unfinished_request_is_failed_and_fills_the_tail():
    done = [tl(f"r{i}", i, i + 0.1, 0.02, 10) for i in range(9)]
    hung = tl("r9", 9.0, 9.1, 0.02, 3, finished=False)
    m = stats.chat_metrics(done + [hung], 20.0)
    assert m["failed"] == 1
    assert "tpot_p90_ms" not in m          # the tail lands on the failure
    assert m["tpot_p50_ms"] == pytest.approx(20.0)
    late = tl("late", 25.0, 25.1, 0.02, 4)
    assert stats.chat_metrics(done + [late], 20.0)["attempted"] == 9


def model(name):
    conf = json.loads((HERE / "configs" / f"{name}.json").read_text())
    return conf["model"]


def test_attention_flops_by_hand():
    m = {"family": "moe", "num_layers": 2, "num_heads": 4, "head_dim": 8}
    # queries at positions 3, 4: 4 + 5 keys; 4 FLOPs per key, head and dim
    assert work.attn_flops(m, 3, 2) == 4 * 4 * 8 * 9 * 2
    # one query at position 0 sees itself alone
    assert work.attn_flops(m, 0, 1) == 4 * 4 * 8 * 1 * 2


def test_decode_bytes_read_a_shared_prefix_once():
    m = {"family": "moe", "num_layers": 1, "num_heads": 2, "num_kv_heads": 1,
         "head_dim": 4}
    per_pos = 2 * 1 * 4 * 2
    qo = 2 * 2 * 4 * 2
    # two sequences over one 10-token prefix, contexts 15 and 12; a third
    # with none
    it = [(15, 0, 10), (12, 0, 10), (7, -1, 0)]
    assert work.decode_attn_bytes(m, it) == (10 + 5 + 2 + 7) * per_pos + 3 * qo


def test_matmul_flops_count_routed_experts_only():
    m = model("phi3.5-moe-16of32")
    d, f = 4096, 6400
    attn = d * 4096 * 2 + 2 * d * 1024
    assert work.token_matmul_flops(m) == 2 * 16 * (attn + 2 * 3 * d * f + d * 16)
    assert work.head_flops(m) == 2 * d * 32064


def test_the_cells_work_counts_as_recorded():
    """phi3.5-moe's counts through ``families/moe.py`` equal those the
    harness counted when the family's branch lived in ``harness/work.py``."""
    m = model("phi3.5-moe-16of32")
    it = [(1500, 0, 1200), (1700, 0, 1200), (2000, 3, 1800), (300, -1, 0)]
    assert work.token_matmul_flops(m) == 6377439232.0
    assert work.attn_flops(m, 1024, 512) == 171865800704.0
    assert work.kv_bytes_per_position(m) == 65536
    assert work.decode_attn_bytes(m, it) == 282853376.0
    assert work.model_flops(m, [(0, 512), (512, 300)], [it, it[:2]], 7) \
        == 5307392589824.0


def test_a_family_without_a_file_is_named():
    m = {**model("phi3.5-moe-16of32"), "family": "hybrid"}
    with pytest.raises(ValueError, match=r"families with one: \['moe'"):
        work.token_matmul_flops(m)


def test_model_flops_add_prefill_decode_and_head():
    m = {"family": "moe", "num_layers": 1, "d_model": 2, "num_heads": 1,
         "num_kv_heads": 1, "head_dim": 2, "d_ff": 3, "vocab_size": 5,
         "moe": {"num_experts": 4, "top_k": 1}}
    per_tok = 2 * (2 * 2 * 2 + 2 * 2 * 2 + 3 * 2 * 3 + 2 * 4)
    # a chunk of 3 tokens from position 0 (1 + 2 + 3 keys), one decode
    # iteration of one sequence at context 5 (5 keys), 2 sampled tokens
    want = 4 * per_tok + 4 * 2 * (6 + 5) + 2 * (2 * 2 * 5)
    assert work.model_flops(m, [(0, 3)], [[(5, -1, 0)]], 2) == want


def test_trace_busy_gaps_and_labels():
    tr = trace.DeviceTrace([(1.0, 2.0, "a"), (1.5, 3.0, "b"), (4.0, 5.0, "c")],
                           {"a": 1.0, "b": 1.5, "c": 1.0})
    assert tr.busy(0.0, 10.0) == pytest.approx(3.0)
    assert tr.busy(2.5, 4.5) == pytest.approx(1.0)
    assert tr.gaps(0.0, 6.0) == [(0.0, 1.0), (3.0, 4.0), (5.0, 6.0)]
    spans = [("step", 0.0, 3.6), ("decode", 0.2, 0.9)]
    assert trace.label_gaps([(3.0, 4.0), (0.0, 1.0)], spans) == [
        ["step", 1.0], ["decode", 1.0]]
    t = trace.from_events([("m", 100, 110), ("k", 200, 300)], 100 - 10**9, 100)
    assert t.intervals == [(1.0 + 1e-7, 1.0 + 2e-7, "k")]
    assert not math.isnan(t.busy(0.0, 2.0))


def test_roofline_names_read_port_kernels():
    assert trace.port_kernel("void paged_decode_kernel<128>(...)") == \
        "paged decode attention"
    assert trace.port_kernel("ssd_chunk_scan_kernel") == "ssd"
    assert trace.kernel_group("nvjet_tst_128x64") == "matmuls"
