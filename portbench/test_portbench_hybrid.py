"""The ``zamba2`` family (the port's ``hybrid`` at the published Zamba2
layout): the port's slot engine against the plain reference
(``reference/zamba2.py``), the
reference against ``transformers``' Zamba2 (the published code, built at
the small size in code, no download), and the family's work counts at
Zamba2-7B's widths against the reckoning by hand.

Tolerances: the engine against the reference, 2e-5 of the logits' scale
(both float32, the same products in other orders and, for the engine, its
one-shot prefill and its decode step through the cache); the reference
against transformers, 1e-4 (float32; transformers sums the scan and the
attention in its own orders, and clamps nothing here: its torch path's dt
clamp at time_step_min is set to 0, the departure the configuration file
lists).

transformers 4.57's Zamba2 torch path (``Zamba2MambaMixer.torch_forward``)
sums its inter-chunk state product over the target chunk where
``modeling_mamba2.py`` sums over the source, so it leaves the recurrence
at the first chunk boundary: the comparison runs its sequences inside one
of its chunks (``HF_CHUNK``). The reference's own scan crosses its chunks
(``reference/zamba2.py``'s ``SCAN_CHUNK`` is 64), and the engine test above
holds it to the port's scan, itself held to the recurrence."""
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import pytest  # noqa: E402
import torch  # noqa: E402

from harness import driver, spec, weights  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread for torch while a test runs: the suite runs in
    several worker processes, and each pool of CPU threads would contend
    with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


M = spec.family("zamba2").SMALL
HF_CHUNK = 128      # above the longest sequence the comparison runs


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_slot_engine_prefill_and_decode_match_the_reference():
    """Prefill of three prompts into the slot backend, then eight fused
    decode iterations through its cache, teacher-forced on tokens drawn
    here: every logit against the reference's full forward over the whole
    sequence."""
    from repro_torch.models import make_model
    from repro_torch.serving.backends import SlotBackend
    params = weights.draw(M, 5, "cpu")
    be = SlotBackend(make_model(driver.port_config({"name": "t", "model": M})),
                     params, max_slots=3, max_len=64, use_kernel=True,
                     device="cpu")
    g = torch.Generator().manual_seed(1)
    seqs = [torch.randint(2, M["vocab_size"], (n + 8,), generator=g).tolist()
            for n in (9, 30, 17)]
    want = spec.reference("zamba2").logits(
        params, M, [(s, len(s) - 9) for s in seqs])
    got = [[be.prefill(f"s{i}", s[:-8])] for i, s in enumerate(seqs)]
    for t in range(8):
        logits = be.decode_batch(torch.tensor([s[-8 + t] for s in seqs]))
        for i in range(3):
            got[i].append(torch.as_tensor(logits[i]))
    for lg, w in zip(got, want):
        assert _rel(torch.stack(lg), w) < 2e-5


def _hf_model(m, params):
    """transformers' Zamba2ForCausalLM at the small size, with ``params``
    copied in (weights as (out, in))."""
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    tr = pytest.importorskip("transformers")
    ids = m["hybrid_layer_ids"]
    L, d, s = m["num_layers"], m["d_model"], m["ssm"]
    cfg = tr.Zamba2Config(
        vocab_size=m["vocab_size"], hidden_size=d, num_hidden_layers=L,
        layers_block_type=["hybrid" if i in ids else "mamba"
                           for i in range(L)],
        num_attention_heads=m["num_heads"],
        num_key_value_heads=m["num_kv_heads"], intermediate_size=m["d_ff"],
        hidden_act="gelu", mamba_d_state=s["d_state"],
        mamba_d_conv=s["conv_kernel"], mamba_expand=s["expand"],
        mamba_ngroups=s["n_groups"],
        n_mamba_heads=s["expand"] * d // s["head_dim"],
        chunk_size=HF_CHUNK, num_mem_blocks=m["num_mem_blocks"],
        adapter_rank=m["adapter_rank"], use_shared_attention_adapter=False,
        use_shared_mlp_adapter=True, use_mem_rope=True,
        rope_theta=m["rope_theta"], rms_norm_eps=m["norm_eps"],
        tie_word_embeddings=m["tie_embeddings"], use_cache=False,
        attn_implementation="eager")
    assert cfg.attention_head_dim == m["head_dim"]
    hf = tr.Zamba2ForCausalLM(cfg).eval()
    P, mb = params["layers"], params["layers"]["mamba"]

    def put(module, w):
        module.weight.data.copy_(w)
    with torch.no_grad():
        put(hf.model.embed_tokens, params["embed"])
        put(hf.model.final_layernorm, params["final_norm"])
        for i, layer in enumerate(hf.model.layers):
            dec = layer.mamba_decoder if i in ids else layer
            mx = dec.mamba
            mx.time_step_min = 0.0          # the departure: no dt clamp
            put(dec.input_layernorm, P["norm"][i])
            put(mx.in_proj, mb["in_proj"][i].T)
            mx.conv1d.weight.copy_(mb["conv_w"][i].T[:, None, :])
            mx.conv1d.bias.copy_(mb["conv_b"][i])
            for n in ("A_log", "D", "dt_bias"):
                getattr(mx, n).copy_(mb[n][i])
            put(mx.norm, mb["norm"][i])
            put(mx.out_proj, mb["out_proj"][i].T)
            if i not in ids:
                continue
            j = ids.index(i)
            bw = params["blocks"]
            k = j % m["num_mem_blocks"]
            put(layer.linear, params["apps"]["linear"][j].T)
            blk = layer.shared_transformer
            put(blk.input_layernorm, bw["norm1"][k])
            put(blk.pre_ff_layernorm, bw["norm2"][k])
            for n in ("q", "k", "v", "o"):
                put(getattr(blk.self_attn, f"{n}_proj"),
                    bw["attn"][f"w{n}"][k].T)
            put(blk.feed_forward.gate_up_proj, bw["mlp"]["gate_up"][k].T)
            put(blk.feed_forward.down_proj, bw["mlp"]["down"][k].T)
            ad = blk.feed_forward.gate_up_proj_adapter_list[j]
            put(ad[0], params["apps"]["adapter_in"][j].T)
            put(ad[1], params["apps"]["adapter_out"][j].T)
    assert hf.lm_head.weight.data_ptr() == hf.model.embed_tokens.weight.data_ptr()
    return hf


def test_reference_is_transformers_zamba2():
    params = weights.draw(M, 7, "cpu")
    hf = _hf_model(M, params)
    g = torch.Generator().manual_seed(2)
    seqs = [torch.randint(2, M["vocab_size"], (n,), generator=g).tolist()
            for n in (HF_CHUNK - 1, 23)]
    want = spec.reference("zamba2").logits(params, M, [(s, 0) for s in seqs])
    for s, w in zip(seqs, want):
        with torch.no_grad():
            got = hf(torch.tensor([s])).logits[0]
        assert _rel(got, w) < 1e-4


def test_work_counts_at_zamba2_7b():
    """The family's counts against the reckoning by hand: one token's
    weight products about 22 GFLOP (14.7 for the stored weights, the tied
    block 13 times); a decode iteration at 32 rows moves the mixers'
    weights (12.7 GB), the tied blocks once per application (9.1 GB) and
    the state read and written (9.7 GB); the scans of a 2048-token prompt
    move about 81 x 44 MB."""
    fam = spec.family("zamba2")
    m = json.loads((HERE / "configs" / "zamba2-7b.json").read_text())["model"]
    assert fam.token_matmul_flops(m) == pytest.approx(22.1e9, rel=0.02)
    assert fam.kv_bytes_per_position(m) == 13 * 2 * 32 * 224 * 2
    base = fam.decode_bytes(m, 32, [])
    assert base == pytest.approx(12.7e9 + 9.1e9 + 9.7e9 + 0.23e9, rel=0.03)
    assert fam.decode_bytes(m, 32, [100, 50]) - base \
        == 150 * fam.kv_bytes_per_position(m)
    nbytes, flops = fam.ssd_work(m, 2048)
    assert nbytes / 81 == pytest.approx(2 * 2048 * 7168 * 2 + 2048 * 112 * 4
                                        + 2 * 2048 * 128 * 2
                                        + 112 * 64 * 64 * 4)
    assert 5e9 < flops / 81 < 1e10


# -- the cell's readers, on hand-made steps, records and device traces --

def _readings(steps, trace=None):
    """``steps`` (and ``trace``) at Zamba2-7B's widths; r0's prompt is 50
    tokens, r1's 100."""
    from harness.driver import Step
    from harness.readings import Readings
    from harness.traffic import Request
    m = json.loads((HERE / "configs" / "zamba2-7b.json").read_text())["model"]
    reqs = {r: Request(r, 0.0, [5] * n, 64, 0.0, 1.0, 1)
            for r, n in (("r0", 50), ("r1", 100))}
    return Readings(m, reqs, steps, {}, trace, 0.0, 1.0)


def _steps():
    """Two decode-only steps of K = 2 (r0 live in three iterations) and
    one that prefilled r1's 100 tokens."""
    from harness.driver import Step
    a = Step(0.0, 0.1, K=2, frames=[("r0", 3, 2)])
    b = Step(0.1, 0.3, K=2, frames=[("r0", 5, 1)])
    c = Step(0.3, 0.5, prefill=[("r1", 0, 100)], frames=[("r1", 0, 1)])
    return [a, b, c]


def _with_counters(monkeypatch, counters):
    from harness import program
    monkeypatch.setattr(program, "of", lambda r: program.Program(
        [], counters, 0.0))


def test_row_readers(monkeypatch):
    from harness import spec as hs
    from harness import trace as tr
    fam = hs.family("zamba2")
    # device busy 0.05 s in the first decode step, 0.1 s in the second
    # (two overlapping activities), 0.1 s in the prefill step
    dev = tr.DeviceTrace([(0.02, 0.07, "a"), (0.15, 0.22, "b"),
                          (0.2, 0.25, "c"), (0.35, 0.45, "d")])
    r = _readings(_steps(), dev)
    live, hbm = (hs.reader(n) for n in ("live_row_share.burst",
                                        "decode_hbm_share.burst"))
    _with_counters(monkeypatch, {"decode_rows.stepped": 4 * 32,
                                 "decode_rows.live": 3})
    assert live.read(r) == pytest.approx(100 * 3 / 128)
    # 4 iterations of 32 rows; r0 live in three of them, at contexts 53,
    # 54 and 55; the prefill step is left out
    need = sum(fam.decode_bytes(r.model, 32, c)
               for c in ([53], [54], [55], []))
    assert hbm.read(r) == pytest.approx(
        100 * need / 3.35e12 / 0.15)
    assert hbm.read(_readings(_steps())) is None
    _with_counters(monkeypatch, {})
    assert live.read(r) is None and hbm.read(r) is None


def test_kernel_readers():
    from harness import spec as hs
    from harness import trace as tr
    fam = hs.family("zamba2")
    ssd, attn = (hs.reader(n) for n in ("ssd_roofline.burst",
                                        "shared_attn_roofline.burst"))
    assert ssd.read(_readings(_steps())) is None
    assert attn.read(_readings(_steps())) is None
    dev = tr.DeviceTrace([], {"ssd_chunk_scan_kernel<64>": 2e-3,
                              "ssd_state_pass_kernel": 1e-3,
                              "void flash_tc_kernel<224>": 4e-4})
    r = _readings(_steps(), dev)
    nbytes, flops = fam.ssd_work(r.model, 100)
    assert ssd.read(r) == pytest.approx(
        100 * max(nbytes / 3.35e12, flops / 989e12) / 3e-3)
    assert attn.read(r) == pytest.approx(
        100 * fam.attn_flops(r.model, 0, 100) / 989e12 / 4e-4)
