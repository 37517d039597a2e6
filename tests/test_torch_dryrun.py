"""The port's dry run (``python -m repro_torch.launch.dryrun``) and the
hints it switches on.

* ``hints.constrain`` / ``constrain_batch`` are the identity, and with a
  policy (``use_hints(make_hints({"attn_dp", "moe_ep"}, False))``) every
  family's one-device outputs are unchanged, bit for bit.
* The dry run's trip-count rule: a cell analysed at a cut depth and
  microbatch count and carried to the full counts gives the counts of the
  full run.
* ``dryrun.main`` on one cell writes a record with the reference's fields.
"""
import dataclasses
import json

import pytest
import torch

from repro_torch.configs import REGISTRY, SHAPES, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import hints
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import make_model
from repro_torch.training.train import loss_and_grads

# the fields of a record of the reference's dry run
# (repro/launch/dryrun.py run_cell) and of its analysis keys, less the ones
# only an XLA module has (hlo_bytes, fusions, while_loops, convert_bytes,
# compile_s, alias and generated-code sizes)
REFERENCE_FIELDS = {
    "arch", "shape", "mesh", "kind", "ok", "devices", "opts",
    "microbatches", "lower_s", "flops", "bytes_accessed",
    "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
    "dot_flops", "top_dots", "traffic_bytes", "all-gather", "all-reduce",
    "reduce-scatter", "all-to-all", "collective-permute", "all-gather_count",
    "all-reduce_count", "reduce-scatter_count", "all-to-all_count",
    "collective-permute_count", "collective_bytes", "top_collectives"}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_constrain_is_the_identity():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert hints.constrain(x, (("data",), None, None)) is x
    assert hints.constrain_batch(x, ("data", "model")) is x
    assert hints.constrain_batch(x, None) is x
    with hints.use_hints(dryrun.make_hints({"attn_dp", "moe_ep"}, False)):
        assert hints.constrain_batch(x, ("data", "model")) is x


FAMILY_ARCHS = ["llama3.2-3b", "phi3.5-moe-42b-a6.6b", "mamba2-130m",
                "zamba2-2.7b", "llava-next-34b", "hubert-xlarge"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_hints_leave_one_device_outputs_unchanged(arch):
    """The policy reaches the hint call sites (the full-sequence attention
    and the grouped MoE combine, which the prefill runs) and changes
    nothing: prefill logits, cache and the next decode step agree bit for
    bit, and so do a train loss and its gradients."""
    cfg = reduced(REGISTRY[arch])
    model = make_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    if cfg.input_kind == "embeds":
        batch = {"embeds": torch.randn(2, 16, cfg.d_model, generator=g)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                         generator=g)}
    policy = dryrun.make_hints({"attn_dp", "moe_ep"}, False)

    def run():
        out = [*model.prefill(params, batch, max_len=20)]
        if not cfg.is_encoder:
            tok = out[0].argmax(-1)
            out.append(model.decode_step(params, tok, out[1])[0])
        labels = torch.randint(0, cfg.vocab_size, (2, 16),
                               generator=torch.Generator().manual_seed(2))
        out += list(loss_and_grads(model, params,
                                   {**batch, "labels": labels}))
        return out

    plain = run()
    with hints.use_hints(policy):
        hinted = run()
    _assert_same(plain, hinted)


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif a is None:
        assert b is None
    else:
        assert torch.equal(a, b)


TRIP_CASES = [("llama3.2-3b", "train", 8), ("zamba2-2.7b", "train", 8),
              ("phi3.5-moe-42b-a6.6b", "prefill", None),
              ("zamba2-2.7b", "decode", None)]


@pytest.mark.parametrize("arch,kind,micro", TRIP_CASES)
def test_multiplied_cell_equals_the_full_run(arch, kind, micro):
    """Reduced configs made deep enough to be cut (5 layers, or 5 groups
    of the hybrid's 2 mamba layers and the shared block) with 8
    microbatches of 1 row a shard: the counts carried from the cut runs
    are the full run's."""
    base = reduced(REGISTRY[arch])
    per = base.attn_every if base.family == "hybrid" else 1
    cfg = dataclasses.replace(base, num_layers=5 * per)
    shape = ShapeConfig("t", kind, 32, 16)
    mesh = Mesh(("data", "model"), (2, 4))
    full = dryrun.analyze_cell(cfg, shape, mesh, microbatches=micro,
                               multiply=False)
    cut = dryrun.analyze_cell(cfg, shape, mesh, microbatches=micro)
    assert cut["layers_multiplied"]
    assert cut["microbatch_multiplied"] == (kind == "train")
    for k in ("dot_flops", "flop_counter_flops", "all-gather",
              "all-reduce", "reduce-scatter", "all-to-all",
              "argument_size_in_bytes", "output_size_in_bytes"):
        assert cut[k] == pytest.approx(full[k], rel=1e-9), k
    for k in ("all-gather_count", "all-reduce_count",
              "reduce-scatter_count"):
        assert cut[k] == full[k], k
    assert cut["traffic_bytes"] == pytest.approx(full["traffic_bytes"],
                                                 rel=1e-6)


def test_shards_with_fewer_rows_than_microbatches():
    """dbrx-132b's train_4k on the multi-pod mesh: 256 rows over 32
    data shards is 8 rows a shard, fewer than its 16 microbatches; a shard
    runs 8 microbatches of one row."""
    cfg = REGISTRY["dbrx-132b"]
    rules_mesh = make_production_mesh(multi_pod=True)
    res = dryrun.analyze_cell(
        dataclasses.replace(reduced(cfg), num_layers=4),
        dataclasses.replace(SHAPES["train_4k"], seq_len=64), rules_mesh,
        microbatches=16)
    assert res["microbatches"] == 16 and res["shard_microbatches"] == 8


def test_main_writes_a_record_with_the_reference_fields(tmp_path):
    dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k",
                 "--mesh", "both", "--out", str(tmp_path)])
    for mesh in ("single", "multi"):
        rec = json.loads((tmp_path / f"{mesh}_mamba2-130m_decode_32k.json")
                         .read_text())
        assert REFERENCE_FIELDS <= set(rec), REFERENCE_FIELDS - set(rec)
        assert rec["ok"] and rec["mesh"] == mesh
        assert rec["devices"] == (256 if mesh == "single" else 512)
        assert rec["dot_flops"] > 0 and rec["traffic_bytes"] > 0
        assert rec["compute_s"] == rec["dot_flops"] / 989e12


def test_a_failed_cell_is_recorded_and_the_sweep_goes_on(tmp_path,
                                                         monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("broken step")
    monkeypatch.setattr(dryrun, "analyze_step", broken)
    rec = dryrun.run_cell("mamba2-130m", "decode_32k", False, str(tmp_path))
    assert not rec["ok"] and rec["error"] == "RuntimeError: broken step"
    assert json.loads((tmp_path / "single_mamba2-130m_decode_32k.json")
                      .read_text())["error"] == rec["error"]
    with pytest.raises(SystemExit, match="2 cells failed"):
        dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k",
                     "--mesh", "both", "--out", str(tmp_path)])
