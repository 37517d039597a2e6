"""The port's cost model (``repro_torch.serving.costmodel``) and typed
client against the JAX package's.

* Given the reference's constants, ``restore_tokens``,
  ``expected_spec_tokens`` and every ``InstanceCost`` method equal the
  reference's EXACTLY for every registry config and the testbed's three
  stand-ins, over a grid of batch, context, K, ``model_shards``, accept
  rate and speculative tokens; ``__post_init__`` raises the same errors.
* The port's own constants are the H100's (datasheet rates; overheads
  fitted on the card, non-negative, summing to ``STEP_OVERHEAD``), and no
  TPU figure is named anywhere in the port.
* ``FirstClient`` over the port's gateway answers as the reference's
  client over its own gateway, call for call, in wire form.
"""
import dataclasses
import importlib
import itertools
import pathlib

import pytest

import repro.serving.costmodel as ref_cost
import repro_torch.serving.costmodel as port_cost
from repro.configs import REGISTRY as REF_REGISTRY
from repro.core import testbed as ref_tb
from repro_torch.configs import REGISTRY as PORT_REGISTRY
from repro_torch.core import testbed as port_tb
from test_torch_core import COUNTERS, REF_HW, chip_smoke

PORT = pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch"

STAND_INS = ("LLAMA70B", "LLAMA8B", "GEMMA27B")
CONFIGS = sorted(REF_REGISTRY) + list(STAND_INS)


def _cfgs(name):
    if name in STAND_INS:
        return getattr(ref_tb, name), getattr(port_tb, name)
    return REF_REGISTRY[name], PORT_REGISTRY[name]


@pytest.fixture
def ref_collective(monkeypatch):
    """``COLLECTIVE_LAUNCH`` is read at call time, not bound to a field."""
    monkeypatch.setattr(port_cost, "COLLECTIVE_LAUNCH",
                        ref_cost.COLLECTIVE_LAUNCH)


def _calls(c, d):
    """Every method of an InstanceCost ``c`` (``d`` a draft cost) over the
    grid, as (call, value) pairs."""
    out = [("load_time", c.load_time())]
    for n in (0, 1, 17, 512, 4096):
        out += [(f"prefill_time({n})", c.prefill_time(n)),
                (f"prefill_time({n}, 3)", c.prefill_time(n, batch=3)),
                (f"swap_time({n})", c.swap_time(n)),
                (f"handoff_time({n})", c.handoff_time(n))]
        for h in (0.0, 0.5, 0.9, 1.0, 1.3):
            out.append((f"restore_time({n}, {h})", c.restore_time(n, h)))
    for b, ctx in itertools.product((1, 8, 48), (1, 1024, 7777)):
        out += [(f"hbm_bytes_per_shard({b}, {ctx})",
                 c.hbm_bytes_per_shard(b, ctx)),
                (f"_collective_time({b})", c._collective_time(b)),
                (f"_collective_time({b}, 5)", c._collective_time(b, 5))]
        for t in (1, 5):
            out.append((f"_decode_roofline({b}, {ctx}, {t})",
                        c._decode_roofline(b, ctx, t)))
        for k in (1, 2, 8, 16):
            out += [(f"decode_step_time({b}, {ctx}, {k})",
                     c.decode_step_time(b, ctx, k)),
                    (f"decode_tok_per_s({b}, {ctx}, {k})",
                     c.decode_tok_per_s(b, ctx, k))]
        for s in (0, 1, 4):
            out.append((f"spec_round_time({b}, {s}, {ctx})",
                        c.spec_round_time(b, d, s, ctx)))
            for a in (0.0, 0.3, 0.8, 1.0):
                out.append((f"spec_decode_tok_per_s({b}, {s}, {a}, {ctx})",
                            c.spec_decode_tok_per_s(b, d, s, a, ctx)))
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_instance_cost_equals_reference(name, ref_collective):
    ref_cfg, port_cfg = _cfgs(name)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
    ref_d = ref_cost.InstanceCost(cfg=REF_REGISTRY["llama3.2-3b"], chips=8)
    port_d = port_cost.InstanceCost(cfg=PORT_REGISTRY["llama3.2-3b"],
                                    chips=8, **REF_HW)
    grid = [dict(chips=1, model_shards=1)] + [
        dict(chips=8, model_shards=n) for n in (1, 2, 4, 8)] + [
        dict(chips=4, model_shards=2, mfu=0.37, bytes_per_param=1.0,
             storage_bw=40e9)]
    for kw in grid:
        ref = ref_cost.InstanceCost(cfg=ref_cfg, **kw)
        port = port_cost.InstanceCost(cfg=port_cfg, **REF_HW, **kw)
        assert _calls(port, port_d) == _calls(ref, ref_d), kw


def test_free_functions_equal_reference():
    for n, h in itertools.product((0, 1, 7, 100, 2048),
                                  (-0.5, 0.0, 0.25, 0.9, 1.0, 2.0)):
        assert port_cost.restore_tokens(n, h) == ref_cost.restore_tokens(n, h)
    for a, k in itertools.product((-1.0, 0.0, 0.1, 0.5, 0.8, 0.99, 1.0,
                                   1.5), (-1, 0, 1, 4, 8)):
        assert port_cost.expected_spec_tokens(a, k) \
            == ref_cost.expected_spec_tokens(a, k)


@pytest.mark.parametrize("chips,shards", [(8, 0), (8, -2), (8, 3), (4, 8),
                                          (6, 4)])
def test_post_init_errors_equal_reference(chips, shards):
    with pytest.raises(ValueError) as ref:
        ref_cost.InstanceCost(cfg=REF_REGISTRY["llama3.2-3b"], chips=chips,
                              model_shards=shards)
    with pytest.raises(ValueError) as port:
        port_cost.InstanceCost(cfg=PORT_REGISTRY["llama3.2-3b"], chips=chips,
                               model_shards=shards)
    assert str(port.value) == str(ref.value)


def test_port_constants_are_the_h100s():
    c = port_cost
    assert (c.PEAK_FLOPS, c.HBM_BW, c.HOST_IO_BW, c.ICI_BW) \
        == (989e12, 3.35e12, 64e9, 450e9)
    # cluster-fabric and control-plane terms carried over unchanged
    assert (c.KV_TRANSFER_BW, c.HANDOFF_OVERHEAD) \
        == (ref_cost.KV_TRANSFER_BW, ref_cost.HANDOFF_OVERHEAD)
    # the card-fitted and card-measured terms (the fit holds the sync
    # term at 0 or above: chip_smoke.fit_overheads)
    assert c.DISPATCH_OVERHEAD > 0 and c.HOST_SYNC_OVERHEAD >= 0
    assert c.STEP_OVERHEAD == c.DISPATCH_OVERHEAD + c.HOST_SYNC_OVERHEAD
    assert c.COLLECTIVE_LAUNCH > 0
    cost = c.InstanceCost(cfg=PORT_REGISTRY["llama3.2-3b"])
    assert (cost.peak_flops, cost.hbm_bw, cost.step_overhead,
            cost.dispatch_overhead, cost.host_io_bw, cost.ici_bw,
            cost.kv_transfer_bw, cost.handoff_overhead) \
        == (c.PEAK_FLOPS, c.HBM_BW, c.STEP_OVERHEAD, c.DISPATCH_OVERHEAD,
            c.HOST_IO_BW, c.ICI_BW, c.KV_TRANSFER_BW, c.HANDOFF_OVERHEAD)
    assert (cost.chips, cost.mfu, cost.storage_bw, cost.model_shards) \
        == (8, 0.5, 2e9, 1)
    # the testbed's deployments take them by default
    dep = port_tb.default_deployment(port_tb.LLAMA70B)
    assert dep.cost.dispatch_overhead == c.DISPATCH_OVERHEAD


@pytest.mark.parametrize("s8,s1", [(40.0, 45.0), (48.3, 43.6), (30.0, 30.0)])
def test_overhead_fit_reproduces_its_windows(s8, s1):
    """chip_smoke.fit_overheads solves step(K) = roofline + dispatch +
    host_sync / K through both windows, or, where the K = 1 step is not
    the longer, holds host_sync at 0 and splits the difference."""
    d, h = chip_smoke.fit_overheads(s8, 2.5, s1, 2.5)
    assert h >= 0
    if s1 > s8:
        assert d + h / 8 + 2.5 == pytest.approx(s8)
        assert d + h + 2.5 == pytest.approx(s1)
    else:
        assert h == 0 and d == pytest.approx((s8 + s1) / 2 - 2.5)


def test_no_tpu_figure_in_the_port():
    hits = [str(p.relative_to(PORT)) for p in sorted(PORT.rglob("*"))
            if p.is_file() and p.suffix in (".py", ".cu", ".cuh")
            and "v5e" in p.read_text()]
    assert not hits
    src = (PORT / "serving" / "costmodel.py").read_text()
    for ref_only in ("197e12", "819e9", "45e9"):
        assert ref_only not in src


# ---------------------------------------------------------------------------
# FirstClient over each package's gateway
# ---------------------------------------------------------------------------

def _wire(x):
    if isinstance(x, BaseException):
        return (type(x).__name__, getattr(x, "code", None),
                getattr(x, "status", None), getattr(x, "retry_after", None),
                str(x), _wire(x.to_dict()) if hasattr(x, "to_dict") else None)
    if hasattr(x, "to_dict"):
        return _wire(x.to_dict())
    if isinstance(x, dict):
        return {k: _wire(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_wire(v) for v in x]
    return x


def _client_calls(root):
    tb = importlib.import_module(f"{root}.core.testbed")
    api = importlib.import_module(f"{root}.api")
    sysd = tb.build_system(
        {c: {tb.LLAMA70B.name: tb.default_deployment(tb.LLAMA70B, hw=REF_HW)}
         for c in ("sophia", "polaris")})
    M = tb.LLAMA70B.name
    client = api.FirstClient(sysd.gateway, sysd.token_for("alice"))
    out = {}
    futs = {"chat": client.chat(model=M, prompt_tokens=64, max_tokens=16,
                                request_id="c0"),
            "complete": client.complete(model=M, prompt_tokens=40,
                                        max_tokens=9, request_id="p0"),
            "bad": client.chat(model=M, prompt_tokens=-1, max_tokens=4)}
    futs["stream"], asm = client.stream(model=M, prompt_tokens=64,
                                        max_tokens=24, request_id="s0")
    futs["cancelled"], asm_c = client.stream(model=M, prompt_tokens=64,
                                             max_tokens=3000,
                                             request_id="x0")
    sysd.loop.call_after(150.0, lambda: out.__setitem__(
        "cancel", (client.cancel("x0"), client.cancel("no-such"))))
    bfut = client.create_batch(
        [{"custom_id": f"b{i}", "method": "POST", "url": "/v1/completions",
          "body": {"model": M, "prompt_tokens": 32 + i,
                   "max_tokens": 4 + i}} for i in range(12)])
    sysd.loop.run_until_idle()
    for k, f in futs.items():
        out[k] = _wire(f.error if f.error is not None else f.result())
    bid = bfut.result().id
    out.update(batch=_wire(bfut.result()), status=_wire(
        client.batch_status(bid)), results=_wire(client.batch_results(bid)),
        missing=_wire(client.batch_status("batch_none")),
        jobs=_wire(client.jobs()),
        frames=_wire(asm.deltas), frames_c=_wire(asm_c.deltas),
        now=sysd.loop.now())
    return out


def test_first_client_over_port_gateway_equals_reference(monkeypatch):
    outs = []
    for root in ("repro", "repro_torch"):
        for mod, name, start in COUNTERS:
            monkeypatch.setattr(importlib.import_module(f"{root}.{mod}"),
                                name, itertools.count(start))
        outs.append(_client_calls(root))
    assert outs[1] == outs[0]
    assert outs[0]["cancel"] == (True, False)
    assert outs[0]["bad"][1] == "invalid_request_error"
