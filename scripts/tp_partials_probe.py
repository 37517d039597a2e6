#!/usr/bin/env python3
"""Does rounding each shard's out_proj partial explain the ssm and hybrid
families' mesh-against-one-device logits error?

Run from the root of a checkout on a machine with one card:
``python3 scripts/tp_partials_probe.py``. For zamba2-2.7b whole and then
mamba2-130m whole (random weights from seed 0, bf16, as ``chip_smoke.py``
phase 8d builds them) it builds five slot backends over the same weights:

* ``one``: the kernel tier on one device;
* ``mesh``: the kernel tier on a (1, 4) mesh whose shards share the card,
  as served: each mixer's row-parallel out_proj partial is rounded to bf16
  before ``all_reduce`` sums the four in float32;
* ``mesh_f32``: the same mesh with each mixer's partials computed from
  float32 operands and summed in float32, the sum rounded to bf16 once (the
  shared block's ``wo`` / ``w2`` partials stay as served);
* ``plain`` and ``floor``: the plain tier on one device with SSD chunks of
  256 and of 128, whose gap is the plain tier's own spread under a
  reordering of its sums.

All five are teacher-forced on phase 8d's prompts (512 and 2048 tokens,
16 decode steps, ``chip_smoke.teacher_forced``), and the script prints the
worst logits rel_err of ``mesh`` and ``mesh_f32`` against ``one`` beside
the spread. Then the same weights' float32 copy serves on one device and
on the mesh (kernel tier): there rounding moves a logit by about 1e-7 of
its scale, so a gap far above that would be a fault of the sharded mixer
or shared block, not rounding. It prints the card's name and power limit
first and one JSON line of every number last. ``--cpu`` runs the same
steps on the CPU at a reduced width in bf16 (a rehearsal: no kernels).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def f32_mixer(stack, x, i, states=None, use_kernel=False):
    """``ServeStack.mixer`` with the out_proj partials in float32:
    ``mamba2.mamba_layer_sharded`` but for the row-parallel product."""
    from repro_torch.models.mamba2 import _mixer
    cfg = stack.cfg
    ps = [lay[i]["mamba"] for lay in stack.layers]
    zxbcdt = stack.gather([x.to(p["in_proj"].device) @ p["in_proj"]
                           for p in ps])
    ys, new_states = [], []
    for s, p in enumerate(ps):
        y, st = _mixer(zxbcdt.to(p["in_proj"].device), p, cfg,
                       state=None if states is None else states[s],
                       use_kernel=use_kernel)
        ys.append(y)
        new_states.append(st)
    rows = ps[0]["out_proj"].shape[0]
    assert rows * stack.n == cfg.d_inner, "out_proj is not split by rows"
    out = stack.reduce([y[..., s * rows:(s + 1) * rows].float()
                        @ p["out_proj"].float()
                        for s, (y, p) in enumerate(zip(ys, ps))])
    return out.to(x.dtype), new_states


def probe(cs, dev, cfg, use_kernel, mesh):
    import numpy as np
    import torch
    from repro_torch.models import make_model

    model = make_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    floor = make_model(dataclasses.replace(
        cfg, ssm=dataclasses.replace(cfg.ssm, chunk=cfg.ssm.chunk // 2)))
    tiers = cs.slot_tiers(dev, [("one", model, use_kernel, None),
                                ("mesh", model, use_kernel, mesh),
                                ("mesh_f32", model, use_kernel, mesh),
                                ("plain", model, False, None),
                                ("floor", floor, False, None)], params, 2)
    st = tiers["mesh_f32"].stack
    st.mixer = lambda x, i, states=None, use_kernel=False: f32_mixer(
        st, x, i, states, use_kernel)
    rng = np.random.default_rng(2)
    lens = (512, 2048) if dev.type == "cuda" else (40, 70)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist()
               for n in lens]
    worst, _, _ = cs.teacher_forced(tiers, prompts, 16, "mesh", "one")
    row = {"model": cfg.name, "mesh": worst("mesh", "one"),
           "mesh_f32": worst("mesh_f32", "one"),
           "mesh_f32_vs_mesh": worst("mesh_f32", "mesh"),
           "plain_spread": worst("floor", "plain")}
    del tiers, st
    # the float32 copy of the same weights, one device against the mesh
    fmodel = make_model(dataclasses.replace(cfg, param_dtype="float32"))
    fparams = _cast(params, torch.float32)
    del params
    worst, _, _ = cs.teacher_forced(
        cs.slot_tiers(dev, [("one", fmodel, use_kernel, None),
                            ("mesh", fmodel, use_kernel, mesh)], fparams, 2),
        prompts, 16, "mesh", "one")
    row["float32_mesh"] = worst("mesh", "one")
    print(f"  {cfg.name}: logits rel_err against one device: mesh "
          f"{row['mesh']:.3e}, mesh with float32 out_proj partials "
          f"{row['mesh_f32']:.3e} ({row['mesh_f32_vs_mesh']:.3e} from the "
          f"mesh); plain tier's own spread {row['plain_spread']:.3e}; in "
          f"float32 the mesh {row['float32_mesh']:.3e}", flush=True)
    return row


def _cast(tree, dtype):
    """A copy of a parameter tree with every floating leaf in ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU at a reduced width")
    args = ap.parse_args()

    import gc

    import torch

    import chip_smoke as cs
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.launch.mesh import make_local_mesh

    if args.cpu:
        dev = torch.device("cpu")
        cfgs = [dataclasses.replace(reduced(REGISTRY[n]),
                                    param_dtype="bfloat16")
                for n in ("zamba2-2.7b", "mamba2-130m")]
        print("card: none (CPU rehearsal)")
    else:
        if not torch.cuda.is_available():
            cs.fail("torch.cuda.is_available() is False: no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", 0)
        cfgs = [REGISTRY[n] for n in ("zamba2-2.7b", "mamba2-130m")]
        print(f"card: {cs.nvidia_smi_line()}")
    mesh = make_local_mesh(1, cs.TP_SHARDS, devices=[dev] * cs.TP_SHARDS)
    rows = []
    for cfg in cfgs:
        rows.append(probe(cs, dev, cfg, not args.cpu, mesh))
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"tp_partials_probe": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
