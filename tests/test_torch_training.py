"""The port's training path (``repro_torch.training``, ``LM.train_loss``,
``_chunked_ce``, remat) against the JAX package's on the same inputs and
the same weights, and the port's versions of ``tests/test_training.py``.

Weights come from the reference's own ``init_params`` (reduced configs)
and cross through ``params_from_jax_numpy``; AdamW states cross through
``opt_state_from_jax_numpy``; batches come from the numpy
``TokenDataset``. Everything is float32, where the two frameworks differ
only in the order of their sums.

Tolerances:
- loss and gradients: ``atol=2e-5, rtol=1e-4`` (measured: 1e-6 to 5e-6 of
  each leaf's largest gradient).
- one AdamW step: m and v elementwise at the gradients' tolerance scaled by
  (1 - beta1) and (1 - beta2). The parameter update is
  ``lr * m_hat / (sqrt(v_hat) + eps)``: on step 1 that is about
  ``lr * sign(g)``, so an entry whose gradient is near 0 -- within the
  frameworks' rounding of it -- may move by up to ``lr`` either way in
  each. Parameters are therefore held to ``atol=2e-7`` (lr 1e-3) only
  where the reference's ``sqrt(v_hat)`` is at least 1e-3 of its leaf's
  largest (the entries whose update direction rounding cannot flip); the
  rest, at most a small share of each leaf, are held to the bound
  ``|dp| <= 2 lr (1 + wd |p|)`` that any update direction obeys. From a
  later state (step 3 of the reference) the same split is used.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.data.tokens import TokenDataset as JaxTokenDataset
from repro.distributed.hints import ShardingHints as JaxHints
from repro.distributed.hints import use_hints as jax_use_hints
from repro.models import moe as jax_moe
from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
from repro.training.optimizer import adamw_init as jax_adamw_init
from repro.training.optimizer import lr_schedule as jax_lr_schedule
from repro.training.train import make_train_step as jax_make_train_step
from repro_torch.bridge import opt_state_from_jax_numpy, params_from_jax_numpy
from repro_torch.configs import REGISTRY, reduced
from repro_torch.data.tokens import TokenDataset
from repro_torch.distributed.hints import ShardingHints, use_hints
from repro_torch.models import make_model, moe
from repro_torch.training.optimizer import AdamWConfig, lr_schedule
from repro_torch.training.train import (init_training, loss_and_grads,
                                        make_train_step)
from repro_torch.tree import tree_leaves

FAMILIES = {"dense": "llama3.2-3b", "moe": "phi3.5-moe-42b-a6.6b",
            "vlm": "llava-next-34b", "ssm": "mamba2-130m",
            "hybrid": "zamba2-2.7b", "audio": "hubert-xlarge"}
TOL = dict(atol=2e-5, rtol=1e-4)
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port(lm_factory, arch):
    """(jax cfg, jax model, jax params, port model, port params)."""
    cfg, model, params = lm_factory(arch)
    tcfg = reduced(REGISTRY[arch])
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return cfg, model, params, make_model(tcfg), tp


def _batch(cfg, batch=4, seq=32, seed=1):
    ds = JaxTokenDataset(cfg.vocab_size, seq, batch, seed=seed,
                         input_kind=cfg.input_kind, d_model=cfg.d_model)
    return ds.next_batch()


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_trees(jtree, ttree, **tol):
    jl, tl = jax.tree.leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == a.shape
        assert_allclose(b.detach().float().numpy(),
                        np.asarray(a, np.float32), **tol)


_JAX_GRADS = {}


def _jax_value_and_grad(model, params, batch, arch):
    if arch not in _JAX_GRADS:
        (loss, _), grads = jax.jit(jax.value_and_grad(
            model.train_loss, has_aux=True))(params, _j(batch))
        _JAX_GRADS[arch] = (float(loss), grads)
    return _JAX_GRADS[arch]


# ---------------------------------------------------------------------------
# loss and gradients, every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_jax(lm_factory, family):
    arch = FAMILIES[family]
    cfg, model, params, tm, tp = _port(lm_factory, arch)
    batch = _batch(cfg)
    jloss, jgrads = _jax_value_and_grad(model, params, batch, arch)
    tloss, tgrads = loss_and_grads(tm, tp, _t(batch))
    assert tloss.dtype == torch.float32
    assert_allclose(float(tloss), jloss, **TOL)
    _assert_trees(jgrads, tgrads, **TOL)
    for g in tree_leaves(tgrads):
        assert torch.isfinite(g).all()


@pytest.mark.parametrize("family", ["dense", "moe", "hybrid"])
def test_remat_changes_no_number(lm_factory, family):
    _, _, _, tm, tp = _port(lm_factory, FAMILIES[family])
    batch = _t(_batch(tm.cfg))
    l0, g0 = loss_and_grads(tm, tp, batch, remat=False)
    l1, g1 = loss_and_grads(tm, tp, batch, remat=True)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_train_loss_metrics_match_jax(lm_factory):
    """``train_loss``'s (ce, aux) of the moe family, whose aux is the
    load-balance loss summed over layers."""
    cfg, model, params, tm, tp = _port(lm_factory, FAMILIES["moe"])
    batch = _batch(cfg)
    jl, jm = model.train_loss(params, _j(batch))
    tl, tmet = tm.train_loss(tp, _t(batch))
    for k in ("ce", "aux"):
        assert_allclose(float(tmet[k]), float(jm[k]), **TOL)
    assert float(tmet["aux"]) > 0
    assert_allclose(float(tl), float(jl), **TOL)


# ---------------------------------------------------------------------------
# grouped MoE under autograd, both combines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("combine", ["gather", "scatter"])
def test_grouped_moe_grads_match_jax(lm_factory, combine, capacity_factor):
    """Gradients through ``_top_k``'s stable sort, the ``x[bb, topc_idx]``
    gather and either combine, with and without capacity drops: d(sum(out
    * r) + aux) by x and by every weight, against ``jax.grad``."""
    import dataclasses
    arch = FAMILIES["moe"]
    cfg, _, params = lm_factory(arch)
    tcfg = reduced(REGISTRY[arch])
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=capacity_factor))
    jl = {k: v[0] for k, v in params["layers"]["moe"].items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    assert 40 * cfg.moe.top_k >= 4 * cfg.moe.num_experts   # grouped runs

    def jf(x, w):
        out, aux = jax_moe.moe_ffn(x, w, cfg, mode="grouped",
                                   combine=combine)
        return jnp.sum(out * r) + aux
    jgx, jgw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jl)

    tx = torch.from_numpy(x).requires_grad_(True)
    tw = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in jl.items()}
    out, aux = moe.moe_ffn(tx, tw, tcfg, mode="grouped", combine=combine)
    (torch.sum(out * torch.from_numpy(r)) + aux).backward()
    assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    for k in jl:
        assert_allclose(tw[k].grad.numpy(), np.asarray(jgw[k]), **TOL)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 7, 50, 100, 101, 5000, 10_000,
                                  20_000])
def test_lr_schedule_matches_jax(step):
    jc = JaxAdamWConfig(lr=3e-3, warmup_steps=100, total_steps=10_000)
    tc = AdamWConfig(lr=3e-3, warmup_steps=100, total_steps=10_000)
    j = float(jax_lr_schedule(jc, jnp.int32(step)))
    t = lr_schedule(tc, torch.tensor(step, dtype=torch.int32))
    assert t.dtype == torch.float32
    assert_allclose(float(t), j, rtol=2e-7, atol=0)


def _assert_params_after_step(jp, tp, jstate, jp0, lr, wd):
    """Parameters after one AdamW step, split as the module docstring
    says: tight where the reference's sqrt(v_hat) is at least 1e-3 of its
    leaf's largest, the direction bound elsewhere. The loose entries are
    under 5 % of all (measured: up to 9 % of one small leaf, 1 to 5 % of
    most), and the firm ones agree to 6e-8 (measured)."""
    step = int(jstate["step"])
    bc2 = 1 - 0.95 ** step
    loose = total = 0
    for a, b, v, p0 in zip(jax.tree.leaves(jp), tree_leaves(tp),
                           jax.tree.leaves(jstate["v"]),
                           jax.tree.leaves(jp0)):
        a, b = np.asarray(a, np.float32), b.numpy()
        sv = np.sqrt(np.asarray(v) / bc2)
        # an entry whose gradient was exactly 0 at every step has no
        # update direction in either framework: weight decay alone
        firm = (sv >= 1e-3 * sv.max()) | (sv == 0)
        assert_allclose(b[firm], a[firm], atol=2e-7, rtol=0)
        bound = 2 * lr * (1 + wd * np.abs(np.asarray(p0))) + 1e-6
        assert np.all(np.abs(b - a) <= bound)
        loose += int((~firm).sum())
        total += firm.size
    assert loose < 0.05 * total


@pytest.mark.parametrize("start", ["init", "step3"])
@pytest.mark.parametrize("family", ["dense", "moe", "hybrid"])
def test_adamw_step_matches_jax(lm_factory, family, start):
    """One ``make_train_step`` step from one bridged (params, AdamW state):
    loss, lr, grad norm, m, v and the parameters."""
    cfg, model, params, tm, _ = _port(lm_factory, FAMILIES[family])
    jcfg = JaxAdamWConfig(lr=LR, warmup_steps=0)
    jstep = jax.jit(jax_make_train_step(model, jcfg))
    jp, jo = params, jax_adamw_init(params)
    if start == "step3":
        for seed in (5, 6, 7):
            jp, jo, _ = jstep(jp, jo, _j(_batch(cfg, seed=seed)))
    batch = _batch(cfg)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp), tm.cfg, "cpu")
    to = opt_state_from_jax_numpy(jax.tree.map(np.asarray, jo), "cpu")
    assert int(to["step"]) == int(jo["step"])

    jp1, jo1, jm = jstep(jp, jo, _j(batch))
    tstep = make_train_step(tm, AdamWConfig(lr=LR, warmup_steps=0))
    tp1, to1, tmet = tstep(tp, to, _t(batch))

    assert_allclose(float(tmet["loss"]), float(jm["loss"]), **TOL)
    assert_allclose(float(tmet["lr"]), float(jm["lr"]), rtol=2e-7)
    assert_allclose(float(tmet["grad_norm"]), float(jm["grad_norm"]),
                    rtol=1e-5)
    assert int(to1["step"]) == int(jo1["step"]) == int(jo["step"]) + 1
    _assert_trees(jo1["m"], to1["m"], atol=0.1 * 2e-5, rtol=1e-4)
    _assert_trees(jo1["v"], to1["v"], atol=1e-10, rtol=3e-4)
    _assert_params_after_step(jp1, tp1, jo1, jp, LR, 0.1)
    # the step left its inputs as they were (no in-place update asked)
    _assert_trees(jp, tp, atol=0, rtol=0)


def test_in_place_step_equals_the_copying_step(lm_factory):
    cfg, _, _, tm, tp = _port(lm_factory, FAMILIES["dense"])
    ocfg = AdamWConfig(lr=LR, warmup_steps=0)
    batch = _t(_batch(cfg))
    from repro_torch.training.optimizer import adamw_init
    clone = lambda t: {k: clone(v) if isinstance(v, dict)  # noqa: E731
                       else v.clone() for k, v in t.items()}
    p_a, o_a, m_a = make_train_step(tm, ocfg)(tp, adamw_init(tp), batch)
    p0, o0 = clone(tp), adamw_init(tp)
    ptrs = [t.data_ptr() for t in tree_leaves(p0) + tree_leaves(o0)]
    p_b, o_b, m_b = make_train_step(tm, ocfg, in_place=True)(p0, o0, batch)
    assert [t.data_ptr() for t in tree_leaves(p_b) + tree_leaves(o_b)] \
        == ptrs
    assert torch.equal(m_a["loss"], m_b["loss"])
    for a, b in zip(tree_leaves(p_a) + tree_leaves(o_a),
                    tree_leaves(p_b) + tree_leaves(o_b)):
        assert torch.equal(a, b)


def test_sliced_update_changes_no_bit(lm_factory, monkeypatch):
    """The optimizer's slices of a leaf's leading axis (room for a float32
    temporary at full width) give the bits of the unsliced update."""
    from repro_torch.training import optimizer
    cfg, _, _, tm, tp = _port(lm_factory, FAMILIES["dense"])
    step = make_train_step(tm, AdamWConfig(lr=LR, warmup_steps=0))
    batch = _t(_batch(cfg))
    opt = optimizer.adamw_init(tp)
    p_a, o_a, _ = step(tp, opt, batch)
    monkeypatch.setattr(optimizer, "SLICE_ELEMS", 64)
    assert len(optimizer._slices(tp["embed"])) > 1
    p_b, o_b, _ = step(tp, opt, batch)
    for a, b in zip(tree_leaves(p_a) + tree_leaves(o_a),
                    tree_leaves(p_b) + tree_leaves(o_b)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# gradient accumulation and the chunked CE
# ---------------------------------------------------------------------------

def test_grad_accumulation_matches_jax(lm_factory):
    """n = 4 microbatches in the port against the reference's n = 4, from
    one bridged state: loss, grad norm and parameters."""
    cfg, model, params, tm, tp = _port(lm_factory, FAMILIES["dense"])
    batch = _batch(cfg, batch=8)
    jcfg = JaxAdamWConfig(lr=LR, warmup_steps=0, grad_clip=0.0)
    jp4, jo4, jm4 = jax.jit(jax_make_train_step(
        model, jcfg, num_microbatches=4))(params, jax_adamw_init(params),
                                          _j(batch))
    from repro_torch.training.optimizer import adamw_init
    tp4, to4, tm4 = make_train_step(
        tm, AdamWConfig(lr=LR, warmup_steps=0, grad_clip=0.0),
        num_microbatches=4)(tp, adamw_init(tp), _t(batch))
    assert_allclose(float(tm4["loss"]), float(jm4["loss"]), **TOL)
    assert_allclose(float(tm4["grad_norm"]), float(jm4["grad_norm"]),
                    rtol=1e-5)
    _assert_trees(jo4["m"], to4["m"], atol=0.1 * 2e-5, rtol=1e-4)
    _assert_params_after_step(jp4, tp4, jo4, params, LR, 0.1)


def test_accumulated_grads_are_float32_means(lm_factory):
    """n = 1 gives gradients in the parameter dtype; n = 4 float32 means
    of the microbatch gradients, and the mean of their losses."""
    _, _, _, tm, tp = _port(lm_factory, FAMILIES["dense"])
    batch = _t(_batch(tm.cfg, batch=8))
    l4, g4 = loss_and_grads(tm, tp, batch, num_microbatches=4)
    parts = [loss_and_grads(tm, tp, {k: v[2 * i:2 * i + 2]
                                     for k, v in batch.items()})
             for i in range(4)]
    loss = torch.zeros(())
    for lp, _ in parts:
        loss = loss + lp
    assert torch.equal(l4, loss / torch.tensor(4.0))
    for j, g in enumerate(tree_leaves(g4)):
        acc = torch.zeros(g.shape)
        for _, gp in parts:
            acc.add_(tree_leaves(gp)[j])
        assert g.dtype == torch.float32
        assert torch.equal(g, acc / torch.tensor(4.0))


def test_chunked_ce_matches_full_loss_and_jax(lm_factory):
    """``ce_chunk=48`` over a 256-word vocabulary (6 chunks, the last
    padded) against the full-logit loss and against the reference's
    chunked loss, loss and gradients (as ``tests/test_perf_paths.py``)."""
    cfg, model, params, tm, tp = _port(lm_factory, FAMILIES["ssm"])
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 32), np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 32), np.int32)}
    l0, g0 = loss_and_grads(tm, tp, _t(batch))
    with use_hints(ShardingHints(ce_chunk=48)):
        l1, g1 = loss_and_grads(tm, tp, _t(batch))
    assert abs(float(l0 - l1)) < 1e-5
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert_allclose(b.numpy(), a.numpy(), **TOL)
    with jax_use_hints(JaxHints(ce_chunk=48)):
        (jl, _), jg = jax.value_and_grad(model.train_loss, has_aux=True)(
            params, _j(batch))
    assert_allclose(float(l1), float(jl), **TOL)
    _assert_trees(jg, g1, **TOL)


def test_chunked_ce_keeps_no_logits_for_the_backward(lm_factory):
    """Under autograd the chunked loss saves no chunk of logits (B, S,
    chunk) for the backward -- each chunk is recomputed -- so the (B, S,
    V) logits are never held at once."""
    from repro_torch.models.model import _chunked_ce
    _, _, _, tm, tp = _port(lm_factory, FAMILIES["ssm"])
    B, S, V, chunk = 2, 32, tm.cfg.vocab_size, 48
    rng = np.random.default_rng(2)
    labels = torch.from_numpy(rng.integers(0, V, (B, S)))
    hidden = torch.from_numpy(rng.standard_normal(
        (B, S, tm.cfg.d_model)).astype(np.float32)).requires_grad_(True)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = _chunked_ce(tp, hidden, labels, chunk)
    assert shapes and (B, S, chunk) not in shapes
    loss.backward()
    assert torch.isfinite(hidden.grad).all()


# ---------------------------------------------------------------------------
# the port's versions of tests/test_training.py
# ---------------------------------------------------------------------------

def _setup(arch="llama3.2-3b", batch=8, seq=32):
    cfg = reduced(REGISTRY[arch])
    model = make_model(cfg)
    params, opt_state = init_training(model,
                                      torch.Generator().manual_seed(0))
    ds = TokenDataset(cfg.vocab_size, seq, batch, seed=1,
                      input_kind=cfg.input_kind, d_model=cfg.d_model)
    return cfg, model, params, opt_state, ds


def test_loss_decreases():
    cfg, model, params, opt_state, ds = _setup()
    step = make_train_step(model, AdamWConfig(lr=1e-2, warmup_steps=5,
                                              total_steps=200),
                           in_place=True)
    losses = []
    for _ in range(30):
        params, opt_state, m = step(params, opt_state, ds.next_batch())
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


def test_grad_accumulation_equivalence():
    cfg, model, params, opt_state, ds = _setup(batch=8)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0, grad_clip=0.0)
    batch = ds.next_batch()
    s1 = make_train_step(model, ocfg, num_microbatches=1)
    s4 = make_train_step(model, ocfg, num_microbatches=4)
    p1, o1, m1 = s1(params, opt_state, batch)
    p4, o4, m4 = s4(params, opt_state, batch)
    d = [float((a.float() - b.float()).abs().max())
         for a, b in zip(tree_leaves(p1), tree_leaves(p4))]
    assert max(d) < 5e-5
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4


def test_moe_and_ssm_train_step():
    for arch in ["phi3.5-moe-42b-a6.6b", "mamba2-130m", "zamba2-2.7b",
                 "hubert-xlarge"]:
        cfg, model, params, opt_state, ds = _setup(arch, batch=4, seq=32)
        step = make_train_step(model, AdamWConfig(), in_place=True)
        for _ in range(2):
            params, opt_state, m = step(params, opt_state, ds.next_batch())
        assert np.isfinite(float(m["loss"])), arch


def test_dataset_cursor_determinism():
    ds1 = TokenDataset(128, 16, 4, seed=9)
    b1 = [ds1.next_batch() for _ in range(3)]
    ds2 = TokenDataset(128, 16, 4, seed=9)
    ds2.restore({"step": 1, "seed": 9})
    b2 = ds2.next_batch()
    assert np.array_equal(b1[1]["tokens"], b2["tokens"])
    with pytest.raises(AssertionError):
        ds2.restore({"step": 0, "seed": 8})
    # the port's copy draws the reference's batches
    ref = JaxTokenDataset(128, 16, 4, seed=9)
    for b in b1:
        r = ref.next_batch()
        assert all(np.array_equal(b[k], r[k]) for k in r)
