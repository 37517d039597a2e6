"""The port's checkpoints (``repro_torch.distributed.checkpoint`` and its
MessagePack subset ``_msgpack``), the training entry point
``python -m repro_torch.launch.train`` and the kernel wrappers' refusal to
run under autograd.

Checkpoints are compared bit for bit: a file written by either package
loads in the other with identical paths, dtypes and array bytes (bf16
included), and a run resumed from a checkpoint continues exactly as the
uninterrupted run.
"""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.distributed import checkpoint as jax_ckpt
from repro.training.optimizer import adamw_init as jax_adamw_init
from repro.training.train import make_train_step as jax_make_train_step
from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
from repro_torch.bridge import opt_state_from_jax_numpy, params_from_jax_numpy
from repro_torch.configs import REGISTRY, reduced
from repro_torch.data.tokens import TokenDataset
from repro_torch.distributed import _msgpack
from repro_torch.distributed.checkpoint import (checkpoint_path,
                                                latest_checkpoint,
                                                load_checkpoint,
                                                save_checkpoint)
from repro_torch.launch import train as train_launch
from repro_torch.models import make_model
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train import init_training, make_train_step
from repro_torch.tree import tree_leaves


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _setup(arch="llama3.2-3b", batch=8, seq=32):
    cfg = reduced(REGISTRY[arch])
    model = make_model(cfg)
    params, opt_state = init_training(model,
                                      torch.Generator().manual_seed(0))
    ds = TokenDataset(cfg.vocab_size, seq, batch, seed=1,
                      input_kind=cfg.input_kind, d_model=cfg.d_model)
    return cfg, model, params, opt_state, ds


def _np(t):
    """A leaf's stored bytes as numpy (bf16 as its uint16 bits)."""
    if torch.is_tensor(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


# ---------------------------------------------------------------------------
# the port's versions of tests/test_training.py's checkpoint tests
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_resume(tmp_path):
    cfg, model, params, opt_state, ds = _setup(batch=4)
    ocfg = AdamWConfig(lr=5e-3, warmup_steps=0)
    step = make_train_step(model, ocfg)
    for _ in range(3):
        params, opt_state, _ = step(params, opt_state, ds.next_batch())

    path = checkpoint_path(str(tmp_path), 3)
    save_checkpoint(path, {"params": params, "opt": opt_state},
                    step=3, metadata={"data": ds.state()})
    assert latest_checkpoint(str(tmp_path)) == path

    # continue original
    p_a, o_a = params, opt_state
    for _ in range(2):
        p_a, o_a, m_a = step(p_a, o_a, ds.next_batch())

    # restore and continue -- must reproduce the same trajectory
    tree, step_no, meta = load_checkpoint(
        path, target={"params": params, "opt": opt_state}, device="cpu")
    assert step_no == 3
    ds2 = TokenDataset(cfg.vocab_size, 32, 4, seed=1)
    ds2.restore(meta["data"])
    p_b, o_b = tree["params"], tree["opt"]
    for _ in range(2):
        p_b, o_b, m_b = step(p_b, o_b, ds2.next_batch())
    for a, b in zip(tree_leaves(p_a) + tree_leaves(o_a),
                    tree_leaves(p_b) + tree_leaves(o_b)):
        assert torch.equal(a, b)
    assert float(m_a["loss"]) == float(m_b["loss"])


def test_checkpoint_bf16_preserved(tmp_path):
    x = {"w": torch.arange(8, dtype=torch.bfloat16) * 0.5,
         "b": torch.ones((3,), dtype=torch.float32)}
    p = os.path.join(tmp_path, "t.ckpt")
    save_checkpoint(p, x, step=1)
    y, s, _ = load_checkpoint(p, target=x, device="cpu")
    assert y["w"].dtype == torch.bfloat16
    assert torch.equal(y["w"], x["w"]) and s == 1


# ---------------------------------------------------------------------------
# one format for both packages
# ---------------------------------------------------------------------------

def _mixed_tree():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    return {"layers": {"w": w, "norm": np.ones((3,), np.float32)},
            "bf": np.asarray(jnp.asarray(w[0]).astype(jnp.bfloat16)),
            "step": np.asarray(7, np.int32),
            "ids": np.arange(5, dtype=np.int64)}


def _torch_tree(tree):
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(np.asarray(x, np.float32)).to(
                torch.bfloat16)
        return torch.from_numpy(np.array(x))
    return conv(tree)


@pytest.mark.parametrize("compression", ["zstd", "zlib"])
def test_jax_checkpoint_loads_in_the_port(tmp_path, monkeypatch,
                                          lm_factory, compression):
    """A training state written by the reference (after one step, so m
    and v are not zeros) and a tree with bf16 and integer leaves load in
    the port with the reference's paths and identical bytes; with a
    target, in its structure."""
    if compression == "zlib":
        monkeypatch.setattr(jax_ckpt, "zstandard", None)
    elif jax_ckpt.zstandard is None:
        pytest.skip("zstandard is not installed: the reference writes zlib")
    cfg, model, params = lm_factory("llama3.2-3b")
    step = jax.jit(jax_make_train_step(model, JaxAdamWConfig()))
    ds = TokenDataset(cfg.vocab_size, 16, 2, seed=3)
    jp, jo, _ = step(params, jax_adamw_init(params), ds.next_batch())
    state = {"params": jp, "opt": jo}
    for name, tree in (("state", state), ("mixed", _mixed_tree())):
        path = str(tmp_path / f"{name}.ckpt")
        jax_ckpt.save_checkpoint(path, tree, step=5,
                                 metadata={"data": {"step": 1, "seed": 3}})
        with open(path, "rb") as f:
            assert f.read(4) == (b"RPZS" if compression == "zstd"
                                 else b"RPZL")
        flat, s, meta = load_checkpoint(path, device="cpu")
        jflat, _, jmeta = jax_ckpt.load_checkpoint(path)
        assert s == 5 and meta == jmeta
        assert list(flat) == list(jflat)
        for k in jflat:
            assert np.array_equal(_np(flat[k]), _np(jflat[k]))
    tcfg = reduced(REGISTRY["llama3.2-3b"])
    target = {"params": params_from_jax_numpy(
        jax.tree.map(np.asarray, jp), tcfg, "cpu"),
        "opt": opt_state_from_jax_numpy(jax.tree.map(np.asarray, jo),
                                        "cpu")}
    tree, _, _ = load_checkpoint(str(tmp_path / "state.ckpt"),
                                 target=target, device="cpu")
    for a, b in zip(jax.tree.leaves(state), tree_leaves(tree)):
        assert b.dtype == getattr(torch, str(np.asarray(a).dtype))
        assert np.array_equal(_np(b), np.asarray(a))


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A port-written training state and mixed tree load in the
    reference: same paths, dtypes and bytes, in the target's structure."""
    cfg, model, params, opt_state, ds = _setup(batch=2, seq=16)
    params, opt_state, _ = make_train_step(model, AdamWConfig())(
        params, opt_state, ds.next_batch())
    tstate = {"params": params, "opt": opt_state}
    mixed = _mixed_tree()
    for name, tree, target in (("state", tstate, None),
                               ("mixed", _torch_tree(mixed), mixed)):
        path = str(tmp_path / f"{name}.ckpt")
        save_checkpoint(path, tree, step=9, metadata={"note": "port"})
        jflat, s, meta = jax_ckpt.load_checkpoint(path)
        assert s == 9 and meta == {"note": "port"}
        flat, _, _ = load_checkpoint(path, device="cpu")
        assert list(jflat) == list(flat)
        for k in flat:
            assert np.array_equal(_np(jflat[k]), _np(flat[k]))
        if target is not None:
            jtree, _, _ = jax_ckpt.load_checkpoint(path, target=target)
            for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(target)):
                assert np.asarray(a).dtype == np.asarray(b).dtype
                assert np.array_equal(_np(a), _np(b))
    assert jflat["bf"].dtype == jnp.bfloat16


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_load_checkpoint_onto_a_mesh(tmp_path, writer, shards):
    """``load_checkpoint(shardings=)`` (elastic restore): a bf16 parameter
    tree written by either package, on one device, restores onto a
    (1, N) CPU mesh as N per-shard trees split by the serving rules;
    ``gather_params`` gives back the saved tree bit for bit, and without
    ``shardings`` the load is as before (one tree)."""
    import dataclasses

    from repro.configs import REGISTRY as JREG
    from repro.configs import reduced as jreduced
    from repro.models import make_model as jax_make_model
    from repro_torch.distributed.sharding import ServeSharding
    from repro_torch.launch.mesh import make_local_mesh

    jcfg = dataclasses.replace(jreduced(JREG["llama3.2-3b"]),
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(reduced(REGISTRY["llama3.2-3b"]),
                              param_dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, jax_make_model(jcfg).init_params(
        jax.random.PRNGKey(4)))
    path = str(tmp_path / "params.ckpt")
    if writer == "reference":
        jax_ckpt.save_checkpoint(path, jparams, step=7)
    else:
        save_checkpoint(path, params_from_jax_numpy(jparams, cfg, "cpu"),
                        step=7)
    sh = ServeSharding(make_local_mesh(1, shards, devices=["cpu"] * shards),
                       cfg)
    target = make_model(cfg).param_shapes()
    trees, step, _ = load_checkpoint(path, target, device="cpu",
                                     shardings=sh)
    assert step == 7 and len(trees) == shards
    wq = trees[0]["layers"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and wq.shape[-1] == cfg.q_dim // shards
    assert trees[1]["embed"].shape[0] == cfg.vocab_size // shards
    whole = sh.gather_params(trees)
    plain, _, _ = load_checkpoint(path, target, device="cpu")
    for a, b, j in zip(tree_leaves(whole), tree_leaves(plain),
                       jax.tree.leaves(jparams)):
        assert np.array_equal(_np(a), _np(b))
        assert np.array_equal(_np(a), _np(j))
    with pytest.raises(ValueError, match="target"):
        load_checkpoint(path, device="cpu", shardings=sh)


def test_port_payload_is_msgpack_bytes(tmp_path):
    """The decompressed payload of a port-written file is what
    ``msgpack.packb`` makes of the same object, byte for byte."""
    import zlib
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, _torch_tree(_mixed_tree()), step=2,
                    metadata={"data": {"step": 4, "seed": 1}})
    with open(path, "rb") as f:
        blob = f.read()
    assert blob[:4] == b"RPZL"
    raw = zlib.decompress(blob[4:])
    assert msgpack.packb(msgpack.unpackb(raw, raw=False),
                         use_bin_type=True) == raw


def test_zstd_checkpoint_without_zstandard_raises(tmp_path, monkeypatch):
    from repro_torch.distributed import checkpoint
    path = str(tmp_path / "z.ckpt")
    with open(path, "wb") as f:
        f.write(b"RPZS" + b"\0" * 16)
    monkeypatch.setattr(checkpoint, "_zstandard", lambda: None)
    with pytest.raises(RuntimeError, match="zstandard"):
        load_checkpoint(path, device="cpu")
    with open(path, "wb") as f:
        f.write(b"XXXX" + b"\0" * 16)
    with pytest.raises(RuntimeError, match="unrecognized"):
        load_checkpoint(path, device="cpu")


def test_load_checkpoint_defaults_to_the_card(tmp_path, monkeypatch):
    path = str(tmp_path / "c.ckpt")
    save_checkpoint(path, {"a": torch.ones(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(path)


def test_missing_arrays_raise(tmp_path):
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, {"a": torch.ones(2)})
    with pytest.raises(KeyError, match="missing 1 arrays"):
        load_checkpoint(path, target={"a": torch.ones(2),
                                      "b": torch.ones(1)}, device="cpu")


# ---------------------------------------------------------------------------
# the MessagePack subset
# ---------------------------------------------------------------------------

_EDGES = [None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536,
          2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129,
          -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.0, 0.5,
          -1e300, float("inf"), 1 / 3, "", "a" * 31, "a" * 32, "a" * 255,
          "a" * 256, "a" * 65535, "a" * 65536, "é中", b"",
          b"x" * 255, b"x" * 256, b"x" * 65535, b"x" * 65536, [],
          list(range(15)), list(range(16)), list(range(65536)), {},
          {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
          {str(i): None for i in range(65536)},
          {"version": 1, "step": 3, "metadata": {"data": {"step": 2}},
           "paths": ["a/b", "c"], "arrays": [
               {"dtype": "<f4", "shape": [2, 3], "data": b"\1" * 24},
               {"dtype": "bfloat16", "shape": [], "data": b"\0\1"}]}]


@pytest.mark.parametrize("obj", _EDGES, ids=lambda o: type(o).__name__)
def test_msgpack_subset_matches_msgpack(obj):
    ref = msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.packb(obj) == ref
    assert _msgpack.unpackb(ref) == msgpack.unpackb(ref, raw=False)
    assert msgpack.unpackb(_msgpack.packb(obj), raw=False) == \
        msgpack.unpackb(ref, raw=False)


def test_msgpack_subset_packs_tuples_and_refuses_the_rest():
    assert _msgpack.packb((1, "a")) == msgpack.packb((1, "a"),
                                                     use_bin_type=True)
    with pytest.raises(TypeError):
        _msgpack.packb({1.5j})
    with pytest.raises(ValueError, match="after the object"):
        _msgpack.unpackb(msgpack.packb(1) + b"\0")
    with pytest.raises(ValueError, match="not supported"):
        _msgpack.unpackb(msgpack.packb(0.25, use_single_float=True))


# ---------------------------------------------------------------------------
# python -m repro_torch.launch.train
# ---------------------------------------------------------------------------

def _launch(capsys, *args):
    loss = train_launch.main(["--device", "cpu", "--batch", "4",
                              "--seq-len", "16", "--ckpt-every", "2",
                              *args])
    return loss, capsys.readouterr().out


def test_train_entry_point_resumes(tmp_path, capsys):
    """Steps 0..2 with a checkpoint at 2, then a rerun to 4 on the same
    directory resumes at 2 and ends on the loss of a fresh run to 4."""
    d, fresh = str(tmp_path / "a"), str(tmp_path / "b")
    _, out = _launch(capsys, "--steps", "2", "--ckpt-dir", d)
    assert os.path.basename(latest_checkpoint(d)) == "ckpt_00000002.ckpt"
    assert "resumed" not in out
    resumed, out = _launch(capsys, "--steps", "4", "--ckpt-dir", d)
    assert f"resumed from {checkpoint_path(d, 2)} at step 2" in out
    assert "2 steps in" in out
    assert latest_checkpoint(d) == checkpoint_path(d, 4)
    ref, out = _launch(capsys, "--steps", "4", "--ckpt-dir", fresh)
    assert "resumed" not in out and np.isfinite(ref)
    assert resumed == ref
    _, _, meta = load_checkpoint(latest_checkpoint(d), device="cpu")
    assert meta == {"step": 4, "data": {"step": 4, "seed": 0}}


def test_train_entry_point_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launch.main(["--steps", "1"])


# ---------------------------------------------------------------------------
# the kernels are forward only
# ---------------------------------------------------------------------------

def _wrapper_calls():
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.ssd import ops as ssd_ops
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    B, H, KH, D, page = 2, 4, 2, 64, 16
    pages = (r(5, page, KH, D), r(5, page, KH, D))
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lens = torch.tensor([20, 7], dtype=torch.int32)
    return {
        "flash_attention": (fa.flash_attention,
                            (r(B, 8, H, D), r(B, 8, KH, D), r(B, 8, KH, D))),
        "paged_flash_prefill": (
            lambda q, k, v: fa.paged_flash_prefill(q, k, v, tables, 4, 12),
            (r(B, 8, H, D), *pages)),
        "paged_attention": (
            lambda q, k, v: pa.paged_attention(q, k, v, tables, lens),
            (r(B, H, D), *pages)),
        "fused_decode_attention": (
            lambda q, k, v, kt, vt: pa.fused_decode_attention(
                q, k, v, tables, lens, kt, vt,
                torch.tensor([1, 2], dtype=torch.int32)),
            (r(B, H, D), *pages, r(B, 2, KH, D), r(B, 2, KH, D))),
        "ssd": (lambda x, a, b, c: ssd_ops.ssd(x, a, b, c, chunk=8),
                (r(1, 16, 2, 16), -r(1, 16, 2).abs(), r(1, 16, 8),
                 r(1, 16, 8))),
    }


@pytest.mark.parametrize("name", ["flash_attention", "paged_flash_prefill",
                                  "paged_attention", "fused_decode_attention",
                                  "ssd"])
def test_kernel_wrappers_refuse_autograd(name):
    """Each wrapper raises when autograd records and an input requires
    grad -- on the CPU, where it would run its differentiable plain
    version, as on the card, where the kernel has no backward -- and runs
    under ``torch.no_grad()``."""
    fn, args = _wrapper_calls()[name]
    for i in range(len(args)):
        grad_args = [a.clone().requires_grad_(j == i)
                     for j, a in enumerate(args)]
        with pytest.raises(RuntimeError, match="forward only"):
            fn(*grad_args)
        with torch.no_grad():
            fn(*grad_args)
    fn(*args)
