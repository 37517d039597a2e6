"""The plain references against the port's CPU path at reduced sizes, and
whole runs of each cell on the CPU (the window, the drain and the judgement,
the look for a card skipped)."""
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import pytest  # noqa: E402
import torch  # noqa: E402

import smallcells  # noqa: E402
from harness import cell, check, driver, spec, weights  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread for torch while a test runs: the suite runs in
    several worker processes, and each pool of CPU threads would contend
    with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

FAMILIES = sorted(p.stem for p in (HERE / "families").glob("*.py"))
BENCH_CELLS = sorted(w["name"] for w in spec.load_benchmark()["workloads"])
SMALL_CELLS = [n for n in smallcells.names() if n in BENCH_CELLS]


@pytest.mark.parametrize("family", FAMILIES)
def test_reference_matches_the_port_forward(family):
    """Teacher-forced logits of every position, reference against the
    port's full-sequence forward (float32, experts dense), two lengths."""
    from repro_torch.models import model
    m, ref = spec.family(family).SMALL, spec.reference(family)
    params = weights.draw(m, 5, "cpu")
    cfg = driver.port_config({"name": "t", "model": m})
    g = torch.Generator().manual_seed(1)
    seqs = [torch.randint(2, m["vocab_size"], (n,), generator=g).tolist()
            for n in (70, 33)]
    got = ref.logits(params, m, [(s, 0) for s in seqs])
    kw = {"moe_mode": "dense"} if m["family"] == "moe" else {}
    for s, lg in zip(seqs, got):
        x = params["embed"][torch.as_tensor(s)][None]
        with torch.no_grad():
            h, _ = model._backend(cfg).forward(params, x, cfg, remat=False,
                                               **kw)
            want = model.make_model(cfg).logits(params, h)[0]
        assert lg.shape == want.shape
        err = (lg - want).abs().max() / want.abs().max()
        assert err < 2e-5, f"{family}: {float(err):.3e}"


# per leaf, in the order drawn: (sum, first element) of the small moe
# model's weights at seed 5, as the harness drew them when the family's
# branch lived in ``harness/weights.py``
MOE_DRAWN = [
    ("embed", -150.72475410387415, 1.8423298597335815),
    ("layers.norm1", 127.40211737155914, 1.0048655271530151),
    ("layers.attn.wq", 1.5028306079184404, 0.4082266092300415),
    ("layers.attn.wk", 2.8152506130809343, -0.06537988781929016),
    ("layers.attn.wv", -8.972892893207245, 0.2284339964389801),
    ("layers.attn.wo", 1.900874429493797, -0.04634624347090721),
    ("layers.norm2", 127.09632134437561, 1.0561785697937012),
    ("layers.moe.router", -1.05240578854864, 0.08826486766338348),
    ("layers.moe.w1", -23.741015293412204, -0.2194039225578308),
    ("layers.moe.w3", 26.049384617347414, 0.2907584309577942),
    ("layers.moe.w2", -5.571895764830941, -0.01877467893064022),
    ("final_norm", 64.68694394826889, 1.08837890625),
    ("lm_head", -13.244817183899613, 0.2966076135635376)]


def test_moe_draws_the_weights_it_drew_before():
    def leaves(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, pre + k + ".")
            else:
                yield pre + k, v
    params = weights.draw(spec.family("moe").SMALL, 5, "cpu")
    got = [(n, float(v.double().sum()), float(v.flatten()[0]))
           for n, v in leaves(params)]
    assert [n for n, _, _ in got] == [n for n, _, _ in MOE_DRAWN]
    for (n, total, first), (_, want_total, want_first) in zip(got, MOE_DRAWN):
        assert first == want_first, n
        assert total == pytest.approx(want_total, rel=1e-12), n


@pytest.mark.parametrize("name", BENCH_CELLS)
def test_every_cell_has_its_small_family_and_reference_files(name):
    """A cell of ``BENCHMARK.json`` runs on the CPU from its small file,
    and its configuration's family has its weights and work counts and its
    reference; the small model is of the cell's family."""
    _, _, conf, _, _ = cell.load(name)
    family = conf["model"]["family"]
    assert name in smallcells.names()
    assert (HERE / "families" / f"{family}.py").is_file()
    assert (HERE / "reference" / f"{family}.py").is_file()
    assert smallcells.load(name)["model"]["family"] == family


@pytest.mark.parametrize("name", SMALL_CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_correct_on_the_cpu(name, traced):
    out = cell.run(name, 2 ** 31 + 3, 3.0, traced, time.perf_counter(),
                   device="cpu", overrides=smallcells.load(name),
                   log=lambda s: None,
                   clock=smallcells.TickClock())
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    if traced:
        assert out["metrics"], "no per-layer metric read"
        for v in out["metrics"].values():
            if v["unit"] == "%":
                assert 0.0 <= v["value"] <= 100.0
    else:
        assert "setup_s" in out["metrics"]


@pytest.mark.parametrize("family", FAMILIES)
def test_control_fails_where_the_program_passes(family):
    """The control (the reference through float8) on the served tokens of a
    CPU run reads a widest gap far above the program's and above the
    test-size limit."""
    m, ref = spec.family(family).SMALL, spec.reference(family)
    params = weights.draw(m, 9, "cpu")
    g = torch.Generator().manual_seed(2)
    served = []
    for n in (40, 90):
        # the program's tokens: the float32 reference's own greedy stream
        toks = torch.randint(2, m["vocab_size"], (n,), generator=g).tolist()
        for _ in range(16):
            lg = ref.logits(params, m, [(toks, len(toks) - 1)])[0]
            toks.append(int(lg[-1].argmax()))
        served.append((toks[:n], toks[n:]))
    prog = check.served_gaps(family, params, m, served)
    ctl = check.served_gaps(family, params, m, served, "fp8")
    assert max(max(x) for x in prog) == 0.0
    assert max(max(x) for x in ctl) > 10 * smallcells.CPU_LIMIT


def greedy_streams(m, params, lengths, new, seed):
    """The float32 reference's own greedy continuations of random prompts,
    as a run's timelines and requests (a program that serves exactly the
    reference's first choices)."""
    from harness.stats import Timeline
    from harness.traffic import Request
    ref = spec.reference(m["family"])
    g = torch.Generator().manual_seed(seed)
    timelines, requests = {}, {}
    for i, n in enumerate(lengths):
        toks = torch.randint(2, m["vocab_size"], (n,), generator=g).tolist()
        for _ in range(new):
            lg = ref.logits(params, m, [(toks, len(toks) - 1)])[0]
            toks.append(int(lg[-1].argmax()))
        rid = f"r{i}"
        requests[rid] = Request(rid, 0.0, toks[:n], new, 0.0, 1.0, i)
        tl = Timeline(rid, 0.0, n, new, finished=1.0, tokens=toks[n:])
        tl.frames = [(1.0, new)]
        timelines[rid] = tl
    return timelines, requests


@pytest.mark.parametrize("name", SMALL_CELLS)
def test_control_is_not_correct_under_the_cells_limits(name):
    """The harness's own comparison (``check.judge``) with the cell's
    committed limits (``correct/<cell>.json``): a program that serves the
    reference's first choices is correct, and the control put in its place
    is not, failing a number the cell compares (phi3.5-moe compares
    ``mean_gap`` alone). The model is the cell's family at small width over
    the configuration's vocabulary, four layers deep: at two layers over
    256 ids the control flips too few tokens for a limit set at the cell's
    own size (``PERF.md``)."""
    _, _, conf, _, c = cell.load(name)
    m = {**spec.family(conf["model"]["family"]).SMALL, "num_layers": 4,
         "vocab_size": conf["model"]["vocab_size"]}
    params = weights.draw(m, 3, "cpu")
    tls, rq = greedy_streams(m, params, (30, 45, 60, 75, 90, 40, 55, 70), 48, 4)
    ok, numbers = check.judge(m, c, params, tls, rq, 4, lambda s: None)
    assert ok and numbers["mean_gap"][0] == 0.0, numbers
    ok, numbers = check.judge(m, c, params, tls, rq, 4, lambda s: None, "fp8")
    assert not ok, numbers
    failed = {k for k, (v, lim) in numbers.items()
              if lim is not None and v > lim}
    assert failed, numbers
    if name.startswith("phi35moe"):
        assert failed == {"mean_gap"}


def test_calibrate_judges_the_control_as_a_run_judges():
    """``calibrate.py`` gives the program's and the control's verdicts from
    ``check.judge`` with the cell's limits (here the small cell's): the
    program correct, the control not."""
    import calibrate
    name = "phi35moe-chat-prefix"
    small = smallcells.load(name)
    rows = calibrate.main(["--workload", name, "--seeds", "21",
                           "--control-seeds", "21", "--seconds", "3"],
                          device="cpu", overrides=small,
                          clock=smallcells.TickClock())
    (row,) = rows
    assert row["limits"] == small["correct"]["limits"]
    assert row["program_correct"] and not row["control_correct"], row
    assert row["control_widest_gap"] > row["program_widest_gap"]
