"""firstlint for the port (``repro_torch.analysis``): rule fixtures,
suppressions, the CLI, and the run-on-repo regressions that keep the
port's serving and kernel contracts enforced.

Each rule has a bad fixture (an exact count of findings) and a good one
(none) under ``tests/fixtures/lint_torch/``. The mutation regressions
edit the port's REAL sources in memory -- delete a ``table_version`` bump,
the device-table key, a wrapper's ``_build.check``; insert an ``.item()``
into the sampler's latch, the fused decode loop, each iteration body it
runs, or the sharded decode loop in the model modules -- and assert the
rules notice.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.analysis import analyze_paths, analyze_source, get_rules
from repro_torch.analysis.framework import Report
from repro_torch.analysis.rules import ALL_RULES, NOT_PORTED, RULES_BY_NAME
from repro_torch.analysis.rules.host_sync import (HostSyncRule, _Tree,
                                                  hot_set, package_root)

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "lint_torch"
PORT = REPO / "src" / "repro_torch"
CLEAN_PATHS = [PORT, REPO / "chip_smoke.py", REPO / "scripts"]


def run_on(path: pathlib.Path, rules=None):
    return analyze_source(path.read_text(), str(path), get_rules(rules))


def cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


# ---------------------------------------------------------------------------
# per-rule fixtures: bad flags an exact count, good passes
# ---------------------------------------------------------------------------

CASES = [
    ("host-sync-in-hot-path", "host_sync_bad.py", "host_sync_good.py", 10),
    ("cache-invalidation", "cache_invalidation_bad.py",
     "cache_invalidation_good.py", 5),
    ("cuda-wrapper-safety", "cuda_wrapper_bad.py", "cuda_wrapper_good.py",
     5),
    ("wire-schema", "wire_schema_bad.py", "wire_schema_good.py", 3),
]


@pytest.mark.parametrize("rule,bad,good,n_bad", CASES,
                         ids=[c[0] for c in CASES])
def test_rule_flags_bad_fixture(rule, bad, good, n_bad):
    kept, waived = run_on(FIXTURES / bad)
    assert len(kept) == n_bad, [f.render() for f in kept]
    assert {f.rule for f in kept} == {rule}
    assert waived == 0
    for f in kept:
        assert f.line > 0 and f.message


@pytest.mark.parametrize("rule,bad,good,n_bad", CASES,
                         ids=[c[0] for c in CASES])
def test_rule_passes_good_fixture(rule, bad, good, n_bad):
    kept, waived = run_on(FIXTURES / good)
    assert kept == [], [f.render() for f in kept]
    assert waived == 0


def test_rule_registry_and_list_rules():
    assert len(ALL_RULES) == 4
    assert set(RULES_BY_NAME) == {c[0] for c in CASES}
    with pytest.raises(KeyError):
        get_rules(["donation-safety"])
    proc = cli("--list-rules")
    assert proc.returncode == 0
    for name in RULES_BY_NAME:
        assert name in proc.stdout
    # the reference's donation rule has no torch counterpart, and says so
    assert "donation-safety: not ported" in proc.stdout
    assert "buffer donation" in NOT_PORTED["donation-safety"]


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

def test_inline_nextline_and_all_suppressions():
    kept, waived = run_on(FIXTURES / "suppressed.py")
    assert kept == [], [f.render() for f in kept]
    assert waived == 3          # same-line, next-line, disable=all


def test_file_level_suppression():
    kept, waived = run_on(FIXTURES / "suppressed_file.py")
    assert kept == []
    assert waived == 4          # every guard rail of the one launch


def test_suppression_is_rule_specific():
    src = ("class B:\n"
           "    def _verify_forward(self, x):\n"
           "        return x.item()"
           "  # firstlint: disable=wire-schema -- wrong rule name\n")
    kept, waived = analyze_source(src, "t.py", get_rules())
    assert len(kept) == 1 and kept[0].rule == "host-sync-in-hot-path"
    assert waived == 0


def test_parse_error_is_unsuppressable_and_fails_the_cli(tmp_path):
    kept, _ = analyze_source("def broken(:\n", "t.py", get_rules())
    assert len(kept) == 1 and kept[0].rule == "parse-error"
    bad = tmp_path / "broken.py"
    bad.write_text("def broken(:  # firstlint: disable-file=all -- no\n")
    proc = cli(str(bad))
    assert proc.returncode == 1 and "parse-error" in proc.stdout


# ---------------------------------------------------------------------------
# JSON output and CLI behaviour
# ---------------------------------------------------------------------------

def test_json_output_schema_and_exit_code():
    proc = cli(str(FIXTURES / "cuda_wrapper_bad.py"), "--format=json")
    assert proc.returncode == 1
    doc = json.loads(proc.stdout)
    assert doc["version"] == 1 and doc["tool"] == "firstlint"
    assert doc["files_checked"] == 1 and doc["suppressed"] == 0
    assert doc["counts"] == {"cuda-wrapper-safety": 5}
    for f in doc["findings"]:
        assert set(f) == {"rule", "path", "line", "col", "message"}


def test_cli_clean_file_exits_zero_and_rule_subsets():
    proc = cli(str(FIXTURES / "cuda_wrapper_good.py"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 findings" in proc.stdout
    proc = cli(str(FIXTURES / "host_sync_bad.py"), "--rules=wire-schema")
    assert proc.returncode == 0          # host-sync findings not selected
    proc = cli("--rules=bogus", str(FIXTURES / "wire_schema_good.py"))
    assert proc.returncode == 2


def test_cli_default_paths_are_clean():
    proc = cli()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    files = int(proc.stdout.rsplit("firstlint: ", 1)[1].split()[0])
    assert files > 100


def test_report_to_dict_roundtrips_through_json():
    report = analyze_paths([str(FIXTURES / "cache_invalidation_bad.py")],
                           get_rules())
    assert isinstance(report, Report)
    doc = json.loads(json.dumps(report.to_dict()))
    assert doc["counts"]["cache-invalidation"] == 5


# ---------------------------------------------------------------------------
# run on the repo: the port is clean
# ---------------------------------------------------------------------------

def test_port_chip_smoke_and_scripts_are_clean():
    report = analyze_paths([str(p) for p in CLEAN_PATHS], get_rules())
    assert report.files_checked > 90
    assert report.findings == [], "\n".join(
        f.render() for f in report.findings)
    assert not report.errors


def test_directory_walk_skips_fixtures_but_explicit_path_checks_them():
    walked = analyze_paths([str(REPO / "tests")], get_rules())
    assert not [f for f in walked.findings if "fixtures" in f.path]
    explicit = analyze_paths([str(FIXTURES / "host_sync_bad.py")],
                             get_rules())
    assert len(explicit.findings) == 10


def test_hot_set_reaches_the_latch_and_the_tail_attention():
    tree = ast.parse((PORT / "serving" / "backends.py").read_text())
    hot = hot_set(tree, HostSyncRule.roots)
    assert {"run", "iterate", "step", "_iteration", "_kernel_step",
            "_reference_step", "_verify_forward", "_decode_step",
            "_decode_forward", "_sample_and_latch",
            "_tail_attend"} <= set(hot)
    # the host wrappers stay outside: they are where token ids cross
    assert not {"fused_decode", "spec_verify", "decode_batch",
                "_refresh_tables"} & set(hot)


def test_hot_set_follows_the_loops_into_the_sharded_models():
    hot = {str(f.relative_to(PORT)): names
           for f, names in _Tree(PORT).hot(HostSyncRule.roots).items()}
    assert {"serve_decode_step"} <= hot["models/hybrid.py"]
    assert {"mamba_layer_sharded", "_mixer",
            "ssd_decode_step"} <= hot["models/mamba2.py"]
    assert {"mixer", "decode_attend", "block", "reduce",
            "gather"} <= hot["models/transformer.py"]
    assert {"all_reduce", "all_gather"} <= hot["distributed/sharding.py"]
    assert {"ssd"} <= hot["kernels/ssd/ops.py"]
    assert {"paged_attention_sharded", "fused_decode_attention_sharded"} \
        <= hot["kernels/paged_attention/ops.py"]
    # prefill and set-up run outside the device loops
    assert "serve_prefill" not in hot["models/hybrid.py"]
    assert not {"shard_params", "shard_slot_cache"} \
        & hot["distributed/sharding.py"]
    assert package_root(str(FIXTURES / "host_sync_bad.py")) is None


# ---------------------------------------------------------------------------
# mutation regressions against the port's real sources
# ---------------------------------------------------------------------------

def _delete_each(path: pathlib.Path, pred, rules):
    """Delete each line matching ``pred`` in turn; yield (line number,
    findings of ``rules`` on the mutated source)."""
    lines = path.read_text().splitlines(keepends=True)
    sites = [i for i, line in enumerate(lines) if pred(line.strip())]
    assert sites, f"no matching lines in {path}"
    for i in sites:
        kept, _ = analyze_source("".join(lines[:i] + lines[i + 1:]),
                                 str(path), get_rules(rules))
        yield i + 1, kept


def test_deleting_table_version_bumps_in_kv_cache_is_caught():
    path = PORT / "serving" / "kv_cache.py"
    caught = [line for line, kept in _delete_each(
        path, lambda s: s == "self.table_version += 1",
        ["cache-invalidation"]) if kept]
    # every bump that guards a block-table mutation is load-bearing (one
    # more bump protects a lengths-only re-upload, outside the contract)
    assert len(caught) == 6, caught


def test_deleting_the_device_table_key_is_caught():
    path = PORT / "serving" / "backends.py"
    results = list(_delete_each(
        path, lambda s: s == "self._dev_tables_key = self.kv.table_version",
        ["cache-invalidation"]))
    assert len(results) == 1
    (line, kept), = results
    assert len(kept) == 1 and "_dev_tables_key" in kept[0].message, line


@pytest.mark.parametrize("kernel", ["flash_attention", "paged_attention",
                                    "ssd"])
def test_deleting_any_build_check_in_a_wrapper_is_caught(kernel):
    path = PORT / "kernels" / kernel / "ops.py"
    seen = 0
    for line, kept in _delete_each(path,
                                   lambda s: s.startswith("_build.check("),
                                   ["cuda-wrapper-safety"]):
        assert len(kept) == 1 and "_build.check" in kept[0].message, \
            f"deleting {path.name}:{line} went unnoticed"
        seen += 1
    assert seen == {"ssd": 1}.get(kernel, 2)


def test_inserting_item_into_the_sampler_latch_is_caught():
    path = PORT / "serving" / "backends.py"
    src = path.read_text()
    needle = "    produced = produced + step\n"
    assert src.count(needle) == 1
    mutated = src.replace(needle, needle + "    produced.item()\n")
    kept, _ = analyze_source(mutated, str(path),
                             get_rules(["host-sync-in-hot-path"]))
    assert len(kept) == 1 and "_sample_and_latch" in kept[0].message


LOOP_SITES = [
    ("            out[i] = self.st[\"tokens\"]\n", "run"),
    ("        logits = self._decode_step(tokens)\n", "_iteration"),
    ("        h = tp.embed(tokens[:, None])\n", "_kernel_step"),
    ("        lens = lens0 + produced\n", "_reference_step"),
]


@pytest.mark.parametrize("needle,fn", LOOP_SITES,
                         ids=[s[1] for s in LOOP_SITES])
def test_inserting_item_into_the_decode_loop_is_caught(needle, fn):
    """The fused decode loop and each iteration body it runs."""
    path = PORT / "serving" / "backends.py"
    src = path.read_text()
    assert src.count(needle) == 1
    indent = needle[:len(needle) - len(needle.lstrip())]
    mutated = src.replace(needle, indent + "produced.item()\n" + needle)
    kept, _ = analyze_source(mutated, str(path),
                             get_rules(["host-sync-in-hot-path"]))
    assert len(kept) == 1 and f"'{fn}'" in kept[0].message


SHARDED_SITES = [
    ("models/hybrid.py", "    lens_s = stack.replicate(lens)\n",
     "serve_decode_step"),
    ("models/mamba2.py", "    ys, new_states = [], []\n",
     "mamba_layer_sharded"),
    ("models/transformer.py", "        return mamba_layer_sharded(\n",
     "mixer"),
    ("distributed/sharding.py",
     "        acc = acc.to(partials[0].dtype)\n", "all_reduce"),
]


@pytest.mark.parametrize("rel,needle,fn", SHARDED_SITES,
                         ids=[s[2] for s in SHARDED_SITES])
def test_inserting_item_into_the_sharded_decode_loop_is_caught(rel, needle,
                                                              fn):
    path = PORT / rel
    src = path.read_text()
    assert src.count(needle) == 1
    indent = needle[:len(needle) - len(needle.lstrip())]
    mutated = src.replace(needle, indent + "lens.item()\n" + needle)
    kept, _ = analyze_source(mutated, str(path),
                             get_rules(["host-sync-in-hot-path"]))
    assert len(kept) == 1 and f"'{fn}'" in kept[0].message


def test_unchanged_serving_and_kernel_sources_are_clean():
    paths = [PORT / "serving" / "backends.py",
             PORT / "serving" / "kv_cache.py",
             *sorted((PORT / "kernels").glob("*/ops.py"))]
    for path in paths:
        kept, waived = run_on(path)
        assert kept == [] and waived == 0, "\n".join(
            f.render() for f in kept)
