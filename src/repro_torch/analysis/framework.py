"""firstlint core: rule protocol, suppressions, file walking, reporting
(the port's copy of the JAX package's ``repro/analysis/framework.py``,
unchanged in behaviour).

A :class:`Rule` inspects one parsed module (:class:`ModuleInfo`) and yields
:class:`Finding` objects. The framework owns everything around that:
discovering files, parsing, matching ``# firstlint: disable=...`` comments,
and rendering text/JSON reports. Rules never filter suppressions
themselves — they report every violation and the framework drops the
suppressed ones (counting them, so reports can say what was waived).

Suppression syntax (one rule name, a comma list, or ``all``)::

    bad_call()          # firstlint: disable=<rule>[,<rule>...] -- <reason>
    # firstlint: disable-next-line=<rule> -- <reason>
    # firstlint: disable-file=<rule> -- <reason>        (anywhere in file)

The ``-- reason`` tail is free text; reviews should treat a reasonless
suppression the way they treat a bare ``type: ignore``.
"""
from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator

SUPPRESS_RE = re.compile(
    r"#\s*firstlint:\s*(disable|disable-next-line|disable-file)"
    r"\s*=\s*([A-Za-z0-9_\-, ]+?)\s*(?:--\s*(?P<reason>.*))?$")

DEFAULT_EXCLUDE_PARTS = ("fixtures", "__pycache__", ".git")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""
    rule: str
    path: str
    line: int
    col: int
    message: str

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"

    @property
    def sort_key(self):
        return (self.path, self.line, self.col, self.rule)


class ModuleInfo:
    """One parsed source file plus its suppression table."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()
        # line -> set of rule names (or {"all"}) waived on that line
        self._line_waivers: dict[int, set[str]] = {}
        self._file_waivers: set[str] = set()
        self._parse_suppressions()

    def _parse_suppressions(self) -> None:
        for i, line in enumerate(self.lines, start=1):
            if "firstlint" not in line:
                continue
            m = SUPPRESS_RE.search(line)
            if m is None:
                continue
            kind = m.group(1)
            rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
            if kind == "disable-file":
                self._file_waivers |= rules
            elif kind == "disable-next-line":
                self._line_waivers.setdefault(i + 1, set()).update(rules)
            else:
                self._line_waivers.setdefault(i, set()).update(rules)

    def suppressed(self, finding: Finding) -> bool:
        if {"all", finding.rule} & self._file_waivers:
            return True
        waived = self._line_waivers.get(finding.line, set())
        return bool({"all", finding.rule} & waived)


class Rule:
    """Base class: subclasses set ``name``/``description`` and implement
    :meth:`check`."""
    name = "abstract"
    description = ""

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, mod: ModuleInfo, node: ast.AST, message: str) -> Finding:
        return Finding(rule=self.name, path=mod.path,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0), message=message)


@dataclass
class Report:
    """Outcome of one analysis run (post-suppression)."""
    findings: list[Finding] = field(default_factory=list)
    suppressed: int = 0
    files_checked: int = 0
    errors: list[Finding] = field(default_factory=list)

    @property
    def all_findings(self) -> list[Finding]:
        out = sorted(self.findings + self.errors, key=lambda f: f.sort_key)
        return out

    def to_dict(self) -> dict:
        counts: dict[str, int] = {}
        for f in self.all_findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return {
            "version": 1,
            "tool": "firstlint",
            "files_checked": self.files_checked,
            "suppressed": self.suppressed,
            "counts": counts,
            "findings": [f.to_dict() for f in self.all_findings],
        }

    def render_text(self) -> str:
        lines = [f.render() for f in self.all_findings]
        n = len(lines)
        lines.append(f"firstlint: {self.files_checked} files, "
                     f"{n} finding{'s' if n != 1 else ''}, "
                     f"{self.suppressed} suppressed")
        return "\n".join(lines)


def analyze_source(source: str, path: str,
                   rules: Iterable[Rule]) -> tuple[list[Finding], int]:
    """Run ``rules`` over one source string. Returns (findings kept,
    findings suppressed). A syntax error yields a single ``parse-error``
    finding (unsuppressable — a file that does not parse checks nothing).
    """
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(rule="parse-error", path=path, line=e.lineno or 1,
                        col=e.offset or 0,
                        message=f"could not parse: {e.msg}")], 0
    mod = ModuleInfo(path, source, tree)
    kept: list[Finding] = []
    waived = 0
    for rule in rules:
        for f in rule.check(mod):
            if mod.suppressed(f):
                waived += 1
            else:
                kept.append(f)
    return kept, waived


def iter_python_files(paths: Iterable[str],
                      exclude_parts: tuple[str, ...] = DEFAULT_EXCLUDE_PARTS
                      ) -> Iterator[Path]:
    seen = set()
    for raw in paths:
        p = Path(raw)
        candidates = [p] if p.is_file() else sorted(p.rglob("*.py"))
        for f in candidates:
            if f.suffix != ".py" or f in seen:
                continue
            # explicit file arguments bypass the exclude list (tests point
            # the analyzer straight at fixture snippets); directory walks
            # skip fixture/cache trees
            if p.is_dir() and set(f.parts) & set(exclude_parts):
                continue
            seen.add(f)
            yield f


def analyze_paths(paths: Iterable[str], rules: Iterable[Rule],
                  exclude_parts: tuple[str, ...] = DEFAULT_EXCLUDE_PARTS
                  ) -> Report:
    """Analyze every ``*.py`` under ``paths`` (files or directories)."""
    rules = list(rules)
    report = Report()
    for f in iter_python_files(paths, exclude_parts):
        try:
            source = f.read_text(encoding="utf-8")
        except OSError as e:
            report.errors.append(Finding(
                rule="io-error", path=str(f), line=1, col=0,
                message=f"could not read: {e}"))
            continue
        report.files_checked += 1
        kept, waived = analyze_source(source, str(f), rules)
        report.suppressed += waived
        for finding in kept:
            (report.errors if finding.rule == "parse-error"
             else report.findings).append(finding)
    return report


def render(report: Report, fmt: str) -> str:
    if fmt == "json":
        return json.dumps(report.to_dict(), indent=2, sort_keys=True)
    return report.render_text()
