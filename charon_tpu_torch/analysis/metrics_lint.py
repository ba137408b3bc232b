"""Metric-name lint — static pass over every registry call site.

A copy of the JAX package's analysis/metrics_lint.py, checked against
this package's own catalogue, docs/observability_torch.md.

The monitoring Registry creates series dynamically from string literals,
so a typo'd or convention-breaking metric name ships silently and only
shows up when a dashboard query returns nothing.  This pass walks the
`charon_tpu_torch` package AST, collects every string literal passed as the
first argument to ``inc`` / ``set_gauge`` / ``observe`` (the Registry
write surface), and fails on:

- names that are not ``snake_case`` (``^[a-z][a-z0-9_]*$``),
- names missing a ``charon_tpu_`` / ``core_`` / ``app_`` subsystem
  prefix,
- names used with more than one metric TYPE (e.g. the same name as both
  a counter and a histogram — Prometheus scrapes reject the collision,
  and a histogram's ``_bucket``/``_sum``/``_count`` expansion colliding
  with a counter of the same stem is the sneaky variant),
- histogram/counter stem collisions: a histogram ``X`` expands to
  ``X_bucket``/``X_sum``/``X_count`` series, so another metric named
  ``X_count`` (etc.) collides at scrape time,
- ``set_buckets`` literals that are not strictly-increasing finite
  numbers (the render path appends the ``+Inf`` bucket itself, so an
  explicit infinity — or a non-monotone ladder — is a config bug),
- label-cardinality guard: guarded label keys (``reason``, ``peer``,
  ``step``, ``path``, ``phase``, ``duty`` …) must carry values drawn
  from bounded sets.  Statically that means NO interpolated strings —
  f-strings, ``%``/``+`` string building, ``.format()``, ``repr()``,
  ``str()`` of anything but a plain name/attribute — as label values:
  one exception message interpolated into a ``reason`` label is an
  unbounded series factory that OOMs the scraper, not a metric.
- catalogue drift: every exported metric family must appear in the
  docs/observability_torch.md metric catalogue, and every metric the doc
  names must exist in code.  A metric a dashboard can't find in the
  docs is unusable; a documented metric that quietly stopped being
  exported is an alert rule firing on nothing.

Runs inside ``python -m charon_tpu_torch.analysis`` (every audit
includes it) and in tests/test_torch_analysis.py.  Pure AST — no imports of
the scanned modules, sub-second.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

#: Registry write methods → the metric type they create.
METRIC_METHODS = {"inc": "counter", "set_gauge": "gauge",
                  "observe": "histogram"}

ALLOWED_PREFIXES = ("charon_tpu_", "core_", "app_")

_SNAKE = re.compile(r"^[a-z][a-z0-9_]*$")

_HIST_SUFFIXES = ("_bucket", "_sum", "_count")

#: Label keys whose values must come from BOUNDED sets (enum names, peer
#: indices, pipeline phases).  An interpolated string under one of these
#: keys mints a new series per distinct value — unbounded cardinality.
GUARDED_LABEL_KEYS = ("reason", "peer", "step", "path", "phase", "duty",
                      "duty_type", "node", "span", "error", "stage", "op",
                      "cache", "program")

#: The Registry implementation itself dispatches sample values through
#: methods with the same names (`_Hist.observe(value)`) — implementation,
#: not call sites.  Its LITERAL-name call sites (the scrape-time
#: exporters: readiness, devcache, dispatch/compile gauges) still feed
#: the catalogue-drift pass through a names-only sweep below.
EXCLUDE_FILES = ("app/monitoring.py",)

#: Where the metric catalogue lives, relative to the repo root.
CATALOGUE_DOC = os.path.join("docs", "observability_torch.md")

#: Doc-side metric token: anything with a subsystem prefix but the
#: package's own name.  Histogram expansion suffixes are normalised away
#: when the stem is a known histogram family (alert exprs legitimately
#: reference `_bucket`).
_DOC_TOKEN = re.compile(r"\b((?:charon_tpu|core|app)_(?!torch\b)[a-z0-9_]+)\b")


@dataclass
class MetricSite:
    file: str
    line: int
    name: str
    kind: str  # counter | gauge | histogram


@dataclass
class MetricsLintReport:
    sites: list = field(default_factory=list)
    #: literal-name sites from EXCLUDE_FILES (the Registry module's own
    #: scrape-time exporters) — catalogue-drift input only, exempt from
    #: the write-surface rules
    extra_sites: list = field(default_factory=list)
    violations: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def names(self) -> dict[str, set]:
        out: dict[str, set] = {}
        for s in self.sites:
            out.setdefault(s.name, set()).add(s.kind)
        return out

    def exported_names(self) -> dict[str, set]:
        """Every family the package exports (main + excluded-file
        sites) — what the doc catalogue is checked against."""
        out = self.names()
        for s in self.extra_sites:
            out.setdefault(s.name, set()).add(s.kind)
        return out

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "metrics": {n: sorted(k) for n, k in sorted(self.names().items())},
            "violations": self.violations,
        }

    def summary(self) -> str:
        status = "PASS" if self.ok else "FAIL"
        return (f"  [{'ok' if self.ok else 'FAIL'}] metric-name lint: "
                f"{len(self.names())} metrics at {len(self.sites)} call "
                f"sites — {status}")


def _unbounded_label_value(value: ast.expr) -> str | None:
    """Why this label-value expression is an unbounded-series factory, or
    None if it passes.  The heuristic targets INTERPOLATION: names,
    attributes, enum ``.name``/``.lower()`` chains and ``str(<name>)``
    index formatting are fine; building strings out of runtime data is
    not."""
    if isinstance(value, ast.JoinedStr):
        return "an f-string"
    if isinstance(value, ast.BinOp):
        return "string arithmetic (+/%)"
    if isinstance(value, ast.Call):
        fn = value.func
        if isinstance(fn, ast.Name) and fn.id == "repr":
            return "repr(...)"
        if isinstance(fn, ast.Attribute) and fn.attr == "format":
            return ".format(...)"
        if isinstance(fn, ast.Name) and fn.id == "str":
            arg = value.args[0] if value.args else None
            if not isinstance(arg, (ast.Name, ast.Attribute, ast.Constant)):
                return "str() of a computed expression"
    return None


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, report: MetricsLintReport):
        self._path = path
        self._report = report

    def _check_labels(self, node: ast.Call, method: str) -> None:
        """Label-cardinality guard over the ``labels={...}`` keyword."""
        for kw in node.keywords:
            if kw.arg != "labels" or not isinstance(kw.value, ast.Dict):
                continue
            for key, value in zip(kw.value.keys, kw.value.values):
                if not (isinstance(key, ast.Constant)
                        and isinstance(key.value, str)):
                    continue
                if key.value not in GUARDED_LABEL_KEYS:
                    continue
                why = _unbounded_label_value(value)
                if why is not None:
                    self._report.violations.append(
                        f"{self._path}:{node.lineno}: label "
                        f"{key.value!r} passed to {method}() is {why} — "
                        f"guarded labels must be drawn from a bounded "
                        f"enum (literal, name, or enum .name), not "
                        f"interpolated runtime data")

    def _check_buckets(self, node: ast.Call) -> None:
        """Histogram bucket config: strictly-increasing finite literals;
        the render path appends +Inf itself."""
        where = f"{self._path}:{node.lineno}"
        bounds = node.args[1] if len(node.args) > 1 else None
        if bounds is None:
            return
        if not isinstance(bounds, (ast.Tuple, ast.List)):
            return  # computed bounds: out of static reach
        values = []
        for el in bounds.elts:
            if (isinstance(el, ast.Constant)
                    and isinstance(el.value, (int, float))
                    and not isinstance(el.value, bool)
                    and el.value == el.value  # not NaN
                    and abs(el.value) != float("inf")):
                values.append(float(el.value))
            else:
                self._report.violations.append(
                    f"{where}: set_buckets() bound is not a finite "
                    f"numeric literal — +Inf is appended by the renderer "
                    f"and must not appear in the config")
                return
        if not values:
            self._report.violations.append(
                f"{where}: set_buckets() with an empty bucket ladder")
            return
        if any(nxt <= cur for cur, nxt in zip(values, values[1:])):
            self._report.violations.append(
                f"{where}: set_buckets() bounds are not strictly "
                f"increasing: {values} — cumulative bucket counts would "
                f"render non-monotone")

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in METRIC_METHODS:
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                self._report.sites.append(MetricSite(
                    file=self._path, line=node.lineno, name=arg.value,
                    kind=METRIC_METHODS[fn.attr]))
            elif arg is not None and not isinstance(arg, ast.Constant):
                # a computed metric name defeats static linting — flag it
                # so dynamic names stay a deliberate, reviewed exception
                self._report.violations.append(
                    f"{self._path}:{node.lineno}: non-literal metric name "
                    f"passed to {fn.attr}() — metric names must be string "
                    f"literals so the lint (and grep) can see them")
            self._check_labels(node, fn.attr)
        if isinstance(fn, ast.Attribute) and fn.attr == "set_buckets":
            self._check_buckets(node)
        self.generic_visit(node)


class _NamesOnlyVisitor(ast.NodeVisitor):
    """Literal metric-name collector for EXCLUDE_FILES: the Registry
    module's value-dispatch calls (`_Hist.observe(value)`) must not trip
    the non-literal-name rule, but its exporter call sites DO export
    families the catalogue must cover."""

    def __init__(self, path: str, out: list):
        self._path = path
        self._out = out

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in METRIC_METHODS:
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                self._out.append(MetricSite(
                    file=self._path, line=node.lineno, name=arg.value,
                    kind=METRIC_METHODS[fn.attr]))
        self.generic_visit(node)


def check_catalogue(report: MetricsLintReport, doc_text: str,
                    doc_path: str = CATALOGUE_DOC) -> None:
    """Catalogue-drift pass: exported families ⊆ documented names and
    documented names ⊆ exported families.  Histogram expansion suffixes
    in the doc (`X_bucket` in an alert expr) normalise to their stem
    when the stem is a known histogram family."""
    exported = report.exported_names()
    hist_stems = {n for n, k in exported.items() if "histogram" in k}
    documented: set[str] = set()
    for token in _DOC_TOKEN.findall(doc_text):
        stem = token
        for suffix in _HIST_SUFFIXES:
            if token.endswith(suffix) and token[: -len(suffix)] in hist_stems:
                stem = token[: -len(suffix)]
                break
        documented.add(stem)
    for name in sorted(set(exported) - documented):
        where = sorted({f"{s.file}:{s.line}"
                        for s in report.sites + report.extra_sites
                        if s.name == name})[0]
        report.violations.append(
            f"{where}: exported metric {name!r} is missing from the "
            f"{doc_path} catalogue — undocumented families are "
            f"un-dashboardable; add a catalogue row")
    for name in sorted(documented - set(exported)):
        report.violations.append(
            f"{doc_path}: documents metric {name!r} which no code "
            f"exports — stale catalogue rows leave alert rules firing "
            f"on nothing; delete the row or restore the metric")


def lint_sources(sources: dict[str, str],
                 catalogue_doc: str | None = None) -> MetricsLintReport:
    """Lint {path: python source} — the unit-testable core.  When
    `catalogue_doc` (the observability doc's text) is given, the
    catalogue-drift pass runs too."""
    report = MetricsLintReport()
    for path, src in sorted(sources.items()):
        if path.replace(os.sep, "/").endswith(EXCLUDE_FILES):
            try:
                tree = ast.parse(src, filename=path)
            except SyntaxError as exc:  # pragma: no cover - repo parses
                report.violations.append(f"{path}: unparseable: {exc}")
                continue
            _NamesOnlyVisitor(path, report.extra_sites).visit(tree)
            continue
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as exc:  # pragma: no cover - repo parses
            report.violations.append(f"{path}: unparseable: {exc}")
            continue
        _Visitor(path, report).visit(tree)

    for site in report.sites:
        where = f"{site.file}:{site.line}"
        if not _SNAKE.match(site.name):
            report.violations.append(
                f"{where}: metric {site.name!r} is not snake_case")
        if not site.name.startswith(ALLOWED_PREFIXES):
            report.violations.append(
                f"{where}: metric {site.name!r} lacks a subsystem prefix "
                f"{ALLOWED_PREFIXES}")

    names = report.names()
    for name, kinds in sorted(names.items()):
        if len(kinds) > 1:
            report.violations.append(
                f"metric {name!r} is used as more than one type: "
                f"{sorted(kinds)} — one name, one type")
    # histogram expansion collisions: histogram X owns X_bucket/_sum/_count
    hist_stems = {n for n, k in names.items() if "histogram" in k}
    for stem in sorted(hist_stems):
        for suffix in _HIST_SUFFIXES:
            if stem + suffix in names:
                report.violations.append(
                    f"metric {stem + suffix!r} collides with histogram "
                    f"{stem!r}'s {suffix} series")
    if catalogue_doc is not None:
        check_catalogue(report, catalogue_doc)
    return report


def package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint_package(root: str | None = None) -> MetricsLintReport:
    """Lint every .py file under the charon_tpu_torch package (tests and
    scripts outside the package define scratch registries freely) and
    check the repo's metric catalogue (docs/observability_torch.md) for
    drift in both directions."""
    root = root or package_root()
    sources: dict[str, str] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path, encoding="utf-8") as f:
                    sources[os.path.relpath(path, os.path.dirname(root))] = \
                        f.read()
    doc_text = None
    doc_path = os.path.join(os.path.dirname(root), CATALOGUE_DOC)
    if os.path.exists(doc_path):
        with open(doc_path, encoding="utf-8") as f:
            doc_text = f.read()
    return lint_sources(sources, catalogue_doc=doc_text)
