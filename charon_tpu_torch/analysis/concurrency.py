"""Lock-discipline pass — the concurrency contract auditor.

A copy of the JAX package's analysis/concurrency.py with this package's
own declaration table.  The port is multi-threaded like the JAX package:
the dispatch pipeline's host-prep and launch threads, prewarm, the
scrape and the chaos harness's stream threads all touch state shared
with the asyncio event loop.  Every lock retrofit the JAX package needed
had the same shape — "shared attribute, declared lock, a mutation site
that forgot the ``with``" — which is exactly the shape a static pass can
pin structurally.

Three checks, all pure AST (no imports of the scanned modules,
sub-second, on in every audit surface like the metrics lint):

1. **Guarded-mutation discipline.**  `SHARED_STATE_SPECS` is the central
   declaration table: every class (or module) with cross-thread state
   names its guarded attributes and the lock that owns them.  The pass
   finds every mutation of a guarded attribute — plain/augmented
   assignment, item assignment/deletion, and mutating container calls
   (``append``/``pop``/``move_to_end``/…) — and requires it to be
   lexically inside ``with <lock>`` or inside a declared locked helper
   (``locked_helpers`` or a ``*_locked`` naming-convention method, whose
   call sites must themselves hold the lock).  ``__init__`` is exempt:
   the object is not yet shared.
2. **Declaration sweep.**  Every ``threading.Lock()``/``RLock()``
   creation in the package must belong to a `SharedStateSpec` — a lock
   with no declared guarded-attribute set is cross-thread state the
   auditor cannot see (the "mutated from ≥2 threads with no
   declaration" failure mode).  A deliberate auditor-internal lock is
   waived with a ``# lock-ok: <why>`` comment on the creation line.
3. **Lock-ordering graph.**  Every ``with``-nesting of two known locks
   adds a directed edge (plus one-hop edges through same-file calls made
   under a lock into functions that acquire another); a cycle in that
   graph is a potential deadlock and is rejected.

Specs with ``lock=None`` declare LOOP-CONFINED state (mutated only from
the event-loop thread): the static pass checks the declaration does not
drift from the code (the attributes must exist), and the runtime
harness (`charon_tpu_torch.testutil.racecheck`) checks the locked specs
at runtime with instrumented locks.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

#: Container/​dict method names that mutate their receiver in place.
MUTATOR_CALLS = frozenset({
    "append", "appendleft", "extend", "insert", "add", "discard",
    "remove", "pop", "popleft", "popitem", "clear", "update",
    "move_to_end", "setdefault", "sort", "reverse",
})

#: Waiver marker for deliberate auditor-internal locks (check 2).
LOCK_WAIVER = "# lock-ok"


@dataclass(frozen=True)
class SharedStateSpec:
    """One class's (or module's) cross-thread state declaration.

    file    : package-relative posix path
              ("charon_tpu_torch/tbls/dispatch.py")
    scope   : class name, or "" for module-level state
    lock    : owning lock attribute/global name; None = loop-confined
    attrs   : guarded attribute (or module-global) names
    threads : which threads touch this state (documentation + racecheck
              reporting; not used by the static pass)
    locked_helpers : methods always called with the lock already held
              (checked at their call sites instead of their bodies)
    """

    file: str
    scope: str
    lock: str | None
    attrs: tuple
    threads: tuple = ()
    locked_helpers: tuple = ()
    notes: str = ""

    @property
    def where(self) -> str:
        return f"{self.file}::{self.scope or '<module>'}"


#: The wrapper modules whose `LAUNCHES` counters `ops/launch_count`'s
#: lock guards (its `WRAPPER_MODULES`).
_WRAPPERS = ("cuda_fp", "cuda_g2", "cuda_pairing", "cuda_h2c",
             "cuda_final_exp", "cuda_codec")

#: THE declaration table.  Every lock of the package is covered here;
#: adding a lock without adding a spec fails the declaration sweep.
SHARED_STATE_SPECS: tuple = (
    SharedStateSpec(
        file="charon_tpu_torch/tbls/dispatch.py", scope="DispatchPipeline",
        lock="_lock",
        attrs=("queue_depth", "prep_busy_s", "device_busy_s", "launches",
               "tiles", "verify_rows", "stage_seconds", "_busy_window"),
        threads=("event-loop", "host-prep", "launch"),
        locked_helpers=("_trim_window_locked",),
        notes="pipeline counters"),
    SharedStateSpec(
        file="charon_tpu_torch/tbls/dispatch.py", scope="",
        lock="_metrics_lock", attrs=("_metrics_registries",),
        threads=("event-loop", "launch", "scrape"),
        notes="registry fan-out list; snapshot reads are lock-free "
              "(immutable tuple swap)"),
    SharedStateSpec(
        file="charon_tpu_torch/tbls/devcache.py", scope="DeviceRowCache",
        lock="_lock",
        attrs=("_store", "_slots", "_free", "_ok", "hits", "misses",
               "evictions", "inserts", "overflows"),
        threads=("host-prep", "launch", "prewarm"),
        locked_helpers=("_lookup_locked", "_ensure_store"),
        notes="lookup_rows single-lock design"),
    SharedStateSpec(
        file="charon_tpu_torch/tbls/backend_cuda.py", scope="CUDABackend",
        lock="_totals_lock",
        attrs=("verify_totals", "verify_launch_totals"),
        threads=("launch", "prewarm", "event-loop"),
        notes="verify stage seconds and launches summed over a flush's "
              "tiles; `last_stages` is rebound whole, not guarded"),
    SharedStateSpec(
        file="charon_tpu_torch/tbls/backend_cuda.py", scope="CUDABackend",
        lock="_cache_lock",
        attrs=("_hm_cache", "_pk_cache", "hm_cache_hits",
               "hm_cache_misses", "hm_cache_evictions", "pk_cache_hits",
               "pk_cache_misses", "pk_cache_evictions", "_pk_dev",
               "_hm_dev"),
        threads=("host-prep", "launch", "prewarm"),
        notes="the host LRUs, their counters and the resident route's "
              "stores' lazy creation; device work for misses runs "
              "outside the lock"),
    SharedStateSpec(
        file="charon_tpu_torch/tbls/backend_cuda.py", scope="_VerifyGraph",
        lock="lock", attrs=("graph", "outputs", "launches"),
        threads=("launch", "prewarm"),
        locked_helpers=("load", "capture", "run"),
        notes="a resident bucket's capture and replay: the backend holds "
              "`lock` from `load` until the tile has read its outputs"),
    SharedStateSpec(
        file="charon_tpu_torch/tbls/backend_cuda.py", scope="",
        lock="_GRAPHS_LOCK", attrs=("_GRAPHS",),
        threads=("launch", "prewarm", "scrape"),
        notes="the resident route's buckets per (device, padded v)"),
    SharedStateSpec(
        file="charon_tpu_torch/ops/build.py", scope="",
        lock="_LOCK", attrs=("_LIB", "INFO"),
        threads=("launch", "host-prep", "prewarm", "scrape"),
        locked_helpers=("build",),
        notes="the kernel library's one build and load"),
    SharedStateSpec(
        file="charon_tpu_torch/ops/launch_count.py", scope="",
        lock="_LOCK", attrs=("totals",),
        threads=("launch", "host-prep", "prewarm", "event-loop"),
        notes="`totals` is a wrapper module's LAUNCHES "
              f"({', '.join(_WRAPPERS)}): counted by `bump` and zeroed by "
              "`reset`, never written elsewhere"),
    SharedStateSpec(
        file="charon_tpu_torch/app/monitoring.py", scope="Registry",
        lock="_lock",
        attrs=("_counters", "_gauges", "_hist", "_buckets"),
        threads=("event-loop", "launch", "scrape"),
        notes="Registry render/write lock"),
    SharedStateSpec(
        file="charon_tpu_torch/app/monitoring.py", scope="",
        lock="_PROFILE_GUARD_LOCK", attrs=("_PROFILE_ACTIVE",),
        threads=("event-loop", "debug-http", "capture"),
        notes="process-wide torch.profiler guard (manual /debug/profile "
              "vs SLO-triggered autoprofile)"),
    SharedStateSpec(
        file="charon_tpu_torch/app/tracing.py", scope="Tracer",
        lock="_lock",
        attrs=("spans", "_seq", "dropped", "sink_errors"),
        threads=("event-loop", "host-prep", "launch"),
        notes="span ring: device_span hooks append from the dispatch "
              "stage threads while app spans come from the loop"),
    # Loop-confined state (lock=None): single-threaded by design.
    SharedStateSpec(
        file="charon_tpu_torch/app/serving.py", scope="SingleFlightCache",
        lock=None,
        attrs=("_entries", "_inflight", "hits", "misses", "coalesced"),
        threads=("event-loop",)),
    SharedStateSpec(
        file="charon_tpu_torch/core/verify.py", scope="BatchVerifier",
        lock=None,
        attrs=("_queue", "_draining", "launches", "entries_total",
               "max_batch", "paths"),
        threads=("event-loop",)),
    SharedStateSpec(
        file="charon_tpu_torch/core/sigagg.py", scope="SigAgg",
        lock=None, attrs=("_queue",),
        threads=("event-loop",)),
    SharedStateSpec(
        file="charon_tpu_torch/app/autoprofile.py", scope="AutoProfiler",
        lock=None,
        attrs=("_last", "_seq", "captures", "skipped_rate_limited",
               "skipped_guard_busy", "capture_errors", "_tasks"),
        threads=("event-loop",),
        notes="the cross-thread part (the profiler claim) lives in "
              "monitoring._PROFILE_ACTIVE, declared above"),
)


@dataclass
class ConcurrencyReport:
    specs_checked: int = 0
    mutation_sites: int = 0
    locks_seen: int = 0
    lock_edges: list = field(default_factory=list)
    violations: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {"ok": self.ok, "specs_checked": self.specs_checked,
                "mutation_sites": self.mutation_sites,
                "locks_seen": self.locks_seen,
                "lock_edges": [list(e) for e in sorted(self.lock_edges)],
                "violations": self.violations}

    def summary(self) -> str:
        status = "PASS" if self.ok else "FAIL"
        return (f"  [{'ok' if self.ok else 'FAIL'}] lock discipline: "
                f"{self.specs_checked} specs, "
                f"{self.mutation_sites} guarded mutation sites, "
                f"{self.locks_seen} locks, "
                f"{len(self.lock_edges)} order edges — {status}")


# ---------------------------------------------------------------------------
# AST helpers
# ---------------------------------------------------------------------------

def _terminal_name(expr) -> str | None:
    """`self._lock` → "_lock", `cls._CACHE_LOCK` → "_CACHE_LOCK",
    `_metrics_lock` → "_metrics_lock"."""
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _recv_matches_scope(expr, scope: str) -> bool:
    """Is `expr` a reference to the spec's scope?  Class scope: `self`,
    `cls`, `type(self)` or the class name itself.  Module scope: the
    guarded state is a bare Name, so there is no receiver."""
    if isinstance(expr, ast.Name):
        return expr.id in ("self", "cls") or expr.id == scope
    if (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name)
            and expr.func.id == "type" and len(expr.args) == 1
            and isinstance(expr.args[0], ast.Name)
            and expr.args[0].id == "self"):
        return True
    return False


def _is_threading_lock_call(expr) -> bool:
    return (isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr in ("Lock", "RLock")
            and isinstance(expr.func.value, ast.Name)
            and expr.func.value.id == "threading")


def _line_has_waiver(src_lines, node) -> bool:
    # the node's own lines plus the line immediately above it, where a
    # justification comment naturally sits
    lo = max(0, node.lineno - 2)
    hi = getattr(node, "end_lineno", node.lineno)
    return any(LOCK_WAIVER in line for line in src_lines[lo:hi])


# ---------------------------------------------------------------------------
# Check 1: guarded-mutation discipline
# ---------------------------------------------------------------------------

class _SpecChecker:
    """Walk one spec's scope and flag guarded-attribute mutations that
    are not lexically under the declared lock."""

    def __init__(self, path: str, spec: SharedStateSpec,
                 report: ConcurrencyReport):
        self._path = path
        self._spec = spec
        self._report = report

    # -- entry ---------------------------------------------------------------

    def check_scope(self, scope_body) -> None:
        for node in scope_body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if self._exempt(node.name):
                    continue
                self._walk(node.body, held=False)
            # class-level / module-level statements run at import time
            # (single-threaded): exempt, like __init__

    def _exempt(self, name: str) -> bool:
        return (name == "__init__" or name in self._spec.locked_helpers
                or name.endswith("_locked"))

    # -- statement walk with lock context ------------------------------------

    def _walk(self, stmts, held: bool) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a nested def executes later, outside this lock region
                if not self._exempt(st.name):
                    self._walk(st.body, held=False)
                continue
            if isinstance(st, ast.ClassDef):
                continue
            if isinstance(st, (ast.With, ast.AsyncWith)):
                takes = any(
                    _terminal_name(item.context_expr) == self._spec.lock
                    for item in st.items)
                for item in st.items:
                    self._scan_exprs([item.context_expr], held, st)
                self._walk(st.body, held or takes)
                continue
            self._scan_exprs(self._own_exprs(st), held, st)
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(st, attr, None)
                if sub:
                    self._walk(sub, held)
            for handler in getattr(st, "handlers", ()):
                self._walk(handler.body, held)

    @staticmethod
    def _own_exprs(st) -> list:
        """The expressions a statement evaluates at ITS level (bodies of
        compound statements are walked separately, preserving the lock
        context)."""
        if isinstance(st, ast.Assign):
            return st.targets + [st.value]
        if isinstance(st, ast.AugAssign):
            return [st.target, st.value]
        if isinstance(st, ast.AnnAssign):
            return ([st.target, st.value] if st.value is not None else [])
        if isinstance(st, ast.Delete):
            return list(st.targets)
        if isinstance(st, ast.Expr):
            return [st.value]
        if isinstance(st, ast.Return):
            return [st.value] if st.value is not None else []
        if isinstance(st, (ast.If, ast.While)):
            return [st.test]
        if isinstance(st, ast.For):
            return [st.target, st.iter]
        if isinstance(st, ast.Assert):
            return [st.test]
        if isinstance(st, ast.Raise):
            return [e for e in (st.exc, st.cause) if e is not None]
        return []

    # -- mutation detection --------------------------------------------------

    def _guarded_base(self, expr) -> str | None:
        """`expr` resolves to a guarded attribute?  → its name."""
        spec = self._spec
        if isinstance(expr, ast.Attribute) and expr.attr in spec.attrs \
                and spec.scope and _recv_matches_scope(expr.value,
                                                       spec.scope):
            return expr.attr
        if isinstance(expr, ast.Name) and not spec.scope \
                and expr.id in spec.attrs:
            return expr.id
        return None

    def _scan_exprs(self, exprs, held: bool, stmt) -> None:
        for expr in exprs:
            if expr is None:
                continue
            for node in ast.walk(expr):
                attr = self._mutation(node)
                if attr is None:
                    continue
                self._report.mutation_sites += 1
                if held or self._spec.lock is None:
                    continue
                self._report.violations.append(
                    f"{self._path}:{node.lineno}: unguarded mutation of "
                    f"{self._spec.scope or '<module>'}.{attr} — declared "
                    f"guarded by {self._spec.lock!r} "
                    f"(threads: {', '.join(self._spec.threads)}) but this "
                    f"site is not inside `with {self._spec.lock}` or a "
                    f"declared locked helper")

    def _mutation(self, node) -> str | None:
        """Does `node` mutate a guarded attribute?  → its name."""
        # self.attr = / self.attr += / del self.attr
        if isinstance(node, ast.Attribute) \
                and isinstance(node.ctx, (ast.Store, ast.Del)):
            return self._guarded_base(node)
        if isinstance(node, ast.Name) \
                and isinstance(node.ctx, (ast.Store, ast.Del)):
            return self._guarded_base(node)
        # self.attr[k] = / del self.attr[k]
        if isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, (ast.Store, ast.Del)):
            return self._guarded_base(node.value)
        # self.attr.append(...) and friends
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in MUTATOR_CALLS:
            return self._guarded_base(node.func.value)
        return None


def _find_scope(tree: ast.Module, scope: str):
    if not scope:
        return tree.body
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == scope:
            return node.body
    return None


def _check_locked_helper_call_sites(path, tree, spec, report) -> None:
    """A `*_locked` helper asserts "my caller holds the lock" — verify
    that statically at every call site inside the scope."""
    helpers = set(spec.locked_helpers) | {
        n.name for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        and n.name.endswith("_locked")}
    if not helpers or spec.lock is None:
        return
    body = _find_scope(tree, spec.scope)
    if body is None:
        return

    class _Calls(_SpecChecker):
        def _scan_exprs(self, exprs, held, stmt):
            for expr in exprs:
                if expr is None:
                    continue
                for node in ast.walk(expr):
                    if isinstance(node, ast.Call) \
                            and isinstance(node.func, ast.Attribute) \
                            and node.func.attr in helpers \
                            and not held:
                        report.violations.append(
                            f"{path}:{node.lineno}: locked helper "
                            f"{node.func.attr}() called without holding "
                            f"{spec.lock!r} — the `_locked` suffix is a "
                            f"contract, not a comment")

    checker = _Calls(path, spec, report)
    # helper bodies may call sibling helpers while the lock is held
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name in helpers:
                continue
            checker._walk(node.body, held=False)


# ---------------------------------------------------------------------------
# Check 2: declaration sweep
# ---------------------------------------------------------------------------

def _sweep_undeclared_locks(path, tree, src_lines, specs, report) -> None:
    declared = {(s.file, s.scope, s.lock) for s in specs
                if s.lock is not None}

    def note(scope: str, name: str, node) -> None:
        report.locks_seen += 1
        if (path, scope, name) in declared:
            return
        if _line_has_waiver(src_lines, node):
            return
        report.violations.append(
            f"{path}:{node.lineno}: lock {name!r} in "
            f"{scope or '<module>'} has no SharedStateSpec — cross-"
            f"thread state must declare its guarded attributes in "
            f"analysis/concurrency.py (or waive an auditor-internal "
            f"lock with `{LOCK_WAIVER}: <why>`)")

    def scan(body, scope: str) -> None:
        for st in body:
            if isinstance(st, ast.ClassDef):
                scan(st.body, st.name)
            elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # instance locks: self.X = threading.Lock() in methods
                for node in ast.walk(st):
                    if isinstance(node, ast.Assign) \
                            and _is_threading_lock_call(node.value):
                        for tgt in node.targets:
                            name = _terminal_name(tgt)
                            if name:
                                note(scope, name, node)
            elif isinstance(st, ast.Assign) \
                    and _is_threading_lock_call(st.value):
                for tgt in st.targets:
                    name = _terminal_name(tgt)
                    if name:
                        note(scope, name, st)

    scan(tree.body, "")


# ---------------------------------------------------------------------------
# Check 3: lock-ordering graph
# ---------------------------------------------------------------------------

def _file_lock_names(tree, specs, path) -> set:
    """Lock names visible in this file: declared specs + every
    threading.Lock/RLock creation (so fixtures with undeclared locks
    still build a graph)."""
    names = {s.lock for s in specs if s.file == path and s.lock}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) \
                and _is_threading_lock_call(node.value):
            for tgt in node.targets:
                name = _terminal_name(tgt)
                if name:
                    names.add(name)
    return names


def _collect_lock_edges(path, tree, lock_names, edges, fn_locks) -> None:
    """Directed edges: `with A` lexically containing `with B` (A→B), and
    `with A` containing a call to a same-file function that acquires B."""

    def walk(stmts, stack) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                walk(st.body, [])
                continue
            if isinstance(st, (ast.With, ast.AsyncWith)):
                taken = [n for item in st.items
                         if (n := _terminal_name(item.context_expr))
                         in lock_names]
                new_stack = stack
                for name in taken:
                    key = f"{path}:{name}"
                    if new_stack and new_stack[-1] != key:
                        edges.setdefault(
                            (new_stack[-1], key), []).append(st.lineno)
                    new_stack = new_stack + [key]
                walk(st.body, new_stack)
                continue
            if stack:
                for node in ast.walk(st):
                    if isinstance(node, ast.Call):
                        callee = _terminal_name(node.func)
                        for lock in fn_locks.get(callee, ()):
                            key = f"{path}:{lock}"
                            if key != stack[-1]:
                                edges.setdefault(
                                    (stack[-1], key), []).append(
                                        node.lineno)
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(st, attr, None)
                if sub:
                    walk(sub, stack)
            for handler in getattr(st, "handlers", ()):
                walk(handler.body, stack)

    walk(tree.body, [])


def _function_locks(tree, lock_names) -> dict:
    """function name → set of lock names its body acquires (for the
    one-hop call edges)."""
    out: dict[str, set] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            acquired = set()
            for sub in ast.walk(node):
                if isinstance(sub, (ast.With, ast.AsyncWith)):
                    for item in sub.items:
                        name = _terminal_name(item.context_expr)
                        if name in lock_names:
                            acquired.add(name)
            if acquired:
                out[node.name] = acquired
    return out


def _find_cycles(edges: dict) -> list:
    graph: dict[str, set] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    cycles, done = [], set()
    state: dict[str, int] = {}  # 1 = on stack, 2 = finished

    def dfs(node, path_nodes):
        state[node] = 1
        path_nodes.append(node)
        for nxt in sorted(graph.get(node, ())):
            if state.get(nxt) == 1:
                cyc = path_nodes[path_nodes.index(nxt):] + [nxt]
                key = frozenset(cyc)
                if key not in done:
                    done.add(key)
                    cycles.append(cyc)
            elif state.get(nxt) is None:
                dfs(nxt, path_nodes)
        path_nodes.pop()
        state[node] = 2

    for start in sorted(graph):
        if state.get(start) is None:
            dfs(start, [])
    return cycles


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def check_sources(sources: dict[str, str],
                  specs: tuple = SHARED_STATE_SPECS) -> ConcurrencyReport:
    """Audit {package-relative path: python source} — the unit-testable
    core (same contract as metrics_lint.lint_sources)."""
    report = ConcurrencyReport(specs_checked=len(specs))
    trees: dict[str, ast.Module] = {}
    lines: dict[str, list] = {}
    for path, src in sorted(sources.items()):
        norm = path.replace(os.sep, "/")
        try:
            trees[norm] = ast.parse(src, filename=path)
        except SyntaxError as exc:  # pragma: no cover - repo parses
            report.violations.append(f"{path}: unparseable: {exc}")
            continue
        lines[norm] = src.splitlines()

    by_file: dict[str, list] = {}
    for spec in specs:
        by_file.setdefault(spec.file, []).append(spec)

    # check 1 + spec-drift existence check
    for path, file_specs in sorted(by_file.items()):
        tree = trees.get(path)
        if tree is None:
            for spec in file_specs:
                report.violations.append(
                    f"{spec.where}: spec file not found in the scanned "
                    f"sources — SharedStateSpec drifted from the code")
            continue
        src_text = "\n".join(lines[path])
        for spec in file_specs:
            body = _find_scope(tree, spec.scope)
            if body is None:
                report.violations.append(
                    f"{spec.where}: scope {spec.scope!r} not found — "
                    f"SharedStateSpec drifted from the code")
                continue
            scope_text = ast.get_source_segment(
                src_text, next(n for n in tree.body
                               if isinstance(n, ast.ClassDef)
                               and n.name == spec.scope)) \
                if spec.scope else src_text
            for attr in spec.attrs + ((spec.lock,) if spec.lock else ()):
                if attr not in (scope_text or ""):
                    report.violations.append(
                        f"{spec.where}: declared attribute {attr!r} "
                        f"never appears in the scope — stale spec")
            _SpecChecker(path, spec, report).check_scope(body)
            _check_locked_helper_call_sites(path, tree, spec, report)

    # check 2: every lock is declared (or waived)
    for path, tree in sorted(trees.items()):
        _sweep_undeclared_locks(path, tree, lines[path], specs, report)

    # check 3: lock-ordering graph over every file
    edges: dict[tuple, list] = {}
    for path, tree in sorted(trees.items()):
        names = _file_lock_names(tree, specs, path)
        if not names:
            continue
        fn_locks = _function_locks(tree, names)
        _collect_lock_edges(path, tree, names, edges, fn_locks)
    report.lock_edges = sorted(edges)
    for cyc in _find_cycles(edges):
        sites = sorted({ln for (a, b), lns in edges.items()
                        for ln in lns
                        if a in cyc and b in cyc})
        report.violations.append(
            "lock-order cycle (potential deadlock): "
            + " -> ".join(cyc)
            + f" (with-nesting sites at lines {sites})")
    return report


def check_package(root: str | None = None) -> ConcurrencyReport:
    """Audit every .py file under the charon_tpu_torch package against
    SHARED_STATE_SPECS."""
    from .metrics_lint import package_root

    root = root or package_root()
    sources: dict[str, str] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path, encoding="utf-8") as f:
                    sources[os.path.relpath(
                        path, os.path.dirname(root))] = f.read()
    return check_sources(sources)
