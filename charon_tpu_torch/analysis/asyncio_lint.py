"""Event-loop-discipline lint — static pass over every ``async def``.

A copy of the JAX package's analysis/asyncio_lint.py on this package:
the fence is `tbls.dispatch.assert_off_loop`.

The duty pipeline keeps the sigagg hot path inside a 12-second slot; an
event loop silently blocked by a device call (or a sync file read, or a
``concurrent.futures`` join) is a LIVENESS bug — QBFT timers and
transport frames stall for its duration — that CPU test timing cannot
reliably observe.  This pass pins the whole class statically:

1. **Blocking calls in async bodies**: ``time.sleep``, zero-arg
   ``.result()`` / ``.join()`` (a ``concurrent.futures`` future or a
   thread — string ``sep.join(xs)`` always has an argument), and a
   curated sync-I/O surface (``open``, ``os.makedirs``/``listdir``/
   ``remove``/``rename``/``system``, ``shutil.rmtree``,
   ``subprocess.run``/``call``/``check_call``/``check_output``,
   ``socket.create_connection``, ``urlopen``).
2. **Loop-guarded device entry points**: the functions that call
   ``dispatch.assert_off_loop`` (in `tbls.api` and `tbls.backend_cuda`)
   seed a per-file call-graph closure through sync wrappers; calling any
   tainted name from an async body WITHOUT ``await`` is the runtime
   loop-guard violation, caught at lint time.  (``await
   pipe.batch_verify(...)`` is the async pipeline twin of a tainted
   name — the ``await`` exempts it.)
3. **The cancellation-swallow shape**: ``asyncio.wait_for`` directly
   wrapping a bare queue/stream ``.get()`` — on timeout the
   cancellation can swallow an already-dequeued item (a consensus hang
   the JAX package once shipped); use a dedicated consumer task or
   ``asyncio.wait``.
4. **Deprecated ``asyncio.get_event_loop()``** anywhere in the package:
   deprecated inside coroutines since 3.10/3.12 and wrong-loop-prone
   when a service object is shared across threads —
   ``get_running_loop()`` / ``asyncio.run`` are the supported idioms.
5. **Fire-and-forget ``create_task``**: a bare expression-statement
   ``loop.create_task(...)`` / ``asyncio.create_task(...)`` whose
   handle is neither retained nor given an ``add_done_callback`` can be
   garbage-collected mid-flight and its exception vanishes silently
   (`core.background.spawn` is the house idiom).

A deliberate, reviewed exception is waived in place with an
``# async-ok: <why>`` comment on the flagged line — e.g. a completed
task's ``.result()`` or a boot-time one-shot file read.

Pure AST, no imports of the scanned modules, sub-second — on in every
audit surface (``python -m charon_tpu_torch.analysis``, the tests) like
the metrics lint.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

#: Waiver marker: a reviewed exception, justified in place.
ASYNC_WAIVER = "# async-ok"

#: Bare-name calls that block the loop.
BLOCKING_NAME_CALLS = frozenset({"open"})

#: module.attr calls that block the loop.
BLOCKING_DOTTED_CALLS = frozenset({
    "time.sleep", "os.system", "os.makedirs", "os.listdir", "os.remove",
    "os.rename", "os.replace", "shutil.rmtree", "subprocess.run",
    "subprocess.call", "subprocess.check_call", "subprocess.check_output",
    "socket.create_connection",
})

#: Terminal attribute names that block regardless of the module alias.
BLOCKING_TERMINALS = frozenset({"urlopen"})

#: The loop-guard fence call that seeds the tainted-call closure
#: (`tbls.dispatch.assert_off_loop`).
LOOP_GUARD_FENCE = "assert_off_loop"

#: The scanned package (the first component of every scanned path).
PACKAGE = "charon_tpu_torch"


@dataclass
class AsyncLintReport:
    async_defs: int = 0
    tainted: list = field(default_factory=list)
    waived: list = field(default_factory=list)
    violations: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {"ok": self.ok, "async_defs": self.async_defs,
                "tainted_entry_points": sorted(self.tainted),
                "waived": self.waived, "violations": self.violations}

    def summary(self) -> str:
        status = "PASS" if self.ok else "FAIL"
        return (f"  [{'ok' if self.ok else 'FAIL'}] asyncio lint: "
                f"{self.async_defs} async defs, "
                f"{len(self.tainted)} loop-guarded entry points, "
                f"{len(self.waived)} waived — {status}")


def _dotted(func) -> str | None:
    """`time.sleep` → "time.sleep" (single-level module.attr only)."""
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        return f"{func.value.id}.{func.attr}"
    return None


def _terminal(func) -> str | None:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _own_calls(fn) -> set:
    """Terminal names of calls made at the function's OWN level — calls
    inside nested defs execute later (a builder returning stage closures
    is not itself a device entry point), so they are excluded; the
    nested defs are collected as functions in their own right."""
    out: set = set()
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Call):
            t = _terminal(node.func)
            if t:
                out.add(t)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _tainted_names(trees: dict) -> set:
    """Per-file call-graph closure from the loop-guard fence: a function
    whose body calls ``assert_off_loop`` is a device entry point; a SYNC
    same-file function that calls a tainted name is tainted too (an
    async wrapper would be awaited, which is the fix, so async defs do
    not propagate taint)."""
    tainted: set = set()
    per_file: list = []
    for path, tree in trees.items():
        fns = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                callees = _own_calls(node)
                fns[node.name] = (isinstance(node, ast.FunctionDef),
                                  callees)
                if LOOP_GUARD_FENCE in callees:
                    tainted.add(node.name)
        per_file.append(fns)
    changed = True
    while changed:
        changed = False
        for fns in per_file:
            for name, (is_sync, callees) in fns.items():
                if name in tainted or not is_sync:
                    continue
                if callees & tainted:
                    tainted.add(name)
                    changed = True
    tainted.discard(LOOP_GUARD_FENCE)
    return tainted


def _tbls_refs(path: str, tree: ast.Module, tainted: set) -> tuple:
    """(aliases, direct_names) through which this file can reach a
    tainted device entry point: module aliases bound by importing from
    the tbls package (``from ..tbls import api as tbls`` → "tbls"),
    tainted names imported directly, and tainted functions defined in
    this file itself.  Restricting the tainted-call check to these
    references keeps a generic name like ``verify`` from flagging an
    unrelated ``keypair.verify(...)``."""
    aliases: set = set()
    direct: set = set()
    in_tbls = path.replace(os.sep, "/").startswith(f"{PACKAGE}/tbls/")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if ".tbls" in a.name or a.name.startswith("tbls"):
                    aliases.add((a.asname or a.name).split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            from_tbls = "tbls" in mod or (in_tbls and node.level >= 1)
            if not from_tbls:
                continue
            for a in node.names:
                bound = a.asname or a.name
                if a.name in tainted:
                    direct.add(bound)
                else:
                    aliases.add(bound)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name in tainted:
                direct.add(node.name)
    return aliases, direct


class _AsyncBodyChecker:
    """Walk one async def body (excluding nested defs) flagging
    blocking calls, un-awaited tainted calls, and the wait_for footgun."""

    def __init__(self, path, src_lines, tainted, tbls_refs, report):
        self._path = path
        self._lines = src_lines
        self._tainted = tainted
        self._aliases, self._direct = tbls_refs
        self._report = report
        self._awaited: set = set()  # id() of Calls directly under await

    def _is_tbls_ref(self, func) -> bool:
        if isinstance(func, ast.Name):
            return func.id in self._direct
        if isinstance(func, ast.Attribute) \
                and isinstance(func.value, ast.Name):
            return func.value.id in self._aliases
        return False

    def _waived(self, node) -> bool:
        # the node's own lines plus the line immediately above it,
        # where a justification comment naturally sits
        lo = max(0, node.lineno - 2)
        hi = getattr(node, "end_lineno", node.lineno)
        if any(ASYNC_WAIVER in line for line in self._lines[lo:hi]):
            self._report.waived.append(
                f"{self._path}:{node.lineno}")
            return True
        return False

    def _flag(self, node, msg: str) -> None:
        if not self._waived(node):
            self._report.violations.append(
                f"{self._path}:{node.lineno}: {msg}")

    def check(self, fn: ast.AsyncFunctionDef) -> None:
        nodes = list(self._walk_no_defs(fn.body))
        for node in nodes:
            if isinstance(node, ast.Await) \
                    and isinstance(node.value, ast.Call):
                self._awaited.add(id(node.value))
        for node in nodes:
            if isinstance(node, ast.Call):
                self._check_call(node)

    def _walk_no_defs(self, body):
        stack = list(body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                # nested defs run later (sync helpers are typically
                # shipped to asyncio.to_thread; nested async defs are
                # linted as async defs in their own right)
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def _check_call(self, node: ast.Call) -> None:
        func = node.func
        dotted = _dotted(func)
        terminal = _terminal(func)
        if isinstance(func, ast.Name) and func.id in BLOCKING_NAME_CALLS:
            self._flag(node, f"blocking call {func.id}() in an async "
                             f"def — sync file I/O stalls the event "
                             f"loop; use asyncio.to_thread")
        elif dotted in BLOCKING_DOTTED_CALLS:
            self._flag(node, f"blocking call {dotted}() in an async def "
                             f"— stalls the event loop; use the asyncio "
                             f"twin or asyncio.to_thread")
        elif terminal in BLOCKING_TERMINALS:
            self._flag(node, f"blocking call .{terminal}() in an async "
                             f"def — sync network I/O stalls the loop")
        elif isinstance(func, ast.Attribute) and func.attr == "result" \
                and not node.args and not node.keywords:
            self._flag(node, "blocking .result() in an async def — a "
                             "concurrent.futures result() blocks the "
                             "loop until the executor finishes; await "
                             "the wrapped future (waive a completed-"
                             "task read with # async-ok)")
        elif isinstance(func, ast.Attribute) and func.attr == "join" \
                and not node.args:
            self._flag(node, "blocking .join() in an async def — "
                             "joining a thread/process blocks the loop; "
                             "await completion instead")
        elif terminal == "wait_for" and node.args:
            inner = node.args[0]
            if isinstance(inner, ast.Call) \
                    and isinstance(inner.func, ast.Attribute) \
                    and inner.func.attr in ("get", "get_nowait"):
                self._flag(node, "asyncio.wait_for wrapping a bare "
                                 ".get() — the swallow footgun: on "
                                 "timeout the cancellation can swallow "
                                 "an already-dequeued item; use a "
                                 "dedicated consumer task or "
                                 "asyncio.wait")
        elif terminal in self._tainted and id(node) not in self._awaited \
                and self._is_tbls_ref(func):
            self._flag(node, f"loop-guarded device entry point "
                             f"{terminal}() called from an async def "
                             f"without await — this is the runtime "
                             f"assert_off_loop violation, caught "
                             f"at lint time; await the dispatch-"
                             f"pipeline twin instead")


def _check_file_wide(path, tree, src_lines, report) -> None:
    """Rules that apply outside async bodies too: deprecated
    get_event_loop and fire-and-forget create_task."""

    def waived(node) -> bool:
        lo = max(0, node.lineno - 2)
        hi = getattr(node, "end_lineno", node.lineno)
        if any(ASYNC_WAIVER in line for line in src_lines[lo:hi]):
            report.waived.append(f"{path}:{node.lineno}")
            return True
        return False

    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and _terminal(node.func) == "get_event_loop":
            if not waived(node):
                report.violations.append(
                    f"{path}:{node.lineno}: deprecated "
                    f"asyncio.get_event_loop() — binds the wrong loop "
                    f"from threads and is deprecated in coroutines; "
                    f"use asyncio.get_running_loop() (or asyncio.run "
                    f"at the top level)")
        if isinstance(node, ast.Expr) \
                and isinstance(node.value, ast.Call) \
                and _terminal(node.value.func) in ("create_task",
                                                   "ensure_future"):
            if not waived(node):
                report.violations.append(
                    f"{path}:{node.lineno}: fire-and-forget "
                    f"{_terminal(node.value.func)}() — the loop holds "
                    f"only a weak ref, so the task can be collected "
                    f"mid-flight and its exception vanishes; retain "
                    f"the handle or use core.background.spawn (which "
                    f"logs + counts failures)")


def lint_sources(sources: dict[str, str]) -> AsyncLintReport:
    """Lint {package-relative path: python source} — the unit-testable
    core (same contract as metrics_lint.lint_sources)."""
    report = AsyncLintReport()
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

    tainted = _tainted_names(trees)
    report.tainted = sorted(tainted)
    for path, tree in sorted(trees.items()):
        refs = _tbls_refs(path, tree, tainted)
        for node in ast.walk(tree):
            if isinstance(node, ast.AsyncFunctionDef):
                report.async_defs += 1
                _AsyncBodyChecker(path, lines[path], tainted, refs,
                                  report).check(node)
        _check_file_wide(path, tree, lines[path], report)
    return report


def lint_package(root: str | None = None) -> AsyncLintReport:
    """Lint every .py file under the charon_tpu_torch package."""
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
    return lint_sources(sources)
