"""Kernel launch counters shared by the kernel wrappers.

Each wrapper module keeps a process-wide `LAUNCHES` dict (what the smoke
run reads for the main path).  The dispatch pipeline launches from two
threads at once — a pubkey-cache miss decompresses on the host-prep
thread while the launch thread runs the previous tile — so a stage's own
launches are counted per thread as well: `this_thread()` is what a stage
clock differences, and another thread's launches never land in it.

A CUDA graph capture launches nothing: the launches a thread's wrappers
record inside `capture()` are collected, not counted, and `replay()`
counts them each time the graph is replayed.
"""

from __future__ import annotations

import contextlib
import sys
import threading

_LOCK = threading.Lock()
_LOCAL = threading.local()

#: the kernel wrapper modules (``charon_tpu_torch.ops.<name>``), each with
#: its `LAUNCHES`
WRAPPER_MODULES = ("cuda_fp", "cuda_g2", "cuda_pairing", "cuda_h2c",
                   "cuda_final_exp", "cuda_codec")


def bump(totals: dict[str, int], name: str) -> None:
    """Count one launch of kernel `name`: in the process-wide `totals` (a
    wrapper module's `LAUNCHES`) and in the calling thread's counts; inside
    `capture()`, record it instead."""
    captured = getattr(_LOCAL, "captured", None)
    if captured is not None:
        captured.append((totals, name))
        return
    with _LOCK:
        totals[name] += 1
    mine = getattr(_LOCAL, "counts", None)
    if mine is None:
        mine = _LOCAL.counts = {}
    mine[name] = mine.get(name, 0) + 1


def reset(totals: dict[str, int]) -> None:
    """Zero a wrapper module's `LAUNCHES` under the lock `bump` counts
    under, so that a launch on another thread is never lost to a reset."""
    with _LOCK:
        for name in totals:
            totals[name] = 0


def this_thread() -> dict[str, int]:
    """The calling thread's launches per kernel since it started (a copy;
    never reset, so callers difference two readings)."""
    return dict(getattr(_LOCAL, "counts", {}))


@contextlib.contextmanager
def capture():
    """Collect the calling thread's launches inside the block (a CUDA graph
    capture) instead of counting them; yields the list `replay` takes."""
    captured: list = []
    _LOCAL.captured = captured
    try:
        yield captured
    finally:
        _LOCAL.captured = None


def replay(captured: list) -> None:
    """Count the launches of one replay of a captured graph."""
    for counts, name in captured:
        bump(counts, name)


def process_launches() -> dict[str, int]:
    """Every kernel's launches in this process, from the wrapper modules
    loaded so far (none before the first device call)."""
    out: dict[str, int] = {}
    for mod in WRAPPER_MODULES:
        wrappers = sys.modules.get(f"{__package__}.{mod}")
        out.update(getattr(wrappers, "LAUNCHES", {}))
    return out
