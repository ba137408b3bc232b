"""Background-task spawn helper — no fire-and-forget tasks.

``asyncio.create_task`` returns a task the loop holds only WEAKLY: if the
caller drops the handle, the task can be garbage-collected mid-flight,
and if it raises, the exception is reported only at GC time (or never) —
the silent-background-failure class known as a fire-and-forget
``create_task()``.  (A copy of the JAX package's helper: the port imports
nothing of that package.)

`spawn` is the sanctioned idiom: the task handle is retained in a
module-level registry until the task finishes, and a done-callback logs
the exception, so a dying flusher shows up in the log instead of
vanishing.  `CancelledError` is not an error: shutdown cancels
background tasks by design.
"""

from __future__ import annotations

import asyncio
import logging

log = logging.getLogger("charon_tpu_torch.background")

#: Strong refs to in-flight tasks (the loop's own ref is weak).  Discarded
#: by the done-callback; only ever touched from the event loop thread.
_TASKS: set = set()


def _on_done(task: "asyncio.Task") -> None:
    _TASKS.discard(task)
    if task.cancelled():
        return
    exc = task.exception()
    if exc is None:
        return
    log.error("background task %s failed: %r", task.get_name(), exc)


def spawn(coro, *, name: str) -> "asyncio.Task":
    """Schedule `coro` on the running loop with a retained handle and an
    exception-reporting done-callback.  Returns the task (callers MAY
    also keep it — e.g. to await or cancel it later)."""
    task = asyncio.get_running_loop().create_task(coro, name=name)
    _TASKS.add(task)
    task.add_done_callback(_on_done)
    return task

