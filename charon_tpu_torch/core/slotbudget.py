"""Slot-budget accountant — decomposes each duty's slot into phase costs.

The north star is "10k validators inside one 12-second slot".  When a
duty is late, "the duty was late" is useless to an operator; the
actionable question is WHICH phase spent the budget — the fetch, the
QBFT rounds, the partial-signature exchange, or the device combine.  This
module answers it from the same component events the Tracker subscribes
to (no new edges in core.wire): it timestamps each duty's hand-off
through

    scheduler → fetcher → consensus → parsig_ex → sigagg → bcast

and at duty finalisation (driven by the Tracker's post-deadline report)
exports:

- ``core_slot_phase_seconds{phase}``         histogram of per-phase cost
  (each phase measured from the previous hand-off; the scheduler phase
  is measured from slot start and therefore includes the duty type's
  intentional firing offset, e.g. ⅓ slot for attesters),
- ``core_slot_budget_remaining_seconds``     gauge, budget left when the
  broadcast hand-off happened (negative = the duty overran its slot),
- ``core_slot_late_duties_total{phase}``     watchdog counter with the
  RESPONSIBLE phase: for a completed-but-late duty the costliest phase,
  for a duty that never completed the phase that never finished.

The clock is injectable so phase attribution is unit-testable against a
fake clock; hand-off hooks must be subscribed BEFORE core.wire() stitches
the pipeline so a timestamp is taken before the downstream edge runs
(the threshold→sigagg edge awaits the whole combine otherwise).

A copy of the JAX package's core/slotbudget.py, whole.  The late-duty
hooks (`subscribe_late`) are where the JAX node hangs its auto-profiler;
the port's counterpart of that profiler waits for the serving slice.
"""

from __future__ import annotations

import time
from collections import OrderedDict

from .tracker import _NO_BCAST, _VC_INITIATED
from .types import Duty

#: Pipeline phases in hand-off order.
PHASES = ("scheduler", "fetcher", "consensus", "parsig_ex", "sigagg",
          "bcast")


def expected_phases(duty_type) -> tuple:
    """The phases a duty of this type is expected to traverse
    (mirrors tracker.expected_steps): VC-initiated duties skip the
    scheduler→consensus front half, internal-only duties end at the
    threshold combine."""
    phases = PHASES
    if duty_type in _VC_INITIATED:
        phases = tuple(p for p in phases
                       if p not in ("scheduler", "fetcher", "consensus"))
    if duty_type in _NO_BCAST:
        phases = tuple(p for p in phases if p != "bcast")
    return phases


class SlotBudget:
    """Event sink + per-duty phase accountant.

    Wire the on_* hooks as component subscribers (before core.wire, see
    module doc) and `on_report` as a Tracker report subscriber; or drive
    `finalize(duty)` directly."""

    def __init__(self, registry=None, slot_start_fn=None,
                 budget_seconds: float = 12.0, clock=time.time,
                 max_duties: int = 1024):
        self._registry = registry
        self._slot_start_fn = slot_start_fn
        self._budget = budget_seconds
        self._clock = clock
        self._max = max_duties
        self._events: "OrderedDict[Duty, dict[str, float]]" = OrderedDict()
        self.late_duties = 0
        self._late_hooks: list = []

    def subscribe_late(self, fn) -> None:
        """fn(duty, responsible_phase) fires SYNCHRONOUSLY whenever the
        late-duty watchdog trips — the SLO hook the auto-profiler
        (app/autoprofile.py) hangs off, so a breach captures its own
        device trace.  Hook failures are swallowed: telemetry reacting
        to a late duty must never make the duty pipeline later."""
        self._late_hooks.append(fn)

    # -- event hooks (subscribe before core.wire) ---------------------------

    def _mark(self, duty: Duty, phase: str) -> None:
        ev = self._events.get(duty)
        if ev is None:
            ev = self._events[duty] = {}
            while len(self._events) > self._max:
                self._events.popitem(last=False)
        ev.setdefault(phase, self._clock())

    async def on_duty_scheduled(self, duty: Duty, defset) -> None:
        self._mark(duty, "scheduler")

    async def on_fetched(self, duty: Duty, unsigned) -> None:
        self._mark(duty, "fetcher")

    async def on_consensus(self, duty: Duty, unsigned) -> None:
        self._mark(duty, "consensus")

    async def on_threshold(self, duty: Duty, pubkey, parsigs) -> None:
        self._mark(duty, "parsig_ex")

    async def on_aggregated(self, duty: Duty, pubkey, signed) -> None:
        self._mark(duty, "sigagg")

    async def on_broadcast(self, duty: Duty, pubkey, data) -> None:
        self._mark(duty, "bcast")
        if self._registry is not None and self._slot_start_fn is not None:
            remaining = (self._slot_start_fn(duty.slot) + self._budget
                         - self._clock())
            self._registry.set_gauge("core_slot_budget_remaining_seconds",
                                     remaining)

    async def on_report(self, report) -> None:
        """Tracker report subscriber: finalise when the duty is analysed
        (post-deadline, so no further events can arrive)."""
        self.finalize(report.duty)

    # -- analysis -----------------------------------------------------------

    def slot_start(self, duty: Duty) -> float:
        if self._slot_start_fn is not None:
            return self._slot_start_fn(duty.slot)
        ev = self._events.get(duty)
        return min(ev.values()) if ev else 0.0

    def finalize(self, duty: Duty) -> dict[str, float] | None:
        """Attribute the duty's elapsed time to phases, export the
        histograms, and run the late-duty watchdog.  Returns the phase
        decomposition (None if the duty was never seen)."""
        start = self.slot_start(duty)
        ev = self._events.pop(duty, None)
        if ev is None:
            return None
        expected = expected_phases(duty.type)
        phases: dict[str, float] = {}
        prev = start
        for phase in PHASES:
            t = ev.get(phase)
            if t is None:
                continue
            # events can land microscopically out of order when several
            # subscribers share one edge; clamp, never go negative
            phases[phase] = max(0.0, t - prev)
            prev = max(prev, t)
        reg = self._registry
        if reg is not None:
            for phase, dt in phases.items():
                reg.observe("core_slot_phase_seconds", dt,
                            labels={"phase": phase})

        # -- late-duty watchdog --------------------------------------------
        final_phase = expected[-1]
        completed = final_phase in ev
        overran = prev - start > self._budget
        if completed and not overran:
            return phases
        if not completed:
            # blame the first expected phase that never finished
            responsible = final_phase
            for phase in expected:
                if phase not in ev:
                    responsible = phase
                    break
        else:
            # completed but past budget: blame the costliest phase
            responsible = max(phases, key=phases.get) if phases else "bcast"
        self.late_duties += 1
        if reg is not None:
            reg.inc("core_slot_late_duties_total",
                    labels={"phase": responsible})
        for fn in self._late_hooks:
            try:
                fn(duty, responsible)
            except Exception:  # noqa: BLE001 — see subscribe_late
                import logging

                logging.getLogger(__name__).exception(
                    "late-duty watchdog hook raised")
        return phases
