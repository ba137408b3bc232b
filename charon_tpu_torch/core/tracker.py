"""Tracker — per-duty failure root-cause analysis + participation metrics.

Mirrors reference core/tracker/tracker.go: subscribe to every component's
output events, replay each duty's event trail after its deadline,
determine the failing step and a human-readable reason (tracker.go:275-340),
and account per-peer participation including unexpected-participation
detection (tracker.go:508-567).

With a registry wired (``Tracker(..., registry=...)``) the analysis also
exports the reference's tracker metric families at /metrics
(core/tracker/incldelay.go:39-117 + tracker.go participation gauges):

- ``charon_tpu_tracker_inclusion_delay``          histogram, seconds from
  slot start to the duty's broadcast hand-off (success duties)
- ``charon_tpu_tracker_participation{peer=...}``  gauge, cumulative
  participation ratio per peer share index
- ``charon_tpu_tracker_failed_duties_total{step,reason}``  counter

A copy of the JAX package's core/tracker.py, whole (the metric families
keep their names, so one dashboard reads both packages).
"""

from __future__ import annotations

import asyncio
import time
from collections import defaultdict
from dataclasses import dataclass, field
from enum import IntEnum

from .types import Duty, DutyType, ParSignedDataSet, PubKey


class Step(IntEnum):
    """Workflow steps in pipeline order (reference: tracker.go:31-42)."""

    SCHEDULER = 0
    FETCHER = 1
    CONSENSUS = 2
    DUTY_DB = 3
    VALIDATOR_API = 4
    PARSIG_DB_INTERNAL = 5
    PARSIG_EX = 6
    PARSIG_DB_THRESHOLD = 7
    SIG_AGG = 8
    AGG_SIG_DB = 9
    BCAST = 10


# VC-initiated duties never pass scheduler/fetcher/consensus/dutydb; the
# first expected step is the validator API (fixes the round-1 finding that
# they were always misblamed on the fetcher; reference: tracker.go:275-340
# tracks per-duty expected steps).
_VC_INITIATED = {DutyType.RANDAO, DutyType.EXIT,
                 DutyType.BUILDER_REGISTRATION, DutyType.PREPARE_AGGREGATOR,
                 DutyType.PREPARE_SYNC_CONTRIBUTION, DutyType.SYNC_MESSAGE}

# Internal-only duties end at the AggSigDB — nothing is broadcast.
_NO_BCAST = {DutyType.RANDAO, DutyType.PREPARE_AGGREGATOR,
             DutyType.PREPARE_SYNC_CONTRIBUTION}


def expected_steps(duty_type: DutyType) -> list[Step]:
    steps = list(Step)
    if duty_type in _VC_INITIATED:
        steps = [s for s in steps if s > Step.DUTY_DB]
    if duty_type in _NO_BCAST:
        steps = [s for s in steps if s != Step.BCAST]
    return steps


_REASONS: dict[Step, str] = {
    Step.FETCHER: "bug: failed to fetch duty data",
    Step.CONSENSUS: "consensus algorithm didn't complete",
    Step.DUTY_DB: "bug: failed to store duty data in DutyDB",
    Step.VALIDATOR_API: "signed duty not submitted by local validator client",
    Step.PARSIG_DB_INTERNAL: "bug: partial signature not stored in local DB",
    Step.PARSIG_EX: "bug: failed to broadcast partial signature to peers",
    Step.PARSIG_DB_THRESHOLD:
        "insufficient partial signatures received, minimum required threshold "
        "not reached",
    Step.SIG_AGG: "bug: failed to aggregate partial signatures",
    Step.AGG_SIG_DB: "bug: failed to store aggregated signature",
    Step.BCAST: "failed to broadcast duty to beacon node",
}


@dataclass
class DutyReport:
    duty: Duty
    success: bool
    failed_step: Step | None = None
    reason: str = ""
    participation: dict = field(default_factory=dict)  # share idx -> bool


class Tracker:
    """Event sink + post-deadline analyser.  Feed events via the on_* hooks
    (wired as extra subscribers on each component), then call
    `analyse(duty)` after the duty's deadline (Deadliner-driven in app
    wiring)."""

    def __init__(self, num_peers: int, threshold: int, registry=None,
                 slot_start_fn=None, clock=time.time):
        self._clock = clock
        self._events: dict[Duty, set[Step]] = defaultdict(set)
        self._parsigs: dict[Duty, dict[PubKey, set[int]]] = defaultdict(
            lambda: defaultdict(set))
        self._num_peers = num_peers
        self._threshold = threshold
        self.reports: list[DutyReport] = []
        self._subs: list = []
        # cumulative per-peer participation counters (metrics feed)
        self.participation_counts: dict[int, int] = defaultdict(int)
        self.duty_total: int = 0
        # metrics export (app.monitoring.Registry) + slot→unix-start map
        # for inclusion-delay accounting (genesis + slot·duration)
        self._registry = registry
        self._slot_start_fn = slot_start_fn
        self._bcast_time: dict[Duty, float] = {}

    def subscribe(self, fn) -> None:
        """fn(report: DutyReport) on each analysed duty."""
        self._subs.append(fn)

    # -- event hooks (wire as component subscribers) ------------------------

    async def on_duty_scheduled(self, duty: Duty, defset) -> None:
        self._events[duty].add(Step.SCHEDULER)

    async def on_fetched(self, duty: Duty, unsigned) -> None:
        self._events[duty].add(Step.FETCHER)

    async def on_consensus(self, duty: Duty, unsigned) -> None:
        self._events[duty].add(Step.CONSENSUS)
        self._events[duty].add(Step.DUTY_DB)

    async def on_parsig_internal(self, duty: Duty,
                                 pset: ParSignedDataSet) -> None:
        self._events[duty].add(Step.VALIDATOR_API)
        self._events[duty].add(Step.PARSIG_DB_INTERNAL)
        self._record_parsigs(duty, pset)

    async def on_parsig_external(self, duty: Duty,
                                 pset: ParSignedDataSet) -> None:
        self._events[duty].add(Step.PARSIG_EX)
        self._record_parsigs(duty, pset)

    async def on_threshold(self, duty: Duty, pubkey: PubKey,
                           parsigs) -> None:
        self._events[duty].add(Step.PARSIG_DB_THRESHOLD)

    async def on_aggregated(self, duty: Duty, pubkey: PubKey, signed) -> None:
        self._events[duty].add(Step.SIG_AGG)
        self._events[duty].add(Step.AGG_SIG_DB)
        self._events[duty].add(Step.BCAST)
        # first aggregate of the duty = broadcast hand-off time (the
        # inclusion-delay numerator; reference: incldelay.go:39-117 uses
        # the block-import observation, here the bcast edge)
        self._bcast_time.setdefault(duty, self._clock())

    def _record_parsigs(self, duty: Duty, pset: ParSignedDataSet) -> None:
        for pubkey, psig in pset.items():
            self._parsigs[duty][pubkey].add(psig.share_idx)

    # -- analysis (reference: tracker.go:275-340) ---------------------------

    async def analyse(self, duty: Duty) -> DutyReport:
        """Called after the duty deadline: replay the trail, find the first
        missing step, emit the report, GC the duty state."""
        steps = self._events.pop(duty, set())
        parsigs = self._parsigs.pop(duty, {})

        participation = {
            idx: any(idx in shares for shares in parsigs.values())
            for idx in range(1, self._num_peers + 1)}
        self.duty_total += 1
        for idx, took_part in participation.items():
            if took_part:
                self.participation_counts[idx] += 1

        expected = expected_steps(duty.type)
        final = expected[-1]
        if final in steps:
            report = DutyReport(duty=duty, success=True,
                                participation=participation)
        else:
            failed = expected[0]
            for step in expected:
                if step not in steps:
                    failed = step
                    break
            report = DutyReport(
                duty=duty, success=False, failed_step=failed,
                reason=_REASONS.get(failed, "unknown"),
                participation=participation)
        self.reports.append(report)
        self._export_metrics(report, self._bcast_time.pop(duty, None))
        for fn in self._subs:
            await fn(report)
        return report

    def _export_metrics(self, report: DutyReport,
                        bcast_time: float | None) -> None:
        reg = self._registry
        if reg is None:
            return
        for idx in range(1, self._num_peers + 1):
            reg.set_gauge(
                "charon_tpu_tracker_participation",
                self.participation_counts[idx] / max(1, self.duty_total),
                labels={"peer": str(idx)})
        reg.set_gauge("charon_tpu_tracker_duties_analysed_total",
                      self.duty_total)
        if not report.success:
            reg.inc("charon_tpu_tracker_failed_duties_total",
                    labels={"step": report.failed_step.name.lower(),
                            "reason": report.reason})
        elif bcast_time is not None and self._slot_start_fn is not None:
            delay = bcast_time - self._slot_start_fn(report.duty.slot)
            reg.observe("charon_tpu_tracker_inclusion_delay", delay,
                        labels={"duty_type": report.duty.type.name.lower()})

    def unexpected_participants(self, duty: Duty) -> set[int]:
        """Peers whose partial sigs arrived for a duty we never scheduled
        (reference: tracker.go:508-567 unexpected-participation)."""
        if Step.SCHEDULER in self._events.get(duty, set()):
            return set()
        return {idx for shares in self._parsigs.get(duty, {}).values()
                for idx in shares}
