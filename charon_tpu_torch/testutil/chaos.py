"""Deterministic chaos/soak simnet — fault injection over the in-memory
cluster.

A copy of the JAX package's testutil/chaos.py on this package's modules,
with two differences: the dispatch pipeline is pinned inline by handing
every node one ``DispatchPipeline(inline=True)`` (`Node(dispatcher=)`; the
JAX harness sets ``CHARON_TPU_DISPATCH=0``), and the tbls scheme is an
argument (`ChaosHarness(scheme=)`, `run_scenario(scheme=)`,
``--tbls-scheme``): ``insecure-test`` by default, as the JAX harness
forces, or ``bls``, whose verifies and combines run on the default tbls
backend — the card; with no card a ``bls`` run fails at its start, it
never falls back to the CPU.  The catalogue, the plans, the seeded rng
draws and `ChaosResult.fingerprint` are the JAX module's: under
``insecure-test`` a scenario's fingerprint equals the JAX harness's.

Everything a run does is a pure function of ``(seed, FaultPlan)``:

- a virtual-time event loop (`SimEventLoop`) jumps straight to the next
  scheduled timer instead of sleeping, so a thousand-slot soak executes
  in wall-seconds and every timeout/round-change/deadline fires at a
  reproducible instant;
- all randomness (drop decisions, latency jitter, byzantine targeting)
  comes from one seeded ``random.Random``;
- the dispatch pipeline is pinned inline (one
  ``DispatchPipeline(inline=True)`` for every node) and the node-level
  wall-clock samplers are disabled (`probes=False`), so no executor
  thread can race virtual time.

A `FaultPlan` is a declarative per-slot schedule of faults — symmetric
partitions, directed link drop/latency/jitter/reorder, per-node clock
skew, leader crashes, mid-slot node restarts (state re-wired from the
previous incarnation's dutydb/aggsigdb), and byzantine behaviours
(validly-signed equivocating partials, conflicting QBFT pre-prepares,
garbage frames).  `ChaosHarness` builds an n-node cluster around it,
drives `Scenario.slots` slots, and asserts three properties:

- **liveness** — every attester duty of a "healthy" slot (a quorum of
  up, mutually-connected nodes existed) reached the beacon mock with a
  valid threshold GROUP signature;
- **safety** — no two nodes decided different consensus values for one
  duty, no node stored two different aggregates for one (duty, pubkey),
  and all nodes' aggregates for a duty are byte-identical;
- **telemetry truthfulness** — ``core_parsigex_equivocations_total``
  fires exactly for the scripted byzantine shares and never for honest
  ones, ``charon_tpu_tracker_participation`` matches the partition/link
  schedule, and ``core_slot_late_duties_total`` blames the phase the
  plan actually injected.

Every `ChaosFailure` message embeds the replay command
(``python -m charon_tpu_torch.testutil.chaos --scenario X --seed N``,
with ``--tbls-scheme bls`` for a run on the card) and the
full plan; re-running reproduces the run bit-identically
(`ChaosResult.fingerprint`).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import hashlib
import math
import random
import selectors
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..app.monitoring import Registry
from ..app.node import Node, NodeConfig
from ..app.serving import CachingBeaconClient
from ..core import qbft
from ..core import types as core_types
from ..core.consensus import ConsensusMemNetwork, QBFTConsensus, duty_leader
from ..core.deadline import LATE_FACTOR
from ..core.parsigex import MemParSigExNetwork
from ..core.types import Duty, DutyType, ParSignedData
from ..eth2util.beacon_client import BeaconApiError
from ..eth2util.signing import DomainName, signing_root
from ..tbls import api as tbls
from ..tbls.dispatch import DispatchPipeline
from .beaconmock import AttesterDutyInfo, BeaconMock
from .cluster import new_cluster_for_test
from .validatormock import ValidatorMock

FORK = bytes(4)
GVR = bytes(32)

PROTO_CONSENSUS = "consensus"
PROTO_PARSIGEX = "parsigex"

BYZ_EQUIVOCATE = "equivocate"
BYZ_PREPREPARE = "conflicting_preprepare"
BYZ_GARBAGE = "garbage"


def qbft_quorum(n: int) -> int:
    return math.ceil(n * 2 / 3)


# ---------------------------------------------------------------------------
# Virtual-time event loop
# ---------------------------------------------------------------------------

class SimEventLoop(asyncio.SelectorEventLoop):
    """Event loop whose clock is virtual: when no callback is ready it
    JUMPS ``time()`` to the earliest scheduled timer instead of blocking
    in select, so asyncio.sleep / wait timeouts / QBFT round timers all
    fire deterministically and a multi-hour soak runs in wall-seconds.

    Any component reading time through ``loop.time()`` (qbft, transports)
    or through an injected ``clock=`` that wraps it (scheduler, deadliner,
    slot budget, tracker — see ChaosHarness._clock_for) lives entirely in
    virtual time."""

    def __init__(self) -> None:
        super().__init__(selectors.SelectSelector())
        self._sim_now = 0.0
        # strict mode turns "nothing ready, nothing scheduled" into an
        # error: with no I/O sources in the simnet that state is a
        # genuine deadlock, and silently blocking in select() forever is
        # the worst possible way to report it.  Disabled during loop
        # teardown (executor shutdown legitimately waits on a thread).
        self.sim_strict = True

    def time(self) -> float:
        return self._sim_now

    def _run_once(self) -> None:  # noqa: D401 — asyncio internal override
        if not self._ready and self._scheduled:
            when = self._scheduled[0].when()
            if when > self._sim_now:
                self._sim_now = when
        elif not self._ready and not self._scheduled and self.sim_strict:
            raise RuntimeError(
                "sim loop deadlock: no ready callbacks and no timers")
        super()._run_once()


def run_sim(coro) -> Any:
    """Run `coro` to completion on a fresh SimEventLoop (the virtual-time
    analogue of asyncio.run, including leftover-task cancellation)."""
    loop = SimEventLoop()
    asyncio.set_event_loop(loop)
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.sim_strict = False
        try:
            tasks = asyncio.all_tasks(loop)
            for t in tasks:
                t.cancel()
            if tasks:
                loop.run_until_complete(
                    asyncio.gather(*tasks, return_exceptions=True))
            loop.run_until_complete(loop.shutdown_asyncgens())
            loop.run_until_complete(loop.shutdown_default_executor())
        finally:
            asyncio.set_event_loop(None)
            loop.close()


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Partition:
    """Symmetric partition for slots [start_slot, end_slot): only nodes
    in the same group exchange messages; unlisted nodes are isolated."""

    start_slot: int
    end_slot: int
    groups: tuple  # tuple[tuple[int, ...], ...]


@dataclass(frozen=True)
class LinkFault:
    """Directed link fault frm→to for slots [start_slot, end_slot).
    `drop` is a per-message loss probability (1.0 = hard cut), `latency`
    + uniform(0, `jitter`) delays delivery, `reorder` is the probability
    of an extra latency+jitter penalty (pushing the message past later
    ones).  `proto` scopes the fault to "consensus", "parsigex" or "*"."""

    frm: int
    to: int
    start_slot: int
    end_slot: int
    drop: float = 0.0
    latency: float = 0.0
    jitter: float = 0.0
    reorder: float = 0.0
    proto: str = "*"


@dataclass(frozen=True)
class ClockSkew:
    """Node's injected clock reads `skew` seconds AHEAD of virtual time
    for the whole run (positive skew = the node acts early)."""

    node: int
    skew: float


@dataclass(frozen=True)
class Crash:
    """Node goes down at ``slot·dur + at`` (seconds into the slot).
    `down_for=None` means it never comes back; otherwise it is revived
    after that many seconds via the restart machinery."""

    node: int
    slot: int
    at: float = 0.0
    down_for: Optional[float] = None


@dataclass(frozen=True)
class Restart:
    """Stop the node mid-slot (``slot·dur + at`` seconds) and immediately
    boot a fresh incarnation re-wired from the old dutydb/aggsigdb."""

    node: int
    slot: int
    at: float = 0.5


@dataclass(frozen=True)
class Byzantine:
    """Scripted byzantine behaviour for slots [start_slot, end_slot)."""

    node: int
    kind: str  # BYZ_EQUIVOCATE | BYZ_PREPREPARE | BYZ_GARBAGE
    start_slot: int = 0
    end_slot: int = 1 << 30


#: BeaconFault modes
BEACON_ERROR = "error"
BEACON_FLAKY = "flaky"
BEACON_SLOW = "slow"


@dataclass(frozen=True)
class BeaconFault:
    """Upstream beacon-API fault for slots [start_slot, end_slot):
    ``error`` fails every duty-data read, ``flaky`` fails each read with
    probability `rate`, ``slow`` only stalls; `latency` seconds are
    added to every read in all three modes.  Submissions are never
    faulted — the scenario scopes the fault to the fetch path the
    serving-layer cache/coalescer can absorb."""

    start_slot: int
    end_slot: int
    mode: str = BEACON_FLAKY
    rate: float = 0.5
    latency: float = 0.0


@dataclass(frozen=True)
class FaultPlan:
    partitions: tuple = ()
    links: tuple = ()
    skews: tuple = ()
    crashes: tuple = ()
    restarts: tuple = ()
    byzantine: tuple = ()
    beacon: tuple = ()

    def skew_of(self, node: int) -> float:
        for s in self.skews:
            if s.node == node:
                return s.skew
        return 0.0

    def _group_of(self, slot: int, node: int):
        for p in self.partitions:
            if p.start_slot <= slot < p.end_slot:
                for gi, group in enumerate(p.groups):
                    if node in group:
                        return (id(p), gi)
                return (id(p), f"solo-{node}")
        return None

    def blocked(self, slot: int, frm: int, to: int) -> bool:
        """Symmetric partition check (directed cuts ride LinkFault)."""
        return self._group_of(slot, frm) != self._group_of(slot, to)

    def link(self, slot: int, frm: int, to: int,
             proto: str) -> Optional[LinkFault]:
        for lf in self.links:
            if (lf.frm == frm and lf.to == to
                    and lf.start_slot <= slot < lf.end_slot
                    and lf.proto in ("*", proto)):
                return lf
        return None

    def byz_kinds(self, node: int, slot: int) -> set:
        return {b.kind for b in self.byzantine
                if b.node == node and b.start_slot <= slot < b.end_slot}

    def beacon_fault(self, slot: int) -> Optional[BeaconFault]:
        for bf in self.beacon:
            if bf.start_slot <= slot < bf.end_slot:
                return bf
        return None

    def byz_equivocator_nodes(self) -> set:
        return {b.node for b in self.byzantine if b.kind == BYZ_EQUIVOCATE}

    def describe(self) -> str:
        parts = []
        for name in ("partitions", "links", "skews", "crashes", "restarts",
                     "byzantine", "beacon"):
            vals = getattr(self, name)
            if vals:
                parts.append(f"{name}={list(vals)!r}")
        return "FaultPlan(" + ", ".join(parts) + ")"


def link_gate(plan: FaultPlan, rng: random.Random, slot: int, frm: int,
              to: int, proto: str) -> tuple[bool, float]:
    """(deliver?, delay_seconds) for one message on one directed link.
    Consumes rng draws only for probabilistic faults, keeping fully
    deterministic plans rng-silent (bit-identical replay)."""
    if plan.blocked(slot, frm, to):
        return False, 0.0
    lf = plan.link(slot, frm, to, proto)
    if lf is None:
        return True, 0.0
    if lf.drop >= 1.0 or (lf.drop > 0.0 and rng.random() < lf.drop):
        return False, 0.0
    delay = lf.latency
    if lf.jitter > 0.0:
        delay += rng.uniform(0.0, lf.jitter)
    if lf.reorder > 0.0 and rng.random() < lf.reorder:
        delay += lf.latency + lf.jitter
    return True, delay


# ---------------------------------------------------------------------------
# Fault-routing transports
# ---------------------------------------------------------------------------

class ChaosRouter:
    """Shared fault engine: every cross-node delivery of both in-memory
    transports funnels through `route`, which applies the plan's
    partition/link faults and the live down-set (crashed nodes)."""

    def __init__(self, plan: FaultPlan, rng: random.Random,
                 slot_duration: float):
        self.plan = plan
        self.rng = rng
        self.slot_duration = slot_duration
        self.down: set[int] = set()
        self.delivered = 0
        self.dropped = 0
        self.delayed = 0
        self.receiver_errors = 0
        self._tasks: set = set()

    def slot_now(self) -> int:
        now = asyncio.get_running_loop().time()
        return max(0, int(now // self.slot_duration))

    async def route(self, frm: int, to: int, proto: str, deliver) -> None:
        if frm in self.down or to in self.down:
            self.dropped += 1
            return
        ok, delay = link_gate(self.plan, self.rng, self.slot_now(), frm, to,
                              proto)
        if not ok:
            self.dropped += 1
            return
        if delay > 0.0:
            self.delayed += 1
            task = asyncio.get_running_loop().create_task(
                self._deliver_later(delay, to, deliver))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)
        else:
            await self._deliver(to, deliver)

    async def _deliver_later(self, delay: float, to: int, deliver) -> None:
        await asyncio.sleep(delay)
        if to in self.down:
            self.dropped += 1
            return
        await self._deliver(to, deliver)

    async def _deliver(self, to: int, deliver) -> None:
        self.delivered += 1
        try:
            await deliver()
        except Exception:
            # a receiver rejecting a frame (failed signature check,
            # equivocation raise from the parsigdb) is the transport's
            # per-connection error containment, not a harness failure
            self.receiver_errors += 1


class _RetiredNet:
    """Fan-out sink for a replaced node's old transport endpoint: a
    zombie task of the previous incarnation (a VC flow that unblocked
    post-restart) must not broadcast through the live mesh."""

    _nodes: tuple = ()  # MemParSigEx.broadcast iterates peers for metrics

    async def _fanout(self, *args, **kwargs) -> None:
        return None


class ChaosParSigExNetwork(MemParSigExNetwork):
    def __init__(self, router: ChaosRouter, byz: "ByzantineSigner" = None):
        super().__init__()
        self._router = router
        self._byz = byz

    def retire(self, idx: int) -> None:
        """Silence the CURRENT endpoint at `idx` before a rejoin."""
        if 0 <= idx < len(self._nodes):
            self._nodes[idx]._net = _RetiredNet()

    async def _fanout(self, from_idx: int, duty, pset, nbytes: int = 0):
        psets = [pset]
        if self._byz is not None:
            psets += self._byz.parsigex_extras(from_idx, duty, pset)
        for node in list(self._nodes):
            if node._idx == from_idx:
                continue
            for ps in psets:
                await self._router.route(
                    from_idx, node._idx, PROTO_PARSIGEX,
                    lambda node=node, ps=ps: node._receive(
                        duty, ps, from_idx=from_idx, nbytes=nbytes))


class ChaosConsensusNetwork(ConsensusMemNetwork):
    def __init__(self, router: ChaosRouter, byz: "ByzantineSigner" = None):
        super().__init__()
        self._router = router
        self._byz = byz

    def register(self, node) -> None:
        # replace-on-rejoin: a restarted node's consensus takes over its
        # peer index instead of double-registering
        self._nodes = [n for n in self._nodes
                       if n._peer_idx != node._peer_idx]
        self._nodes.append(node)

    async def broadcast(self, duty, msg) -> None:
        frm = msg.source
        variants = None
        if self._byz is not None:
            variants = self._byz.consensus_variants(
                frm, duty, msg, [n._peer_idx for n in self._nodes])
        for node in list(self._nodes):
            to = node._peer_idx
            m = msg if variants is None else variants.get(to, msg)
            if to == frm:
                # QBFT self-delivery never crosses the network, but a
                # down node delivers nothing at all
                if frm not in self._router.down:
                    await node._deliver(duty, m)
                continue
            await self._router.route(
                frm, to, PROTO_CONSENSUS,
                lambda node=node, m=m: node._deliver(duty, m))


class ByzantineSigner:
    """Crafts the scripted adversary's artefacts.

    Equivocations are VALIDLY SIGNED with the byzantine node's real share
    key over a conflicting message root — pinning runs after signature
    verification (core/parsigex.py), so an invalidly-signed "equivocation"
    would never reach the detector and would test nothing."""

    def __init__(self, plan: FaultPlan, cluster, rng: random.Random):
        self._plan = plan
        self._cluster = cluster
        self._rng = rng
        self.equivocating_psets = 0
        self.garbage_psets = 0
        self.conflicting_preprepares = 0

    def _share_key(self, node0: int, group_pk):
        return self._cluster.share_privkey_map(node0 + 1)[group_pk]

    # -- parsigex ----------------------------------------------------------

    def parsigex_extras(self, from_idx: int, duty, pset) -> list:
        kinds = self._plan.byz_kinds(from_idx, duty.slot)
        out = []
        if BYZ_EQUIVOCATE in kinds and duty.type == DutyType.ATTESTER:
            alt = self._conflicting_pset(from_idx, duty, pset)
            if alt:
                out.append(alt)
                self.equivocating_psets += 1
        if BYZ_GARBAGE in kinds:
            out.append(self._garbage_pset(pset))
            self.garbage_psets += 1
        return out

    def _conflicting_pset(self, node0: int, duty, pset):
        alt = {}
        for group_pk, psig in pset.items():
            data = psig.data
            if not isinstance(data, core_types.SignedAttestation):
                continue
            att = data.attestation
            new_root = hashlib.sha256(
                b"chaos-equivocate" + att.data.beacon_block_root).digest()
            new_data = att.data.replace(beacon_block_root=new_root)
            root = signing_root(DomainName.BEACON_ATTESTER,
                                new_data.hash_tree_root(), FORK, GVR)
            sig = tbls.sign(self._share_key(node0, group_pk), root)
            alt[group_pk] = ParSignedData(
                data=core_types.SignedAttestation(
                    att.replace(data=new_data, signature=sig)),
                share_idx=psig.share_idx)
        return alt or None

    def _garbage_pset(self, pset):
        # parses fine, fails signature verification — must be rejected
        # WITHOUT minting equivocation evidence (pin-after-verify)
        alt = {}
        for group_pk, psig in pset.items():
            bad = bytes(self._rng.getrandbits(8) for _ in range(96))
            alt[group_pk] = ParSignedData(data=psig.data.set_signature(bad),
                                          share_idx=psig.share_idx)
        return alt

    # -- consensus ---------------------------------------------------------

    def consensus_variants(self, frm: int, duty, msg, peer_indices):
        """For a byzantine leader's PRE-PREPARE: send the honest value to
        half the peers and a validly-shaped conflicting value to the other
        half.  Returns {peer: alternate Msg} or None."""
        if msg.type != qbft.MsgType.PRE_PREPARE:
            return None
        if BYZ_PREPREPARE not in self._plan.byz_kinds(frm, duty.slot):
            return None
        alt_value = self._perturb_value(msg.value)
        if alt_value is None:
            return None
        others = sorted(p for p in peer_indices if p != frm)
        half = others[len(others) // 2:]
        self.conflicting_preprepares += 1
        alt = dataclasses.replace(msg, value=alt_value)
        return {p: alt for p in half}

    def _perturb_value(self, value):
        if not isinstance(value, tuple):
            return None
        out, changed = [], False
        for item in value:
            if (not changed and isinstance(item, tuple) and len(item) == 2
                    and isinstance(item[1], core_types.AttestationDataUD)):
                pk, ud = item
                nr = hashlib.sha256(
                    b"chaos-byz" + ud.data.beacon_block_root).digest()
                item = (pk, core_types.AttestationDataUD(
                    data=ud.data.replace(beacon_block_root=nr), duty=ud.duty))
                changed = True
            out.append(item)
        return tuple(out) if changed else None


class MeshLinkFaults:
    """`TCPMesh(faults=...)` adapter: drives the mesh's dial/send hooks
    from the same FaultPlan + seeded rng (drop → ConnectionError, latency
    → sim-time sleep), so the TCP transport sits behind the identical
    fault schedule as the in-memory simnet."""

    def __init__(self, plan: FaultPlan, rng: random.Random, self_index: int,
                 slot_duration: float):
        self._plan = plan
        self._rng = rng
        self._self = self_index
        self._dur = slot_duration

    def _slot(self) -> int:
        return max(0, int(asyncio.get_running_loop().time() // self._dur))

    async def on_dial(self, peer_index: int) -> None:
        ok, delay = link_gate(self._plan, self._rng, self._slot(),
                              self._self, peer_index, "*")
        if not ok:
            raise ConnectionError(f"chaos: dial {peer_index} blacked out")
        if delay > 0.0:
            await asyncio.sleep(delay)

    async def on_send(self, peer_index: int, protocol: str,
                      nbytes: int) -> None:
        ok, delay = link_gate(self._plan, self._rng, self._slot(),
                              self._self, peer_index, "*")
        if not ok:
            raise ConnectionError(f"chaos: frame to {peer_index} dropped")
        if delay > 0.0:
            await asyncio.sleep(delay)


# ---------------------------------------------------------------------------
# Scenario + result
# ---------------------------------------------------------------------------

@dataclass
class Scenario:
    name: str
    slots: int
    plan_fn: Callable[["Scenario", random.Random], FaultPlan]
    description: str = ""
    n_nodes: int = 4
    threshold: int = 3
    n_vals: int = 2
    slot_duration: float = 1.0
    spe: int = 8
    round_timeout_base: float = 0.75
    round_timeout_inc: float = 0.25
    #: telemetry-truth expectations
    min_equivocations: int = 0       # per expected byz share, per observer
    expect_late_phase: Optional[str] = None
    min_late: int = 1
    check_participation: bool = False
    #: garbage consensus frames injected alongside BYZ_GARBAGE psets
    garbage_consensus: bool = False


class ChaosFailure(AssertionError):
    """Assertion failure carrying the exact replay recipe."""

    def __init__(self, scenario: str, seed: int, plan: FaultPlan,
                 message: str, scheme: str = "insecure-test"):
        self.scenario = scenario
        self.seed = seed
        self.plan = plan
        flag = "" if scheme == "insecure-test" else f" --tbls-scheme {scheme}"
        super().__init__(
            f"[chaos:{scenario}] {message}\n"
            f"  replay: python -m charon_tpu_torch.testutil.chaos "
            f"--scenario {scenario} --seed {seed}{flag}\n"
            f"  {plan.describe()}")


@dataclass
class ChaosResult:
    scenario: str
    seed: int
    plan: FaultPlan
    slots: int
    healthy_slots: set
    #: (slot, committee_index, hex-root-prefix, verifying group pk) per
    #: attestation that reached the beacon mock
    attestations: list = field(default_factory=list)
    #: (node, slot, duty_type) -> decided value (first decision)
    decisions: dict = field(default_factory=dict)
    #: (node, slot, duty_type, pubkey) -> group signature hex
    aggregates: dict = field(default_factory=dict)
    safety_violations: list = field(default_factory=list)
    #: node -> tracker DutyReport list (final incarnation)
    reports: dict = field(default_factory=dict)
    #: node -> {peer label -> equivocation count}
    equivocations: dict = field(default_factory=dict)
    #: node -> {phase -> late-duty count}
    late_duties: dict = field(default_factory=dict)
    #: node -> {peer label -> participation ratio gauge}
    participation: dict = field(default_factory=dict)
    router_stats: dict = field(default_factory=dict)
    byz_stats: dict = field(default_factory=dict)

    def fingerprint(self) -> str:
        """Digest of everything the assertions look at — two runs with
        the same (seed, plan) must produce the same fingerprint."""
        h = hashlib.sha256()
        for att in self.attestations:
            h.update(repr(att).encode())
        for key in sorted(self.decisions):
            h.update(repr((key, self.decisions[key])).encode())
        for key in sorted(self.aggregates):
            h.update(repr((key, self.aggregates[key])).encode())
        for node in sorted(self.reports):
            for r in self.reports[node]:
                h.update(repr((node, r.duty.slot, int(r.duty.type),
                               r.success,
                               int(r.failed_step) if r.failed_step is not None
                               else -1,
                               sorted(r.participation.items()))).encode())
        h.update(repr(sorted((n, sorted(d.items()))
                             for n, d in self.equivocations.items())).encode())
        h.update(repr(sorted((n, sorted(d.items()))
                             for n, d in self.late_duties.items())).encode())
        h.update(repr(sorted(self.router_stats.items())).encode())
        return h.hexdigest()


def metric_value(reg: Registry, name: str, labels: dict | None = None,
                 default: float = 0.0) -> float:
    """Read one counter/gauge series (test/assertion helper)."""
    key = reg._key(name, labels)
    with reg._lock:
        if key in reg._counters:
            return reg._counters[key]
        return reg._gauges.get(key, default)


def metric_label_values(reg: Registry, name: str,
                        label: str) -> dict[str, float]:
    """All series of a counter/gauge family, keyed by one label's value."""
    out: dict[str, float] = {}
    with reg._lock:
        for (mname, lbls), v in list(reg._counters.items()) + list(
                reg._gauges.items()):
            if mname != name:
                continue
            for k, lv in lbls:
                if k == label:
                    out[lv] = out.get(lv, 0.0) + v
    return out


# ---------------------------------------------------------------------------
# Harness
# ---------------------------------------------------------------------------

#: Duty-data read methods subject to BeaconFault injection (submissions
#: and liveness probes pass through untouched).
_BEACON_READ_METHODS = frozenset((
    "spec", "genesis_time", "genesis_validators_root", "active_validators",
    "attester_duties", "proposer_duties", "sync_duties", "attestation_data",
))


class _FlakyBeacon:
    """Duck-typed beacon-client wrapper that injects the plan's
    BeaconFault into duty-data reads: optional stall plus scripted
    failures (503) on faulted slots.  Deterministic per (seed, node)."""

    def __init__(self, inner, plan: FaultPlan, rng: random.Random,
                 slot_of) -> None:
        self._inner = inner
        self._plan = plan
        self._rng = rng
        self._slot_of = slot_of
        self.injected = 0

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        attr = getattr(self._inner, name)
        if name not in _BEACON_READ_METHODS or not callable(attr):
            return attr

        async def faulted(*args, **kwargs):
            bf = self._plan.beacon_fault(self._slot_of())
            if bf is not None:
                if bf.latency > 0:
                    await asyncio.sleep(bf.latency)
                if bf.mode == BEACON_ERROR or (
                        bf.mode == BEACON_FLAKY
                        and self._rng.random() < bf.rate):
                    self.injected += 1
                    raise BeaconApiError(503, "injected beacon fault",
                                         f"bmock/{name}")
            return await attr(*args, **kwargs)

        return faulted


class _NodeSlot:
    """Mutable holder for one cluster position (survives restarts)."""

    def __init__(self) -> None:
        self.node: Node | None = None
        self.vmock: ValidatorMock | None = None
        self.consensus: QBFTConsensus | None = None
        self.parsigex = None
        self.registry: Registry | None = None


class ChaosHarness:
    """`scheme` is the tbls scheme of the run: ``insecure-test`` (the JAX
    harness's) or ``bls`` (the default tbls backend: the card).  `pipe`
    is the run's one inline dispatch pipeline, every node's
    `dispatcher`."""

    def __init__(self, scenario: Scenario, seed: int = 0,
                 scheme: str = "insecure-test"):
        if scheme not in ("bls", "insecure-test"):
            raise ValueError(f"unknown tbls scheme {scheme!r}")
        self.scenario = scenario
        self.seed = seed
        self.scheme = scheme
        self.pipe: DispatchPipeline | None = None
        self.rng = random.Random(seed)
        self.plan = scenario.plan_fn(scenario, self.rng)
        self.n = scenario.n_nodes
        self.dur = scenario.slot_duration
        self._slots: list[_NodeSlot] = []
        self._loop: SimEventLoop | None = None
        self._decisions: dict = {}
        self._aggregates: dict = {}
        self._safety_violations: list = []
        self._fuzzy = self._transition_slots()
        self._down_intervals = self._compute_down_intervals()

    # -- plan geometry ------------------------------------------------------

    def _transition_slots(self) -> set:
        bounds: list[int] = []
        for p in self.plan.partitions:
            bounds += [p.start_slot, p.end_slot]
        for lf in self.plan.links:
            bounds += [lf.start_slot, lf.end_slot]
        for c in self.plan.crashes:
            bounds.append(c.slot)
            if c.down_for is not None:
                bounds.append(int((c.slot * self.dur + c.at + c.down_for)
                                  // self.dur))
        for r in self.plan.restarts:
            bounds.append(r.slot)
        out: set[int] = set()
        for b in bounds:
            out |= {b - 1, b, b + 1}
        return out

    def _compute_down_intervals(self) -> dict[int, list]:
        out: dict[int, list] = {i: [] for i in range(self.n)}
        for c in self.plan.crashes:
            t0 = c.slot * self.dur + c.at
            t1 = t0 + c.down_for if c.down_for is not None else float("inf")
            out[c.node].append((t0, t1))
        for r in self.plan.restarts:
            t0 = r.slot * self.dur + r.at
            out[r.node].append((t0, t0 + 0.05))
        return out

    def _down_overlaps_slot(self, node: int, slot: int) -> bool:
        a, b = slot * self.dur, (slot + 2) * self.dur
        return any(t0 < b and t1 > a for t0, t1 in self._down_intervals[node])

    def healthy_slots(self) -> set:
        """Slots whose attester duty MUST complete: a quorum-sized group
        of up, mutually-connected (consensus AND parsigex) nodes existed
        for the whole duty window.  ±1-slot margins around every fault
        transition are excluded; the catalogue's plans all keep a quorum,
        so this is `all slots − transitions − down-windows that shrink
        the best group below threshold`."""
        import itertools

        need = max(self.scenario.threshold, qbft_quorum(self.n))
        healthy = set()
        for slot in range(1, self.scenario.slots - 1):
            if slot in self._fuzzy:
                continue
            up = [i for i in range(self.n)
                  if not self._down_overlaps_slot(i, slot)]

            def pair_open(i: int, j: int) -> bool:
                # only statically-OPEN counts: an undecidable link
                # (probabilistic loss, heavy latency) must not put a
                # slot into the must-complete set — one unlucky drop
                # would then read as a liveness violation
                return (self._link_open(slot, i, j) is True
                        and self._link_open(slot, j, i) is True)

            # mutual connectivity means a CLIQUE, not a star around one
            # pivot (a hub node reaching two mutually-cut spokes is not a
            # quorum that can exchange prepares); n is single-digit, so
            # exhaustive subsets are fine
            if any(all(pair_open(i, j) for i, j in
                       itertools.combinations(group, 2))
                   for group in itertools.combinations(up, need)):
                healthy.add(slot)
        return healthy

    def _link_open(self, slot: int, a: int, b: int,
                   proto: str = "*") -> Optional[bool]:
        """True = statically open, False = statically cut, None = not
        statically decidable (probabilistic loss or heavy latency)."""
        if a == b:
            return True
        if self.plan.blocked(slot, a, b):
            return False
        protos = ([PROTO_CONSENSUS, PROTO_PARSIGEX] if proto == "*"
                  else [proto])
        verdict: Optional[bool] = True
        for p in protos:
            lf = self.plan.link(slot, a, b, p)
            if lf is None:
                continue
            if lf.drop >= 1.0:
                return False
            if lf.drop > 0.0 or lf.latency + lf.jitter > 0.4 * self.dur:
                verdict = None
        return verdict

    # -- cluster build ------------------------------------------------------

    def _clock_for(self, idx: int):
        skew = self.plan.skew_of(idx)
        loop = self._loop

        def clock() -> float:
            return loop.time() + skew

        return clock

    def _install_bmock_overrides(self, bmock: BeaconMock) -> None:
        """Every validator attests EVERY slot (dense liveness signal);
        proposer/sync families are disabled so participation accounting
        is exactly the attester partial-exchange schedule."""

        async def attester_duties(epoch, indices):
            by_index = {v.index: v for v in bmock.validators.values()}
            out = []
            for idx in sorted(indices):
                v = by_index.get(idx)
                if v is None:
                    continue
                for s in range(bmock.slots_per_epoch):
                    slot = epoch * bmock.slots_per_epoch + s
                    out.append(AttesterDutyInfo(
                        pubkey=v.pubkey, validator_index=idx, slot=slot,
                        committee_index=idx % 4, committee_length=8,
                        committees_at_slot=4,
                        validator_committee_index=idx % 8))
            return out

        async def no_duties(epoch, indices):
            return []

        bmock.overrides["attester_duties"] = attester_duties
        bmock.overrides["proposer_duties"] = no_duties
        bmock.overrides["sync_duties"] = no_duties

    def _build_node(self, idx: int, slot_holder: _NodeSlot,
                    dutydb=None, aggsigdb=None) -> None:
        scn = self.scenario
        clk = self._clock_for(idx)
        reg = slot_holder.registry
        consensus = QBFTConsensus(
            self.qnet, idx, self.n,
            round_timeout_base=scn.round_timeout_base,
            round_timeout_inc=scn.round_timeout_inc,
            registry=reg, clock=clk)
        parsigex = self.psx_net.join(registry=reg, idx=(
            idx if idx < len(self.psx_net._nodes) else None))
        cfg = NodeConfig(share_idx=idx + 1, threshold=scn.threshold,
                         pubshares_by_peer=self.pubshares_by_peer,
                         fork_version=FORK)
        eth2cl = self.bmock
        if self.plan.beacon:
            flaky = _FlakyBeacon(
                self.bmock, self.plan,
                rng=random.Random((self.seed * 1000003) ^ (idx + 1)),
                slot_of=self.router.slot_now)
            eth2cl = CachingBeaconClient(
                flaky, clock=clk, retries=8, retry_base=0.02,
                rng=random.Random((self.seed * 7919) ^ (idx + 1)),
                slot_duration=self.dur, slots_per_epoch=scn.spe,
                genesis_time=0.0)
        node = Node(cfg, eth2cl, consensus=consensus, parsigex=parsigex,
                    slots_per_epoch=scn.spe, genesis_time=0.0,
                    slot_duration=self.dur, registry=reg, clock=clk,
                    dutydb=dutydb, aggsigdb=aggsigdb, probes=False,
                    fetched_types=(DutyType.ATTESTER,),
                    dispatcher=self.pipe)
        vmock = ValidatorMock(node.vapi,
                              self.cluster.share_privkey_map(idx + 1),
                              FORK, slots_per_epoch=scn.spe,
                              eth2cl=eth2cl)
        node.scheduler.subscribe_slots(vmock.on_slot)
        self._watch(idx, node, consensus)
        slot_holder.node = node
        slot_holder.vmock = vmock
        slot_holder.consensus = consensus
        slot_holder.parsigex = parsigex

    def _watch(self, idx: int, node: Node, consensus: QBFTConsensus) -> None:
        async def on_decide(duty, unsigned):
            key = (idx, duty.slot, int(duty.type))
            val = tuple(sorted(unsigned.items(), key=lambda kv: kv[0]))
            prev = self._decisions.setdefault(key, val)
            if prev != val:
                self._safety_violations.append(
                    f"node {idx} decided twice differently for {duty}")

        consensus.subscribe(on_decide)

        async def on_agg(duty, pubkey, signed):
            key = (idx, duty.slot, int(duty.type), pubkey)
            sig = signed.signature.hex()
            prev = self._aggregates.setdefault(key, sig)
            if prev != sig:
                self._safety_violations.append(
                    f"node {idx} stored two aggregates for {duty}/{pubkey}")

        node.sigagg.subscribe(on_agg)

    # -- fault driver -------------------------------------------------------

    def _take_down(self, idx: int) -> None:
        holder = self._slots[idx]
        self.router.down.add(idx)
        holder.node.stop()
        for task in list(holder.consensus._tasks.values()):
            task.cancel()

    async def _bring_up(self, idx: int) -> None:
        old = self._slots[idx]
        self.psx_net.retire(idx)
        # state re-wired from the previous incarnation's duty/agg DBs —
        # the "persistent disk" of the in-memory simnet
        self._build_node(idx, old, dutydb=old.node.dutydb,
                         aggsigdb=old.node.aggsigdb)
        old.node.start()
        self.router.down.discard(idx)

    async def _fault_driver(self) -> None:
        events: list[tuple[float, int, str, int]] = []
        seq = 0
        for c in self.plan.crashes:
            t0 = c.slot * self.dur + c.at
            events.append((t0, seq, "down", c.node))
            seq += 1
            if c.down_for is not None:
                events.append((t0 + c.down_for, seq, "up", c.node))
                seq += 1
        for r in self.plan.restarts:
            events.append((r.slot * self.dur + r.at, seq, "restart", r.node))
            seq += 1
        loop = asyncio.get_running_loop()
        for t, _, kind, node in sorted(events):
            await asyncio.sleep(max(0.0, t - loop.time()))
            if kind == "down":
                self._take_down(node)
            elif kind == "up":
                await self._bring_up(node)
            elif kind == "restart":
                self._take_down(node)
                await self._bring_up(node)

    async def _garbage_consensus_loop(self, node0: int) -> None:
        """Byzantine garbage at the consensus layer: off-round COMMITs
        for near-future duties.  These create input-less instances at
        every honest node BEFORE the real duty fires — the pin for the
        qbft late-binding fix (an early frame must not null the honest
        input and stall the duty)."""
        while True:
            slot = self.router.slot_now()
            if (BYZ_GARBAGE in self.plan.byz_kinds(node0, slot)
                    and slot + 2 < self.scenario.slots):
                duty = Duty(slot + 2, DutyType.ATTESTER)
                msg = qbft.Msg(qbft.MsgType.COMMIT, duty, node0, 7,
                               ("chaos-garbage", slot))
                await self.qnet.broadcast(duty, msg)
            await asyncio.sleep(self.dur)

    # -- run ----------------------------------------------------------------

    def run(self) -> ChaosResult:
        """Build the cluster, drive the scenario on a virtual-time loop,
        collect the result.  Deterministic in (seed, plan): sets the
        harness's tbls scheme and hands every node one inline (thread-free)
        dispatch pipeline for the duration.  Under ``bls`` the default tbls
        backend is resolved first, so a machine without a card fails here
        (RuntimeError naming the device)."""
        prev_scheme = tbls.scheme_name()
        tbls.set_scheme(self.scheme)
        self.pipe = DispatchPipeline(inline=True)
        try:
            if self.scheme == "bls":
                tbls.backend_name()
            return run_sim(self._main())
        finally:
            self.pipe.shutdown()
            tbls.set_scheme(prev_scheme)

    async def _main(self) -> ChaosResult:
        scn = self.scenario
        self._loop = asyncio.get_running_loop()
        self.cluster = new_cluster_for_test(scn.threshold, self.n,
                                            scn.n_vals)
        self.bmock = BeaconMock(slot_duration=self.dur,
                                slots_per_epoch=scn.spe, genesis_time=0.0)
        for v in self.cluster.validators:
            self.bmock.add_validator(v.group_pubkey)
        self._install_bmock_overrides(self.bmock)
        self.pubshares_by_peer = {
            i: self.cluster.pubshare_map(i) for i in range(1, self.n + 1)}

        self.router = ChaosRouter(self.plan, self.rng, self.dur)
        self.byz = ByzantineSigner(self.plan, self.cluster, self.rng)
        self.psx_net = ChaosParSigExNetwork(self.router, self.byz)
        self.qnet = ChaosConsensusNetwork(self.router, self.byz)

        for idx in range(self.n):
            holder = _NodeSlot()
            holder.registry = Registry(const_labels={"node": f"node{idx}"})
            self._slots.append(holder)
            self._build_node(idx, holder)
        for holder in self._slots:
            holder.node.start()

        driver = self._loop.create_task(self._fault_driver())
        garbage_tasks = []
        if scn.garbage_consensus:
            for b in self.plan.byzantine:
                if b.kind == BYZ_GARBAGE:
                    garbage_tasks.append(self._loop.create_task(
                        self._garbage_consensus_loop(b.node)))

        # scenario window, then quiesce scheduling, then cooldown so the
        # deadliner analyses every duty (deadline = 5 slots)
        await asyncio.sleep(scn.slots * self.dur + 0.01)
        for holder in self._slots:
            holder.node.scheduler.stop()
        await asyncio.sleep((LATE_FACTOR + 2) * self.dur)

        driver.cancel()
        for t in garbage_tasks:
            t.cancel()
        for holder in self._slots:
            holder.node.stop()
        await asyncio.sleep(0)

        return await self._collect()

    async def _verified_keys(self, atts) -> list:
        """Per attestation, the first validator (cluster order) whose group
        key verifies its signature, else None — the JAX harness's
        `tbls.verify` loop as ONE deduplicated batch through the run's
        pipeline (on the card a device verify may not run on the loop
        thread outside a pipeline stage)."""
        rows = []
        for att in atts:
            root = signing_root(DomainName.BEACON_ATTESTER,
                                att.data.hash_tree_root(), FORK, GVR)
            rows.append([(v.tss.group_pubkey, root, att.signature)
                         for v in self.cluster.validators])
        entries = list(dict.fromkeys(e for row in rows for e in row))
        oks = await self.pipe.batch_verify(entries) if entries else []
        verdict = dict(zip(entries, oks))
        out = []
        for row in rows:
            out.append(next((v.group_pubkey for v, e in
                             zip(self.cluster.validators, row)
                             if verdict[e]), None))
        return out

    async def _collect(self) -> ChaosResult:
        res = ChaosResult(scenario=self.scenario.name, seed=self.seed,
                          plan=self.plan, slots=self.scenario.slots,
                          healthy_slots=self.healthy_slots())
        atts = list(self.bmock.attestations)
        for att, verified_pk in zip(atts, await self._verified_keys(atts)):
            res.attestations.append(
                (att.data.slot, att.data.index,
                 att.data.beacon_block_root.hex()[:16], verified_pk))
        res.decisions = dict(self._decisions)
        res.aggregates = dict(self._aggregates)
        res.safety_violations = list(self._safety_violations)
        for idx, holder in enumerate(self._slots):
            reg = holder.registry
            if holder.node.tracker is not None:
                res.reports[idx] = list(holder.node.tracker.reports)
            res.equivocations[idx] = metric_label_values(
                reg, "core_parsigex_equivocations_total", "peer")
            res.late_duties[idx] = metric_label_values(
                reg, "core_slot_late_duties_total", "phase")
            res.participation[idx] = metric_label_values(
                reg, "charon_tpu_tracker_participation", "peer")
        res.router_stats = {
            "delivered": self.router.delivered,
            "dropped": self.router.dropped,
            "delayed": self.router.delayed,
            "receiver_errors": self.router.receiver_errors,
        }
        res.byz_stats = {
            "equivocating_psets": self.byz.equivocating_psets,
            "garbage_psets": self.byz.garbage_psets,
            "conflicting_preprepares": self.byz.conflicting_preprepares,
        }
        return res

    # -- assertions ---------------------------------------------------------

    def _fail(self, message: str) -> None:
        raise ChaosFailure(self.scenario.name, self.seed, self.plan, message,
                           scheme=self.scheme)

    def check(self, res: ChaosResult) -> None:
        self.check_liveness(res)
        self.check_safety(res)
        self.check_telemetry(res)

    def check_liveness(self, res: ChaosResult) -> None:
        """Every healthy slot's attestation reached the beacon mock with
        a valid group signature for EVERY validator."""
        got = {(slot, pk) for slot, _, _, pk in res.attestations
               if pk is not None}
        missing = []
        for slot in sorted(res.healthy_slots):
            for v in self.cluster.validators:
                if (slot, v.group_pubkey) not in got:
                    missing.append((slot, v.group_pubkey[:18]))
        if missing:
            self._fail(
                f"liveness: {len(missing)} healthy (slot, validator) duties "
                f"never produced a verified attestation; first 5: "
                f"{missing[:5]} (healthy slots: {len(res.healthy_slots)}, "
                f"attestations: {len(res.attestations)})")
        bad_sig = [a for a in res.attestations if a[3] is None]
        if bad_sig:
            self._fail(f"liveness: {len(bad_sig)} broadcast attestations "
                       f"carry signatures verifying under NO group key: "
                       f"{bad_sig[:3]}")

    def check_safety(self, res: ChaosResult) -> None:
        if res.safety_violations:
            self._fail("safety: " + "; ".join(res.safety_violations[:5]))
        by_duty: dict = {}
        for (node, slot, dtype), val in res.decisions.items():
            by_duty.setdefault((slot, dtype), {})[node] = val
        for key, by_node in sorted(by_duty.items()):
            vals = set(by_node.values())
            if len(vals) > 1:
                self._fail(f"safety: conflicting consensus decisions for "
                           f"duty {key}: nodes {sorted(by_node)} decided "
                           f"{len(vals)} distinct values")
        by_agg: dict = {}
        for (node, slot, dtype, pk), sig in res.aggregates.items():
            by_agg.setdefault((slot, dtype, pk), {})[node] = sig
        for key, by_node in sorted(by_agg.items()):
            if len(set(by_node.values())) > 1:
                self._fail(f"safety: nodes disagree on the aggregate "
                           f"signature for {key[:2]}")

    def check_telemetry(self, res: ChaosResult) -> None:
        self._check_equivocation_truth(res)
        if self.scenario.expect_late_phase is not None:
            self._check_late_blame(res)
        if self.scenario.check_participation:
            self._check_participation(res)

    def _check_equivocation_truth(self, res: ChaosResult) -> None:
        byz_nodes = self.plan.byz_equivocator_nodes()
        byz_shares = {str(b + 1) for b in byz_nodes}
        for idx, counts in res.equivocations.items():
            for peer, count in counts.items():
                if count > 0 and peer not in byz_shares:
                    self._fail(
                        f"telemetry: node {idx} counted {count} "
                        f"equivocations against HONEST share {peer}")
        min_needed = self.scenario.min_equivocations
        if min_needed > 0:
            for idx in range(self.n):
                if idx in byz_nodes or self._down_intervals[idx]:
                    continue
                for share in sorted(byz_shares):
                    got = res.equivocations.get(idx, {}).get(share, 0.0)
                    if got < min_needed:
                        self._fail(
                            f"telemetry: node {idx} counted only {got} "
                            f"equivocations for byzantine share {share} "
                            f"(expected ≥ {min_needed})")

    def _check_late_blame(self, res: ChaosResult) -> None:
        expect = self.scenario.expect_late_phase
        for idx in range(self.n):
            counts = res.late_duties.get(idx, {})
            got = counts.get(expect, 0.0)
            if got < self.scenario.min_late:
                self._fail(
                    f"telemetry: node {idx} late-duty watchdog blamed "
                    f"'{expect}' only {got} times (expected ≥ "
                    f"{self.scenario.min_late}); full blame counts: "
                    f"{counts}")
            wrong = {p: c for p, c in counts.items()
                     if p != expect and c > 0}
            if wrong:
                self._fail(
                    f"telemetry: node {idx} blamed uninjected phases "
                    f"{wrong} (injected fault: {expect})")

    def _link_open_window(self, slot: int, a: int, b: int,
                          proto: str) -> Optional[bool]:
        """Link verdict over the duty's whole LIFETIME [slot, deadline]:
        participation counts any partial arriving before the deadline
        (LATE_FACTOR slots), and a cut that heals mid-window lets the
        stalled side catch up via QBFT DECIDED replay and deliver late —
        so only all-open (True) and cut-throughout (False) are statically
        decidable."""
        vals = [self._link_open(s, a, b, proto)
                for s in range(slot, slot + LATE_FACTOR + 1)]
        if all(v is True for v in vals):
            return True
        if all(v is False for v in vals):
            return False
        return None

    def _expected_participation(self, o: int, p: int,
                                slot: int) -> Optional[bool]:
        """Plan-derived ground truth for 'did share p+1 participate in
        slot's attester duty as seen by node o' — None = not statically
        decidable (fault transition, down window, probabilistic fault,
        or a cut healing inside the duty's deadline window)."""
        if slot in self._fuzzy:
            return None
        if (self._down_overlaps_slot(p, slot)
                or self._down_overlaps_slot(o, slot)):
            return None
        # p can only sign if its consensus instance hears a QBFT quorum
        reach_p = 0
        for q in range(self.n):
            open_ = self._link_open_window(slot, q, p, PROTO_CONSENSUS)
            if open_ is None:
                return None
            if open_:
                reach_p += 1
        if reach_p < qbft_quorum(self.n):
            return False
        if o == p:
            return True
        return self._link_open_window(slot, p, o, PROTO_PARSIGEX)

    def _check_participation(self, res: ChaosResult) -> None:
        for idx in range(self.n):
            reports = res.reports.get(idx, [])
            for r in reports:
                if r.duty.type != DutyType.ATTESTER:
                    continue
                if not (0 <= r.duty.slot < self.scenario.slots):
                    continue
                for share, took_part in sorted(r.participation.items()):
                    exp = self._expected_participation(idx, share - 1,
                                                      r.duty.slot)
                    if exp is None:
                        continue
                    if took_part != exp:
                        self._fail(
                            f"telemetry: node {idx} recorded "
                            f"participation[share {share}]={took_part} "
                            f"for slot {r.duty.slot}, but the fault plan "
                            f"says {exp}")
            # the exported gauge must equal the tracker's own counts
            holder = self._slots[idx]
            tracker = holder.node.tracker
            if tracker is None or tracker.duty_total == 0:
                continue
            for share in range(1, self.n + 1):
                want = (tracker.participation_counts[share]
                        / tracker.duty_total)
                got = res.participation.get(idx, {}).get(str(share))
                if got is None or abs(got - want) > 1e-9:
                    self._fail(
                        f"telemetry: node {idx} participation gauge for "
                        f"share {share} is {got}, tracker counted {want}")


# ---------------------------------------------------------------------------
# Scenario catalogue
# ---------------------------------------------------------------------------

def _plan_partition(scn: Scenario, rng: random.Random) -> FaultPlan:
    return FaultPlan(partitions=(
        Partition(10, 26, groups=((0, 1, 2), (3,))),))


def _plan_asymmetric_loss(scn: Scenario, rng: random.Random) -> FaultPlan:
    # node 3 hears everyone; nobody hears node 3 (directed full cut)
    links = tuple(LinkFault(3, t, 8, 22, drop=1.0) for t in (0, 1, 2))
    return FaultPlan(links=links)


def _plan_clock_skew(scn: Scenario, rng: random.Random) -> FaultPlan:
    return FaultPlan(skews=(ClockSkew(2, 0.25),))


def _plan_leader_crash(scn: Scenario, rng: random.Random) -> FaultPlan:
    slot = 15
    leader = duty_leader(Duty(slot, DutyType.ATTESTER), 1, scn.n_nodes)
    return FaultPlan(crashes=(
        Crash(leader, slot, at=0.45, down_for=5 * scn.slot_duration),))


def _plan_node_restart(scn: Scenario, rng: random.Random) -> FaultPlan:
    return FaultPlan(restarts=(Restart(1, 12, at=0.6),))


def _plan_byzantine_equivocation(scn: Scenario,
                                 rng: random.Random) -> FaultPlan:
    return FaultPlan(byzantine=(Byzantine(3, BYZ_EQUIVOCATE, 6, 26),))


def _plan_conflicting_preprepare(scn: Scenario,
                                 rng: random.Random) -> FaultPlan:
    return FaultPlan(byzantine=(Byzantine(0, BYZ_PREPREPARE, 5, 25),))


def _plan_garbage(scn: Scenario, rng: random.Random) -> FaultPlan:
    return FaultPlan(byzantine=(Byzantine(3, BYZ_GARBAGE, 4, 16),))


def _plan_consensus_stall(scn: Scenario, rng: random.Random) -> FaultPlan:
    links = tuple(LinkFault(a, b, 5, 13, latency=0.4, proto=PROTO_CONSENSUS)
                  for a in range(scn.n_nodes) for b in range(scn.n_nodes)
                  if a != b)
    return FaultPlan(links=links)


def _plan_parsigex_stall(scn: Scenario, rng: random.Random) -> FaultPlan:
    links = tuple(LinkFault(a, b, 5, 13, latency=0.8, proto=PROTO_PARSIGEX)
                  for a in range(scn.n_nodes) for b in range(scn.n_nodes)
                  if a != b)
    return FaultPlan(links=links)


def _plan_beacon_flap(scn: Scenario, rng: random.Random) -> FaultPlan:
    return FaultPlan(beacon=(
        BeaconFault(10, 22, mode=BEACON_FLAKY, rate=0.35, latency=0.05),))


def _plan_soak(scn: Scenario, rng: random.Random) -> FaultPlan:
    """Randomised mixed chaos: one fault window at a time (so a quorum
    always survives), drawn from the whole fault vocabulary."""
    parts: list = []
    links: list = []
    crashes: list = []
    restarts: list = []
    byz: list = []
    n, dur = scn.n_nodes, scn.slot_duration
    slot = 5
    while slot < scn.slots - 30:
        kind = rng.choice(["partition", "asym", "equivocate", "crash",
                           "restart", "latency", "none"])
        span = rng.randrange(8, 20)
        node = rng.randrange(n)
        end = slot + span
        if kind == "partition":
            others = tuple(i for i in range(n) if i != node)
            parts.append(Partition(slot, end, (others, (node,))))
        elif kind == "asym":
            links += [LinkFault(node, t, slot, end, drop=1.0)
                      for t in range(n) if t != node]
        elif kind == "equivocate":
            byz.append(Byzantine(node, BYZ_EQUIVOCATE, slot, end))
        elif kind == "crash":
            crashes.append(Crash(node, slot, at=rng.uniform(0.1, 0.9),
                                 down_for=span * dur * 0.6))
        elif kind == "restart":
            restarts.append(Restart(node, slot, at=rng.uniform(0.1, 0.9)))
        elif kind == "latency":
            links += [LinkFault(a, b, slot, end,
                                latency=rng.uniform(0.05, 0.3),
                                jitter=0.05, proto=PROTO_CONSENSUS)
                      for a in range(n) for b in range(n) if a != b]
        slot = end + rng.randrange(6, 12)
    return FaultPlan(partitions=tuple(parts), links=tuple(links),
                     crashes=tuple(crashes), restarts=tuple(restarts),
                     byzantine=tuple(byz))


SCENARIOS: dict[str, Scenario] = {s.name: s for s in (
    Scenario("partition", 40, _plan_partition,
             "symmetric partition isolating one node for 16 slots; the "
             "majority quorum must keep completing duties",
             check_participation=True),
    Scenario("asymmetric_loss", 32, _plan_asymmetric_loss,
             "hard directed cut: node 3's outbound frames vanish while "
             "its inbound path stays up",
             check_participation=True),
    Scenario("clock_skew", 28, _plan_clock_skew,
             "node 2's clock runs 0.25 s ahead; duties still complete "
             "and the skewed node still participates",
             check_participation=True),
    Scenario("leader_crash", 36, _plan_leader_crash,
             "the slot-15 QBFT leader crashes mid-round and revives 5 "
             "slots later; round-change keeps the cluster live",
             check_participation=True),
    Scenario("node_restart", 28, _plan_node_restart,
             "node 1 restarts mid-slot, re-wired from its previous "
             "dutydb/aggsigdb"),
    Scenario("byzantine_equivocation", 32, _plan_byzantine_equivocation,
             "node 3 signs conflicting attester partials for 20 slots; "
             "detection must hit exactly share 4, never honest shares",
             min_equivocations=30),
    Scenario("conflicting_preprepare", 32, _plan_conflicting_preprepare,
             "byzantine leader sends different PRE-PREPARE values to "
             "each half of the cluster; safety must hold",),
    Scenario("garbage", 24, _plan_garbage,
             "byzantine node floods garbage partials and off-round "
             "consensus frames; nothing counts as equivocation and "
             "duties still complete", garbage_consensus=True),
    Scenario("consensus_stall", 20, _plan_consensus_stall,
             "0.4 s consensus-link latency for 8 slots; the late-duty "
             "watchdog must blame the consensus phase and nothing else",
             expect_late_phase="consensus", min_late=3),
    Scenario("parsigex_stall", 20, _plan_parsigex_stall,
             "0.8 s parsigex-link latency for 8 slots; the late-duty "
             "watchdog must blame the parsig_ex phase and nothing else",
             expect_late_phase="parsig_ex", min_late=3),
    Scenario("beacon_flap", 32, _plan_beacon_flap,
             "upstream beacon API flaps (35% error rate + 50 ms stall) "
             "for 12 slots; the serving cache + single-flight retry "
             "layer absorbs it and every duty still completes",
             check_participation=True),
    Scenario("soak", 1200, _plan_soak,
             "randomised mixed chaos soak (slow lane): the whole fault "
             "vocabulary over 1200 slots"),
)}

#: the tier-1 deterministic subset (the soak rides the slow lane)
FAST_SCENARIOS = tuple(n for n in SCENARIOS if n != "soak")


def run_scenario(name: str, seed: int = 0, slots: int | None = None,
                 scheme: str = "insecure-test") -> ChaosResult:
    """Run one catalogue scenario and its assertions; raises ChaosFailure
    (with the replay recipe) on any violated property."""
    scn = SCENARIOS[name]
    if slots is not None:
        scn = dataclasses.replace(scn, slots=slots)
    harness = ChaosHarness(scn, seed=seed, scheme=scheme)
    res = harness.run()
    harness.check(res)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m charon_tpu_torch.testutil.chaos",
        description="deterministic chaos simnet: run a fault-injection "
                    "scenario and check liveness/safety/telemetry-truth")
    p.add_argument("--scenario", default="fast",
                   help="catalogue name, 'fast' (all but the soak) or "
                        "'all'")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--slots", type=int, default=None,
                   help="override the scenario's slot count")
    p.add_argument("--list", action="store_true", dest="list_scenarios")
    p.add_argument("--tbls-scheme", default="insecure-test",
                   choices=["insecure-test", "bls"],
                   help="bls verifies and combines on the card")
    args = p.parse_args(argv)

    if args.list_scenarios:
        for name, scn in SCENARIOS.items():
            print(f"{name:26s} slots={scn.slots:<5d} {scn.description}")
        return 0

    if args.scenario == "fast":
        names = list(FAST_SCENARIOS)
    elif args.scenario == "all":
        names = list(SCENARIOS)
    elif args.scenario in SCENARIOS:
        names = [args.scenario]
    else:
        print(f"unknown scenario {args.scenario!r}; --list shows the "
              f"catalogue", file=sys.stderr)
        return 2

    if args.tbls_scheme == "bls":
        # the card's backend, resolved before any scenario: with no card,
        # stop here naming the device (nothing falls back to the CPU)
        prev = tbls.scheme_name()
        tbls.set_scheme("bls")
        try:
            tbls.backend_name()
        except RuntimeError as exc:
            print(f"error: chaos: {exc}", file=sys.stderr)
            return 1
        finally:
            tbls.set_scheme(prev)

    rc = 0
    for name in names:
        try:
            res = run_scenario(name, seed=args.seed, slots=args.slots,
                               scheme=args.tbls_scheme)
        except ChaosFailure as exc:
            print(f"FAIL {name}\n{exc}", file=sys.stderr)
            rc = 1
        else:
            print(f"PASS {name:26s} slots={res.slots:<5d} seed={res.seed} "
                  f"healthy={len(res.healthy_slots)} "
                  f"attestations={len(res.attestations)} "
                  f"fingerprint={res.fingerprint()[:16]}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
