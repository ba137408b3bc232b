"""QBFT — dependency-free implementation of the IBFT-2.0/QBFT consensus
algorithm (Moniz, https://arxiv.org/pdf/2002.03613.pdf).

Re-creation of the reference's standalone module (reference: core/qbft/
qbft.go:31-770): same message types, upon-rules, explicit justifications and
quorum math (⌈2n/3⌉, tolerating ⌊(n−1)/3⌋ byzantine peers); rebuilt on
asyncio with frozen dataclass messages.  Like the reference, this module
depends on NOTHING else in the framework — transports and leader election
are injected (core/qbft/README.md design rule).

Algorithm notes mirrored from the reference:
- PRE-PREPARE for round 1 is implicitly justified; later rounds carry a
  justified quorum of ROUND-CHANGEs (J1 null / J2 highest-prepared).
- PREPARE/COMMIT only count for the current round; quorums are per
  (round, value) with one vote per process.
- ROUND-CHANGE above the current round triggers a jump once F+1 processes
  are ahead; at the current round, the new leader re-proposes the highest
  prepared value (or the input if none).
- After deciding, the instance keeps answering ROUND-CHANGEs with DECIDED
  (+ quorum COMMIT justification) so laggards catch up.

A copy of the JAX package's core/qbft.py, whole: the same messages,
upon-rules and pure justification functions (the port imports nothing of
that package; tests/test_torch_qbft.py holds the two against each other).
"""

from __future__ import annotations

import asyncio
import math
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, Awaitable, Callable, Optional


class MsgType(IntEnum):
    PRE_PREPARE = 1
    PREPARE = 2
    COMMIT = 3
    ROUND_CHANGE = 4
    DECIDED = 5


class UponRule(IntEnum):
    NOTHING = 0
    JUSTIFIED_PRE_PREPARE = 1
    QUORUM_PREPARES = 2
    QUORUM_COMMITS = 3
    UNJUST_QUORUM_ROUND_CHANGES = 4
    F_PLUS_1_ROUND_CHANGES = 5
    QUORUM_ROUND_CHANGES = 6
    JUSTIFIED_DECIDED = 7
    ROUND_TIMEOUT = 8


@dataclass(frozen=True)
class Msg:
    """One consensus message.  `value`/`prepared_value` must be hashable;
    None is the zero value.

    `sig` is opaque to the algorithm: the p2p transport signs each outgoing
    message with the node's identity key and verifies inbound ones —
    including every message embedded in `justification`, which peers relay
    and could otherwise forge (reference: core/consensus/component.go:343-353
    ECDSA-signs/verifies messages the same way)."""

    type: MsgType
    instance: Any
    source: int
    round: int
    value: Any = None
    prepared_round: int = 0
    prepared_value: Any = None
    justification: tuple = ()
    sig: bytes = b""

    def signing_payload(self) -> "Msg":
        """The message with signature and justification stripped — what the
        identity signature covers (justification entries carry their own
        signatures)."""
        return Msg(self.type, self.instance, self.source, self.round,
                   self.value, self.prepared_round, self.prepared_value)


@dataclass
class Definition:
    """Consensus-system parameters external to the algorithm
    (reference: qbft.go:44-66)."""

    is_leader: Callable[[Any, int, int], bool]
    round_timeout: Callable[[int], float]  # seconds for a round
    nodes: int
    decide: Optional[Callable[[Any, Any, tuple], Awaitable[None]]] = None
    fifo_limit: int = 1000
    on_rule: Optional[Callable[..., None]] = None  # debug/sniffer hook

    @property
    def quorum(self) -> int:
        return math.ceil(self.nodes * 2 / 3)

    @property
    def faulty(self) -> int:
        return (self.nodes - 1) // 3


class Transport:
    """Abstract transport: broadcast must deliver to ALL processes including
    the sender (reference: qbft.go:31-41)."""

    def __init__(self, broadcast, receive: asyncio.Queue):
        self.broadcast = broadcast  # async fn(Msg)
        self.receive = receive


class InstanceCancelled(Exception):
    pass


async def run(d: Definition, t: Transport, instance: Any, process: int,
              input_value: Any) -> Any:
    """Run one consensus instance.  Decision is delivered via d.decide;
    after deciding the loop keeps serving DECIDED to round-changing
    laggards.  Runs until cancelled, exactly like the reference's
    qbft.Run-until-ctx-done contract.

    `input_value=None` means "participate but cannot lead": the process
    votes/commits on others' proposals but skips its own PRE-PREPARE when
    leader with nothing justified (peers round-change past it).  This lets
    a node whose duty fetch failed still follow the cluster's decision.

    `input_value` may also be a CALLABLE, re-resolved at every proposal
    point (round-1 pre-prepare, quorum-round-change re-propose).  This is
    the late-binding hook: an instance started by an inbound message —
    before the local fetch finished — picks up the local value as soon as
    it exists instead of being permanently input-less (without it, one
    early byzantine/garbage frame per duty nulled every honest node's
    input and stalled the duty forever; pinned by the chaos simnet's
    garbage scenario)."""

    def resolve_input() -> Any:
        return input_value() if callable(input_value) else input_value

    round_ = 1
    prepared_round = 0
    prepared_value: Any = None
    prepared_justification: tuple = ()
    qcommit: tuple = ()
    buffer: dict[int, list[Msg]] = {}
    dedup: dict[UponRule, int] = {}
    decided_value: Any = None
    decided_evt = asyncio.Event()

    async def broadcast(typ: MsgType, value: Any,
                        justification: tuple = ()) -> None:
        await t.broadcast(Msg(typ, instance, process, round_, value, 0, None,
                              justification))

    async def broadcast_round_change() -> None:
        await t.broadcast(Msg(MsgType.ROUND_CHANGE, instance, process, round_,
                              None, prepared_round, prepared_value,
                              prepared_justification))

    def buffer_msg(msg: Msg) -> None:
        fifo = buffer.setdefault(msg.source, [])
        fifo.append(msg)
        if len(fifo) > d.fifo_limit:
            del fifo[: len(fifo) - d.fifo_limit]

    def is_dup(rule: UponRule, msg_round: int) -> bool:
        if rule not in dedup:
            dedup[rule] = msg_round
            return False
        return True

    def change_round(new_round: int) -> None:
        nonlocal round_, dedup
        if round_ != new_round:
            round_ = new_round
            dedup = {}

    timer_deadline = [asyncio.get_running_loop().time() + d.round_timeout(round_)]

    def reset_timer() -> None:
        timer_deadline[0] = (asyncio.get_running_loop().time()
                             + d.round_timeout(round_))

    # Algorithm 1:11 — leader proposes in round 1.
    if d.is_leader(instance, round_, process):
        value0 = resolve_input()
        if value0 is not None:
            await broadcast(MsgType.PRE_PREPARE, value0)

    # The timed receive is an explicit getter + asyncio.wait, NOT
    # asyncio.wait_for: wait_for (3.8-3.11) returns the ready result and
    # SWALLOWS an outer task.cancel() that lands while a message is
    # queued — a cancelled-once instance (Deadliner trim, node shutdown,
    # asyncio.run teardown) would keep looping and then block forever on
    # the next empty-queue get, wedging event-loop shutdown.  wait()
    # always re-raises cancellation; the finally reaps the getter.
    getter: asyncio.Future | None = None
    try:
        while True:
            timeout = (None if decided_evt.is_set()
                       else max(0.0, timer_deadline[0]
                                - asyncio.get_running_loop().time()))
            if getter is None:
                getter = asyncio.ensure_future(t.receive.get())
            done, _ = await asyncio.wait({getter}, timeout=timeout)
            if not done:
                # Algorithm 3:1 — round timeout.
                change_round(round_ + 1)
                reset_timer()
                if d.on_rule:
                    d.on_rule(instance, process, round_, None,
                              UponRule.ROUND_TIMEOUT)
                await broadcast_round_change()
                continue
            # async-ok: completed-task read (getter is in the done set)
            msg = getter.result()
            getter = None

            if qcommit:
                # Already decided: answer laggards (Algorithm 3:17).
                if msg.source != process and msg.type == MsgType.ROUND_CHANGE:
                    await t.broadcast(Msg(MsgType.DECIDED, instance, process,
                                          qcommit[0].round, qcommit[0].value,
                                          0, None, qcommit))
                continue

            if not is_justified(d, instance, msg):
                continue

            buffer_msg(msg)
            rule, justification = classify(d, instance, round_, process,
                                           buffer, msg)
            if rule == UponRule.NOTHING or is_dup(rule, msg.round):
                continue
            if d.on_rule:
                d.on_rule(instance, process, round_, msg, rule)

            if rule == UponRule.JUSTIFIED_PRE_PREPARE:      # Algorithm 2:1
                # Note: change_round clears the dedup map, so a re-delivered
                # PRE-PREPARE can re-fire this rule once after a round jump —
                # intentional parity with the reference (duplicate PREPAREs
                # are deduped per-source by receivers' quorum filters).
                change_round(msg.round)
                reset_timer()
                await broadcast(MsgType.PREPARE, msg.value)

            elif rule == UponRule.QUORUM_PREPARES:          # Algorithm 2:4
                prepared_round = round_
                prepared_value = msg.value
                prepared_justification = justification
                await broadcast(MsgType.COMMIT, prepared_value)

            elif rule in (UponRule.QUORUM_COMMITS,
                          UponRule.JUSTIFIED_DECIDED):      # Algorithm 2:8
                change_round(msg.round)
                qcommit = justification
                decided_value = msg.value
                decided_evt.set()
                if d.decide is not None:
                    try:
                        await d.decide(instance, msg.value, justification)
                    except Exception:
                        # A failing decide sink (e.g. a DutyDB slashing
                        # clash) must not kill the instance: we still serve
                        # DECIDED catch-ups to lagging peers.
                        import logging

                        logging.getLogger("charon_tpu_torch.qbft").exception(
                            "decide callback failed for %s", instance)
                # Like the reference, keep serving DECIDED to laggards until
                # the caller cancels this instance (qbft.go:264-271).

            elif rule == UponRule.F_PLUS_1_ROUND_CHANGES:   # Algorithm 3:5
                change_round(next_min_round(d, justification, round_))
                reset_timer()
                await broadcast_round_change()

            elif rule == UponRule.QUORUM_ROUND_CHANGES:     # Algorithm 3:11
                value = resolve_input()
                pr_pv = get_single_justified_pr_pv(d, justification)
                if pr_pv is not None:
                    _, pv = pr_pv
                    if pv is not None:
                        value = pv
                if value is not None:  # non-leaders cannot propose
                    await broadcast(MsgType.PRE_PREPARE, value, justification)

            elif rule == UponRule.UNJUST_QUORUM_ROUND_CHANGES:
                pass  # ignore: bug or byzantine
    finally:
        if getter is not None:
            getter.cancel()


# ---------------------------------------------------------------------------
# Classification (reference: qbft.go:383-456)
# ---------------------------------------------------------------------------

def flatten(buffer: dict[int, list[Msg]]) -> list[Msg]:
    """All buffered messages plus their one-level justifications (so
    PREPAREs nested in ROUND-CHANGEs count toward quorums)."""
    out: list[Msg] = []
    for msgs in buffer.values():
        for m in msgs:
            out.append(m)
            out.extend(m.justification)
    return out


def classify(d: Definition, instance: Any, round_: int, process: int,
             buffer: dict[int, list[Msg]], msg: Msg):
    if msg.type == MsgType.DECIDED:
        return UponRule.JUSTIFIED_DECIDED, msg.justification

    if msg.type == MsgType.PRE_PREPARE:
        if msg.round < round_:
            return UponRule.NOTHING, ()
        return UponRule.JUSTIFIED_PRE_PREPARE, ()

    if msg.type == MsgType.PREPARE:
        if msg.round != round_:
            return UponRule.NOTHING, ()
        prepares = filter_msgs(flatten(buffer), MsgType.PREPARE, msg.round,
                               value=msg.value)
        if len(prepares) >= d.quorum:
            return UponRule.QUORUM_PREPARES, tuple(prepares)
        return UponRule.NOTHING, ()

    if msg.type == MsgType.COMMIT:
        if msg.round != round_:
            return UponRule.NOTHING, ()
        commits = filter_msgs(flatten(buffer), MsgType.COMMIT, msg.round,
                              value=msg.value)
        if len(commits) >= d.quorum:
            return UponRule.QUORUM_COMMITS, tuple(commits)
        return UponRule.NOTHING, ()

    if msg.type == MsgType.ROUND_CHANGE:
        if msg.round < round_:
            return UponRule.NOTHING, ()
        all_ = flatten(buffer)
        if msg.round > round_:
            frc = get_f_plus_1_round_changes(d, all_, round_)
            if frc is not None:
                return UponRule.F_PLUS_1_ROUND_CHANGES, frc
            return UponRule.NOTHING, ()
        if len(filter_msgs(all_, MsgType.ROUND_CHANGE, msg.round)) < d.quorum:
            return UponRule.NOTHING, ()
        qrc = get_justified_qrc(d, all_, msg.round)
        if qrc is None:
            return UponRule.UNJUST_QUORUM_ROUND_CHANGES, ()
        if not d.is_leader(instance, msg.round, process):
            return UponRule.NOTHING, ()
        return UponRule.QUORUM_ROUND_CHANGES, qrc

    raise AssertionError("invalid message type")


def next_min_round(d: Definition, frc: tuple, round_: int) -> int:
    assert len(frc) >= d.faulty + 1
    rounds = [m.round for m in frc]
    assert all(m.type == MsgType.ROUND_CHANGE and m.round > round_
               for m in frc)
    return min(rounds)


# ---------------------------------------------------------------------------
# Justification predicates (reference: qbft.go:478-592)
# ---------------------------------------------------------------------------

def is_justified(d: Definition, instance: Any, msg: Msg) -> bool:
    if msg.type == MsgType.PRE_PREPARE:
        return is_justified_pre_prepare(d, instance, msg)
    if msg.type in (MsgType.PREPARE, MsgType.COMMIT):
        return True
    if msg.type == MsgType.ROUND_CHANGE:
        return is_justified_round_change(d, msg)
    if msg.type == MsgType.DECIDED:
        return is_justified_decided(d, msg)
    return False


def is_justified_round_change(d: Definition, msg: Msg) -> bool:
    prepares = msg.justification
    pr, pv = msg.prepared_round, msg.prepared_value
    if not prepares:
        return pr == 0 and pv is None
    if len(prepares) < d.quorum:
        return False
    seen: set[int] = set()
    for p in prepares:
        if p.source in seen:
            return False
        seen.add(p.source)
        if p.type != MsgType.PREPARE or p.round != pr or p.value != pv:
            return False
    return True


def is_justified_decided(d: Definition, msg: Msg) -> bool:
    commits = filter_msgs(list(msg.justification), MsgType.COMMIT, msg.round,
                          value=msg.value)
    return len(commits) >= d.quorum


def is_justified_pre_prepare(d: Definition, instance: Any, msg: Msg) -> bool:
    if msg.value is None:
        return False  # zero-value proposals are never just
    if not d.is_leader(instance, msg.round, msg.source):
        return False
    if msg.round == 1:
        return True
    res = contains_justified_qrc(d, list(msg.justification), msg.round)
    if res is None:
        return False
    pv = res
    if pv is _NULL:
        return True  # new value being proposed
    return msg.value == pv


class _Null:
    """Sentinel distinguishing 'justified with null pv' from 'not justified'."""


_NULL = _Null()


def contains_justified_qrc(d: Definition, justification: list[Msg],
                           round_: int):
    """Algorithm 4:1.  Returns _NULL (J1), the justified pv (J2), or None."""
    qrc = filter_msgs(justification, MsgType.ROUND_CHANGE, round_)
    if len(qrc) < d.quorum:
        return None
    if all(rc.prepared_round == 0 and rc.prepared_value is None
           for rc in qrc):
        return _NULL  # J1
    pr_pv = get_single_justified_pr_pv(d, justification)
    if pr_pv is None:
        return None
    pr, pv = pr_pv
    found = False
    for rc in qrc:
        if rc.prepared_round > pr:
            return None
        if rc.prepared_round == pr and rc.prepared_value == pv:
            found = True
    return pv if found else None


def get_single_justified_pr_pv(d: Definition, msgs) -> tuple[int, Any] | None:
    pr, pv, count = 0, None, 0
    seen: set[int] = set()
    for m in msgs:
        if m.type != MsgType.PREPARE:
            continue
        if m.source in seen:
            return None
        seen.add(m.source)
        if count == 0:
            pr, pv = m.round, m.value
        elif pr != m.round or pv != m.value:
            return None
        count += 1
    if count >= d.quorum:
        return pr, pv
    return None


def get_justified_qrc(d: Definition, all_: list[Msg], round_: int):
    """Algorithm 4:1 — a justified quorum of ROUND-CHANGEs, or None."""
    null_qrc = [m for m in filter_msgs(all_, MsgType.ROUND_CHANGE, round_)
                if m.prepared_round == 0 and m.prepared_value is None]
    if len(null_qrc) >= d.quorum:
        return tuple(null_qrc)

    round_changes = filter_msgs(all_, MsgType.ROUND_CHANGE, round_)
    for prepares in get_prepare_quorums(d, all_):
        pr, pv = prepares[0].round, prepares[0].value
        qrc, has_highest = [], False
        seen: set[int] = set()
        for rc in round_changes:
            if rc.prepared_round > pr or rc.source in seen:
                continue
            seen.add(rc.source)
            if rc.prepared_round == pr and rc.prepared_value == pv:
                has_highest = True
            qrc.append(rc)
        if len(qrc) >= d.quorum and has_highest:
            return tuple(qrc) + tuple(prepares)
    return None


def get_f_plus_1_round_changes(d: Definition, all_: list[Msg], round_: int):
    highest: dict[int, Msg] = {}
    for m in all_:
        if m.type != MsgType.ROUND_CHANGE or m.round <= round_:
            continue
        cur = highest.get(m.source)
        if cur is None or m.round > cur.round:
            highest[m.source] = m
    if len(highest) < d.faulty + 1:
        return None
    return tuple(list(highest.values())[: d.faulty + 1])


def get_prepare_quorums(d: Definition, all_: list[Msg]) -> list[list[Msg]]:
    sets: dict[tuple, dict[int, Msg]] = {}
    for m in all_:
        if m.type != MsgType.PREPARE:
            continue
        sets.setdefault((m.round, m.value), {})[m.source] = m
    return [list(by_src.values()) for by_src in sets.values()
            if len(by_src) >= d.quorum]


def filter_msgs(msgs, typ: MsgType, round_: int, value=_Null) -> list[Msg]:
    """One message per source matching type/round (and value if given)."""
    out, seen = [], set()
    for m in msgs:
        if m.type != typ or m.round != round_ or m.source in seen:
            continue
        if value is not _Null and m.value != value:
            continue
        seen.add(m.source)
        out.append(m)
    return out
