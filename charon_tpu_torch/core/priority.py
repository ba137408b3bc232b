"""Priority protocol — generic cluster-preference agreement.

Mirrors reference core/priority/: each peer submits ordered preferences
per topic, all peers' messages are exchanged (request/response with every
peer), the composite result is deterministically scored
(count·1000 − order, reference: core/priority/calculate.go:29-100), and
the scored result goes through consensus so the cluster agrees on one
answer (reference: core/priority/prioritiser.go:189-245, 389-405).

Infosync (reference: core/infosync/infosync.go) is the first use case:
agreement on supported protocol versions, triggered in the last slot of
each epoch.

A copy of the JAX package's core/priority.py.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

from .types import Duty, DutyType, SlotTick


@dataclass(frozen=True)
class PriorityMsg:
    """One peer's preferences: topic -> ordered priorities."""

    peer_idx: int
    slot: int
    topics: tuple  # tuple[(topic, tuple[priority, ...]), ...]


@dataclass(frozen=True)
class TopicResult:
    topic: str
    priorities: tuple  # ordered by descending score


def calculate_result(msgs: list[PriorityMsg], quorum: int) -> tuple[TopicResult, ...]:
    """Deterministic scoring: score = count·1000 − min_order; only
    priorities supported by ≥ quorum peers survive
    (reference: core/priority/calculate.go:38-100)."""
    out = []
    all_topics: dict[str, list[tuple]] = defaultdict(list)
    for msg in msgs:
        for topic, prios in msg.topics:
            all_topics[topic].append(prios)
    for topic in sorted(all_topics):
        scores: dict[str, int] = defaultdict(int)
        orders: dict[str, int] = {}
        counts: dict[str, int] = defaultdict(int)
        for prios in all_topics[topic]:
            for order, p in enumerate(prios):
                counts[p] += 1
                orders[p] = min(orders.get(p, order), order)
        for p, count in counts.items():
            if count >= quorum:
                scores[p] = count * 1000 - orders[p]
        ranked = tuple(sorted(scores, key=lambda p: (-scores[p], p)))
        out.append(TopicResult(topic=topic, priorities=ranked))
    return tuple(out)


def local_priority_msg(peer_idx: int, slot: int, topics: dict) -> PriorityMsg:
    """Canonical (sorted, tuple-ised) PriorityMsg for this peer+slot."""
    return PriorityMsg(peer_idx=peer_idx, slot=slot,
                       topics=tuple((t, tuple(p))
                                    for t, p in sorted(topics.items())))


class Prioritiser:
    """reference: core/priority/prioritiser.go NewComponent."""

    def __init__(self, peer_idx: int, num_peers: int, exchange,
                 consensus_propose, consensus_subscribe):
        """`exchange(msg) -> list[PriorityMsg]` collects all peers' msgs
        (p2p send_receive fan-out or in-memory); consensus hooks agree on
        the scored result."""
        self._peer_idx = peer_idx
        self._num_peers = num_peers
        self._exchange = exchange
        self._propose = consensus_propose
        self._subs: list = []
        consensus_subscribe(self._on_decided)

    @property
    def quorum(self) -> int:
        import math

        return math.ceil(self._num_peers * 2 / 3)

    def subscribe(self, fn) -> None:
        self._subs.append(fn)

    async def prioritise(self, slot: int, topics: dict) -> None:
        """Submit our preferences and drive agreement for this slot."""
        msg = local_priority_msg(self._peer_idx, slot, topics)
        msgs = await self._exchange(msg)
        result = calculate_result(msgs, self.quorum)
        duty = Duty(slot, DutyType.INFO_SYNC)
        await self._propose(duty, result)

    async def _on_decided(self, duty: Duty, value) -> None:
        if duty.type != DutyType.INFO_SYNC:
            return
        for fn in self._subs:
            await fn(duty.slot, value)


class InfoSync:
    """Cluster-wide agreement on supported versions/protocols, triggered in
    the last slot of each epoch (reference: core/infosync/infosync.go:129-139)."""

    TOPIC_VERSION = "version"
    TOPIC_PROTOCOL = "protocol"

    def __init__(self, prioritiser: Prioritiser, versions: list[str],
                 protocols: list[str]):
        self._prio = prioritiser
        self._versions = list(versions)
        self._protocols = list(protocols)
        self._results: dict[int, tuple] = {}  # slot -> TopicResults
        prioritiser.subscribe(self._on_result)

    async def on_slot(self, slot: SlotTick) -> None:
        if not slot.last_in_epoch:
            return
        await self.trigger(slot.slot)

    def local_msg(self, slot: int) -> PriorityMsg:
        """This node's priority message for a slot — served to peers that
        request our preferences during their exchange fan-out
        (reference: prioritiser.go request/response handler :350-387)."""
        return local_priority_msg(self._prio._peer_idx, slot, {
            self.TOPIC_VERSION: self._versions,
            self.TOPIC_PROTOCOL: self._protocols,
        })

    async def trigger(self, slot: int) -> None:
        await self._prio.prioritise(slot, {
            self.TOPIC_VERSION: self._versions,
            self.TOPIC_PROTOCOL: self._protocols,
        })

    async def _on_result(self, slot: int, result) -> None:
        self._results[slot] = result

    def protocols(self, slot: int) -> list[str]:
        """Agreed protocol precedence at a slot (falls back to local)."""
        best = None
        for s, result in self._results.items():
            if s <= slot and (best is None or s > best[0]):
                best = (s, result)
        if best is None:
            return list(self._protocols)
        for tr in best[1]:
            if tr.topic == self.TOPIC_PROTOCOL:
                return list(tr.priorities)
        return list(self._protocols)
