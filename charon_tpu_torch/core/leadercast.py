"""Leadercast — non-BFT fallback consensus: the deterministic leader
broadcasts its value, everyone accepts.

Mirrors reference core/leadercast/leadercast.go:29-50 + transport.go: the
Transport abstraction lets tests run in-memory clusters in one process
(the same idiom as the reference's in-memory ParSigEx).  QBFT replaces this
when the cluster needs byzantine fault tolerance (feature-gated in the
reference, featureset `QBFTConsensus`).

A copy of the JAX package's core/leadercast.py: the in-process cluster's
consensus.  QBFT comes with a later slice.
"""

from __future__ import annotations

from .types import Duty, UnsignedDataSet


def leader(duty: Duty, num_peers: int) -> int:
    """Deterministic leader (reference: leadercast.go leader())."""
    return (duty.slot + int(duty.type)) % num_peers


class MemTransportNetwork:
    """In-memory transport shared by a cluster of LeaderCast instances."""

    def __init__(self) -> None:
        self._nodes: dict[int, "LeaderCast"] = {}

    def register(self, idx: int, node: "LeaderCast") -> None:
        self._nodes[idx] = node

    async def broadcast(self, from_idx: int, duty: Duty,
                        unsigned: UnsignedDataSet) -> None:
        for idx, node in list(self._nodes.items()):
            await node._receive(from_idx, duty, unsigned)


class LeaderCast:
    def __init__(self, transport: MemTransportNetwork, peer_idx: int,
                 num_peers: int):
        self._transport = transport
        self._peer_idx = peer_idx
        self._num_peers = num_peers
        self._subs: list = []
        self._decided: set[Duty] = set()
        transport.register(peer_idx, self)

    def subscribe(self, fn) -> None:
        self._subs.append(fn)

    async def propose(self, duty: Duty, unsigned: UnsignedDataSet) -> None:
        if leader(duty, self._num_peers) != self._peer_idx:
            return  # only the leader's proposal counts
        await self._transport.broadcast(self._peer_idx, duty, unsigned)

    async def _receive(self, from_idx: int, duty: Duty,
                       unsigned: UnsignedDataSet) -> None:
        if leader(duty, self._num_peers) != from_idx:
            return  # reject non-leader values (leadercast.go handle())
        if duty in self._decided:
            return
        self._decided.add(duty)
        for fn in self._subs:
            await fn(duty, unsigned)
