"""Cluster protocols over the TCP mesh: parsigex + QBFT consensus.

Protocol registry (the reference's catalogue, app/app.go:825-832):
    /charon_tpu/parsigex/1.0.0    full-mesh partial-signature exchange
    /charon_tpu/consensus/qbft/1.0.0
    /charon_tpu/ping/1.0.0
    /charon_tpu/peerinfo/1.0.0
    /charon_tpu/priority/1.0.0

These classes satisfy the same interfaces as the in-memory transports
(core/parsigex.MemParSigEx, core/consensus.ConsensusMemNetwork), so the
node wiring is identical in simnet and production — the property that
makes the whole workflow unit-testable (reference: docs/architecture.md:198-200).

A copy of the JAX package's p2p/protocols.py, with the port's
`EquivocationDetector`.  The protocol IDs keep the JAX package's names:
they are wire identifiers, and port and JAX nodes share one mesh.
"""

from __future__ import annotations

import asyncio
import dataclasses

from ..core import serialize
from ..core.parsigex import EquivocationDetector
from ..core.qbft import Msg
from ..core.types import Duty, ParSignedDataSet
from . import identity as ident

PARSIGEX_PROTOCOL = "/charon_tpu/parsigex/1.0.0"
CONSENSUS_PROTOCOL = "/charon_tpu/consensus/qbft/1.0.0"
PRIORITY_PROTOCOL = "/charon_tpu/priority/1.0.0"


def sign_consensus_msg(msg: Msg, node_identity: ident.NodeIdentity) -> Msg:
    """Attach the sender's identity signature over the message's signing
    payload (reference: core/consensus/component.go:343-353 signs each
    QBFT message with the node's ECDSA key)."""
    payload = serialize.encode(msg.signing_payload())
    return dataclasses.replace(msg, sig=node_identity.sign(payload))


def verify_consensus_msg(msg: Msg, peer_pubkeys: dict[int, bytes],
                         depth: int = 0) -> bool:
    """Verify the message signature against its claimed source, and every
    justification message recursively (PRE_PREPAREs justify with ROUND_CHANGEs
    which justify with PREPAREs) — relayed justifications are exactly what a
    byzantine insider could otherwise forge."""
    if depth > 3:
        return False
    pub = peer_pubkeys.get(msg.source)
    if pub is None or not msg.sig:
        return False
    payload = serialize.encode(msg.signing_payload())
    if not ident.verify(pub, msg.sig, payload):
        return False
    return all(verify_consensus_msg(j, peer_pubkeys, depth + 1)
               for j in msg.justification)


class P2PParSigEx:
    """ParSigEx over the TCP mesh (reference: core/parsigex/parsigex.go).

    With a registry, exports inbound/outbound message counters per duty
    type and the per-sender-share equivocation counter (the mesh itself
    exports the per-peer byte/frame/latency families)."""

    def __init__(self, mesh, verify_fn=None, registry=None):
        self._mesh = mesh
        self._verify_fn = verify_fn
        self._subs: list = []
        self._registry = registry
        self._equiv = EquivocationDetector(registry)
        mesh.register_handler(PARSIGEX_PROTOCOL, self._on_frame)

    def subscribe(self, fn) -> None:
        self._subs.append(fn)

    async def broadcast(self, duty: Duty, pset: ParSignedDataSet) -> None:
        if self._registry is not None:
            self._registry.inc("core_parsigex_outbound_total",
                               labels={"duty": duty.type.name.lower()})
        await self._mesh.broadcast(PARSIGEX_PROTOCOL,
                                   serialize.encode_parsig_set(duty, pset))

    async def _on_frame(self, sender: int, payload: bytes):
        duty, pset = serialize.decode_parsig_set(payload)
        if self._registry is not None:
            self._registry.inc("core_parsigex_inbound_total",
                               labels={"duty": duty.type.name.lower()})
        if self._verify_fn is not None:
            await self._verify_fn(duty, pset)  # raises on invalid sigs
        # pin AFTER verification: a forged set claiming another share's
        # index must not mint false equivocation evidence
        self._equiv.check(duty, pset)
        for fn in self._subs:
            await fn(duty, pset)
        return None

    def trim(self, duty: Duty) -> None:
        """Deadliner GC: drop the duty's equivocation pins."""
        self._equiv.trim(duty)


class P2PPriorityExchange:
    """Priority-protocol request/response fan-out over the mesh
    (reference: core/priority/prioritiser.go:350-387): `exchange(msg)`
    sends our PriorityMsg to every peer with send_receive; each peer
    replies with ITS OWN message for that slot (computed by the registered
    `local_msg(slot)` callback).  Returns all collected messages including
    our own — the Prioritiser scores them deterministically."""

    def __init__(self, mesh, timeout: float = 3.0):
        self._mesh = mesh
        self._local_fn = None
        self._timeout = timeout
        mesh.register_handler(PRIORITY_PROTOCOL, self._on_request)

    def register_local(self, fn) -> None:
        """fn(slot) -> PriorityMsg for this node."""
        self._local_fn = fn

    async def _on_request(self, sender: int, payload: bytes) -> bytes:
        req = serialize.decode(payload)
        if self._local_fn is None:
            return serialize.encode(None)
        return serialize.encode(self._local_fn(req.slot))

    async def exchange(self, msg) -> list:
        async def ask(peer: int):
            try:
                reply = await self._mesh.send_receive(
                    peer, PRIORITY_PROTOCOL, serialize.encode(msg),
                    timeout=self._timeout)
                return serialize.decode(reply)
            except (asyncio.TimeoutError, OSError, ConnectionError):
                return None

        replies = await asyncio.gather(*(ask(p) for p in self._mesh.peers))
        return [msg] + [r for r in replies if r is not None]


class P2PConsensusTransport:
    """Duty-scoped QBFT broadcast over the mesh, self-delivery included
    (QBFT requires the sender to receive its own messages).  Plugs into
    core.consensus.QBFTConsensus in place of ConsensusMemNetwork.

    Every outgoing message is signed with the node's identity key; every
    inbound message — including relayed justification messages — is
    verified against the pinned peer pubkeys, so a byzantine insider cannot
    forge another member's consensus votes
    (reference: core/consensus/component.go:343-353)."""

    def __init__(self, mesh):
        self._mesh = mesh
        self._node = None
        mesh.register_handler(CONSENSUS_PROTOCOL, self._on_frame)

    def register(self, node) -> None:
        self._node = node

    async def broadcast(self, duty: Duty, msg: Msg) -> None:
        if msg.source == self._mesh.self_index:
            msg = sign_consensus_msg(msg, self._mesh.identity)
        data = serialize.encode_consensus_msg(duty, msg)
        await self._mesh.broadcast(CONSENSUS_PROTOCOL, data)
        if self._node is not None:  # self-delivery (of the signed copy)
            await self._node._deliver(duty, msg)

    async def _on_frame(self, sender: int, payload: bytes):
        duty, msg = serialize.decode_consensus_msg(payload)
        if msg.source != sender:
            return None  # spoofed source: drop
        # signature + recursive justification checks (a few ms of
        # Ed25519 each, a round change's justifications several): run
        # them off-loop so a burst of inbound frames cannot hold QBFT's
        # timers in one block
        ok = await asyncio.to_thread(verify_consensus_msg, msg,
                                     self._mesh.peer_pubkeys)
        if not ok:
            return None  # forged message or justification: drop
        if self._node is not None:
            await self._node._deliver(duty, msg)
        return None
