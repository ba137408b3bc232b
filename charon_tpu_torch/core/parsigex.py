"""ParSigEx — full-mesh exchange of partial signatures.

Mirrors reference core/parsigex/parsigex.go: broadcast one node's partial
signatures to the n−1 peers; inbound sets are signature-verified against
the SENDER's pubshare before storage (parsigex.go:152-176 NewEth2Verifier).

`MemParSigExNetwork` is the in-memory transport used by simnet tests
(reference: core/parsigex/memory.go); the p2p-backed implementation lives
in charon_tpu_torch.p2p and plugs in via the same interface.

With a registry wired (``join(registry=...)`` / the p2p constructor) the
exchange exports inbound/outbound message counters per duty type, an
equivocation counter per sender share (two DIFFERENT signatures from the
same share for the same (duty, validator) — byzantine or split-brain
evidence, reference: core/parsigex metrics + tracker equivocation), and —
for the in-memory transport — the same per-peer wire-byte families the
TCP mesh exports (frame size measured through the real wire codec), so
the crypto-free simnet serves ``app_p2p_peer_sent_bytes_total`` exactly
like production.

A copy of the JAX package's core/parsigex.py.
"""

from __future__ import annotations

from collections import OrderedDict

from .types import Duty, ParSignedDataSet


class EquivocationDetector:
    """First-signature pinning per (duty, validator pubkey, share index).

    A later DIFFERENT signature for the same key is an equivocation: the
    sender signed two conflicting messages for one duty.  Memory is
    bounded per-duty (oldest duties evicted)."""

    def __init__(self, registry=None, max_duties: int = 1024):
        self._registry = registry
        self._max = max_duties
        self._seen: "OrderedDict[Duty, dict]" = OrderedDict()
        self.equivocations = 0

    def check(self, duty: Duty, pset: ParSignedDataSet) -> list[int]:
        """Record the set; returns the share indices caught equivocating."""
        sigs = self._seen.get(duty)
        if sigs is None:
            sigs = self._seen[duty] = {}
            while len(self._seen) > self._max:
                self._seen.popitem(last=False)
        out = []
        for pubkey, psig in pset.items():
            key = (pubkey, psig.share_idx)
            first = sigs.setdefault(key, psig.signature)
            if first != psig.signature:
                out.append(psig.share_idx)
                self.equivocations += 1
                if self._registry is not None:
                    self._registry.inc("core_parsigex_equivocations_total",
                                       labels={"peer": str(psig.share_idx)})
        return out

    def trim(self, duty: Duty) -> None:
        self._seen.pop(duty, None)


class MemParSigExNetwork:
    """Shared hub: wires n in-process nodes into a full mesh."""

    def __init__(self) -> None:
        self._nodes: list[MemParSigEx] = []

    def join(self, verify_fn=None, registry=None,
             idx: int | None = None) -> "MemParSigEx":
        """Join the mesh.  `idx=None` appends a new member; passing an
        existing index REPLACES that member's endpoint — the node-restart
        hook (a restarted node must not leave its dead predecessor in the
        fanout list double-delivering into stale subscribers)."""
        if idx is None:
            idx = len(self._nodes)
        node = MemParSigEx(self, idx, verify_fn, registry=registry)
        if idx == len(self._nodes):
            self._nodes.append(node)
        elif 0 <= idx < len(self._nodes):
            self._nodes[idx] = node
        else:
            raise ValueError(f"rejoin index {idx} out of range")
        return node

    async def _fanout(self, from_idx: int, duty: Duty,
                      pset: ParSignedDataSet, nbytes: int = 0) -> None:
        for node in self._nodes:
            if node._idx != from_idx:
                await node._receive(duty, pset, from_idx=from_idx,
                                    nbytes=nbytes)


class MemParSigEx:
    def __init__(self, net: MemParSigExNetwork, idx: int, verify_fn=None,
                 registry=None):
        self._net = net
        self._idx = idx
        self._verify_fn = verify_fn  # async (duty, pset) -> None, raises
        self._subs: list = []
        self._registry = registry
        self._equiv = EquivocationDetector(registry)

    def subscribe(self, fn) -> None:
        self._subs.append(fn)

    def _frame_bytes(self, duty: Duty, pset: ParSignedDataSet) -> int:
        """Wire size of this exchange through the real codec — what the
        TCP transport would put on the socket (sans AEAD framing)."""
        from . import serialize

        try:
            return len(serialize.encode_parsig_set(duty, pset))
        except Exception:  # non-wire test doubles: count messages only
            return 0

    async def broadcast(self, duty: Duty, pset: ParSignedDataSet) -> None:
        nbytes = 0
        if self._registry is not None:
            nbytes = self._frame_bytes(duty, pset)
            self._registry.inc("core_parsigex_outbound_total",
                               labels={"duty": duty.type.name.lower()})
            for node in self._net._nodes:
                if node._idx != self._idx:
                    peer = {"peer": str(node._idx)}
                    self._registry.inc("app_p2p_peer_sent_bytes_total",
                                       float(nbytes), labels=peer)
                    self._registry.inc("app_p2p_peer_sent_frames_total",
                                       labels=peer)
        await self._net._fanout(self._idx, duty, pset, nbytes=nbytes)

    async def _receive(self, duty: Duty, pset: ParSignedDataSet,
                       from_idx: int | None = None, nbytes: int = 0) -> None:
        if self._registry is not None:
            self._registry.inc("core_parsigex_inbound_total",
                               labels={"duty": duty.type.name.lower()})
            if from_idx is not None:
                peer = {"peer": str(from_idx)}
                self._registry.inc("app_p2p_peer_recv_bytes_total",
                                   float(nbytes), labels=peer)
                self._registry.inc("app_p2p_peer_recv_frames_total",
                                   labels=peer)
        if self._verify_fn is not None:
            await self._verify_fn(duty, pset)  # raises on bad sigs
        # equivocation pinning runs AFTER verification: an unverified set
        # claiming another share's index must not poison the first-sig
        # pin (false equivocation evidence against an honest peer)
        self._equiv.check(duty, pset)
        for fn in self._subs:
            await fn(duty, pset)

    def trim(self, duty: Duty) -> None:
        """Deadliner GC: drop the duty's equivocation pins."""
        self._equiv.trim(duty)
