"""Synthetic proposer duties — load-testing wrapper around a beacon client.

Mirrors reference app/eth2wrap/synthproposer.go:41-196: block proposals are
rare (one validator per slot across the whole network), so soak-testing the
proposal path needs synthetic duties.  This wraps any eth2 client and
deterministically assigns ONE cluster validator a synthetic proposer duty
per slot (hash-based selection over the active validators); fetching a
block for a synthetic slot returns a deterministic synthetic block, and
submitting a synthetic signed block is swallowed (never reaches the real
BN).  Real proposer duties pass through untouched.

A copy of the JAX package's eth2util/synthproposer.py.
"""

from __future__ import annotations

import hashlib

from . import spec


class SynthProposerClient:
    """Duck-types the eth2 client interface; delegates everything except
    the proposer-duty path."""

    def __init__(self, inner):
        self._inner = inner
        self._synth_slots: set[int] = set()
        self.synthetic_blocks_submitted: list[spec.SignedBeaconBlock] = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    async def proposer_duties(self, epoch: int, indices: list[int]):
        real = await self._inner.proposer_duties(epoch, indices)
        real_slots = {d.slot for d in real}
        spe = (await self._inner.spec())["SLOTS_PER_EPOCH"]
        vals = sorted(indices)
        if not vals:
            return real
        from ..testutil.beaconmock import ProposerDutyInfo

        out = list(real)
        by_index = {}
        for slot_in_epoch in range(spe):
            slot = epoch * spe + slot_in_epoch
            if slot in real_slots:
                continue
            h = hashlib.sha256(f"synth/{epoch}/{slot}".encode()).digest()
            idx = vals[h[0] % len(vals)]
            if not by_index:
                # resolve pubkeys once via the validators endpoint shape
                pass
            self._synth_slots.add(slot)
            out.append(ProposerDutyInfo(
                pubkey=await self._pubkey_of(idx), validator_index=idx,
                slot=slot))
        return out

    async def _pubkey_of(self, index: int) -> bytes:
        # active_validators keyed by PubKey; invert once per call set
        if not hasattr(self, "_pk_cache"):
            self._pk_cache = {}
        pk = self._pk_cache.get(index)
        if pk is None:
            # the inner client caches; this stays cheap
            from ..core.types import pubkey_to_bytes

            vals = await self._inner.active_validators(
                getattr(self._inner, "_known_pubkeys", []))
            for p, v in vals.items():
                self._pk_cache[v.index] = pubkey_to_bytes(p)
            pk = self._pk_cache.get(index, bytes(48))
        return pk

    def register_pubkeys(self, pubkeys) -> None:
        """Cluster pubkeys for validator-index resolution."""
        self._inner._known_pubkeys = list(pubkeys)

    async def beacon_block_proposal(self, slot: int, randao_reveal: bytes,
                                    graffiti: bytes = b"",
                                    blinded: bool = False):
        if slot not in self._synth_slots:
            return await self._inner.beacon_block_proposal(
                slot, randao_reveal, graffiti, blinded=blinded)
        root = hashlib.sha256(b"synthblock/%d" % slot).digest()
        return spec.BeaconBlock(
            slot=slot, proposer_index=0,
            parent_root=hashlib.sha256(b"synthparent/%d" % slot).digest(),
            state_root=root, body_root=root, body=b"synthetic",
            blinded=blinded)

    async def submit_beacon_block(self, block: spec.SignedBeaconBlock):
        if block.message.slot in self._synth_slots:
            # synthetic blocks must never reach the real chain
            self.synthetic_blocks_submitted.append(block)
            return
        return await self._inner.submit_beacon_block(block)
