"""ValidatorMock — in-process validator client that signs with share keys.

Mirrors reference testutil/validatormock + app/vmock.go:38-298: driven by
scheduler slot ticks, it performs the attestation flow (query duties →
fetch attestation data → sign with the SHARE key → submit) and block
proposals (randao reveal → request block → sign → submit) against the
node's ValidatorAPI.  A copy of the JAX package's
testutil/validatormock.py, with one addition: `flows` narrows what it
signs to a deployment's duty mix (``attester``, ``proposer``,
``sync_message``, ``sync_contribution``; default all).  With
``sync_message`` and no ``sync_contribution`` the sync flow signs every
validator's message and submits them together, with no selection proofs
(`BASELINE.json` config 2's validator client).  With a `signer` (an
executor: `app/run` gives it a process of its own) it signs there, as a
validator client in a process of its own would: the node's event loop and
its interpreter lock stay free for consensus, the mesh and the flushes
while the VC signs.
"""

from __future__ import annotations

import asyncio

from ..core.types import Duty, DutyType, PubKey, SlotTick
from ..core.validatorapi import ValidatorAPI
from ..eth2util import spec
from ..eth2util.signing import DomainName, signing_root
from ..eth2util.ssz import Bitlist
from ..tbls import api as tbls


#: the duty flows a validator mock can run
FLOWS = ("attester", "proposer", "sync_message", "sync_contribution")


class ValidatorMock:
    def __init__(self, vapi: ValidatorAPI,
                 share_privkeys: dict[PubKey, bytes],
                 fork_version: bytes,
                 genesis_validators_root: bytes = bytes(32),
                 slots_per_epoch: int = 16,
                 eth2cl=None, flows: tuple[str, ...] | None = None,
                 signer=None):
        self._vapi = vapi
        self._signer = signer   # concurrent.futures.Executor, or None
        self._flows = set(flows) if flows else set(FLOWS)
        unknown = self._flows - set(FLOWS)
        if unknown:
            raise ValueError(f"unknown validator mock flows {unknown}")
        self._keys = dict(share_privkeys)  # group pubkey -> share privkey
        self._fork = fork_version
        self._gvr = genesis_validators_root
        self._spe = slots_per_epoch
        self._eth2cl = eth2cl  # for beacon-block-root queries (sync flow)

    def _sign(self, group_pk: PubKey, domain: DomainName, root: bytes,
              epoch: int) -> bytes:
        sk = self._keys[group_pk]
        return tbls.sign(sk, signing_root(domain, root, self._fork, self._gvr))

    async def _signed(self, group_pk: PubKey, domain: DomainName,
                      root: bytes, epoch: int) -> bytes:
        """`_sign`, on the `signer` when there is one."""
        if self._signer is None:
            return self._sign(group_pk, domain, root, epoch)
        return await asyncio.get_running_loop().run_in_executor(
            self._signer, tbls.sign, self._keys[group_pk],
            signing_root(domain, root, self._fork, self._gvr))

    # -- slot driver --------------------------------------------------------

    async def on_slot(self, slot: SlotTick) -> None:
        """Scheduler slot subscriber.  Spawns the duty flows as tasks so the
        scheduler tick never blocks on duty data becoming available
        (reference: app/vmock.go spawns goroutines per flow)."""
        from ..core import background

        background.spawn(self._run_slot(slot),
                         name=f"vmock-slot-{slot.slot}")

    async def _run_slot(self, slot: SlotTick) -> None:
        try:
            flows = []
            if "attester" in self._flows:
                flows.append(self.attest(slot))
            if "proposer" in self._flows:
                flows.append(self.propose(slot))
            if self._eth2cl is not None:
                if "sync_contribution" in self._flows:
                    flows.append(self.sync_committee(slot))
                elif "sync_message" in self._flows:
                    flows.append(self.sync_messages(slot))
            await asyncio.gather(*flows)
        except Exception:
            import logging
            logging.getLogger("charon_tpu_torch.vmock").exception(
                "vmock slot %s failed", slot.slot)

    # -- attestation flow (validatormock/attest.go:43-440) ------------------

    async def attest(self, slot: SlotTick) -> None:
        duty = Duty(slot.slot, DutyType.ATTESTER)
        defset = await self._vapi._get_duty_definition(duty)
        for group_pk, d in (defset or {}).items():
            if group_pk not in self._keys:
                continue
            data = await self._vapi.attestation_data(slot.slot,
                                                     d.committee_index)
            bools = [False] * d.committee_length
            bools[d.validator_committee_index] = True
            sig = await self._signed(group_pk, DomainName.BEACON_ATTESTER,
                                     data.hash_tree_root(),
                                     data.target.epoch)
            att = spec.Attestation(
                aggregation_bits=Bitlist.from_bools(bools), data=data,
                signature=sig)
            await self._vapi.submit_attestations([att])

    # -- proposal flow ------------------------------------------------------

    async def propose(self, slot: SlotTick) -> None:
        duty = Duty(slot.slot, DutyType.PROPOSER)
        try:
            defset = await asyncio.wait_for(
                self._vapi._get_duty_definition(duty), timeout=0.05)
        except asyncio.TimeoutError:
            return
        for group_pk, d in (defset or {}).items():
            if group_pk not in self._keys:
                continue
            randao_root = SignedRandaoRoot(slot.epoch)
            randao_sig = await self._signed(group_pk, DomainName.RANDAO,
                                            randao_root, slot.epoch)
            block = await self._vapi.beacon_block_proposal(slot.slot,
                                                           randao_sig)
            sig = await self._signed(group_pk, DomainName.BEACON_PROPOSER,
                                     block.hash_tree_root(), slot.epoch)
            signed = spec.SignedBeaconBlock(message=block, signature=sig)
            await self._vapi.submit_beacon_block(signed)


    # -- sync-committee flow (validatormock/synccomm.go) --------------------

    async def sync_committee(self, slot: SlotTick) -> None:
        """Selection proofs → sync message → (as aggregator) signed
        contribution-and-proof, mirroring the reference's altair flow
        (reference: testutil/validatormock/synccomm.go)."""
        duty = Duty(slot.slot, DutyType.SYNC_MESSAGE)
        try:
            defset = await asyncio.wait_for(
                self._vapi._get_duty_definition(duty), timeout=0.1)
        except asyncio.TimeoutError:
            return
        if not defset:
            return
        block_root = await self._eth2cl.beacon_block_root(slot.slot)
        # Concurrent per-validator flows: the cluster's sync-contribution
        # fetch waits on ALL validators' aggregated selections, so a
        # sequential loop here (validator A awaiting its contribution
        # before validator B submits its selection) would deadlock.
        await asyncio.gather(*(
            self._sync_one(slot, group_pk, d, block_root)
            for group_pk, d in defset.items() if group_pk in self._keys))

    async def sync_messages(self, slot: SlotTick) -> None:
        """The sync committee's messages alone: every validator's signed
        first, then all submitted at once, so they meet in the node's next
        verify flush."""
        duty = Duty(slot.slot, DutyType.SYNC_MESSAGE)
        defset = await self._vapi._get_duty_definition(duty)
        if not defset:
            return
        root = await self._eth2cl.beacon_block_root(slot.slot)
        mine = [(pk, d) for pk, d in defset.items() if pk in self._keys]
        sigs = [await self._signed(pk, DomainName.SYNC_COMMITTEE, root,
                                   slot.epoch) for pk, _ in mine]
        msgs = [spec.SyncCommitteeMessage(
            slot=slot.slot, beacon_block_root=root,
            validator_index=d.validator_index, signature=sig)
            for (_, d), sig in zip(mine, sigs)]
        await asyncio.gather(*(
            self._vapi.submit_sync_committee_messages([m]) for m in msgs))

    async def _sync_one(self, slot: SlotTick, group_pk: PubKey, d,
                        block_root: bytes) -> None:
        subcommittee = d.validator_sync_committee_indices[0] // 128
        # 1. partial selection proof → threshold-aggregated selection
        sel = spec.SyncCommitteeSelection(
            validator_index=d.validator_index, slot=slot.slot,
            subcommittee_index=subcommittee)
        sel_root = spec.SyncAggregatorSelectionData(
            slot=slot.slot,
            subcommittee_index=subcommittee).hash_tree_root()
        sel_sig = await self._signed(
            group_pk, DomainName.SYNC_COMMITTEE_SELECTION_PROOF, sel_root,
            slot.epoch)
        selection_task = asyncio.get_running_loop().create_task(
            self._vapi.submit_sync_committee_selections(
                [sel.replace(selection_proof=sel_sig)]))
        # 2. sync-committee message over the block root
        msg_sig = await self._signed(group_pk, DomainName.SYNC_COMMITTEE,
                                     block_root, slot.epoch)
        await self._vapi.submit_sync_committee_messages(
            [spec.SyncCommitteeMessage(
                slot=slot.slot, beacon_block_root=block_root,
                validator_index=d.validator_index,
                signature=msg_sig)])
        # 3. aggregator path: await the consensus-agreed contribution,
        #    sign ContributionAndProof, submit
        [agg_sel] = await selection_task
        contrib = await self._vapi._await_sync_contribution(
            slot.slot, subcommittee, block_root)
        cap = spec.ContributionAndProof(
            aggregator_index=d.validator_index,
            contribution=contrib,
            selection_proof=agg_sel.selection_proof)
        cap_sig = await self._signed(
            group_pk, DomainName.CONTRIBUTION_AND_PROOF,
            cap.hash_tree_root(), slot.epoch)
        await self._vapi.submit_sync_contributions(
            [spec.SignedContributionAndProof(message=cap,
                                             signature=cap_sig)])


def SignedRandaoRoot(epoch: int) -> bytes:
    from ..eth2util import ssz
    return ssz.uint64.hash_tree_root(epoch)
