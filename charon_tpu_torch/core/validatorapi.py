"""ValidatorAPI — the beacon-node façade serving downstream validator
clients.

Mirrors reference core/validatorapi/validatorapi.go: duty data is served
from the DutyDB (blocking until consensus), submissions are verified
against the node's LOCAL PUBSHARE before acceptance
(validatorapi.go:1052-1068) and converted into ParSignedData pushed to the
ParSigDB.  Pubshare↔group-pubkey mapping happens on this boundary
(validatorapi.go:980-1014): the VC only ever sees its share key.

This class is the transport-independent component (the reference's
`Component`); `charon_tpu_torch.app.router` wraps it in an HTTP router
with the reverse proxy, mirroring router.go.  A copy of the JAX package's
core/validatorapi.py.
"""

from __future__ import annotations

import asyncio

from ..eth2util import spec
from ..eth2util.signing import signing_root
from ..tbls import api as tbls
from .types import (Duty, DutyType, ParSignedData, ParSignedDataSet, PubKey,
                    SignedAggregateAndProofSD, SignedAttestation,
                    SignedBeaconCommitteeSelection, SignedBlock, SignedExit,
                    SignedRandao, SignedRegistration, SignedSyncMessage,
                    SignedSyncCommitteeSelection,
                    SignedSyncContributionAndProof, pubkey_from_bytes,
                    pubkey_to_bytes)


class VapiError(Exception):
    pass


class ValidatorAPI:
    def __init__(self, share_idx: int,
                 pubshare_by_group: dict[PubKey, bytes],
                 fork_version: bytes,
                 genesis_validators_root: bytes = bytes(32),
                 slots_per_epoch: int = 32,
                 verifier=None):
        """`pubshare_by_group` maps group pubkey (hex PubKey) → this node's
        48-byte pubshare for that validator.  `verifier` is an optional
        core.verify.BatchVerifier: when set, partial-sig verification is
        micro-batched across concurrent submissions into one device launch
        (otherwise each call is a direct tbls.verify)."""
        self._share_idx = share_idx
        self._verifier = verifier
        self._pubshare_by_group = dict(pubshare_by_group)
        self._group_by_pubshare = {
            v: k for k, v in pubshare_by_group.items()}
        self._fork_version = fork_version
        self._gvr = genesis_validators_root
        self._spe = slots_per_epoch
        self._subs: list = []
        # wired query functions
        self._await_attestation = None
        self._await_beacon_block = None
        self._await_sync_contribution = None
        self._await_agg_attestation = None
        self._get_duty_definition = None
        self._pubkey_by_attestation = None
        self._await_agg_sig_db = None
        self._serving_cache = None
        self._serving_ttl: float | None = None

    # -- registration (wire hooks) -----------------------------------------

    def register_await_attestation(self, fn): self._await_attestation = fn
    def register_await_beacon_block(self, fn): self._await_beacon_block = fn
    def register_await_sync_contribution(self, fn): self._await_sync_contribution = fn
    def register_await_agg_attestation(self, fn): self._await_agg_attestation = fn
    def register_get_duty_definition(self, fn): self._get_duty_definition = fn
    def register_pubkey_by_attestation(self, fn): self._pubkey_by_attestation = fn
    def register_await_agg_sig_db(self, fn): self._await_agg_sig_db = fn

    def subscribe(self, fn) -> None:
        self._subs.append(fn)

    def attach_serving_cache(self, cache, ttl: float | None = None) -> None:
        """Route attestation-data reads through an app-layer
        single-flight cache (app/serving.SingleFlightCache duck-type):
        N VCs awaiting the same (slot, committee) share ONE dutydb wait,
        and the consensus-agreed result is slot-keyed cached — safe
        because the DutyDB value for a key is fixed once decided."""
        self._serving_cache = cache
        self._serving_ttl = ttl

    # -- helpers ------------------------------------------------------------

    async def _verify_partial(self, group_pubkey: PubKey, signed,
                              epoch_hint=None):
        """Verify a VC submission against this node's pubshare
        (reference: validatorapi.go:1052-1068): recompute the domain-wrapped
        signing root and pairing-verify — through the shared BatchVerifier
        when wired, so concurrent submissions across all validators share
        one batched pairing launch."""
        pubshare = self._pubshare_by_group.get(group_pubkey)
        if pubshare is None:
            raise VapiError(f"unknown validator {group_pubkey}")
        domain, epoch = signed.signing_info(self._spe)
        root = signing_root(domain, signed.message_root(), self._fork_version,
                            self._gvr)
        if self._verifier is not None:
            ok = await self._verifier.verify(pubshare, root, signed.signature)
        else:
            # no BatchVerifier wired: still keep the padded batch-of-1
            # pairing launch off the loop (the loop guard rejects the
            # inline form)
            ok = await asyncio.to_thread(tbls.verify, pubshare, root,
                                         signed.signature)
        if not ok:
            raise VapiError("invalid partial signature")

    async def _push(self, duty: Duty, group_pubkey: PubKey, signed) -> None:
        pset: ParSignedDataSet = {
            group_pubkey: ParSignedData(data=signed,
                                        share_idx=self._share_idx)}
        for fn in self._subs:
            await fn(duty, pset)

    def group_pubkey_for_share(self, pubshare: bytes) -> PubKey:
        pk = self._group_by_pubshare.get(pubshare)
        if pk is None:
            raise VapiError("unknown pubshare")
        return pk

    # -- attestations (validatorapi.go:220-286) -----------------------------

    async def attestation_data(self, slot: int,
                               committee_index: int) -> spec.AttestationData:
        if self._serving_cache is not None:
            return await self._serving_cache.get(
                "attestation_data", (slot, committee_index),
                lambda: self._await_attestation(slot, committee_index),
                ttl=self._serving_ttl)
        return await self._await_attestation(slot, committee_index)

    async def submit_attestations(self,
                                  atts: list[spec.Attestation]) -> None:
        for att in atts:
            val_comm_idx = _single_set_bit(att.aggregation_bits)
            group_pk = await self._pubkey_by_attestation(
                att.data.slot, att.data.index, val_comm_idx)
            signed = SignedAttestation(attestation=att)
            await self._verify_partial(group_pk, signed)
            duty = Duty(att.data.slot, DutyType.ATTESTER)
            await self._push(duty, group_pk, signed)

    # -- block proposal w/ RANDAO bootstrap (validatorapi.go:289-345) -------

    async def beacon_block_proposal(self, slot: int, randao_reveal: bytes,
                                    graffiti: bytes = b"") -> spec.BeaconBlock:
        # 1. find this slot's proposer definition
        duty = Duty(slot, DutyType.PROPOSER)
        defset = await self._get_duty_definition(duty)
        if not defset:
            defset = await self._get_duty_definition(
                Duty(slot, DutyType.BUILDER_PROPOSER))
        if not defset:
            raise VapiError(f"no proposer duty for slot {slot}")
        [(group_pk, _)] = list(defset.items())[:1] or [(None, None)]
        # 2. verify + store the partial RANDAO reveal
        randao = SignedRandao(epoch=slot // self._spe,
                              signature=randao_reveal)
        await self._verify_partial(group_pk, randao)
        await self._push(Duty(slot, DutyType.RANDAO), group_pk, randao)
        # 3. block until consensus provides the unsigned block (fetcher
        #    blocks on aggregated randao internally)
        return await self._await_beacon_block(slot)

    async def submit_beacon_block(self,
                                  block: spec.SignedBeaconBlock) -> None:
        duty_type = (DutyType.BUILDER_PROPOSER if block.message.blinded
                     else DutyType.PROPOSER)
        duty = Duty(block.message.slot, duty_type)
        defset = await self._get_duty_definition(duty)
        if not defset:
            raise VapiError(f"no proposer duty for slot {block.message.slot}")
        [group_pk] = list(defset)[:1]
        signed = SignedBlock(block=block)
        await self._verify_partial(group_pk, signed)
        await self._push(duty, group_pk, signed)

    # -- voluntary exit (validatorapi.go SubmitVoluntaryExit) ---------------

    async def submit_voluntary_exit(self, exit_: spec.SignedVoluntaryExit,
                                    group_pubkey: PubKey) -> None:
        signed = SignedExit(exit=exit_)
        await self._verify_partial(group_pubkey, signed)
        duty = Duty(exit_.message.epoch * self._spe, DutyType.EXIT)
        await self._push(duty, group_pubkey, signed)

    # -- builder registrations ---------------------------------------------

    async def submit_validator_registrations(
            self, regs: list[spec.SignedValidatorRegistration]) -> None:
        for reg in regs:
            # The registration message carries the GROUP pubkey (the VC is
            # configured with it for registration purposes); all nodes'
            # partials then share one message root so they threshold-
            # aggregate.  A registration keyed by a pubshare is remapped.
            try:
                group_pk = self.group_pubkey_for_share(reg.message.pubkey)
                msg = reg.message.replace(pubkey=pubkey_to_bytes(group_pk))
                reg = reg.replace(message=msg)
            except VapiError:
                group_pk = pubkey_from_bytes(reg.message.pubkey)
            signed = SignedRegistration(registration=reg)
            await self._verify_partial(group_pk, signed)
            duty = Duty(0, DutyType.BUILDER_REGISTRATION)
            await self._push(duty, group_pk, signed)

    # -- selection proofs (DVT-specific, validatorapi.go:607-660) -----------

    async def submit_beacon_committee_selections(
            self, selections: list[spec.BeaconCommitteeSelection]
    ) -> list[spec.BeaconCommitteeSelection]:
        """VC submits partial selection proofs; returns the aggregated ones
        once the cluster threshold-combines them."""
        out = []
        for sel in selections:
            duty = Duty(sel.slot, DutyType.PREPARE_AGGREGATOR)
            defset = await self._get_duty_definition(
                Duty(sel.slot, DutyType.ATTESTER))
            group_pk = _pubkey_by_validator_index(defset, sel.validator_index)
            signed = SignedBeaconCommitteeSelection(selection=sel)
            await self._verify_partial(group_pk, signed)
            await self._push(duty, group_pk, signed)
            agg = await self._await_agg_sig_db(duty, group_pk)
            out.append(agg.selection)
        return out

    # -- sync committee -----------------------------------------------------

    async def submit_sync_committee_messages(
            self, msgs: list[spec.SyncCommitteeMessage]) -> None:
        for msg in msgs:
            duty = Duty(msg.slot, DutyType.SYNC_MESSAGE)
            defset = await self._get_duty_definition(duty)
            group_pk = _pubkey_by_validator_index(defset, msg.validator_index)
            signed = SignedSyncMessage(message=msg)
            await self._verify_partial(group_pk, signed)
            await self._push(duty, group_pk, signed)

    async def submit_sync_contributions(
            self, contribs: list[spec.SignedContributionAndProof]) -> None:
        """VC submits signed contribution-and-proofs
        (reference: validatorapi.go SubmitSyncCommitteeContributions)."""
        for c in contribs:
            slot = c.message.contribution.slot
            duty = Duty(slot, DutyType.SYNC_CONTRIBUTION)
            defset = await self._get_duty_definition(
                Duty(slot, DutyType.SYNC_MESSAGE))
            group_pk = _pubkey_by_validator_index(
                defset, c.message.aggregator_index)
            signed = SignedSyncContributionAndProof(contribution=c)
            await self._verify_partial(group_pk, signed)
            await self._push(duty, group_pk, signed)

    async def submit_sync_committee_selections(
            self, selections: list[spec.SyncCommitteeSelection]
    ) -> list[spec.SyncCommitteeSelection]:
        """Partial sync-committee selection proofs in, threshold-aggregated
        selections out (reference: validatorapi.go:864-914)."""
        out = []
        for sel in selections:
            duty = Duty(sel.slot, DutyType.PREPARE_SYNC_CONTRIBUTION)
            defset = await self._get_duty_definition(
                Duty(sel.slot, DutyType.SYNC_MESSAGE))
            group_pk = _pubkey_by_validator_index(defset, sel.validator_index)
            signed = SignedSyncCommitteeSelection(selection=sel)
            await self._verify_partial(group_pk, signed)
            await self._push(duty, group_pk, signed)
            agg = await self._await_agg_sig_db(duty, group_pk)
            out.append(agg.selection)
        return out

    # -- aggregate & proof --------------------------------------------------

    async def submit_aggregate_attestations(
            self, aggs: list[spec.SignedAggregateAndProof]) -> None:
        for agg in aggs:
            slot = agg.message.aggregate.data.slot
            duty = Duty(slot, DutyType.AGGREGATOR)
            defset = await self._get_duty_definition(duty)
            group_pk = _pubkey_by_validator_index(
                defset, agg.message.aggregator_index)
            signed = SignedAggregateAndProofSD(agg=agg)
            await self._verify_partial(group_pk, signed)
            await self._push(duty, group_pk, signed)


def _single_set_bit(bits) -> int:
    """Committee position of the (single) set bit in an unaggregated
    attestation's aggregation_bits (reference: validatorapi.go:248)."""
    from ..eth2util.ssz import Bitlist
    bools = Bitlist.to_bools(bits)
    set_bits = [i for i, b in enumerate(bools) if b]
    if len(set_bits) != 1:
        raise VapiError("expected exactly one aggregation bit")
    return set_bits[0]


def _pubkey_by_validator_index(defset, validator_index: int) -> PubKey:
    for pk, d in (defset or {}).items():
        if getattr(d, "validator_index", None) == validator_index:
            return pk
    raise VapiError(f"no duty definition for validator {validator_index}")
