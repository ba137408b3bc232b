"""DKG keygen math — transport-agnostic pure functions.

Pedersen/Feldman 2-round DKG (the reference's FROST-DKG shape,
reference: dkg/frost.go:33-125, one participant instance per validator):

Round 1 (per participant i, per validator v):
    sample f_iv of degree t−1; broadcast Feldman commitments
    A_iv = (a_0·G, …, a_{t−1}·G); send f_iv(k) to participant k.
Round 2 (per participant k, per validator v):
    verify every received share against the sender's commitments;
    final share x_kv = Σ_i f_iv(k);
    group pubkey  = Σ_i A_iv[0];
    summed commitments give every participant's pubshare.

Keycast (trusted dealer, reference: dkg/keycast.go): the leader runs
GenerateTSS and distributes shares — one round, weaker trust model.

A copy of the JAX package's dkg/keygen.py on this package's tbls: the same
byte outputs for the same `rng`, and the share-proof batches are one
`tbls.batch_verify`, which the card's backend serves.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from ..tbls import api as tbls
from ..tbls import shamir
from ..tbls.ref.fields import R


@dataclass(frozen=True)
class Round1Broadcast:
    """Public part of a participant's round-1 output for one validator."""

    commitments: tuple[bytes, ...]  # t Feldman commitments


@dataclass(frozen=True)
class Round1Shares:
    """Private part: share for each receiving participant (1-based idx)."""

    shares: dict  # recipient idx -> PrivKey bytes


@dataclass(frozen=True)
class KeygenResult:
    """One node's view of one validator's keygen outcome."""

    group_pubkey: bytes
    secret_share: bytes                # this node's share of the group key
    pubshares: dict                    # share idx -> pubshare (all nodes)


def pedersen_round1(threshold: int, num_nodes: int,
                    rng=None) -> tuple[Round1Broadcast, Round1Shares]:
    randbelow = rng.randrange if rng is not None else (
        lambda n: secrets.randbelow(n))
    secret = randbelow(R)
    shares, coeffs = shamir.split_secret(secret, threshold, num_nodes, rng)
    return (Round1Broadcast(tuple(tbls.commit_coeff(a) for a in coeffs)),
            Round1Shares({i: tbls.int_to_privkey(s)
                          for i, s in shares.items()}))


def pedersen_round2(self_idx: int, num_nodes: int,
                    broadcasts: dict, received_shares: dict) -> KeygenResult:
    """`broadcasts`: sender idx -> Round1Broadcast;
    `received_shares`: sender idx -> PrivKey (this node's share from them).

    Verifies every share against its sender's commitments (the batched
    verify workload), then combines.
    Raises ValueError naming the misbehaving sender on bad shares."""
    if set(broadcasts) != set(received_shares):
        raise ValueError("round1 broadcast/share sender sets differ")
    for sender, share in received_shares.items():
        if not tbls.feldman_verify(share, self_idx,
                                   broadcasts[sender].commitments):
            raise ValueError(f"invalid DKG share from participant {sender}")

    secret_share = tbls.add_privkeys(list(received_shares.values()))
    group_pubkey = tbls.add_pubkeys(
        [b.commitments[0] for b in broadcasts.values()])
    # summed commitment polynomial gives every node's pubshare
    pubshares = {}
    for k in range(1, num_nodes + 1):
        pubshares[k] = tbls.add_pubkeys(
            [tbls.feldman_eval(b.commitments, k)
             for b in broadcasts.values()])
    return KeygenResult(group_pubkey=group_pubkey,
                        secret_share=secret_share, pubshares=pubshares)


def keycast_deal(threshold: int, num_nodes: int,
                 seed: bytes | None = None) -> tuple[bytes, dict, dict]:
    """Trusted-dealer keygen for one validator: returns
    (group_pubkey, {idx: share_privkey}, {idx: pubshare})."""
    tss, shares = tbls.generate_tss(threshold, num_nodes, seed=seed)
    return (tss.group_pubkey, shares,
            {i: tss.public_share(i) for i in shares})


# ---------------------------------------------------------------------------
# Batched share possession proofs — the DKG's batched-pairing workload.
#
# After round 2 every participant must prove it actually holds its share
# (the reference signs the ceremony lock hash with every share key and
# aggregates, reference: dkg/dkg.go:426-478).  Each proof is an ordinary
# partial signature by the share over the ceremony transcript, verified
# against the share's Feldman-derived pubshare — which means verification
# of ALL proofs across ALL validators is one `tbls.batch_verify` call and
# rides the batched RLC pairing kernels on the card's backend
# (BASELINE.json config 5: FROST DKG batched share-verify, 1k validators).
# ---------------------------------------------------------------------------

_SHARE_PROOF_DST = b"charon-tpu/dkg-share-proof/v1/"


def share_proof_msg(transcript_hash: bytes) -> bytes:
    """Domain-separated message a share proof signs: the ceremony
    transcript (lock) hash, shared by every validator of the ceremony."""
    return _SHARE_PROOF_DST + transcript_hash


def share_proof(share, transcript_hash: bytes) -> bytes:
    """Prove possession of `share`: partial-sign the ceremony transcript."""
    return tbls.partial_sign(share, share_proof_msg(transcript_hash))


def verify_share_proofs(items, transcript_hash: bytes) -> list:
    """items: [(pubshare, proof_sig)] across any number of validators /
    share indices → [bool], ONE batched pairing verification."""
    msg = share_proof_msg(transcript_hash)
    return tbls.batch_verify([(ps, msg, sig) for ps, sig in items])


def verify_share_proofs_multi(items) -> list:
    """Cross-ceremony batched share-proof verification: items are
    [(pubshare, proof_sig, transcript_hash)] with each proof signing ITS
    OWN ceremony's transcript message → [bool], still ONE batched
    pairing verification.  A coordinator validating many single-cluster
    ceremonies at once sees per-item-DISTINCT messages — the cold-cache
    hash-to-G2 workload the device h2c path (ops/cuda_h2c) exists for,
    config 5's cold-cache entry."""
    return tbls.batch_verify(
        [(ps, share_proof_msg(th), sig) for ps, sig, th in items])
