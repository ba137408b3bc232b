"""Cluster fabrication for tests — the reference's cluster.NewForT
(reference: cluster/test_cluster.go:171): build a t-of-n cluster with known
key shares for `m` distributed validators.  A copy of the JAX package's
testutil/cluster.py."""

from __future__ import annotations

from dataclasses import dataclass

from ..core.types import PubKey, pubkey_from_bytes
from ..tbls import api as tbls


@dataclass(frozen=True)
class TestValidator:
    tss: tbls.TSS
    group_pubkey: PubKey
    share_privkeys: dict[int, bytes]   # 1-based share idx -> privkey bytes
    pubshares: dict[int, bytes]        # 1-based share idx -> 48B pubshare


@dataclass(frozen=True)
class TestCluster:
    threshold: int
    num_nodes: int
    validators: list[TestValidator]

    def pubshare_map(self, share_idx: int) -> dict[PubKey, bytes]:
        """group pubkey -> this node's pubshare (validatorapi input)."""
        return {v.group_pubkey: v.pubshares[share_idx]
                for v in self.validators}

    def share_privkey_map(self, share_idx: int) -> dict[PubKey, bytes]:
        """group pubkey -> this node's share private key (vmock input)."""
        return {v.group_pubkey: v.share_privkeys[share_idx]
                for v in self.validators}


def new_cluster_for_test(threshold: int, num_nodes: int,
                         num_validators: int,
                         seed: bytes = b"charon-tpu-test") -> TestCluster:
    vals = []
    for v in range(num_validators):
        tss, shares = tbls.generate_tss(threshold, num_nodes,
                                        seed=seed + bytes([v]))
        pubshares = {i: tss.public_share(i) for i in shares}
        vals.append(TestValidator(
            tss=tss,
            group_pubkey=pubkey_from_bytes(tss.group_pubkey),
            share_privkeys=shares,
            pubshares=pubshares))
    return TestCluster(threshold=threshold, num_nodes=num_nodes,
                       validators=vals)
