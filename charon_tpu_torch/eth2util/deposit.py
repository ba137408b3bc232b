"""Deposit data: signing roots and deposit-data.json.

Mirrors reference eth2util/deposit/deposit.go:70-146: DepositMessage root
wrapped with DOMAIN_DEPOSIT (genesis fork, empty genesis-validators-root),
and the deposit-data.json file consumed by the launchpad.  A copy of the
JAX package's eth2util/deposit.py.
"""

from __future__ import annotations

import json

from .signing import DomainName, compute_domain
from .spec import DepositData, DepositMessage, SigningData

ETH1_WITHDRAWAL_PREFIX = b"\x01"
DEPOSIT_AMOUNT_GWEI = 32_000_000_000


def withdrawal_credentials(eth1_address: bytes) -> bytes:
    """0x01 credentials for an eth1 withdrawal address."""
    if len(eth1_address) != 20:
        raise ValueError("eth1 address must be 20 bytes")
    return ETH1_WITHDRAWAL_PREFIX + bytes(11) + eth1_address


def deposit_signing_root(pubkey: bytes, withdrawal_creds: bytes,
                         fork_version: bytes,
                         amount: int = DEPOSIT_AMOUNT_GWEI) -> bytes:
    """The root each key share partially signs during the ceremony
    (reference: deposit.go GetMessageSigningRoot).  DOMAIN_DEPOSIT uses the
    fork version directly with an empty genesis-validators-root."""
    msg_root = DepositMessage(pubkey=pubkey,
                              withdrawal_credentials=withdrawal_creds,
                              amount=amount).hash_tree_root()
    domain = compute_domain(DomainName.DEPOSIT, fork_version, bytes(32))
    return SigningData(object_root=msg_root, domain=domain).hash_tree_root()


def deposit_data_json(deposits: list[DepositData],
                      fork_version: bytes) -> list[dict]:
    """reference: deposit.go MarshalDepositData."""
    out = []
    for d in deposits:
        msg_root = DepositMessage(
            pubkey=d.pubkey, withdrawal_credentials=d.withdrawal_credentials,
            amount=d.amount).hash_tree_root()
        out.append({
            "pubkey": d.pubkey.hex(),
            "withdrawal_credentials": d.withdrawal_credentials.hex(),
            "amount": str(d.amount),
            "signature": d.signature.hex(),
            "deposit_message_root": msg_root.hex(),
            "deposit_data_root": d.hash_tree_root().hex(),
            "fork_version": fork_version.hex(),
        })
    return out


def save_deposit_data(path: str, deposits: list[DepositData],
                      fork_version: bytes) -> None:
    with open(path, "w") as f:
        json.dump(deposit_data_json(deposits, fork_version), f, indent=2)
