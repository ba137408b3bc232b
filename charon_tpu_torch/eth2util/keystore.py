"""EIP-2335 keystores: scrypt + AES-128-CTR + sha256 checksum.

Mirrors reference eth2util/keystore/keystore.go:54-189 (load/store of
validator key shares as keystore-%d.json + .txt password files).

A copy of the JAX package's eth2util/keystore.py over the port's
AES-128-CTR (`eth2util/aes.py`) in place of `cryptography`'s: a keystore
written by either package decrypts in the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import secrets
import uuid

from . import aes

# Insecure-but-fast scrypt cost for DV key shares, mirroring the
# reference's choice and rationale (reference: eth2util/keystore/
# keystore.go:146-160 "insecure parameters" for large validator counts).
SCRYPT_N_INSECURE = 2**4
SCRYPT_N_STANDARD = 2**18


def _scrypt(password: bytes, salt: bytes, n: int) -> bytes:
    return hashlib.scrypt(password, salt=salt, n=n, r=8, p=1, dklen=32)


def encrypt(secret: bytes, password: str, *,
            insecure: bool = True) -> dict:
    """Encrypt a 32-byte BLS secret into an EIP-2335 keystore dict.

    Includes the EIP-2335 `path` and `pubkey` fields standard validator
    clients require on import (reference: eth2util/keystore/
    keystore.go:139-172 writes both; round-1 advisor finding)."""
    salt = secrets.token_bytes(32)
    iv = secrets.token_bytes(16)
    n = SCRYPT_N_INSECURE if insecure else SCRYPT_N_STANDARD
    dk = _scrypt(password.encode(), salt, n)
    ct = aes.ctr(dk[:16], iv, secret)
    checksum = hashlib.sha256(dk[16:32] + ct).digest()
    from ..tbls import api as _tbls

    return {
        "path": "m/12381/3600/0/0/0",  # EIP-2334 signing-key path
        "pubkey": _tbls.privkey_to_pubkey(secret).hex(),
        "crypto": {
            "kdf": {"function": "scrypt",
                    "params": {"dklen": 32, "n": n, "r": 8, "p": 1,
                               "salt": salt.hex()},
                    "message": ""},
            "checksum": {"function": "sha256", "params": {},
                         "message": checksum.hex()},
            "cipher": {"function": "aes-128-ctr", "params": {"iv": iv.hex()},
                       "message": ct.hex()},
        },
        "description": "charon-tpu validator key share",
        "uuid": str(uuid.uuid4()),
        "version": 4,
    }


def decrypt(keystore: dict, password: str) -> bytes:
    crypto = keystore["crypto"]
    kdf = crypto["kdf"]["params"]
    dk = _scrypt(password.encode(), bytes.fromhex(kdf["salt"]), kdf["n"])
    ct = bytes.fromhex(crypto["cipher"]["message"])
    want = bytes.fromhex(crypto["checksum"]["message"])
    if hashlib.sha256(dk[16:32] + ct).digest() != want:
        raise ValueError("keystore checksum mismatch (wrong password?)")
    iv = bytes.fromhex(crypto["cipher"]["params"]["iv"])
    return aes.ctr(dk[:16], iv, ct)


def store_keys(secrets_list: list[bytes], dir_path: str) -> None:
    """Write keystore-%d.json + keystore-%d.txt password files
    (reference: eth2util/keystore/keystore.go StoreKeys)."""
    os.makedirs(dir_path, exist_ok=True)
    for i, sk in enumerate(secrets_list):
        password = secrets.token_hex(16)
        ks = encrypt(sk, password)
        with open(os.path.join(dir_path, f"keystore-{i}.json"), "w") as f:
            json.dump(ks, f, indent=2)
        with open(os.path.join(dir_path, f"keystore-{i}.txt"), "w") as f:
            f.write(password)


def load_keys(dir_path: str) -> list[bytes]:
    """Load all keystore-*.json via sibling .txt passwords."""
    out = []
    i = 0
    while True:
        jpath = os.path.join(dir_path, f"keystore-{i}.json")
        tpath = os.path.join(dir_path, f"keystore-{i}.txt")
        if not os.path.exists(jpath):
            break
        with open(jpath) as f:
            ks = json.load(f)
        with open(tpath) as f:
            password = f.read().strip()
        out.append(decrypt(ks, password))
        i += 1
    return out
