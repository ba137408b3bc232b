"""The DKG ceremony — the reference's dkg.Run (reference: dkg/dkg.go:57-211).

Flow: load definition → mesh up → sync barrier (all peers online, matching
definition hash — reference dkg/dkg.go:274-333 + dkg/sync/) → run keygen
(keycast or pedersen, all validators' instances sharing transport rounds —
reference dkg/frost.go:62-97 runFrostParallel) → sign + exchange + verify
lock-hash partial signatures and deposit-data signatures → write keystores,
cluster-lock.json, deposit-data.json (reference: dkg/disk.go).

Protocols:
    /charon_tpu/dkg/sync/1.0.0      definition-hash barrier
    /charon_tpu/dkg/round1/1.0.0    pedersen round-1 (commitments + shares)
    /charon_tpu/dkg/keycast/1.0.0   dealer share distribution
    /charon_tpu/dkg/lock_sig/1.0.0  lock-hash partial-signature exchange

A copy of the JAX package's dkg/ceremony.py on this package's cluster,
eth2util, p2p and tbls modules: the same protocol IDs and JSON payloads,
so JAX and port operators can run one ceremony together.  The lock and
deposit verifies and combines always run through `tbls.dispatch` (the
port has no inline mode), on the card unless the process chose the CPU.
Unlike the JAX barrier, `sync_barrier` keeps dialling a peer that is not
listening yet until its timeout, so operator processes that start
seconds apart still meet.
"""

from __future__ import annotations

import asyncio
import hashlib
import os

from ..cluster.definition import (Definition, DistValidator, Lock,
                                  definition_hash, lock_hash, lock_to_json,
                                  save_json)
from ..eth2util import deposit as deposit_mod
from ..eth2util import keystore
from ..eth2util.spec import DepositData
from ..p2p.transport import TCPMesh, encode_json, decode_json
from ..tbls import api as tbls
from ..tbls import dispatch
from . import keygen

SYNC_PROTOCOL = "/charon_tpu/dkg/sync/1.0.0"
ROUND1_PROTOCOL = "/charon_tpu/dkg/round1/1.0.0"
ECHO_PROTOCOL = "/charon_tpu/dkg/echo/1.0.0"
KEYCAST_PROTOCOL = "/charon_tpu/dkg/keycast/1.0.0"
LOCKSIG_PROTOCOL = "/charon_tpu/dkg/lock_sig/1.0.0"

#: seconds between the sync barrier's dials of a peer not listening yet
SYNC_RETRY_S = 0.25


class Ceremony:
    """One operator's side of the ceremony.  `index` is 0-based (share idx
    = index + 1)."""

    def __init__(self, definition: Definition, mesh: TCPMesh, index: int,
                 def_hash: bytes):
        self.definition = definition
        self.mesh = mesh
        self.index = index
        self.share_idx = index + 1
        self.def_hash = def_hash
        self.n = definition.num_operators
        self.t = definition.threshold
        self.m = definition.num_validators
        # inbound state
        self._sync_seen: dict[int, bytes] = {index: def_hash}
        self._sync_evt = asyncio.Event()
        self._round1: dict[int, dict] = {}   # sender -> payload
        self._round1_evt = asyncio.Event()
        self._echoes: dict[int, dict] = {}   # sender -> {dealer: digest hex}
        self._echo_evt = asyncio.Event()
        self._keycast: dict | None = None
        self._keycast_evt = asyncio.Event()
        self._lock_sigs: dict[int, list] = {index: []}
        self._locksig_evt = asyncio.Event()
        mesh.register_handler(SYNC_PROTOCOL, self._on_sync)
        mesh.register_handler(ROUND1_PROTOCOL, self._on_round1)
        mesh.register_handler(ECHO_PROTOCOL, self._on_echo)
        mesh.register_handler(KEYCAST_PROTOCOL, self._on_keycast)
        mesh.register_handler(LOCKSIG_PROTOCOL, self._on_locksig)

    # -- inbound handlers ---------------------------------------------------

    async def _on_sync(self, sender: int, payload: bytes):
        obj = decode_json(payload)
        self._sync_seen[sender] = bytes.fromhex(obj["def_hash"])
        if len(self._sync_seen) == self.n:
            self._sync_evt.set()
        return encode_json({"def_hash": self.def_hash.hex()})

    async def _on_round1(self, sender: int, payload: bytes):
        self._round1[sender] = decode_json(payload)
        if len(self._round1) == self.n - 1:
            self._round1_evt.set()
        return None

    async def _on_echo(self, sender: int, payload: bytes):
        self._echoes[sender] = decode_json(payload)
        if len(self._echoes) == self.n - 1:
            self._echo_evt.set()
        return None

    async def _on_keycast(self, sender: int, payload: bytes):
        if sender == 0:  # only the dealer (operator 0) may cast
            self._keycast = decode_json(payload)
            self._keycast_evt.set()
        return None

    async def _on_locksig(self, sender: int, payload: bytes):
        self._lock_sigs[sender] = decode_json(payload)["sigs"]
        if len(self._lock_sigs) == self.n:
            self._locksig_evt.set()
        return None

    # -- phases -------------------------------------------------------------

    async def sync_barrier(self, timeout: float = 30.0) -> None:
        """All peers connected with a matching definition hash
        (reference: dkg/sync/server.go:46-258).  A peer that refuses the
        connection (its process is not listening yet) is dialled again
        every SYNC_RETRY_S until `timeout`."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        for peer in self.mesh.peers:
            while True:
                try:
                    reply = await self.mesh.send_receive(
                        peer, SYNC_PROTOCOL,
                        encode_json({"def_hash": self.def_hash.hex()}),
                        timeout=max(deadline - loop.time(), 0.0))
                    break
                except asyncio.TimeoutError:
                    raise TimeoutError(
                        f"peer {peer} unreachable in sync barrier")
                except ConnectionError:
                    if loop.time() + SYNC_RETRY_S >= deadline:
                        raise TimeoutError(
                            f"peer {peer} unreachable in sync barrier")
                    await asyncio.sleep(SYNC_RETRY_S)
            self._sync_seen[peer] = bytes.fromhex(
                decode_json(reply)["def_hash"])
        bad = {p: h for p, h in self._sync_seen.items() if h != self.def_hash}
        if bad:
            raise ValueError(f"definition hash mismatch with peers {list(bad)}")

    async def run_pedersen(self, timeout: float = 60.0) -> list[keygen.KeygenResult]:
        """All m validators' 2-round DKGs sharing one transport round
        (reference: dkg/frost.go:62-97)."""
        # Round 1: generate for every validator, send each peer its shares.
        my_bcasts, my_shares = [], []
        for _ in range(self.m):
            b, s = keygen.pedersen_round1(self.t, self.n)
            my_bcasts.append(b)
            my_shares.append(s)
        for peer in self.mesh.peers:
            payload = {
                "commitments": [[c.hex() for c in b.commitments]
                                for b in my_bcasts],
                "shares": [s.shares[peer + 1].hex() for s in my_shares],
            }
            await self.mesh.send_async(peer, ROUND1_PROTOCOL,
                                       encode_json(payload))
        if self.n > 1:
            await asyncio.wait_for(self._round1_evt.wait(), timeout)
            await self._echo_commitments(my_bcasts, timeout)

        # Round 2: verify + combine per validator.
        results = []
        for v in range(self.m):
            bcasts = {self.share_idx: my_bcasts[v]}
            shares = {self.share_idx: my_shares[v].shares[self.share_idx]}
            for sender, payload in self._round1.items():
                bcasts[sender + 1] = keygen.Round1Broadcast(tuple(
                    bytes.fromhex(c) for c in payload["commitments"][v]))
                shares[sender + 1] = bytes.fromhex(payload["shares"][v])
            results.append(keygen.pedersen_round2(
                self.share_idx, self.n, bcasts, shares))
        return results

    async def _echo_commitments(self, my_bcasts, timeout: float) -> None:
        """Reliable-broadcast check on round-1 Feldman commitments: every
        peer echoes a per-dealer digest of the commitments it received; a
        dealer who equivocated (sent different commitments to different
        peers) is identified by digest mismatch and the ceremony aborts
        naming them.  (The reference gets this property from FROST's
        broadcast-round assumptions.)"""
        def digest(commitments) -> str:
            blob = encode_json(commitments)
            return hashlib.sha256(blob).hexdigest()

        mine: dict[str, str] = {
            str(self.index): digest([[c.hex() for c in b.commitments]
                                     for b in my_bcasts])}
        for sender, payload in self._round1.items():
            mine[str(sender)] = digest(payload["commitments"])
        await asyncio.gather(*(
            self.mesh.send_async(peer, ECHO_PROTOCOL, encode_json(mine))
            for peer in self.mesh.peers))
        await asyncio.wait_for(self._echo_evt.wait(), timeout)
        for sender, seen in self._echoes.items():
            for dealer, dig in seen.items():
                if dealer in mine and dig != mine[dealer]:
                    raise ValueError(
                        f"dealer {dealer} equivocated round-1 commitments "
                        f"(digest mismatch reported by peer {sender})")

    async def run_keycast(self, timeout: float = 60.0) -> list[keygen.KeygenResult]:
        """Operator 0 deals (reference: dkg/keycast.go leader)."""
        if self.index == 0:
            deals = [keygen.keycast_deal(self.t, self.n)
                     for _ in range(self.m)]
            for peer in self.mesh.peers:
                payload = {
                    "validators": [{
                        "group": g.hex(),
                        "share": shares[peer + 1].hex(),
                        "pubshares": {str(i): p.hex()
                                      for i, p in pubs.items()},
                    } for g, shares, pubs in deals]}
                await self.mesh.send_async(peer, KEYCAST_PROTOCOL,
                                           encode_json(payload))
            return [keygen.KeygenResult(g, shares[1], pubs)
                    for g, shares, pubs in deals]
        await asyncio.wait_for(self._keycast_evt.wait(), timeout)
        out = []
        for v in self._keycast["validators"]:
            out.append(keygen.KeygenResult(
                group_pubkey=bytes.fromhex(v["group"]),
                secret_share=bytes.fromhex(v["share"]),
                pubshares={int(i): bytes.fromhex(p)
                           for i, p in v["pubshares"].items()}))
        return out

    async def sign_and_aggregate(
            self, results: list[keygen.KeygenResult],
            withdrawal_creds: bytes,
            timeout: float = 60.0) -> tuple[Lock, list[DepositData]]:
        """Each node partial-signs the lock hash AND the deposit root per
        validator; one exchange round; threshold-combine both into group
        signatures (reference: dkg/dkg.go:336-478 signAndAggLockHash +
        signAndAggDepositData sharing the exchanger)."""
        validators = tuple(
            DistValidator(
                public_key=r.group_pubkey,
                public_shares=tuple(r.pubshares[i + 1]
                                    for i in range(self.n)))
            for r in results)
        lock = Lock(definition=self.definition, validators=validators)
        msg = lock_hash(lock)
        fork = self.definition.fork_version
        dep_roots = [deposit_mod.deposit_signing_root(
            r.group_pubkey, withdrawal_creds, fork) for r in results]

        my = {"lock": [tbls.partial_sign(r.secret_share, msg).hex()
                       for r in results],
              "deposit": [tbls.partial_sign(r.secret_share, root).hex()
                          for r, root in zip(results, dep_roots)]}
        self._lock_sigs[self.index] = my
        for peer in self.mesh.peers:
            await self.mesh.send_async(peer, LOCKSIG_PROTOCOL,
                                       encode_json({"sigs": my}))
        if self.n > 1:
            await asyncio.wait_for(self._locksig_evt.wait(), timeout)

        # Every per-partial verification, the threshold combines, and
        # the group-signature verifications run as BATCHED launches
        # awaited OFF the event loop through the dispatch pipeline: this
        # coroutine must not block the mesh handlers mid-ceremony on
        # device work (the pipeline's loop guard rejects the blocking
        # batch entry points on the loop).  Row order: (v0 lock,
        # v0 deposit, v1 lock, …).
        pipe = dispatch.default_pipeline()

        rows = []       # (r, kind, root) aligned with the combine batch
        row_partials = []
        ver_entries, ver_meta = [], []
        for v, (r, droot) in enumerate(zip(results, dep_roots)):
            for kind, root in (("lock", msg), ("deposit", droot)):
                partials = {}
                for sender, sigs in self._lock_sigs.items():
                    sig = bytes.fromhex(sigs[kind][v])
                    ver_entries.append((r.pubshares[sender + 1], root, sig))
                    ver_meta.append((kind, sender))
                    partials[sender + 1] = sig
                rows.append((r, kind, root))
                row_partials.append(partials)
        for ok, (kind, sender) in zip(await pipe.batch_verify(ver_entries),
                                      ver_meta):
            if not ok:
                raise ValueError(
                    f"bad {kind} partial sig from operator {sender}")
        batch = [dict(list(p.items())[: self.t]) for p in row_partials]
        combined = await pipe.threshold_combine(batch)
        group_entries = [(r.group_pubkey, root, sig)
                         for (r, kind, root), sig in zip(rows, combined)]
        for ok, (r, kind, root) in zip(await pipe.batch_verify(group_entries),
                                       rows):
            if not ok:
                raise ValueError(f"{kind} group signature invalid")
        group_sigs = combined[0::2]
        deposits = [
            DepositData(
                pubkey=r.group_pubkey, withdrawal_credentials=withdrawal_creds,
                amount=deposit_mod.DEPOSIT_AMOUNT_GWEI,
                signature=combined[2 * v + 1])
            for v, r in enumerate(results)]

        return (Lock(definition=self.definition, validators=validators,
                     signature_aggregate=b"".join(group_sigs)), deposits)


async def run_dkg(definition: Definition, mesh: TCPMesh, index: int,
                  output_dir: str, algorithm: str | None = None,
                  withdrawal_address: bytes = b"\x00" * 20) -> Lock:
    """Full ceremony for one operator; writes outputs and returns the Lock
    (reference: dkg/dkg.go:57-211)."""
    algorithm = algorithm or definition.dkg_algorithm
    cer = Ceremony(definition, mesh, index, definition_hash(definition))
    await cer.sync_barrier()
    if algorithm in ("default", "pedersen", "frost"):
        results = await cer.run_pedersen()
    elif algorithm == "keycast":
        results = await cer.run_keycast()
    else:
        raise ValueError(f"unknown dkg algorithm {algorithm!r}")
    creds = deposit_mod.withdrawal_credentials(withdrawal_address)
    lock, deposits = await cer.sign_and_aggregate(results, creds)
    fork = definition.fork_version

    def write_outputs() -> None:
        os.makedirs(output_dir, exist_ok=True)
        keystore.store_keys([r.secret_share for r in results],
                            os.path.join(output_dir, "validator_keys"))
        save_json(os.path.join(output_dir, "cluster-lock.json"),
                  lock_to_json(lock))
        deposit_mod.save_deposit_data(
            os.path.join(output_dir, "deposit-data.json"), deposits, fork)

    # key material hits disk off-loop: the mesh handlers of peers still
    # finishing their ceremony are served by THIS loop
    await asyncio.to_thread(write_outputs)
    return lock
