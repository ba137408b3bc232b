"""HTTP validator client — a real VC speaking beacon-API HTTP to the node.

The reference's simnet integration test drives real Teku containers against
the charon validator-API router (app/simnet_test.go:177-190); this is the
equivalent here: a self-timed validator client that discovers its duties
and submits share-signed attestations/blocks over genuine HTTP through
`app.router.VapiRouter` — exercising the pubshare↔group mapping, the
intercepted endpoints, and the reverse proxy (genesis/spec queries pass
through to the beacon mock).

A copy of the JAX package's testutil/httpvc.py over the port's HTTP/1.1
client (`app/http1.py`) in place of aiohttp, with two additions: `flows`
narrows what it signs (``attester``, ``proposer``; default both), as the
in-process validator mock's `flows` does; and each slot's duties run as
a task of their own, as a real VC's per-duty timers do, so a slot whose
attestation data comes late does not hold the next slot's tick (the JAX
client awaits each slot before it looks at the clock again).  `timeout`
is the seconds a request may take (the JAX client's 10 by default).
Like the JAX one it has no sync-committee flow.  Run as a process of its
own, a VC beside a node:

    python -m charon_tpu_torch.testutil.httpvc --vapi-url URL \\
        --keystore-dir DIR [--flows attester] [--max-slots N]

It loads the share keys from the keystores, signs until `--max-slots`
slots have passed or SIGTERM, and prints its counts as one JSON line.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time

from ..app.http1 import HTTPClient
from ..eth2util import beaconapi as api
from ..eth2util import spec
from ..eth2util.signing import DomainName, signing_root
from ..eth2util.ssz import Bitlist, uint64
from ..tbls import api as tbls

log = logging.getLogger(__name__)

#: the duty flows the client can run
FLOWS = ("attester", "proposer")


class HttpValidatorClient:
    """One node's downstream VC: signs with SHARE keys, speaks HTTP."""

    def __init__(self, vapi_addr: str,
                 privkey_by_pubshare: dict[bytes, bytes],
                 flows: tuple[str, ...] | None = None,
                 timeout: float = 10.0):
        self.addr = vapi_addr.rstrip("/")
        self._keys = dict(privkey_by_pubshare)   # 48B pubshare -> share sk
        self._flows = set(flows) if flows else set(FLOWS)
        unknown = self._flows - set(FLOWS)
        if unknown:
            raise ValueError(f"unknown http validator client flows {unknown}")
        self._client: HTTPClient | None = None
        self._timeout = timeout
        self._slot_tasks: set[asyncio.Task] = set()
        self._fork: bytes | None = None
        self._gvr = bytes(32)
        self._genesis = 0.0
        self._slot_dur = 1.0
        self._spe = 16
        self._index_to_pubshare: dict[int, bytes] = {}
        self._stop = False
        self.submitted_atts = 0
        self.submitted_blocks = 0
        self.failed_slots = 0

    async def _get(self, path: str, params=None) -> dict:
        resp = await self._client.get(self.addr + path, params=params)
        body = resp.json()
        if resp.status != 200:
            raise RuntimeError(f"GET {path}: {resp.status} {body}")
        return body

    async def _post(self, path: str, payload) -> dict:
        resp = await self._client.post(self.addr + path, json_body=payload)
        text = resp.text()
        if resp.status not in (200, 202):
            raise RuntimeError(f"POST {path}: {resp.status} {text}")
        return {} if not text else json.loads(text)

    async def _bootstrap(self) -> None:
        # genesis + spec ride the REVERSE PROXY (not intercepted endpoints)
        gen = (await self._get("/eth/v1/beacon/genesis"))["data"]
        self._genesis = float(gen["genesis_time"])
        self._gvr = api.to_bytes(gen["genesis_validators_root"], 32)
        self._fork = api.to_bytes(gen["genesis_fork_version"], 4)
        sp = (await self._get("/eth/v1/config/spec"))["data"]
        self._slot_dur = float(sp["SECONDS_PER_SLOT"])
        self._spe = int(sp["SLOTS_PER_EPOCH"])
        # validator discovery by PUBSHARE ids (router maps to group keys
        # upstream and back to pubshares in the response)
        ids = [api.hex_of(ps) for ps in self._keys]
        vals = await self._post("/eth/v1/beacon/states/head/validators",
                                {"ids": ids})
        for v in vals["data"]:
            ps = api.to_bytes(v["validator"]["pubkey"], 48)
            if ps in self._keys:
                self._index_to_pubshare[int(v["index"])] = ps

    def _sign(self, pubshare: bytes, domain: DomainName, root: bytes) -> bytes:
        return tbls.sign(self._keys[pubshare],
                         signing_root(domain, root, self._fork, self._gvr))

    async def run(self, max_slots: int = 64) -> None:
        self._client = HTTPClient(timeout=self._timeout)
        try:
            await self._bootstrap()
            seen = -1
            deadline = time.time() + max_slots * self._slot_dur
            while not self._stop and time.time() < deadline:
                slot = int((time.time() - self._genesis) // self._slot_dur)
                if slot <= seen:
                    await asyncio.sleep(self._slot_dur / 20)
                    continue
                seen = slot
                task = asyncio.get_running_loop().create_task(
                    self._slot(slot))
                self._slot_tasks.add(task)
                task.add_done_callback(self._slot_tasks.discard)
        finally:
            for task in list(self._slot_tasks):
                task.cancel()
            await asyncio.gather(*self._slot_tasks, return_exceptions=True)
            await self._client.close()

    async def _slot(self, slot: int) -> None:
        flows = []
        if "attester" in self._flows:
            flows.append(self._attest(slot))
        if "proposer" in self._flows:
            flows.append(self._propose(slot))
        try:
            await asyncio.gather(*flows)
        except Exception:
            self.failed_slots += 1
            log.exception("slot %d duties failed", slot)

    def stop(self) -> None:
        self._stop = True

    def stats(self) -> dict:
        return {"submitted_atts": self.submitted_atts,
                "submitted_blocks": self.submitted_blocks,
                "failed_slots": self.failed_slots,
                "validators": len(self._index_to_pubshare)}

    # -- duty flows ---------------------------------------------------------

    async def _attest(self, slot: int) -> None:
        epoch = slot // self._spe
        duties = await self._post(
            f"/eth/v1/validator/duties/attester/{epoch}",
            [str(i) for i in self._index_to_pubshare])
        for d in duties["data"]:
            if int(d["slot"]) != slot:
                continue
            ps = api.to_bytes(d["pubkey"], 48)
            if ps not in self._keys:
                continue
            data = await self._get(
                "/eth/v1/validator/attestation_data",
                {"slot": str(slot),
                 "committee_index": d["committee_index"]})
            att_data = api.att_data_from(data["data"])
            bools = [False] * int(d["committee_length"])
            bools[int(d["validator_committee_index"])] = True
            sig = self._sign(ps, DomainName.BEACON_ATTESTER,
                             att_data.hash_tree_root())
            att = spec.Attestation(aggregation_bits=Bitlist.from_bools(bools),
                                   data=att_data, signature=sig)
            await self._post("/eth/v1/beacon/pool/attestations",
                             [api.attestation_json(att)])
            self.submitted_atts += 1

    async def _propose(self, slot: int) -> None:
        epoch = slot // self._spe
        duties = await self._get(
            f"/eth/v1/validator/duties/proposer/{epoch}")
        for d in duties["data"]:
            if int(d["slot"]) != slot:
                continue
            ps = api.to_bytes(d["pubkey"], 48)
            if ps not in self._keys:
                continue
            randao = self._sign(ps, DomainName.RANDAO,
                                uint64.hash_tree_root(epoch))
            blk = await self._get(f"/eth/v2/validator/blocks/{slot}",
                                  {"randao_reveal": api.hex_of(randao)})
            block = api.block_from(blk["data"])
            sig = self._sign(ps, DomainName.BEACON_PROPOSER,
                             block.hash_tree_root())
            signed = spec.SignedBeaconBlock(message=block, signature=sig)
            await self._post("/eth/v1/beacon/blocks",
                             api.signed_block_json(signed))
            self.submitted_blocks += 1


def load_share_keys(keystore_dir: str) -> dict[bytes, bytes]:
    """pubshare → share private key, from a node's keystores."""
    from ..eth2util import keystore

    return {tbls.privkey_to_pubkey(sk): sk
            for sk in keystore.load_keys(keystore_dir)}


def main(argv: list[str] | None = None) -> int:
    import argparse
    import signal

    p = argparse.ArgumentParser(
        prog="python -m charon_tpu_torch.testutil.httpvc",
        description="an HTTP validator client for one DV node's "
                    "validator API")
    p.add_argument("--vapi-url", required=True,
                   help="the node's validator API, e.g. "
                        "http://127.0.0.1:3600")
    p.add_argument("--keystore-dir", required=True,
                   help="the node's share-key keystores")
    p.add_argument("--flows", default="",
                   help="comma-separated flows (attester, proposer; "
                        "default both)")
    p.add_argument("--max-slots", type=int, default=64)
    p.add_argument("--timeout", type=float, default=10.0,
                   help="seconds a request may take")
    p.add_argument("--tbls-scheme", default="bls",
                   choices=["bls", "insecure-test"])
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    tbls.set_scheme(args.tbls_scheme)
    vc = HttpValidatorClient(
        args.vapi_url, load_share_keys(args.keystore_dir),
        flows=tuple(f for f in args.flows.split(",") if f) or None,
        timeout=args.timeout)

    async def run() -> None:
        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM,
                                                      vc.stop)
        await vc.run(max_slots=args.max_slots)

    asyncio.run(run())
    print(json.dumps(vc.stats()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
