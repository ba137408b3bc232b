"""PeerInfo — periodic peer-metadata gossip with clock-skew measurement.

Mirrors reference app/peerinfo/peerinfo.go:40-233: each node periodically
send_receives {version, lock_hash, sent_at} with every peer; replies allow
clock-skew estimation (RTT-compensated) and lock-hash mismatch detection.

A copy of the JAX package's app/peerinfo.py.
"""

from __future__ import annotations

import asyncio
import time

from ..p2p.transport import TCPMesh, decode_json, encode_json

PROTOCOL = "/charon_tpu/peerinfo/1.0.0"


class PeerInfo:
    """With a registry wired, the gossiped state reaches /metrics
    (reference: app/peerinfo/metrics.go): per-peer clock skew as
    ``app_peerinfo_clock_skew_seconds{peer}`` and a per-peer counter of
    version-mismatch observations."""

    def __init__(self, mesh: TCPMesh, version: str, lock_hash: bytes,
                 interval: float = 10.0, registry=None):
        self._mesh = mesh
        self.version = version
        self.lock_hash = lock_hash
        self.interval = interval
        self.peer_versions: dict[int, str] = {}
        self.clock_skews: dict[int, float] = {}
        self.lock_mismatches: set[int] = set()
        self._registry = registry
        self._task: asyncio.Task | None = None
        mesh.register_handler(PROTOCOL, self._on_request)

    def _note_version(self, peer: int, peer_version: str) -> None:
        self.peer_versions[peer] = peer_version
        if self._registry is not None and peer_version != self.version:
            self._registry.inc("app_peerinfo_version_mismatch_total",
                               labels={"peer": str(peer)})

    async def _on_request(self, sender: int, payload: bytes) -> bytes:
        req = decode_json(payload)
        if req.get("lock_hash") != self.lock_hash.hex():
            self.lock_mismatches.add(sender)
        self._note_version(sender, req.get("version", "?"))
        return encode_json({"version": self.version,
                            "lock_hash": self.lock_hash.hex(),
                            "sent_at": time.time()})

    async def poll_once(self) -> None:
        for peer in self._mesh.peers:
            t0 = time.time()
            try:
                reply = decode_json(await self._mesh.send_receive(
                    peer, PROTOCOL,
                    encode_json({"version": self.version,
                                 "lock_hash": self.lock_hash.hex(),
                                 "sent_at": t0}), timeout=3.0))
            except (asyncio.TimeoutError, OSError):
                continue
            t1 = time.time()
            self._note_version(peer, reply.get("version", "?"))
            if reply.get("lock_hash") != self.lock_hash.hex():
                self.lock_mismatches.add(peer)
            # skew = peer_send_time - midpoint of our RTT window
            # (reference: peerinfo.go:162-218)
            self.clock_skews[peer] = reply["sent_at"] - (t0 + t1) / 2
            if self._registry is not None:
                self._registry.set_gauge("app_peerinfo_clock_skew_seconds",
                                         self.clock_skews[peer],
                                         labels={"peer": str(peer)})

    def start(self) -> None:
        async def loop():
            while True:
                await self.poll_once()
                await asyncio.sleep(self.interval)
        self._task = asyncio.get_running_loop().create_task(loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
