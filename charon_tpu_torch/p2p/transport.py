"""TCP mesh transport: authenticated-encrypted frames with protocol routing.

Reference analogues:
- `send_async` / `send_receive` / `register_handler`
  (reference: p2p/sender.go:112-251, p2p/receive.go:33-94),
- one-message-per-logical-stream framing (the reference's one-proto-per-
  stream convention) multiplexed over one persistent connection per peer,
- per-peer failure hysteresis logging (sender.go:53-110 semantics,
  simplified to counters exposed for the tracker/metrics),
- ping keepalive with RTT measurement (p2p/ping.go:37-234),
- channel security ≙ libp2p noise + conn-gater (p2p/p2p.go:42-99,
  p2p/gater.go): a signed-ephemeral handshake pins each connection to a
  cluster member's identity key, then all frames are AEAD-encrypted.

Handshake (per TCP connection; identities are Ed25519 keys pinned in the
cluster definition, ephemerals are X25519):

    dialer   → index(1) ‖ eph_i(32)
    listener → index(1) ‖ eph_r(32) ‖ sig_r("resp" ‖ cluster ‖ eph_i ‖ eph_r)
    dialer   → sig_i("init" ‖ cluster ‖ eph_i ‖ eph_r)

Both signatures cover BOTH fresh ephemerals, so neither a MITM insider nor
a transcript replay can impersonate a member.  Session keys are HKDF-style
derivations of the X25519 shared secret (one key per direction); frames are
ChaCha20-Poly1305 with strictly-increasing counter nonces (replay-proof).
Pairwise keys derived from a shared cluster secret would be
insider-forgeable; these are not, and DKG share transfers get
confidentiality on the wire.

Wire format after the handshake (big-endian):
    u32 frame_len | u64 counter | ciphertext
ciphertext = AEAD(body), body = u16 proto_len | proto | u8 sender |
u64 msg_id | u8 is_reply | payload.

The JAX package's p2p/transport.py over the port's X25519 and
ChaCha20-Poly1305 (`p2p/aead.py`), byte-compatible with it on the wire:
a port mesh and a JAX mesh handshake and exchange frames.  One
difference: each inbound request is served by a task of its own, where
the JAX mesh awaits its handler inside the connection's read loop (see
`_on_body`), at most `MAX_INFLIGHT` of them a connection; a handler's
exception is logged and the connection kept.  The `faults=` injection
hook drives the chaos harness's link faults (`testutil/chaos.MeshLinkFaults`).
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import struct
from dataclasses import dataclass
from typing import Awaitable, Callable, Optional

from . import aead
from . import identity as ident

log = logging.getLogger(__name__)

MAX_FRAME = 32 * 1024 * 1024
HS_TIMEOUT = 5.0
#: requests of one connection whose handlers may run at once; past it the
#: connection's reads wait for a handler to finish (backpressure on the
#: peer).  Above what a cluster sends a peer in a slot: a partial
#: signature set per validator and duty, each waiting on a verify flush
MAX_INFLIGHT = 1024


@dataclass(frozen=True)
class Peer:
    """Cluster peer identity (reference: p2p/peer.go:36-100).  `name` is a
    deterministic human name derived from the index + cluster hash (the
    reference derives it from the peer ID, p2p/name.go)."""

    index: int          # 0-based peer index (share_idx - 1)
    host: str
    port: int

    def name(self, cluster_hash: bytes = b"") -> str:
        h = hashlib.sha256(b"name" + cluster_hash + bytes([self.index]))
        adjectives = ["brisk", "calm", "deft", "eager", "fond", "glad",
                      "keen", "merry", "noble", "proud", "quick", "wise"]
        animals = ["otter", "heron", "lynx", "finch", "ibex", "koala",
                   "marmot", "osprey", "puffin", "raven", "seal", "tern"]
        return (f"{adjectives[h.digest()[0] % len(adjectives)]}-"
                f"{animals[h.digest()[1] % len(animals)]}-{self.index}")


class _Channel:
    """One authenticated-encrypted connection to a specific peer."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, peer_index: int,
                 send_key: bytes, recv_key: bytes):
        self.reader = reader
        self.writer = writer
        self.peer_index = peer_index
        self._send = aead.ChaCha20Poly1305(send_key)
        self._recv = aead.ChaCha20Poly1305(recv_key)
        self._send_ctr = 0
        self._recv_ctr = -1

    def seal(self, body: bytes) -> bytes:
        self._send_ctr += 1
        nonce = b"\x00\x00\x00\x00" + struct.pack(">Q", self._send_ctr)
        ct = self._send.encrypt(nonce, body, None)
        frame = struct.pack(">Q", self._send_ctr) + ct
        return struct.pack(">I", len(frame)) + frame

    def open(self, frame: bytes) -> bytes | None:
        """Decrypt one frame; None on forgery or replay."""
        if len(frame) < 8 + 16:
            return None
        (ctr,) = struct.unpack(">Q", frame[:8])
        if ctr <= self._recv_ctr:
            return None  # replayed or reordered: drop
        nonce = b"\x00\x00\x00\x00" + frame[:8]
        try:
            body = self._recv.decrypt(nonce, frame[8:], None)
        except Exception:
            return None
        self._recv_ctr = ctr
        return body


def _derive_keys(shared: bytes, cluster_hash: bytes, eph_i: bytes,
                 eph_r: bytes) -> tuple[bytes, bytes]:
    """(initiator→responder key, responder→initiator key)."""
    base = shared + cluster_hash + eph_i + eph_r
    return (hashlib.sha256(b"ct-i2r" + base).digest(),
            hashlib.sha256(b"ct-r2i" + base).digest())


class TCPMesh:
    """One node's endpoint in the full mesh.

    Reconnect policy: a failed dial puts the peer behind a jittered
    exponential backoff gate (app/retry.backoff_delays, capped at
    `backoff_ceiling`).  Sends while the gate is closed fail FAST without
    touching the socket — under a flapping link the dial rate is bounded
    by the backoff schedule, not by the send rate (the reconnect-storm
    failure mode), while every fast-failed send still rides the
    ``app_p2p_send_failure_streak`` gauge so a peer the mesh has
    effectively given up on is visible at /metrics.  A successful dial
    resets the gate.  `rng` pins the jitter for deterministic tests.

    `faults` is the chaos-harness injection point (testutil/chaos.py):
    an object with async hooks ``on_dial(peer_index)`` and
    ``on_send(peer_index, protocol, nbytes)`` that may delay (inject
    latency) or raise OSError/ConnectionError (drop the dial/frame)."""

    def __init__(self, self_index: int, peers: list[Peer],
                 node_identity: ident.NodeIdentity,
                 peer_pubkeys: dict[int, bytes],
                 cluster_hash: bytes = b"", registry=None, faults=None,
                 rng=None, backoff_base: float = 0.1,
                 backoff_factor: float = 1.6, backoff_jitter: float = 0.2,
                 backoff_ceiling: float = 30.0):
        self.self_index = self_index
        self.peers = {p.index: p for p in peers if p.index != self_index}
        self.self_peer = next(p for p in peers if p.index == self_index)
        self.identity = node_identity
        self.peer_pubkeys = dict(peer_pubkeys)
        self.cluster_hash = cluster_hash
        self._handlers: dict[str, Callable] = {}
        self._channels: dict[int, _Channel] = {}
        self._conn_locks: dict[int, asyncio.Lock] = {}
        self._pending: dict[int, asyncio.Future] = {}
        self._msg_id = 0
        self._server: Optional[asyncio.AbstractServer] = None
        self._tasks: list[asyncio.Task] = []
        self._handling: set[asyncio.Task] = set()  # inbound requests
        self._inbound: list[_Channel] = []
        self._raw_writers: list[asyncio.StreamWriter] = []
        # failure hysteresis counters (reference: p2p/sender.go:53-110)
        self.send_failures: dict[int, int] = {}
        self.rtts: dict[int, float] = {}
        # per-peer transport health metrics (reference: p2p/sender.go:53-110
        # logs + p2p metrics.go counters); optional app.monitoring.Registry
        self.registry = registry
        self._faults = faults
        self._ever_connected: set[int] = set()
        # reconnect gate state: peer -> (not-before loop time, delay gen)
        self._rng = rng
        self._backoff_params = (backoff_base, backoff_factor, backoff_jitter,
                                backoff_ceiling)
        self._backoff: dict[int, tuple[float, object]] = {}
        self.dial_attempts: dict[int, int] = {}  # storm witness for tests

    # -- metrics helpers ----------------------------------------------------

    def _count_sent(self, peer_index: int, nbytes: int,
                    latency: float) -> None:
        reg = self.registry
        if reg is None:
            return
        peer = {"peer": str(peer_index)}
        reg.inc("app_p2p_peer_sent_bytes_total", float(nbytes), labels=peer)
        reg.inc("app_p2p_peer_sent_frames_total", labels=peer)
        reg.observe("app_p2p_send_latency_seconds", latency, labels=peer)

    def _count_recv(self, peer_index: int, nbytes: int) -> None:
        reg = self.registry
        if reg is None:
            return
        peer = {"peer": str(peer_index)}
        reg.inc("app_p2p_peer_recv_bytes_total", float(nbytes), labels=peer)
        reg.inc("app_p2p_peer_recv_frames_total", labels=peer)

    def _count_send_result(self, peer_index: int, ok: bool) -> None:
        """Surface the hysteresis state (consecutive-failure streak) plus a
        monotonic failure counter."""
        reg = self.registry
        if reg is None:
            return
        peer = {"peer": str(peer_index)}
        if not ok:
            reg.inc("app_p2p_send_failures_total", labels=peer)
        reg.set_gauge("app_p2p_send_failure_streak",
                      float(self.send_failures.get(peer_index, 0)),
                      labels=peer)

    def _count_handshake_failure(self, peer_label: str) -> None:
        if self.registry is not None:
            # inbound failures happen before the peer authenticates, so
            # the label is the constant "inbound" rather than an index
            self.registry.inc("app_p2p_handshake_failures_total",
                              labels={"peer": peer_label})

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_inbound, self.self_peer.host, self.self_peer.port)

    async def stop(self) -> None:
        for t in self._tasks + list(self._handling):
            t.cancel()
        for ch in self._channels.values():
            ch.writer.close()
        self._channels.clear()
        for ch in self._inbound:
            ch.writer.close()
        self._inbound.clear()
        for w in self._raw_writers:
            w.close()
        self._raw_writers.clear()
        if self._server is not None:
            self._server.close()
            # wait_closed() blocks until every inbound connection is done
            # (3.12 semantics); bound it — sockets are already closed.
            try:
                await asyncio.wait_for(self._server.wait_closed(), 1.0)
            except asyncio.TimeoutError:
                pass

    # -- handler registry (reference: p2p/receive.go:33-94) ----------------

    def register_handler(self, protocol: str,
                         fn: Callable[[int, bytes], Awaitable[bytes | None]]):
        """fn(sender_index, payload) -> optional reply payload.  The sender
        index is the handshake-authenticated channel identity, not a frame
        field a peer could spoof."""
        self._handlers[protocol] = fn

    # -- send paths (reference: p2p/sender.go:112-251) ---------------------

    async def send_async(self, peer_index: int, protocol: str,
                         payload: bytes) -> None:
        """Fire-and-forget; failures are counted, not raised."""
        try:
            await self._send_frame(peer_index, protocol, payload,
                                   msg_id=self._next_id(), is_reply=False)
            self.send_failures[peer_index] = 0
            self._count_send_result(peer_index, ok=True)
        except (OSError, asyncio.TimeoutError):
            self.send_failures[peer_index] = (
                self.send_failures.get(peer_index, 0) + 1)
            self._count_send_result(peer_index, ok=False)

    async def send_receive(self, peer_index: int, protocol: str,
                           payload: bytes, timeout: float = 5.0) -> bytes:
        """Synchronous request/response over the mesh."""
        msg_id = self._next_id()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[msg_id] = fut
        try:
            await self._send_frame(peer_index, protocol, payload,
                                   msg_id=msg_id, is_reply=False)
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(msg_id, None)

    async def broadcast(self, protocol: str, payload: bytes) -> None:
        """send_async to all n−1 peers."""
        await asyncio.gather(*(self.send_async(i, protocol, payload)
                               for i in self.peers))

    # -- ping (reference: p2p/ping.go) --------------------------------------

    async def ping(self, peer_index: int) -> float:
        t0 = asyncio.get_running_loop().time()
        await self.send_receive(peer_index, "/charon_tpu/ping/1.0.0", b"ping")
        rtt = asyncio.get_running_loop().time() - t0
        self.rtts[peer_index] = rtt
        return rtt

    def enable_ping_responder(self) -> None:
        async def _pong(sender: int, payload: bytes) -> bytes:
            return b"pong"
        self.register_handler("/charon_tpu/ping/1.0.0", _pong)

    # -- handshake ----------------------------------------------------------

    async def _handshake_initiator(self, reader, writer,
                                   peer_index: int) -> _Channel:
        eph, eph_i = aead.x25519_generate()
        writer.write(bytes([self.self_index]) + eph_i)
        await writer.drain()
        resp = await asyncio.wait_for(reader.readexactly(1 + 32 + 64),
                                      HS_TIMEOUT)
        r_index, eph_r, sig_r = resp[0], resp[1:33], resp[33:]
        if r_index != peer_index:
            raise ConnectionError("handshake: wrong responder index")
        pub = self.peer_pubkeys.get(r_index)
        ctx = self.cluster_hash + eph_i + eph_r
        if pub is None or not ident.verify(pub, sig_r, b"resp" + ctx):
            raise ConnectionError("handshake: bad responder signature")
        writer.write(self.identity.sign(b"init" + ctx))
        await writer.drain()
        try:
            shared = aead.x25519(eph, eph_r)
        except ValueError as e:  # a small-order ephemeral
            raise ConnectionError(f"handshake: {e}") from None
        k_i2r, k_r2i = _derive_keys(shared, self.cluster_hash, eph_i, eph_r)
        return _Channel(reader, writer, peer_index, k_i2r, k_r2i)

    async def _handshake_responder(self, reader, writer) -> _Channel:
        hello = await asyncio.wait_for(reader.readexactly(1 + 32), HS_TIMEOUT)
        i_index, eph_i = hello[0], hello[1:]
        pub = self.peer_pubkeys.get(i_index)
        if pub is None or i_index == self.self_index:
            raise ConnectionError("handshake: unknown initiator")
        eph, eph_r = aead.x25519_generate()
        ctx = self.cluster_hash + eph_i + eph_r
        writer.write(bytes([self.self_index]) + eph_r
                     + self.identity.sign(b"resp" + ctx))
        await writer.drain()
        sig_i = await asyncio.wait_for(reader.readexactly(64), HS_TIMEOUT)
        if not ident.verify(pub, sig_i, b"init" + ctx):
            raise ConnectionError("handshake: bad initiator signature")
        try:
            shared = aead.x25519(eph, eph_i)
        except ValueError as e:  # a small-order ephemeral
            raise ConnectionError(f"handshake: {e}") from None
        k_i2r, k_r2i = _derive_keys(shared, self.cluster_hash, eph_i, eph_r)
        return _Channel(reader, writer, i_index, k_r2i, k_i2r)

    # -- internals ----------------------------------------------------------

    def _next_id(self) -> int:
        self._msg_id += 1
        return (self.self_index << 48) | self._msg_id

    async def _dial(self, peer: Peer):
        """The raw socket connect — factored out so socket-free
        reconnect tests can stub it."""
        return await asyncio.open_connection(peer.host, peer.port)

    async def _connect(self, peer_index: int) -> _Channel:
        lock = self._conn_locks.setdefault(peer_index, asyncio.Lock())
        async with lock:
            ch = self._channels.get(peer_index)
            if ch is not None and not ch.writer.is_closing():
                return ch
            now = asyncio.get_running_loop().time()
            state = self._backoff.get(peer_index)
            if state is not None and now < state[0]:
                # gate closed: fail fast, do NOT redial (see class doc)
                raise ConnectionError(
                    f"peer {peer_index} in reconnect backoff for "
                    f"{state[0] - now:.2f}s")
            peer = self.peers[peer_index]
            self.dial_attempts[peer_index] = (
                self.dial_attempts.get(peer_index, 0) + 1)
            writer = None
            try:
                if self._faults is not None:
                    await self._faults.on_dial(peer_index)
                reader, writer = await self._dial(peer)
                ch = await self._handshake_initiator(reader, writer,
                                                     peer_index)
            except (OSError, asyncio.IncompleteReadError,
                    asyncio.TimeoutError) as e:
                # app.retry is the canonical expbackoff helper; imported
                # at the use site so this lower layer never participates
                # in app's import-time graph
                from ..app.retry import backoff_delays

                if writer is not None:
                    writer.close()
                    self._count_handshake_failure(str(peer_index))
                base, factor, jitter, ceiling = self._backoff_params
                delays = (state[1] if state is not None else backoff_delays(
                    base=base, factor=factor, jitter=jitter,
                    max_delay=ceiling, rng=self._rng))
                # gate deadline from the FAILURE instant, not the dial
                # start: a dial that burns its whole timeout (silently
                # dropped SYNs, handshake timeout) would otherwise leave
                # the gate pre-expired and the storm protection inert
                self._backoff[peer_index] = (
                    asyncio.get_running_loop().time() + next(delays), delays)
                raise ConnectionError(f"connect to {peer_index}: {e}")
            self._backoff.pop(peer_index, None)
            if self.registry is not None:
                if peer_index in self._ever_connected:
                    self.registry.inc("app_p2p_reconnects_total",
                                      labels={"peer": str(peer_index)})
                self._ever_connected.add(peer_index)
            self._channels[peer_index] = ch
            self._tasks.append(asyncio.get_running_loop().create_task(
                self._read_loop(ch)))
            return ch

    def _encode_body(self, protocol: str, payload: bytes, msg_id: int,
                     is_reply: bool) -> bytes:
        proto_b = protocol.encode()
        return (struct.pack(">H", len(proto_b)) + proto_b
                + bytes([self.self_index]) + struct.pack(">Q", msg_id)
                + bytes([1 if is_reply else 0]) + payload)

    async def _send_frame(self, peer_index: int, protocol: str,
                          payload: bytes, msg_id: int, is_reply: bool):
        t0 = asyncio.get_running_loop().time()
        ch = await self._connect(peer_index)
        if self._faults is not None:
            await self._faults.on_send(peer_index, protocol, len(payload))
        frame = ch.seal(self._encode_body(protocol, payload, msg_id,
                                          is_reply))
        ch.writer.write(frame)
        await ch.writer.drain()
        # latency covers connect (incl. handshake on a cold channel) +
        # seal + kernel hand-off — the sender-side slot-budget cost
        self._count_sent(peer_index, len(frame),
                         asyncio.get_running_loop().time() - t0)

    async def _on_inbound(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        # Serve this connection inline: start_server tracks the handler
        # coroutine, so returning early would make wait_closed() hang on
        # the still-running read task.  Track the raw writer immediately so
        # stop() can sever connections stuck mid-handshake.
        self._raw_writers.append(writer)
        try:
            ch = await self._handshake_responder(reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.TimeoutError, OSError):
            writer.close()
            self._count_handshake_failure("inbound")
            return
        finally:
            if writer in self._raw_writers:
                self._raw_writers.remove(writer)
        # a successful inbound handshake proves the peer is back: open
        # the reconnect gate so outbound sends stop fast-failing for the
        # rest of a (possibly ceiling-length) backoff window
        self._backoff.pop(ch.peer_index, None)
        self._inbound.append(ch)
        await self._read_loop(ch)

    async def _read_loop(self, ch: _Channel) -> None:
        inflight = asyncio.Semaphore(MAX_INFLIGHT)
        try:
            while True:
                hdr = await ch.reader.readexactly(4)
                (length,) = struct.unpack(">I", hdr)
                if length > MAX_FRAME:
                    break
                frame = await ch.reader.readexactly(length)
                body = ch.open(frame)
                if body is None:
                    break  # forged/replayed frame: kill the connection
                self._count_recv(ch.peer_index, 4 + len(frame))
                await self._on_body(ch, body, inflight)
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.CancelledError):
            pass
        finally:
            # actually sever the connection and forget the channel so the
            # next send reconnects instead of reusing a dead session
            ch.writer.close()
            if self._channels.get(ch.peer_index) is ch:
                del self._channels[ch.peer_index]
            if ch in self._inbound:
                self._inbound.remove(ch)

    async def _on_body(self, ch: _Channel, body: bytes,
                       inflight: asyncio.Semaphore) -> None:
        (proto_len,) = struct.unpack(">H", body[:2])
        off = 2
        protocol = body[off : off + proto_len].decode()
        off += proto_len
        sender = body[off]
        off += 1
        (msg_id,) = struct.unpack(">Q", body[off : off + 8])
        off += 8
        is_reply = body[off] == 1
        off += 1
        payload = body[off:]

        # the channel identity is authoritative; a frame claiming another
        # sender index is a protocol violation
        if sender != ch.peer_index:
            return

        if is_reply:
            fut = self._pending.get(msg_id)
            if fut is not None and not fut.done():
                fut.set_result(payload)
            return

        handler = self._handlers.get(protocol)
        if handler is None:
            return
        # each request runs as a task of its own (the reference's stream a
        # request): a handler awaiting a verify flush on the card must not
        # hold every later frame of this connection — a peer's QBFT votes
        # queued behind its partial signatures miss their round timers.
        # `inflight` bounds the tasks of this connection: past it the read
        # loop waits here, so a peer cannot queue handlers without limit
        await inflight.acquire()
        task = asyncio.get_running_loop().create_task(
            self._serve(ch, handler, sender, protocol, msg_id, payload))
        self._handling.add(task)
        task.add_done_callback(self._handling.discard)
        task.add_done_callback(lambda _: inflight.release())

    async def _serve(self, ch: _Channel, handler, sender: int,
                     protocol: str, msg_id: int, payload: bytes) -> None:
        try:
            reply = await handler(sender, payload)
        except Exception as exc:  # noqa: BLE001 — a bad frame, not a crash
            log.warning("%s from peer %d refused: %r", protocol, sender, exc)
            return
        if reply is not None and not ch.writer.is_closing():
            t0 = asyncio.get_running_loop().time()
            # seal and write with no await between: frames leave in
            # counter order, as the peer's replay check wants
            frame = ch.seal(self._encode_body(protocol, reply, msg_id,
                                              is_reply=True))
            ch.writer.write(frame)
            try:
                await ch.writer.drain()
            except ConnectionError:
                return
            self._count_sent(ch.peer_index, len(frame),
                             asyncio.get_running_loop().time() - t0)


def mesh_params_from_definition(definition) -> tuple[list[Peer],
                                                     dict[int, bytes]]:
    """Build the mesh peer list + pinned identity pubkeys from a cluster
    definition whose operator ENRs are `ed25519:<hex>@host:port` records
    (reference: app/app.go:162-178 loads peers from the lock ENRs)."""
    peers, pubs = [], {}
    for i, enr in definition.peers():
        pub, host, port = ident.enr_parse(enr)
        peers.append(Peer(i, host, port))
        pubs[i] = pub
    return peers, pubs


def new_test_identities(n: int, seed: bytes = b"test-cluster") -> tuple[
        list[ident.NodeIdentity], dict[int, bytes]]:
    """Deterministic per-node identities for tests/fixtures: n keypairs +
    the pinned pubkey map every node shares."""
    ids = [ident.NodeIdentity.generate(seed + bytes([i])) for i in range(n)]
    return ids, {i: nid.pubkey for i, nid in enumerate(ids)}


# ---------------------------------------------------------------------------
# JSON codec helpers for protocol payloads
# ---------------------------------------------------------------------------

def encode_json(obj) -> bytes:
    return json.dumps(obj, separators=(",", ":"), sort_keys=True).encode()


def decode_json(data: bytes):
    return json.loads(data.decode())
