"""The port's TCP mesh and its protocols, on their own and beside the JAX
package's.

(i)   the six cases of tests/test_p2p.py on the port: request/response
      with per-peer metrics, an unknown identity refused at the handshake,
      frames encrypted on the wire, parsigex over sockets, signed QBFT
      messages delivered, an insider's forged votes and justifications
      dropped.
(ii)  a port `TCPMesh` and a JAX `TCPMesh` on localhost: each dials the
      other (both handshake directions), `send_async`, `send_receive` and
      `ping` cross in both directions, each side's consensus transport
      verifies the other's signed message and drops a forged one.
(iii) every wire type of `core/serialize` (39 classes, filled from their
      type hints) encodes to the JAX package's bytes and decodes them.
"""

import asyncio
import dataclasses
import enum
import socket
import typing

import pytest

from charon_tpu.core import serialize as jserialize
from charon_tpu.p2p import protocols as jprotocols
from charon_tpu.p2p import transport as jtransport
from charon_tpu_torch.core import serialize
from charon_tpu_torch.core.qbft import Msg, MsgType
from charon_tpu_torch.core.types import (Duty, DutyType, ParSignedData,
                                         SignedRandao)
from charon_tpu_torch.p2p import identity as ident
from charon_tpu_torch.p2p.protocols import (P2PConsensusTransport,
                                            P2PParSigEx, sign_consensus_msg,
                                            verify_consensus_msg)
from charon_tpu_torch.p2p.transport import Peer, TCPMesh, new_test_identities


def free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def make_mesh(n: int, registries=None):
    ports = free_ports(n)
    peers = [Peer(i, "127.0.0.1", ports[i]) for i in range(n)]
    ids, pubs = new_test_identities(n)
    return [TCPMesh(i, peers, ids[i], pubs, cluster_hash=b"test",
                    registry=registries[i] if registries else None)
            for i in range(n)]


def test_send_receive_roundtrip():
    from charon_tpu_torch.app.monitoring import Registry

    regs = [Registry(), Registry()]

    async def main():
        meshes = make_mesh(2, registries=regs)
        for m in meshes:
            await m.start()
        try:
            async def echo(sender, payload):
                return b"echo:" + payload
            meshes[1].register_handler("/t/echo", echo)
            reply = await meshes[0].send_receive(1, "/t/echo", b"hi")
            assert reply == b"echo:hi"
            # ping service
            meshes[1].enable_ping_responder()
            rtt = await meshes[0].ping(1)
            assert 0 <= rtt < 1.0
        finally:
            for m in meshes:
                await m.stop()
    asyncio.run(main())

    # per-peer transport metrics rode the exchange: node0 sent 2 frames
    # to peer 1 (echo + ping) and got 2 replies back; byte counters and
    # the send-latency histogram populate alongside
    sent = regs[0]._counters[
        ("app_p2p_peer_sent_frames_total", (("peer", "1"),))]
    assert sent == 2.0
    assert regs[0]._counters[
        ("app_p2p_peer_sent_bytes_total", (("peer", "1"),))] > 0
    assert regs[0]._counters[
        ("app_p2p_peer_recv_frames_total", (("peer", "1"),))] == 2.0
    lat_key = ("app_p2p_send_latency_seconds", (("peer", "1"),))
    assert regs[0]._hist[lat_key].count == 2
    # responder side mirrors it under peer=0 (2 inbound, 2 replies)
    assert regs[1]._counters[
        ("app_p2p_peer_recv_frames_total", (("peer", "0"),))] == 2.0
    assert regs[1]._counters[
        ("app_p2p_peer_sent_frames_total", (("peer", "0"),))] == 2.0


def test_slow_handler_does_not_hold_the_connection():
    """A request whose handler waits (a partial signature set waiting on a
    verify flush) must not delay the reply to a later request of another
    protocol on the same connection (a QBFT vote, a ping)."""
    async def main():
        meshes = make_mesh(2)
        for m in meshes:
            await m.start()
        release = asyncio.Event()
        try:
            async def slow(sender, payload):
                await release.wait()
                return b"slow:" + payload

            async def fast(sender, payload):
                return b"fast:" + payload
            meshes[1].register_handler("/t/slow", slow)
            meshes[1].register_handler("/t/fast", fast)
            pending = asyncio.ensure_future(
                meshes[0].send_receive(1, "/t/slow", b"a", timeout=10.0))
            await asyncio.sleep(0.1)
            assert await meshes[0].send_receive(
                1, "/t/fast", b"b", timeout=2.0) == b"fast:b"
            assert not pending.done()
            release.set()
            assert await pending == b"slow:a"
        finally:
            release.set()
            for m in meshes:
                await m.stop()
    asyncio.run(main())


def test_inflight_handlers_bounded_per_connection(monkeypatch):
    """At most `MAX_INFLIGHT` handlers of one connection run at once; the
    next request waits for one to finish, and every request is answered."""
    from charon_tpu_torch.p2p import transport

    monkeypatch.setattr(transport, "MAX_INFLIGHT", 2)

    async def main():
        meshes = make_mesh(2)
        for m in meshes:
            await m.start()
        release = asyncio.Event()
        running, most = [0], [0]
        try:
            async def slow(sender, payload):
                running[0] += 1
                most[0] = max(most[0], running[0])
                try:
                    await release.wait()
                finally:
                    running[0] -= 1
                return payload
            meshes[1].register_handler("/t/slow", slow)
            calls = [asyncio.ensure_future(meshes[0].send_receive(
                1, "/t/slow", bytes([k]), timeout=10.0)) for k in range(5)]
            await asyncio.sleep(0.3)
            assert running[0] == 2
            release.set()
            assert await asyncio.gather(*calls) == [bytes([k])
                                                    for k in range(5)]
            assert most[0] == 2
        finally:
            release.set()
            for m in meshes:
                await m.stop()
    asyncio.run(main())


def test_unknown_identity_rejected():
    """A node whose identity key is not pinned in the cluster cannot
    complete the handshake (conn-gater equivalent)."""
    async def main():
        ports = free_ports(2)
        peers = [Peer(i, "127.0.0.1", ports[i]) for i in range(2)]
        ids, pubs = new_test_identities(2)
        good = TCPMesh(0, peers, ids[0], pubs, cluster_hash=b"test")
        evil_id = ident.NodeIdentity.generate(b"not-in-cluster")
        evil = TCPMesh(1, peers, evil_id, pubs, cluster_hash=b"test")
        await good.start()
        await evil.start()
        try:
            got = []

            async def handler(sender, payload):
                got.append(payload)
                return None
            good.register_handler("/t/x", handler)
            await evil.send_async(0, "/t/x", b"evil payload")
            await asyncio.sleep(0.2)
            assert got == []
            # the listener killed the connection after the failed handshake
            ch = evil._channels.get(0)
            assert ch is None or ch.reader.at_eof()
        finally:
            await good.stop()
            await evil.stop()
    asyncio.run(main())


def test_frames_encrypted_on_wire():
    """DKG secret shares must not transit in plaintext: capture the raw
    bytes written to the socket and assert the payload is absent."""
    async def main():
        meshes = make_mesh(2)
        for m in meshes:
            await m.start()
        try:
            got = []

            async def handler(sender, payload):
                got.append(payload)
                return None
            meshes[1].register_handler("/t/share", handler)

            secret = b"SECRET-DKG-SHARE-0123456789abcdef"
            ch = await meshes[0]._connect(1)
            captured = []
            orig_write = ch.writer.write
            ch.writer.write = lambda data: (captured.append(data),
                                            orig_write(data))[1]
            await meshes[0].send_async(1, "/t/share", secret)
            await asyncio.sleep(0.2)
            assert got == [secret]
            wire = b"".join(captured)
            assert secret not in wire
        finally:
            for m in meshes:
                await m.stop()
    asyncio.run(main())


def test_parsigex_over_sockets():
    async def main():
        meshes = make_mesh(3)
        for m in meshes:
            await m.start()
        try:
            exes = [P2PParSigEx(m) for m in meshes]
            received = {i: [] for i in range(3)}
            for i, ex in enumerate(exes):
                def mk(i):
                    async def sub(duty, pset):
                        received[i].append((duty, pset))
                    return sub
                ex.subscribe(mk(i))
            duty = Duty(7, DutyType.RANDAO)
            pset = {"0x" + "ab" * 48: ParSignedData(
                data=SignedRandao(epoch=1, signature=b"\x01" * 96),
                share_idx=1)}
            await exes[0].broadcast(duty, pset)
            await asyncio.sleep(0.3)
            assert received[1] and received[2] and not received[0]
            got_duty, got_pset = received[1][0]
            assert got_duty == duty
            [(pk, psig)] = got_pset.items()
            assert psig.share_idx == 1 and psig.data.epoch == 1
        finally:
            for m in meshes:
                await m.stop()
    asyncio.run(main())


def test_consensus_transport_signed_and_delivered():
    """Properly signed QBFT messages round-trip the wire."""
    async def main():
        meshes = make_mesh(2)
        for m in meshes:
            await m.start()
        try:
            t0 = P2PConsensusTransport(meshes[0])
            t1 = P2PConsensusTransport(meshes[1])
            delivered = []

            class FakeNode:
                async def _deliver(self, duty, msg):
                    delivered.append((duty, msg))
            t1.register(FakeNode())
            duty = Duty(3, DutyType.ATTESTER)
            msg = Msg(MsgType.PRE_PREPARE, duty, source=0, round=1,
                      value=(("k", 1),))
            await t0.broadcast(duty, msg)
            await asyncio.sleep(0.3)
            assert len(delivered) == 1
            got = delivered[0][1]
            assert got.signing_payload() == msg.signing_payload()
            assert verify_consensus_msg(got, meshes[1].peer_pubkeys)
        finally:
            for m in meshes:
                await m.stop()
    asyncio.run(main())


def test_insider_cannot_forge_peer_consensus_msg():
    """THE byzantine-tolerance property (round-1 verdict item 5): a fully
    valid cluster MEMBER (knows every shared secret, completes handshakes)
    still cannot forge another member's consensus votes — directly or inside
    a relayed justification."""
    async def main():
        meshes = make_mesh(3)
        for m in meshes:
            await m.start()
        try:
            transports = [P2PConsensusTransport(m) for m in meshes]
            delivered = []

            class FakeNode:
                async def _deliver(self, duty, msg):
                    delivered.append(msg)
            transports[0].register(FakeNode())
            duty = Duty(9, DutyType.ATTESTER)

            # 1. insider 1 claims source=2 with its own (valid) signature:
            forged = sign_consensus_msg(
                Msg(MsgType.PREPARE, duty, source=2, round=1, value="v"),
                meshes[1].identity)
            await meshes[1].send_async(
                0, "/charon_tpu/consensus/qbft/1.0.0",
                serialize.encode_consensus_msg(duty, forged))

            # 2. insider 1 embeds a forged justification from peer 2 inside
            #    its OWN legitimately-signed round-change:
            fake_prepare = sign_consensus_msg(
                Msg(MsgType.PREPARE, duty, source=2, round=1, value="v"),
                meshes[1].identity)  # signed by 1, claims 2
            rc = sign_consensus_msg(
                Msg(MsgType.ROUND_CHANGE, duty, source=1, round=2,
                    prepared_round=1, prepared_value="v",
                    justification=(fake_prepare,)),
                meshes[1].identity)
            await transports[1].broadcast(duty, rc)

            await asyncio.sleep(0.3)
            assert delivered == []  # both forgeries dropped

            # 3. the same round-change with a GENUINE justification passes:
            real_prepare = sign_consensus_msg(
                Msg(MsgType.PREPARE, duty, source=2, round=1, value="v"),
                meshes[2].identity)
            rc_ok = sign_consensus_msg(
                Msg(MsgType.ROUND_CHANGE, duty, source=1, round=2,
                    prepared_round=1, prepared_value="v",
                    justification=(real_prepare,)),
                meshes[1].identity)
            await transports[1].broadcast(duty, rc_ok)
            await asyncio.sleep(0.3)
            assert len(delivered) == 1
            assert delivered[0].source == 1
        finally:
            for m in meshes:
                await m.stop()
    asyncio.run(main())


# ---------------------------------------------------------------------------
# (ii) a port mesh and a JAX mesh
# ---------------------------------------------------------------------------

def mixed_pair():
    """Node 0 the port's, node 1 the JAX package's, one cluster."""
    ports = free_ports(2)
    ids, pubs = new_test_identities(2)
    port = TCPMesh(0, [Peer(i, "127.0.0.1", ports[i]) for i in range(2)],
                   ids[0], pubs, cluster_hash=b"mixed")
    jids, jpubs = jtransport.new_test_identities(2)
    assert jpubs == pubs
    jax = jtransport.TCPMesh(
        1, [jtransport.Peer(i, "127.0.0.1", ports[i]) for i in range(2)],
        jids[1], jpubs, cluster_hash=b"mixed")
    return port, jax


@pytest.mark.parametrize("dialer", ["port", "jax"])
def test_port_and_jax_meshes_talk_both_ways(dialer):
    async def main():
        port, jax = mixed_pair()
        await port.start()
        await jax.start()
        try:
            got = {"port": [], "jax": []}

            def sink(name):
                async def fn(sender, payload):
                    got[name].append((sender, payload))
                    return None
                return fn

            async def echo(sender, payload):
                return b"echo:" + payload
            port.register_handler("/t/x", sink("port"))
            jax.register_handler("/t/x", sink("jax"))
            port.register_handler("/t/echo", echo)
            jax.register_handler("/t/echo", echo)
            port.enable_ping_responder()
            jax.enable_ping_responder()
            first, second = (port, jax) if dialer == "port" else (jax, port)
            peer_of = {id(port): 1, id(jax): 0}
            # the first send dials: the handshake runs in this direction
            await first.send_async(peer_of[id(first)], "/t/x", b"hello")
            await second.send_async(peer_of[id(second)], "/t/x", b"back")
            assert await port.send_receive(1, "/t/echo", b"a") == b"echo:a"
            assert await jax.send_receive(0, "/t/echo", b"b") == b"echo:b"
            assert 0 <= await port.ping(1) < 5
            assert 0 <= await jax.ping(0) < 5
            big = bytes(range(256)) * 300   # several ChaCha20 blocks
            await port.send_async(1, "/t/x", big)
            await asyncio.sleep(0.3)
            assert (0, big) in got["jax"] and (0, b"hello" if dialer ==
                                               "port" else b"back") \
                in got["jax"]
            assert (1, b"back" if dialer == "port" else b"hello") \
                in got["port"]
        finally:
            await port.stop()
            await jax.stop()
    asyncio.run(main())


def test_port_and_jax_consensus_transports_verify_each_other():
    from charon_tpu.core.qbft import Msg as JMsg, MsgType as JMsgType
    from charon_tpu.core.types import Duty as JDuty, DutyType as JDutyType

    async def main():
        port, jax = mixed_pair()
        await port.start()
        await jax.start()
        try:
            pt = P2PConsensusTransport(port)
            jt = jprotocols.P2PConsensusTransport(jax)
            at_port, at_jax = [], []

            class Sink:
                def __init__(self, out):
                    self.out = out

                async def _deliver(self, duty, msg):
                    self.out.append(msg)
            pt.register(Sink(at_port))
            jt.register(Sink(at_jax))
            duty = Duty(5, DutyType.ATTESTER)
            await pt.broadcast(duty, Msg(MsgType.PREPARE, duty, source=0,
                                         round=1, value=(("k", 1),)))
            jduty = JDuty(5, JDutyType.ATTESTER)
            await jt.broadcast(jduty, JMsg(JMsgType.COMMIT, jduty, source=1,
                                           round=1, value=(("k", 1),)))
            # forgeries: each side claims the other as the source
            fake = sign_consensus_msg(
                Msg(MsgType.PREPARE, duty, source=1, round=1, value="v"),
                port.identity)
            await port.send_async(1, jprotocols.CONSENSUS_PROTOCOL,
                                  serialize.encode_consensus_msg(duty, fake))
            jfake = jprotocols.sign_consensus_msg(
                JMsg(JMsgType.PREPARE, jduty, source=0, round=1, value="v"),
                jax.identity)
            await jax.send_async(0, jprotocols.CONSENSUS_PROTOCOL,
                                 jserialize.encode_consensus_msg(jduty, jfake))
            await asyncio.sleep(0.5)
            # self-delivery plus the peer's genuine message, no forgery
            assert sorted((m.source, m.type.name) for m in at_port) == [
                (0, "PREPARE"), (1, "COMMIT")]
            assert sorted((m.source, m.type.name) for m in at_jax) == [
                (0, "PREPARE"), (1, "COMMIT")]
            assert all(verify_consensus_msg(m, port.peer_pubkeys)
                       for m in at_port)
            assert all(jprotocols.verify_consensus_msg(m, jax.peer_pubkeys)
                       for m in at_jax)
        finally:
            await port.stop()
            await jax.stop()
    asyncio.run(main())


# ---------------------------------------------------------------------------
# (iii) the wire codec against the JAX package's
# ---------------------------------------------------------------------------

def _fill(cls, hints_of=typing.get_type_hints):
    hints = hints_of(cls)
    return cls(**{f.name: _value(hints[f.name], i)
                  for i, f in enumerate(dataclasses.fields(cls))})


def _value(t, i):
    if t is int:
        return 3 + i
    if t is bool:
        return True
    if t is str:
        return f"s{i}"
    if t is bytes:
        return bytes([i + 1]) * 8
    if isinstance(t, type) and issubclass(t, enum.IntEnum):
        return list(t)[1]
    if dataclasses.is_dataclass(t):
        return _fill(t)
    if t is tuple or typing.get_origin(t) is tuple:
        return ()
    if typing.get_origin(t) is typing.Union:
        return _value(typing.get_args(t)[0], i)
    return ("k", i)


def test_serialize_registers_the_jax_packages_types():
    assert sorted(serialize._CLASSES) == sorted(jserialize._CLASSES)
    assert len(serialize._CLASSES) == 39


@pytest.mark.parametrize("name", sorted(serialize._CLASSES))
def test_serialize_bytes_equal_the_jax_packages(name):
    value = _fill(serialize._CLASSES[name])
    jvalue = _fill(jserialize._CLASSES[name])
    data = serialize.encode(value)
    assert jserialize.encode(jvalue) == data
    assert serialize.decode(data) == value
    assert jserialize.encode(jserialize.decode(data)) == data
    assert serialize.encode(serialize.decode(jserialize.encode(jvalue))) \
        == data


def test_serialize_envelopes_equal_the_jax_packages():
    from charon_tpu.core.types import Duty as JDuty, DutyType as JDutyType
    from charon_tpu.core.types import ParSignedData as JPSD
    from charon_tpu.core.types import SignedRandao as JRandao

    pset = {"0x" + "ab" * 48: ParSignedData(
        data=SignedRandao(epoch=1, signature=b"\x01" * 96), share_idx=2)}
    jpset = {"0x" + "ab" * 48: JPSD(
        data=JRandao(epoch=1, signature=b"\x01" * 96), share_idx=2)}
    duty, jduty = Duty(9, DutyType.RANDAO), JDuty(9, JDutyType.RANDAO)
    data = serialize.encode_parsig_set(duty, pset)
    assert jserialize.encode_parsig_set(jduty, jpset) == data
    assert serialize.decode_parsig_set(data) == (duty, pset)
    msg = Msg(MsgType.ROUND_CHANGE, duty, source=1, round=2,
              prepared_round=1, prepared_value="v",
              justification=(Msg(MsgType.PREPARE, duty, source=2, round=1,
                                 value="v", sig=b"\x02" * 64),))
    data = serialize.encode_consensus_msg(duty, msg)
    jduty2, jmsg = jserialize.decode_consensus_msg(data)
    assert jserialize.encode_consensus_msg(jduty2, jmsg) == data
    assert serialize.decode_consensus_msg(data) == (duty, msg)
