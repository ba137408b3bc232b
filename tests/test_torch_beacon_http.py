"""The port's beacon-API HTTP stack against the JAX package's aiohttp one.

Two equally seeded mocks (one `BeaconMock` a package, the same genesis,
validators and duties), each behind its package's `BeaconMockServer`.
Every `BeaconClient` method — chain metadata, duties, duty data,
aggregator checks and all seven submissions — returns the same values
through

- the port's client against the JAX server,
- the JAX client against the port's server, and
- the JAX client against the JAX server (the reference),

and the mocks record the same submissions.  Error statuses (404 for an
unknown route, 405 for a wrong method, 500 for a handler that raises)
raise `BeaconApiError` with the same status in both clients, and
`MultiBeaconClient` takes the first success past a dead URL.
"""

import asyncio
import dataclasses
import socket

import pytest

from charon_tpu.eth2util import beacon_client as jbc
from charon_tpu.eth2util import spec as jspec
from charon_tpu.testutil import beaconmock as jbm
from charon_tpu.testutil import beaconmock_http as jbmh
from charon_tpu_torch.app.monitoring import Registry
from charon_tpu_torch.eth2util import beacon_client as pbc
from charon_tpu_torch.eth2util import spec as pspec
from charon_tpu_torch.testutil import beaconmock as pbm
from charon_tpu_torch.testutil import beaconmock_http as pbmh

GENESIS = 1_700_000_000.0
V = 6


def norm(x):
    """A package-free form of a result: dataclasses by class name and
    fields, containers element-wise, dict keys normalised."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            norm(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return {norm(k): norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    return x


def seeded_mock(mod):
    mock = mod.BeaconMock(slot_duration=12.0, slots_per_epoch=8,
                          genesis_time=GENESIS)
    for i in range(V):
        mock.add_validator("0x" + bytes([0x80 | i]).hex() * 48)
    return mock


def submissions(spec, sig: bytes):
    att_data = spec.AttestationData(
        slot=9, index=1, beacon_block_root=b"\x11" * 32,
        source=spec.Checkpoint(epoch=0, root=b"\x22" * 32),
        target=spec.Checkpoint(epoch=1, root=b"\x33" * 32))
    att = spec.Attestation(aggregation_bits=(b"\x05", 5), data=att_data,
                           signature=sig)
    block = spec.SignedBeaconBlock(message=spec.BeaconBlock(
        slot=9, proposer_index=2, parent_root=b"\x01" * 32,
        state_root=b"\x02" * 32, body_root=b"\x03" * 32, body=b"\xab\xcd",
        blinded=False), signature=sig)
    exit_ = spec.SignedVoluntaryExit(message=spec.VoluntaryExit(
        epoch=3, validator_index=4), signature=sig)
    reg = spec.SignedValidatorRegistration(message=spec.ValidatorRegistration(
        fee_recipient=b"\x0f" * 20, gas_limit=30_000_000,
        timestamp=1_700_000_123, pubkey=b"\x81" * 48), signature=sig)
    agg = spec.SignedAggregateAndProof(message=spec.AggregateAndProof(
        aggregator_index=3, aggregate=att, selection_proof=sig),
        signature=sig)
    sync = spec.SyncCommitteeMessage(slot=9, beacon_block_root=b"\x44" * 32,
                                     validator_index=5, signature=sig)
    contrib = spec.SignedContributionAndProof(
        message=spec.ContributionAndProof(
            aggregator_index=1,
            contribution=spec.SyncCommitteeContribution(
                slot=9, beacon_block_root=b"\x44" * 32, subcommittee_index=2,
                aggregation_bits=(b"\x03" * 16, 128), signature=sig),
            selection_proof=sig),
        signature=sig)
    return [("submit_attestations", [att]), ("submit_beacon_block", block),
            ("submit_voluntary_exit", exit_),
            ("submit_validator_registrations", [reg]),
            ("submit_aggregate_attestations", [agg]),
            ("submit_sync_committee_messages", [sync]),
            ("submit_sync_committee_contributions", [contrib])]


async def drive(client, mock, spec) -> dict:
    """Every method of `client` → {method: normalised result}."""
    pks = list(mock.validators)
    sig = bytes(range(96))
    out = {"spec": await client.spec(),
           "genesis_time": await client.genesis_time(),
           "gvr": await client.genesis_validators_root(),
           "syncing": await client.node_syncing(),
           "active": await client.active_validators(pks[:4]),
           "attester": await client.attester_duties(1, list(range(V))),
           "proposer": await client.proposer_duties(1, [0, 2, 4]),
           "sync": await client.sync_duties(1, list(range(V))),
           "att_data": await client.attestation_data(9, 1),
           "block": await client.beacon_block_proposal(
               9, b"\x07" * 96, graffiti=b"g" * 32),
           "blinded": await client.beacon_block_proposal(
               10, b"\x07" * 96, blinded=True),
           "root": await client.beacon_block_root(9),
           "agg_att": await client.aggregate_attestation(9, b"\x09" * 32),
           "is_agg": await client.is_attestation_aggregator(9, 128, sig),
           "is_sync_agg": await client.is_sync_comm_aggregator(sig),
           "contribution": await client.sync_committee_contribution(
               9, 2, b"\x44" * 32)}
    for method, arg in submissions(spec, sig):
        await getattr(client, method)(arg)
    out["recorded"] = [mock.attestations, mock.blocks, mock.exits,
                       mock.registrations, mock.aggregates,
                       mock.sync_messages, mock.sync_contributions]
    return {k: norm(v) for k, v in out.items()}


async def session(client_mod, server_mod, mock_mod, spec):
    mock = seeded_mock(mock_mod)
    server = server_mod.BeaconMockServer(mock)
    await server.start()
    client = client_mod.BeaconClient(server.addr)
    try:
        return await drive(client, mock, spec), server.requests
    finally:
        await client.close()
        await server.stop()


@pytest.fixture(scope="module")
def runs():
    async def main():
        return {"ref": await session(jbc, jbmh, jbm, jspec),
                "port_client": await session(pbc, jbmh, jbm, pspec),
                "port_server": await session(jbc, pbmh, pbm, jspec),
                "port_both": await session(pbc, pbmh, pbm, pspec)}
    return asyncio.run(main())


KEYS = ("spec", "genesis_time", "gvr", "syncing", "active", "attester",
        "proposer", "sync", "att_data", "block", "blinded", "root",
        "agg_att", "is_agg", "is_sync_agg", "contribution", "recorded")


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("which", ["port_client", "port_server",
                                   "port_both"])
def test_every_method_equals_the_jax_stack(runs, which, key):
    assert runs[which][0][key] == runs["ref"][0][key]


def test_servers_log_the_same_requests(runs):
    assert runs["port_server"][1] == runs["ref"][1]
    # 23 calls less the cached genesis and the two local aggregator checks
    assert len(runs["ref"][1]) == 20


def test_some_results_are_not_empty(runs):
    ref = runs["ref"][0]
    assert ref["attester"] and ref["sync"] and ref["active"]
    assert all(rec for rec in ref["recorded"])


@pytest.mark.parametrize("path,method,status", [
    ("/eth/v1/nope", "get", 404),
    ("/eth/v1/beacon/genesis", "post", 405),
    ("/eth/v1/validator/attestation_data", "get", 500),  # no slot: KeyError
    ("/eth/v1/validator/duties/attester/x", "post", 500),
])
def test_error_statuses_raise_the_same_beacon_api_error(path, method,
                                                        status):
    async def one(client_mod, server_mod, mock_mod):
        server = server_mod.BeaconMockServer(seeded_mock(mock_mod))
        await server.start()
        client = client_mod.BeaconClient(server.addr)
        try:
            if method == "get":
                await client._get(path)
            else:
                await client._post(path, ["1"])
        except client_mod.BeaconApiError as exc:
            return exc.status
        finally:
            await client.close()
            await server.stop()
        return None

    async def main():
        return [await one(c, s, m) for c, s, m in (
            (jbc, jbmh, jbm), (pbc, jbmh, jbm), (jbc, pbmh, pbm),
            (pbc, pbmh, pbm))]
    assert asyncio.run(main()) == [status] * 4


def test_multi_client_takes_the_first_success_past_a_dead_url():
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_url = f"http://127.0.0.1:{dead.getsockname()[1]}"
    dead.close()   # nothing listens there

    async def main():
        server = pbmh.BeaconMockServer(seeded_mock(pbm))
        await server.start()
        reg = Registry()
        multi = pbc.MultiBeaconClient.from_urls([dead_url, server.addr],
                                                timeout=2.0)
        multi.bind_registry(reg)
        try:
            spec = await multi.spec()
            duties = await multi.attester_duties(1, list(range(V)))
            solo = pbc.MultiBeaconClient.from_urls([dead_url], timeout=2.0)
            with pytest.raises(OSError):
                await solo.genesis_time()
            await solo.close()
        finally:
            await multi.close()
            await server.stop()
        return spec, duties, multi, reg.render()

    spec, duties, multi, text = asyncio.run(main())
    assert spec["SLOTS_PER_EPOCH"] == 8 and duties
    assert multi.errors[dead_url] == 2 and multi.errors[
        multi.clients[1].base_url] == 0
    assert 'result="error"' in text and 'result="ok"' in text
    assert "app_beacon_request_seconds" in text
