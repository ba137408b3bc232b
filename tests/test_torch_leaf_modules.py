"""The port's leaf modules held against the JAX package's:
`app.forkjoin` (fork-join with fail-fast, first-success fan-out),
`eth2util.network` (fork versions ↔ networks ↔ chain ids) and
`eth2util.synthproposer` (synthetic proposer duties over a beacon
client) — the same calls give the same results, timings aside."""

import asyncio

import pytest
import torch

torch.set_num_threads(1)

from charon_tpu.app import forkjoin as j_forkjoin  # noqa: E402
from charon_tpu.eth2util import network as j_network  # noqa: E402
from charon_tpu.eth2util import spec as j_spec  # noqa: E402
from charon_tpu.eth2util import synthproposer as j_synth  # noqa: E402
from charon_tpu.tbls import api as japi  # noqa: E402
from charon_tpu.testutil import beaconmock as j_bmock  # noqa: E402
from charon_tpu.testutil import cluster as j_cluster  # noqa: E402
from charon_tpu_torch.app import forkjoin as t_forkjoin  # noqa: E402
from charon_tpu_torch.eth2util import network as t_network  # noqa: E402
from charon_tpu_torch.eth2util import spec as t_spec  # noqa: E402
from charon_tpu_torch.eth2util import synthproposer as t_synth  # noqa: E402
from charon_tpu_torch.tbls import api as tbls  # noqa: E402
from charon_tpu_torch.testutil import beaconmock as t_bmock  # noqa: E402
from charon_tpu_torch.testutil import cluster as t_cluster  # noqa: E402


@pytest.fixture(autouse=True)
def insecure_scheme():
    tbls.set_scheme("insecure-test")
    japi.set_scheme("insecure-test")
    yield
    tbls.set_scheme("bls")
    japi.set_scheme("bls")


def test_forkjoin_and_first_success():
    def scenario(fj):
        async def main():
            async def double(x):
                await asyncio.sleep(0.001 * (3 - x))
                return x * 2

            async def fail():
                raise ValueError("boom")

            async def slow_ok():
                await asyncio.sleep(0.01)
                return "ok"

            out = [await fj.forkjoin([1, 2, 3], double)]
            try:
                await fj.forkjoin([1, 2], lambda x: fail())
            except ValueError as e:
                out.append(str(e))
            mixed = await fj.forkjoin([1, 2], lambda x: fail() if x == 1
                                      else double(x), fail_fast=False)
            out.append([type(r).__name__ if isinstance(r, Exception) else r
                        for r in mixed])
            out.append(await fj.first_success([fail, slow_ok]))
            for fns, exc in (([fail, fail], ValueError), ([], ValueError)):
                try:
                    await fj.first_success(fns)
                except exc as e:
                    out.append(str(e))

            async def never():
                await asyncio.sleep(10)

            try:
                await fj.first_success([never], timeout=0.01)
            except asyncio.TimeoutError as e:
                out.append(str(e))
            return out

        return asyncio.run(main())

    assert scenario(t_forkjoin) == scenario(j_forkjoin) == [
        [2, 4, 6], "boom", ["ValueError", 4], "ok", "boom",
        "no functions provided", "first_success timed out"]


def test_network_registry():
    assert {k: (n.name, n.fork_version, n.chain_id)
            for k, n in t_network.NETWORKS.items()} == {
        k: (n.name, n.fork_version, n.chain_id)
        for k, n in j_network.NETWORKS.items()}
    versions = [n.fork_version for n in t_network.NETWORKS.values()] + [
        bytes.fromhex("01020304")]
    for v in versions:
        assert t_network.fork_version_to_network(v) == \
            j_network.fork_version_to_network(v)
        assert t_network.fork_version_to_chain_id(v) == \
            j_network.fork_version_to_chain_id(v)
    for name in [*t_network.NETWORKS, "simnet"]:
        assert t_network.network_to_fork_version(name) == \
            j_network.network_to_fork_version(name)
    for mod in (t_network, j_network):
        with pytest.raises(ValueError):
            mod.network_to_fork_version("nonet")
    assert t_network.fork_version_to_network(bytes(4)) == "mainnet"
    assert t_network.fork_version_to_network(b"\x01\x02\x03\x04") == "simnet"


def test_synth_proposer_duties_and_block_swallowing():
    """Over a mock proposing only at each epoch's first slot: the wrapper
    fills every other slot with a synthetic duty of the same validator in
    both packages, serves the same deterministic synthetic block, swallows
    its submission, and passes the real slot's through."""

    def scenario(bmock_mod, cluster_mod, synth, spec):
        async def main():
            cluster = cluster_mod.new_cluster_for_test(2, 3, 2)
            bmock = bmock_mod.BeaconMock(slot_duration=1.0,
                                         slots_per_epoch=8)
            for v in cluster.validators:
                bmock.add_validator(v.group_pubkey)
            first = next(iter(bmock.validators.values()))

            async def sparse(epoch, indices):
                return [bmock_mod.ProposerDutyInfo(
                    pubkey=first.pubkey, validator_index=first.index,
                    slot=epoch * 8)]

            bmock.overrides["proposer_duties"] = sparse
            cl = synth.SynthProposerClient(bmock)
            cl.register_pubkeys([v.group_pubkey for v in cluster.validators])
            indices = [v.index for v in bmock.validators.values()]
            duties = await cl.proposer_duties(0, indices)
            out = [sorted((d.slot, d.validator_index, bytes(d.pubkey).hex())
                          for d in duties)]
            s = 3
            blk = await cl.beacon_block_proposal(s, b"\x01" * 96)
            blk2 = await cl.beacon_block_proposal(s, b"\x02" * 96)
            out.append((blk.slot, blk.state_root.hex(), blk.body,
                        blk.hash_tree_root().hex(),
                        blk2.hash_tree_root() == blk.hash_tree_root()))
            await cl.submit_beacon_block(
                spec.SignedBeaconBlock(message=blk, signature=b"\x03" * 96))
            out.append((len(bmock.blocks),
                        len(cl.synthetic_blocks_submitted)))
            rb = await cl.beacon_block_proposal(0, b"\x01" * 96)
            await cl.submit_beacon_block(
                spec.SignedBeaconBlock(message=rb, signature=b"\x04" * 96))
            out.append((len(bmock.blocks), rb.slot))
            return out

        return asyncio.run(main())

    t = scenario(t_bmock, t_cluster, t_synth, t_spec)
    j = scenario(j_bmock, j_cluster, j_synth, j_spec)
    assert t == j
    duties, synth_blk, swallowed, real = t
    assert [d[0] for d in duties] == list(range(8))
    assert synth_blk[0] == 3 and synth_blk[2] == b"synthetic"
    assert synth_blk[4]
    assert swallowed == (0, 1) and real == (1, 0)
