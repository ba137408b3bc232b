"""The DKG as operators run it, on the port's CLI: `create enr` ×3 →
`create dkg` → `sign` ×3 on one definition file → `dkg` ×3 → `combine`,
and a port `App` booted from what the ceremony wrote.

(i)   `create dkg`'s definition and every `sign`'s output are the bytes the
      JAX package's `cmd.main` writes from the same ENRs and keys.
(ii)  the three `dkg` runs (in-process, one thread and event loop each,
      insecure-test scheme, Pedersen) write one lock that loads and passes
      `verify_lock` in both packages, keystores of the lock's pubshares
      and deposit data whose signatures verify; a definition without its
      operators' signatures is refused.
(iii) `combine` over the three node directories recombines each group
      secret (its pubkey the lock's group key, its value the JAX `combine`'s
      after decryption); below the threshold, or with a share that does
      not belong to its node, it exits non-zero, as the JAX `combine` does.
(iv)  three port `App`s boot from the ceremony's lock and keystores and
      attest under the group keys.
(v)   `dkg` with the bls scheme on a machine with no card exits non-zero
      and names the missing device.
"""

import asyncio
import contextlib
import io
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

from charon_tpu import cmd as jcmd
from charon_tpu.cluster import definition as jdef
from charon_tpu.eth2util import keystore as jkeystore
from charon_tpu.tbls import api as japi
from charon_tpu_torch.app.run import App, RunConfig
from charon_tpu_torch.cluster import definition as pdef
from charon_tpu_torch.cmd import main as cli
from charon_tpu_torch.core.types import pubkey_from_bytes
from charon_tpu_torch.eth2util import deposit as pdeposit
from charon_tpu_torch.eth2util import keystore as pkeystore
from charon_tpu_torch.eth2util.signing import DomainName, signing_root
from charon_tpu_torch.tbls import api as papi
from charon_tpu_torch.tbls import dispatch
from charon_tpu_torch.testutil.beaconmock import BeaconMock
from charon_tpu_torch.testutil.beaconmock_http import BeaconMockServer

ROOT = Path(__file__).resolve().parent.parent
N, T, M = 3, 2, 2
FORK = bytes(4)


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


def run_cli(main, argv: list[str]) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@contextlib.contextmanager
def insecure_schemes():
    papi.set_scheme("insecure-test")
    japi.set_scheme("insecure-test")
    try:
        yield
    finally:
        papi.set_scheme("bls")
        japi.set_scheme("bls")


def keep_pipeline(mp) -> None:
    """This process runs several `dkg`s: the dispatch pipeline they share
    outlives each one's end-of-process shutdown."""
    mp.setattr(dispatch, "current_pipeline", lambda: None)


@pytest.fixture(scope="module")
def ceremony(tmp_path_factory):
    """The operators' flow on the port's CLI → (work dir, ENRs)."""
    work = tmp_path_factory.mktemp("dkg-cli")
    ports = free_ports(N)
    enrs = []
    for i in range(N):
        rc, out = run_cli(cli, ["create", "enr", "--data-dir",
                                str(work / f"op{i}"), "--host", "127.0.0.1",
                                "--port", str(ports[i])])
        assert rc == 0
        enrs.append(out.strip())
    definition = str(work / "cluster-definition.json")
    assert run_cli(cli, ["create", "dkg", "--name", "dkg-cli",
                         "--operator-enrs", ",".join(enrs),
                         "--threshold", str(T), "--num-validators", str(M),
                         "--output-file", definition])[0] == 0
    shutil.copy(definition, work / "unsigned.json")
    for i in range(N):
        shutil.copy(definition, work / f"signed-before-{i}.json")
        rc, out = run_cli(cli, ["sign", "--definition-file", definition,
                                "--identity-key-file",
                                str(work / f"op{i}" /
                                    "charon-enr-private-key")])
        assert rc == 0 and f"signed operator {i}" in out

    rcs = [None] * N

    def operator(i: int) -> None:
        rcs[i] = cli(["dkg", "--definition-file", definition,
                      "--identity-key-file",
                      str(work / f"op{i}" / "charon-enr-private-key"),
                      "--output-dir", str(work / "cluster" / f"node{i}")])

    with insecure_schemes(), pytest.MonkeyPatch.context() as mp:
        keep_pipeline(mp)
        threads = [threading.Thread(target=operator, args=(i,))
                   for i in range(N)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    assert rcs == [0] * N
    return work, enrs


def test_create_dkg_and_sign_write_the_jax_packages_bytes(ceremony,
                                                          tmp_path):
    work, enrs = ceremony
    jfile = str(tmp_path / "jax-definition.json")
    assert run_cli(jcmd.main, ["create", "dkg", "--name", "dkg-cli",
                               "--operator-enrs", ",".join(enrs),
                               "--threshold", str(T), "--num-validators",
                               str(M), "--output-file", jfile])[0] == 0
    assert Path(jfile).read_bytes() == (work / "unsigned.json").read_bytes()
    for i in range(N):
        assert Path(jfile).read_bytes() == \
            (work / f"signed-before-{i}.json").read_bytes()
        assert run_cli(jcmd.main, ["sign", "--definition-file", jfile,
                                   "--identity-key-file",
                                   str(work / f"op{i}" /
                                       "charon-enr-private-key")])[0] == 0
    assert Path(jfile).read_bytes() == \
        (work / "cluster-definition.json").read_bytes()
    jdef.verify_definition_signatures(
        jdef.definition_from_json(jdef.load_json(jfile)))


def test_dkg_writes_one_verified_lock_keystores_and_deposits(ceremony):
    work, _ = ceremony
    with insecure_schemes():
        objs = [pdef.load_json(str(work / "cluster" / f"node{i}" /
                                   "cluster-lock.json")) for i in range(N)]
        locks = [pdef.lock_from_json(obj) for obj in objs]
        assert len({lk.lock_hash for lk in locks}) == 1
        assert all(obj == objs[0] for obj in objs)
        jlock = jdef.lock_from_json(objs[0])
        assert jlock.lock_hash == locks[0].lock_hash
        jdef.verify_lock(jlock)
        lock = locks[0]
        assert lock.definition.dkg_algorithm == "default"
        assert len(lock.validators) == M
        for i in range(N):
            keys = pkeystore.load_keys(str(work / "cluster" / f"node{i}" /
                                           "validator_keys"))
            assert [papi.privkey_to_pubkey(sk) for sk in keys] == \
                [v.public_shares[i] for v in lock.validators]
        deposits = pdef.load_json(str(work / "cluster" / "node1" /
                                      "deposit-data.json"))
        for d, v in zip(deposits, lock.validators):
            assert bytes.fromhex(d["pubkey"]) == v.public_key
            root = pdeposit.deposit_signing_root(
                v.public_key, bytes.fromhex(d["withdrawal_credentials"]),
                FORK)
            assert papi.verify(v.public_key, root,
                               bytes.fromhex(d["signature"]))


def test_dkg_refuses_a_definition_without_operator_signatures(ceremony,
                                                              monkeypatch):
    work, _ = ceremony
    keep_pipeline(monkeypatch)
    with insecure_schemes(), pytest.raises(ValueError):
        cli(["dkg", "--definition-file", str(work / "unsigned.json"),
             "--identity-key-file",
             str(work / "op0" / "charon-enr-private-key"),
             "--output-dir", str(work / "refused")])
    assert not (work / "refused" / "cluster-lock.json").exists()


def copy_nodes(src: Path, dst: Path, nodes) -> Path:
    for i in nodes:
        shutil.copytree(src / f"node{i}", dst / f"node{i}")
    return dst


def test_combine_recombines_the_group_secrets(ceremony, tmp_path):
    work, _ = ceremony
    lock = pdef.lock_from_json(pdef.load_json(str(
        work / "cluster" / "node0" / "cluster-lock.json")), verify=False)
    rc, out = run_cli(cli, ["combine", "--cluster-dir", str(work / "cluster"),
                            "--output-dir", str(tmp_path / "port"),
                            "--tbls-scheme", "insecure-test"])
    papi.set_scheme("bls")
    assert rc == 0 and f"recombined {M} validator secrets" in out
    rc, _ = run_cli(jcmd.main, ["combine", "--cluster-dir",
                                str(work / "cluster"), "--output-dir",
                                str(tmp_path / "jax"), "--tbls-scheme",
                                "insecure-test"])
    japi.set_scheme("bls")
    assert rc == 0
    secrets = pkeystore.load_keys(str(tmp_path / "port"))
    # keystores salt at random: compare the decrypted keys
    assert secrets == jkeystore.load_keys(str(tmp_path / "jax"))
    with insecure_schemes():
        assert [papi.privkey_to_pubkey(sk) for sk in secrets] == \
            [v.public_key for v in lock.validators]


@pytest.mark.parametrize("case", ["below_threshold", "foreign_share"])
def test_combine_refuses(ceremony, tmp_path, capsys, case):
    work, _ = ceremony
    if case == "below_threshold":
        cluster = copy_nodes(work / "cluster", tmp_path / "c", [0])
        want = f"1 shares < threshold {T}"
    else:
        # node1's directory holds node2's shares: the secret recombined
        # from indices 1 and 2 is not the group's
        cluster = copy_nodes(work / "cluster", tmp_path / "c", [0])
        shutil.copytree(work / "cluster" / "node2", cluster / "node1")
        want = "does not match the lock's group pubkey"
    for main in (cli, jcmd.main):
        rc = main(["combine", "--cluster-dir", str(cluster), "--output-dir",
                   str(tmp_path / "out"), "--tbls-scheme", "insecure-test"])
        papi.set_scheme("bls")
        japi.set_scheme("bls")
        assert rc == 1
        assert want in capsys.readouterr().err
    assert not (tmp_path / "out" / "keystore-0.json").exists()


def test_apps_boot_from_the_ceremony_and_attest(ceremony):
    """Three port `App`s from the ceremony's lock, ENR keys and keystores
    (insecure-test scheme, 0.5 s slots): attestations reach the beacon mock
    under the lock's group keys."""
    work, _ = ceremony
    slot, spe = 0.5, 4

    async def main():
        lock = pdef.lock_from_json(pdef.load_json(str(
            work / "cluster" / "node0" / "cluster-lock.json")))
        bmock = BeaconMock(slot_duration=slot, slots_per_epoch=spe)
        for v in lock.validators:
            bmock.add_validator(pubkey_from_bytes(v.public_key))
        server = BeaconMockServer(bmock)
        await server.start()
        apps = [App(RunConfig(
            lock_file=str(work / "cluster" / f"node{i}" /
                          "cluster-lock.json"),
            identity_key_file=str(work / f"op{i}" /
                                  "charon-enr-private-key"),
            beacon_urls=[server.addr], simnet_vmock=True,
            keystore_dir=str(work / "cluster" / f"node{i}" /
                             "validator_keys"),
            ping_interval=0.5, peerinfo_interval=0.5)) for i in range(N)]
        runners = []
        for app in apps:
            await app.setup()
            runners.append(asyncio.ensure_future(app.life.run()))
        deadline = time.time() + 40.0
        try:
            while time.time() < deadline and not bmock.attestations:
                await asyncio.sleep(0.1)
        finally:
            for app in apps:
                app.life.stop()
            for r in runners:
                await asyncio.wait_for(r, timeout=15)
            await server.stop()
        return lock, bmock, apps

    with insecure_schemes():
        lock, bmock, apps = asyncio.run(main())
        assert bmock.attestations
        assert all(a.lock.lock_hash == lock.lock_hash for a in apps)
        for att in bmock.attestations:
            root = signing_root(DomainName.BEACON_ATTESTER,
                                att.data.hash_tree_root(), FORK)
            assert any(papi.verify(v.public_key, root, att.signature)
                       for v in lock.validators)


def test_dkg_with_bls_and_no_card_names_the_missing_device(ceremony,
                                                           tmp_path):
    """The ceremony's verifies and combines need the card: with the bls
    scheme and none, `dkg` exits non-zero before it dials a peer."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    work, _ = ceremony
    res = subprocess.run(
        [sys.executable, "-m", "charon_tpu_torch", "dkg",
         "--definition-file", str(work / "cluster-definition.json"),
         "--identity-key-file", str(work / "op0" / "charon-enr-private-key"),
         "--output-dir", str(tmp_path / "out")],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr, res.stderr[-2000:]
    assert not (tmp_path / "out").exists()
