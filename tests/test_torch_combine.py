"""The combine slice as a whole: the port's SigAgg → dispatch pipeline →
tbls.api.threshold_combine → CUDABackend, run on the CPU (device="cpu":
every kernel wrapper takes its plain version), against the JAX package's
tbls.api.threshold_combine on its "cpu" backend, byte for byte, with the
full 87 Straus windows.

Also: real Shamir shares combine to sk·H(m); malformed and off-curve
signatures raise ValueError; the backend refuses to start without a card
unless the CPU is asked for; and the port imports neither JAX nor any
module of the JAX package.
"""

import asyncio
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.tbls import api as japi
from charon_tpu_torch.core.sigagg import SigAgg
from charon_tpu_torch.core.types import Duty, DutyType, ParSignedData, \
    SignedRandao
from charon_tpu_torch.tbls import api as tapi
from charon_tpu_torch.tbls import backend_cuda
from charon_tpu_torch.tbls.ref import curve as rc
from charon_tpu_torch.tbls.ref.fields import FQ2, R
from charon_tpu_torch.tbls.ref.hash_to_curve import hash_to_g2

MSG = b"charon-tpu-torch combine test"


@pytest.fixture
def port_backend(monkeypatch):
    """The port's "cuda" backend on the CPU, validators padded to 8."""
    monkeypatch.setattr(backend_cuda, "ROW_TILE", 8)
    monkeypatch.setattr(tapi, "_BACKENDS", dict(tapi._BACKENDS))
    monkeypatch.setattr(tapi, "_current_name", tapi._current_name)
    be = backend_cuda.CUDABackend(device="cpu")
    tapi.register_backend("cuda", be)
    tapi.set_backend("cuda")
    japi.set_backend("cpu")
    yield be


def _sigagg(sig_sets: list[dict[int, bytes]], threshold: int) -> list[bytes]:
    """One SigAgg.aggregate() per validator in one loop tick; returns the
    group signatures in validator order (asserts ONE coalesced combine)."""
    from charon_tpu_torch.tbls import dispatch

    async def run():
        agg = SigAgg(threshold)
        out = {}

        async def sub(duty, pk, signed):
            out[pk] = signed.signature

        agg.subscribe(sub)
        pipe = dispatch.default_pipeline()
        before = pipe.launches
        duty = Duty(3, DutyType.RANDAO)
        await asyncio.gather(*[
            agg.aggregate(duty, f"0x{v:096x}",
                          [ParSignedData(SignedRandao(1, s), i)
                           for i, s in sigs.items()])
            for v, sigs in enumerate(sig_sets)])
        assert pipe.launches - before == 1
        return [out[f"0x{v:096x}"] for v in range(len(sig_sets))]

    return asyncio.run(run())


_POOL = [rc.g2_to_bytes(rc.multiply(rc.G2_GEN, 11 + 7 * k)) for k in range(12)]


def _check_against_jax(v: int, t: int) -> None:
    """Random signatures from a pool, a random t-subset of 1..10 per
    validator (so the batch holds several Lagrange digit rows)."""
    rng = random.Random(v * 100 + t)
    sig_sets = [{i: rng.choice(_POOL)
                 for i in sorted(rng.sample(range(1, 11), t))}
                for _ in range(v)]
    assert _sigagg(sig_sets, t) == japi.threshold_combine(sig_sets)


def test_sigagg_equals_jax_cpu_backend(port_backend):
    """V = 3, T = 3 (V = 130 is in tests/test_torch_combine_wide.py)."""
    _check_against_jax(3, 3)


def test_real_shamir_shares_combine_to_the_group_signature(port_backend):
    """V = 1, T = 7 of 10: partial signatures of real Shamir shares
    combine to sk·H(m), as the JAX cpu backend's do."""
    rng = random.Random(1)
    sk = rng.randrange(1, R)
    tss, shares = tapi.split_secret(tapi.int_to_privkey(sk), 7, 10, rng)
    assert tss.threshold == 7
    idxs = sorted(rng.sample(range(1, 11), 7))
    sigs = {i: tapi.sign(shares[i], MSG) for i in idxs}
    [got] = _sigagg([sigs], 7)
    assert got == rc.g2_to_bytes(rc.multiply(hash_to_g2(MSG), sk))
    assert got == japi.threshold_combine([sigs])[0]


def test_malformed_and_off_curve_signatures_raise(port_backend):
    good = {1: _POOL[0], 2: _POOL[1]}
    malformed = bytes([_POOL[2][0] & 0x7F]) + _POOL[2][1:]
    with pytest.raises(ValueError, match="malformed"):
        tapi.threshold_combine([good, {1: _POOL[3], 2: malformed}])
    x = 1
    while (FQ2([x, 0]) ** 3 + rc.B2).sqrt() is not None:
        x += 1
    off_curve = bytes([0x80]) + bytes(47) + x.to_bytes(48, "big")
    with pytest.raises(ValueError, match="not on the G2 curve"):
        tapi.threshold_combine([good, {1: _POOL[3], 2: off_curve}])
    with pytest.raises(ValueError, match="96 bytes"):
        tapi.threshold_combine([{1: _POOL[0][:95], 2: _POOL[1]}])


def test_backend_attribution_and_padding(port_backend):
    assert tapi.backend_name() == "cuda"
    assert tapi.combine_path() == "straus"
    assert tapi.combine_padded_rows(130, 7) == 136
    assert tapi.threshold_combine([]) == []
    # the verify half exists on the same backend (slice 2)
    assert port_backend.batch_verify([]) == []
    assert tapi.verify_path(2048) == "cuda-rlc+h2c-dev"


def test_padding_of_the_north_star_batch():
    """10,000 validators pad to 10,240 (the JAX fused path's padding)."""
    be = backend_cuda.CUDABackend(device="cpu")
    assert be.combine_padded_rows(10_000, 7) == 10_240
    assert be.combine_padded_rows(0, 7) == 0


def test_backend_without_a_card_raises(monkeypatch):
    """No silent CPU run: only device="cpu" runs the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend_cuda.CUDABackend()
    monkeypatch.setattr(tapi, "_BACKENDS", {"cpu": tapi.CPUBackend()})
    monkeypatch.setattr(tapi, "_current_name", "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.set_backend("cuda")
    with pytest.raises(KeyError, match="unknown"):
        tapi.set_backend("tpu")


def test_default_backend_is_the_card():
    """A fresh import with no set_backend() call combines on the card: it
    resolves to the cuda backend, or raises when there is no card — the
    pure-Python oracle runs only after set_backend("cpu")."""
    code = (
        "import torch\n"
        "from charon_tpu_torch.tbls import api\n"
        "if torch.cuda.is_available():\n"
        "    assert api.backend_name() == 'cuda'\n"
        "    print('cuda')\n"
        "else:\n"
        "    try:\n"
        "        api.threshold_combine([])\n"
        "    except RuntimeError as exc:\n"
        "        assert 'no CUDA device' in str(exc), exc\n"
        "        print('raised')\n"
        "api.set_backend('cpu')\n"
        "assert api.backend_name() == 'cpu'\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=str(Path(__file__).resolve().parent.parent))
    assert res.returncode == 0, res.stderr
    want = "cuda" if torch.cuda.is_available() else "raised"
    assert res.stdout.split() == [want]


def test_port_imports_neither_jax_nor_the_jax_package():
    """Nor aiohttp or cryptography: the card's machine has neither, so the
    port brings its own HTTP and primitives."""
    code = (
        "import pkgutil, sys, importlib, charon_tpu_torch\n"
        "for m in pkgutil.walk_packages(charon_tpu_torch.__path__,"
        " 'charon_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax',"
        " 'jaxlib', 'charon_tpu', 'aiohttp', 'cryptography'))\n"
        "assert not bad, bad\n"
        "new = ('charon_tpu_torch.tbls.devcache', 'charon_tpu_torch.tbls.api',"
        " 'charon_tpu_torch.tbls.ref.bls', 'charon_tpu_torch.tbls.shamir',"
        " 'charon_tpu_torch.eth2util.ssz', 'charon_tpu_torch.eth2util.spec',"
        " 'charon_tpu_torch.eth2util.signing',"
        " 'charon_tpu_torch.core.interfaces', 'charon_tpu_torch.core.scheduler',"
        " 'charon_tpu_torch.core.fetcher', 'charon_tpu_torch.core.leadercast',"
        " 'charon_tpu_torch.core.dutydb', 'charon_tpu_torch.core.validatorapi',"
        " 'charon_tpu_torch.core.parsigdb', 'charon_tpu_torch.core.parsigex',"
        " 'charon_tpu_torch.core.aggsigdb', 'charon_tpu_torch.core.bcast',"
        " 'charon_tpu_torch.app.node', 'charon_tpu_torch.testutil.cluster',"
        " 'charon_tpu_torch.testutil.beaconmock',"
        " 'charon_tpu_torch.testutil.validatormock',"
        " 'charon_tpu_torch.core.qbft', 'charon_tpu_torch.core.consensus',"
        " 'charon_tpu_torch.core.deadline', 'charon_tpu_torch.core.tracker',"
        " 'charon_tpu_torch.core.slotbudget', 'charon_tpu_torch.app.qbftdebug',"
        " 'charon_tpu_torch.app.tracing', 'charon_tpu_torch.app.monitoring',"
        " 'charon_tpu_torch.p2p.ed25519', 'charon_tpu_torch.p2p.aead',"
        " 'charon_tpu_torch.eth2util.aes', 'charon_tpu_torch.p2p.identity',"
        " 'charon_tpu_torch.p2p.transport', 'charon_tpu_torch.core.serialize',"
        " 'charon_tpu_torch.core.priority', 'charon_tpu_torch.p2p.protocols',"
        " 'charon_tpu_torch.app.retry', 'charon_tpu_torch.app.featureset',"
        " 'charon_tpu_torch.app.lifecycle', 'charon_tpu_torch.app.peerinfo',"
        " 'charon_tpu_torch.cluster.definition',"
        " 'charon_tpu_torch.eth2util.keystore',"
        " 'charon_tpu_torch.eth2util.deposit',"
        " 'charon_tpu_torch.eth2util.beaconapi', 'charon_tpu_torch.app.http1',"
        " 'charon_tpu_torch.eth2util.beacon_client',"
        " 'charon_tpu_torch.testutil.beaconmock_http',"
        " 'charon_tpu_torch.app.run', 'charon_tpu_torch.cmd',"
        " 'charon_tpu_torch.__main__', 'charon_tpu_torch.app.serving',"
        " 'charon_tpu_torch.app.router', 'charon_tpu_torch.app.otlp',"
        " 'charon_tpu_torch.app.log', 'charon_tpu_torch.app.autoprofile',"
        " 'charon_tpu_torch.app.forkjoin', 'charon_tpu_torch.eth2util.network',"
        " 'charon_tpu_torch.eth2util.synthproposer',"
        " 'charon_tpu_torch.testutil.httpvc',"
        " 'charon_tpu_torch.testutil.serving_load',"
        " 'charon_tpu_torch.testutil.chaos',"
        " 'charon_tpu_torch.testutil.racecheck',"
        " 'charon_tpu_torch.testutil.golden')\n"
        "assert all(m in sys.modules for m in new), new\n"
        "print(len([m for m in sys.modules if m.startswith('charon_tpu_torch')]))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=str(Path(__file__).resolve().parent.parent))
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 97
