"""Kernel K13's CPU side: the whole Miller loop as one scheduled program
(charon_tpu_torch.ops.miller_program, run by csrc/miller.cu), its plain
version `miller_loop_plain`, and the verify path that now launches it.

- `miller_loop_plain` against the JAX package's `pallas_pairing.
  miller_rows` in DIRECT mode, bit for bit, at 128 rows: two real pairs,
  ∞ rows, all-LMAX and random limbs; `miller_rows` on CPU tensors takes
  it and counts no launch.
- The scheduled program (what each lane of K13 runs) executed on CPU
  tensors with the plain field functions (`run_plain`) equals the step
  sequence bit for bit, and keeps the invariants the kernel relies on.
- `verify_device_exec` calls K13's wrapper once per tile and none of the
  K4/K5 step wrappers; the reject path's re-check (K13 on the unscaled
  rows, a K5 product of the halves, K11) gives the oracle's verdicts and
  `pairing.pairing_product_is_one`'s on a bad signature, a swapped
  message and an ∞ pubkey.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.ops import curve as jcurve
from charon_tpu.ops import pallas_g2
from charon_tpu.ops import pallas_pairing as pp
from charon_tpu_torch import convert
from charon_tpu_torch.ops import cuda_pairing as cp
from charon_tpu_torch.ops import curve as tcurve
from charon_tpu_torch.ops import fp as tfp
from charon_tpu_torch.ops import miller_program as mp
from charon_tpu_torch.ops import pairing as tpair
from charon_tpu_torch.tbls import backend_cuda
from charon_tpu_torch.tbls.ref import bls, curve as rc

ROWS = 128  # S = 1
STEP_WRAPPERS = ("pp_dbl", "pp_add", "pp_sqr", "pp_mul014")


@pytest.fixture(autouse=True)
def direct_mode():
    pallas_g2.DIRECT = True
    yield
    pallas_g2.DIRECT = False


def _inputs():
    """[3, 32, 128] p and [4, 32, 128] q: rows 0–1 two real pairs, 2–5
    pairs with P or Q at ∞, 6–9 all-LMAX limbs, the rest seeded random
    limbs in [0, LMAX]."""
    ps = [rc.multiply(rc.G1_GEN, 7), rc.multiply(rc.G1_GEN, 2**65 + 3),
          None, rc.multiply(rc.G1_GEN, 5), None, rc.G1_GEN]
    qs = [rc.multiply(rc.G2_GEN, 13), rc.multiply(rc.G2_GEN, 3**30),
          rc.G2_GEN, None, None, rc.multiply(rc.G2_GEN, 2)]
    p_side = np.asarray(pp.g1_proj_rows(jnp.asarray(jcurve.g1_pack(ps))))
    q_side = np.asarray(pp.g2_affine_rows(jnp.asarray(jcurve.g2_pack(qs))))
    gen = np.random.default_rng(20261017)
    p = gen.integers(0, tfp.LMAX + 1, (3, 32, ROWS), dtype=np.int32)
    q = gen.integers(0, tfp.LMAX + 1, (4, 32, ROWS), dtype=np.int32)
    p[..., :6] = convert.g1_from_jax(p_side)
    q[..., :6] = convert.elems_from_jax(q_side)
    p[..., 6:10] = tfp.LMAX
    q[..., 6:10] = tfp.LMAX
    return p, q


@pytest.fixture(scope="module")
def miller():
    """(p, q, the JAX rows, the port's rows, its launches)."""
    pallas_g2.DIRECT = True
    try:
        p, q = _inputs()
        want = pp.miller_rows(jnp.asarray(pallas_g2.fold_consts()),
                              jnp.asarray(convert.planes_to_jax(p)),
                              jnp.asarray(convert.planes_to_jax(q)))
        cp.reset_launches()
        got = cp.miller_rows(torch.from_numpy(p), torch.from_numpy(q))
        return p, q, convert.planes_from_jax(np.asarray(want)), got, \
            dict(cp.LAUNCHES)
    finally:
        pallas_g2.DIRECT = False


def test_plain_loop_equals_jax_miller_rows(miller):
    _, _, want, got, _ = miller
    assert tuple(got.shape) == (12, 32, ROWS)
    np.testing.assert_array_equal(got.numpy(), want)


def test_miller_rows_on_the_cpu_launches_nothing(miller):
    *_, launches = miller
    assert launches == {k: 0 for k in cp.LAUNCHES}


def test_program_runs_the_step_sequence(miller):
    """Every lane's ops of K13's default program, executed on the CPU
    with the plain field functions, give the plain loop's bits (real, ∞,
    LMAX and random rows)."""
    p, q, _, got, _ = miller
    rows = [0, 1, 2, 3, 6, 7, 20, 21]
    prog = mp.miller_program()
    out = mp.run_plain(prog, torch.from_numpy(p[..., rows]),
                       torch.from_numpy(q[..., rows]))
    np.testing.assert_array_equal(out.numpy(), got.numpy()[..., rows])


@pytest.mark.parametrize("lanes,slots,window", [
    (mp.LANES, mp.SLOTS, mp.WINDOW), (4, 54, 50), (16, 110, 100)])
def test_program_invariants(lanes, slots, window):
    prog = mp.miller_program(lanes, slots, window)
    mp.check(prog)
    assert prog.code.shape == (prog.steps, lanes, 2)
    assert int(np.asarray(prog.out).max()) < slots
    dag, _ = mp.miller_dag()
    kinds = [op.kind for op in dag.ops]
    # every op of the loop is scheduled exactly once
    assert int((mp._fields(prog.code)[0] != mp.NOP).sum()) == len(kinds)
    # 63 doublings, 5 additions, 62 squarings and 68 line multiplies:
    # 15, 13, 12 and 13 Fp2 products or squares each, 6 Fp products a line
    assert kinds.count(mp.MUL2) + kinds.count(mp.SQR2) == \
        63 * 15 + 5 * 13 + 62 * 12 + 68 * 13
    assert kinds.count(mp.MUL) == 68 * 6


@pytest.mark.parametrize("form", ["add", "sub", "small3", "small8"])
def test_lin_is_the_field_function(form):
    """LIN's one function gives the bits of fp.add / sub / mul_small."""
    from charon_tpu_torch.ops import cuda_g2

    gen = np.random.default_rng(3)
    a, b = (torch.from_numpy(gen.integers(0, tfp.LMAX + 1, (32, 64),
                                          dtype=np.int32)) for _ in range(2))
    a[:, :4] = tfp.LMAX
    b[:, 2:6] = tfp.LMAX
    got, want = {
        "add": (mp.lin_plain(a, b, 1, 1, 1, 0), cuda_g2._addf(a, b)),
        "sub": (mp.lin_plain(a, b, 1, -1, 1, 1), cuda_g2._subf(a, b)),
        "small3": (mp.lin_plain(a, a, 3, 0, 2, 0), cuda_g2._msmall(a, 3)),
        "small8": (mp.lin_plain(a, a, 8, 0, 2, 0), cuda_g2._msmall(a, 8)),
    }[form]
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the verify path
# ---------------------------------------------------------------------------

M1, M2 = b"charon-tpu-torch K13: slot 9", b"charon-tpu-torch K13: slot 10"
SKS = (0x5151, 0x626262626, 0x73737)
PKS = [rc.g1_to_bytes(bls.sk_to_pk(sk)) for sk in SKS]


def _sig(sk: int, msg: bytes) -> bytes:
    return rc.g2_to_bytes(bls.sign(sk, msg))


@pytest.fixture
def counted(monkeypatch):
    """K13's wrapper counting its calls; the step wrappers raising."""
    calls = []
    real = cp.miller_loop

    def k13(p, q, *args):
        calls.append(p.shape[-1])
        return real(p, q, *args)

    def step(*_):
        raise AssertionError("a K4/K5 step wrapper was called")

    monkeypatch.setattr(cp, "miller_loop", k13)
    for name in STEP_WRAPPERS:
        monkeypatch.setattr(cp, name, step)
    return calls


def test_verify_tile_launches_k13_once(counted):
    be = backend_cuda.CUDABackend(device="cpu")
    entries = [(PKS[0], M1, _sig(SKS[0], M1)), (PKS[1], M1, _sig(SKS[1], M1)),
               (PKS[2], M2, _sig(SKS[2], M2))]
    for tile in (entries[:2], entries[2:]):
        assert be.verify_device_exec(be.verify_host_prep(tile)) == \
            [True] * len(tile)
    # one launch per tile over its 2·v Miller rows, no re-check
    assert counted == [4, 2]
    assert "recheck_s" not in be.last_stages


def test_recheck_gives_the_oracles_verdicts(counted):
    be = backend_cuda.CUDABackend(device="cpu")
    inf_pk = rc.g1_to_bytes(None)
    entries = [
        (PKS[0], M1, _sig(SKS[0], M1)),                 # valid
        (PKS[1], M1, _sig(SKS[2], M1)),                 # another key's sig
        (PKS[2], M2, _sig(SKS[2], M1)),                 # swapped message
        (inf_pk, M1, _sig(SKS[0], M1)),                 # ∞ pubkey
    ]
    prep = be.verify_host_prep(entries)
    got = be.verify_device_exec(prep)
    want = [bls.verify(rc.g1_from_bytes(pk), m, rc.g2_from_bytes(s))
            for pk, m, s in entries]
    assert got == want == [True, False, False, False]
    # the batch check failed, so the re-check ran: one more K13 launch,
    # over both halves of the unscaled rows
    assert "recheck_s" in be.last_stages
    assert counted == [8, 8]
    # the same verdicts as the plain tower's per-row product check on the
    # rows that decode (the ∞ key does not: its verdict is the mask's)
    k = len(entries) - 1
    neg_g1 = tfp.const(backend_cuda._NEG_G1, "cpu").unsqueeze(-1).expand(
        3, 32, k)
    pks = torch.from_numpy(prep["pks"][..., :k])
    sigs = torch.from_numpy(tcurve.g2_pack([rc.g2_from_bytes(s)
                                            for _, _, s in entries[:k]]))
    hms = torch.from_numpy(prep["hms"][..., :k])
    tower = tpair.pairing_product_is_one(torch.stack([neg_g1, pks]),
                                         torch.stack([sigs, hms]))
    assert tower.tolist() == got[:k]
