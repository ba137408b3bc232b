"""Kernel K24 (SSWU with its flags in one launch, csrc/h2c_sswu.cu): its
CPU side, where the wrapper runs its plain version, and the host packing
that feeds it.

- `cuda_h2c.sswu_head_plain` — the prologue (the exceptional flag u ≡ 0
  and RFC 9380's sgn0(u), from u alone) and SSWU as ops/miller_program.py's
  scheduled `sswu_dag` executed on tensors — against the JAX package's
  `_sswu_body` (pallas_h2c.py :172-209, the `h2c_sswu` kernel body in
  DIRECT mode) given the JAX package's host flags, bit for bit, at 128
  rows of seeded canonical u: random u, rows with u = 0, rows with c0 = 0
  and c1 ≠ 0, rows with c1 = 0, and the rows of `pallas_h2c.pack_messages`
  (its u = 0 pad rows included).  The flags: the JAX packing's (messages)
  or its formula line for line (`_jax_host_flags`, the seeded u).
- The identity behind the flag: Z's norm is a non-residue, −1 is a square,
  so Z·u² = −1 has no root and tv1 = 0 exactly where u = 0.
- The program under the smoke run's sweep gives the same bits; its
  invariants (`check`; 11 products, 4 squares, 8 LIN halves, one Fp2 SEL);
  the program with any flag equals K8's plain body (`sswu_plain`) with that
  flag, on redundant limbs too.
- `_pack_u`'s vectorised limb split equals `fp.to_limbs` (0 and p − 1
  among its values); `pack_messages` returns u only, JAX's rows.
- The wrapper's CPU route; one hash batch calls K24 once and K8 never.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.ops import pallas_g2, pallas_h2c
from charon_tpu.tbls.ref import sswu as jsswu
from charon_tpu.tbls.ref.fields import FQ2 as JFQ2
from charon_tpu.tbls.ref.hash_to_curve import DST_G2
from charon_tpu_torch import convert
from charon_tpu_torch.ops import cuda_g2, cuda_h2c, fp
from charon_tpu_torch.ops import curve as tcurve
from charon_tpu_torch.ops import miller_program as mp
from charon_tpu_torch.tbls import backend_cuda
from charon_tpu_torch.tbls.ref import sswu
from charon_tpu_torch.tbls.ref.fields import FQ2, P
from charon_tpu_torch.tbls.ref.hash_to_curve import hash_to_g2

ROWS = 128  # S = 1
#: the smoke run's sweep of K24's (lanes, slots, look-ahead)
SWEEP = [(2, 20, 40), (4, 24, 40), (8, 20, 40), (16, 20, 40)]
CASES = ["random", "zero", "c0_zero", "c1_zero", "messages"]
MSGS = [b"", b"abc", b"charon-tpu-torch K24: slot 11"]


@pytest.fixture(autouse=True)
def direct_mode():
    pallas_g2.DIRECT = True
    yield
    pallas_g2.DIRECT = False


def _coeff(gen) -> int:
    return int.from_bytes(gen.bytes(48), "little") % P


def _case_values(case: str) -> list[tuple[int, int]]:
    """128 seeded canonical u values (c0, c1); every second row of the
    special kind."""
    gen = np.random.default_rng(20261117 + CASES.index(case))
    vals = [(_coeff(gen), _coeff(gen)) for _ in range(ROWS)]
    for r in range(0, ROWS, 2):
        c0, c1 = vals[r]
        if case == "zero":
            vals[r] = (0, 0)
        elif case == "c0_zero":
            vals[r] = (0, c1 or 1)
        elif case == "c1_zero":
            vals[r] = (c0 if r % 4 else r // 4, 0)    # u = 0 at row 0 too
    return vals


def _jax_host_flags(vals) -> tuple[np.ndarray, np.ndarray]:
    """The flags as `pallas_h2c.pack_messages` computes them per row, on
    the JAX package's ref field: tv1 = 0 and sgn0(u)."""
    exc, sgn = [], []
    for c0, c1 in vals:
        u = JFQ2([c0, c1])
        zu2 = jsswu.Z_SSWU * (u * u)
        tv1 = zu2 * zu2 + zu2
        exc.append(1 if tv1.is_zero() else 0)
        sgn.append(jsswu._sgn0(u))
    return np.array(exc, np.int32), np.array(sgn, np.int32)


def _inputs(case: str):
    """(u [2, 32, 128] canonical limbs, JAX's exc and sgn [128])."""
    if case == "messages":
        u_rows, exc, sgn = pallas_h2c.pack_messages(MSGS, DST_G2, ROWS // 2)
        return convert.h2c_inputs_from_jax(u_rows, exc, sgn)
    vals = _case_values(case)
    u = cuda_h2c._pack_u([FQ2(list(v)) for v in vals])
    return (u, *_jax_host_flags(vals))


def _jax_sswu(u: np.ndarray, exc: np.ndarray) -> np.ndarray:
    ju, jexc, _ = convert.h2c_inputs_to_jax(u, exc, exc)
    out = pallas_h2c._DIRECT_FNS["h2c_sswu"](
        jnp.asarray(pallas_g2.fold_consts()),
        jnp.asarray(pallas_h2c.h2c_consts()), jnp.asarray(ju),
        jnp.asarray(jexc))
    return convert.planes_from_jax(np.asarray(out))


@pytest.mark.parametrize("case", CASES)
def test_plain_version_equals_jax(case):
    u, exc, sgn = _inputs(case)
    out, got_sgn = cuda_h2c.sswu_head_plain(torch.from_numpy(u))
    assert tuple(out.shape) == (10, 32, ROWS) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), _jax_sswu(u, exc))
    np.testing.assert_array_equal(got_sgn.numpy(), sgn)


@pytest.mark.parametrize("case", CASES)
def test_prologue_flags_equal_the_jax_host_flags(case):
    """exc and sgn0(u) from u alone equal the JAX packing's; each case has
    rows of its kind, and both values of both flags occur where they
    can."""
    u, exc, sgn = _inputs(case)
    got_exc, got_sgn = cuda_h2c.sswu_flags_plain(torch.from_numpy(u))
    np.testing.assert_array_equal(got_exc.numpy(), exc)
    np.testing.assert_array_equal(got_sgn.numpy(), sgn)
    assert sgn.any() and not sgn.all()
    if case in ("zero", "c1_zero", "messages"):
        assert exc.any() and not exc.all()
    else:
        assert not exc.any()
    if case == "c0_zero":
        assert (u[0][:, ::2] == 0).all()
        assert (u[1][:, ::2] != 0).any(axis=0).all()


def test_the_flag_is_u_equal_to_zero():
    """Z = −(2 + i) has norm 5, a non-residue mod p, so Z is a non-square
    in Fp2; −1 = i² is a square; so −1/Z is not, and Z·u² = −1 has no
    root: tv1 = Z·u²·(Z·u² + 1) = 0 exactly where u = 0."""
    z0, z1 = (int(c) % P for c in sswu.Z_SSWU.coeffs)
    assert (z0, z1) == (P - 2, P - 1)
    norm = (z0 * z0 + z1 * z1) % P
    assert norm == 5 and pow(5, (P - 1) // 2, P) == P - 1
    assert FQ2([0, 1]) * FQ2([0, 1]) == -FQ2.one()
    inv_norm = pow(norm, P - 2, P)                      # norm(−1/Z)
    assert pow(inv_norm, (P - 1) // 2, P) == P - 1
    gen = np.random.default_rng(20261118)
    vals = [(_coeff(gen), _coeff(gen)) for _ in range(64)]
    vals += [(0, 0), (0, 1), (1, 0), (P - 1, P - 1)]
    exc, _ = _jax_host_flags(vals)
    np.testing.assert_array_equal(
        exc, [int(v == (0, 0)) for v in vals])


@pytest.mark.parametrize("cfg", SWEEP)
def test_sweep_configurations_give_the_same_bits(cfg):
    u = torch.from_numpy(_inputs("zero")[0])
    out, sgn = cuda_h2c.h2c_sswu_head(u, cfg)
    want, want_sgn = cuda_h2c.sswu_head_plain(u)
    assert torch.equal(out, want) and torch.equal(sgn, want_sgn)


@pytest.mark.parametrize("cfg", [None, *SWEEP])
def test_program_invariants(cfg):
    prog = mp.sswu_program(cfg)
    mp.check(prog)
    assert prog.preset == (0, 1) and len(prog.out) == 10
    assert prog.consts.shape == (mp.SW_CONST_PLANES, 32)
    np.testing.assert_array_equal(prog.consts, cuda_h2c.h2c_consts()[:12])
    kind = mp._fields(prog.code)[0]
    counts = {k: int((kind == k).sum()) for k in (mp.MUL2, mp.SQR2, mp.MUL,
                                                  mp.LIN, mp.SEL)}
    assert counts == {mp.MUL2: 11, mp.SQR2: 4, mp.MUL: 0, mp.LIN: 8,
                      mp.SEL: 2}


@pytest.mark.parametrize("pattern", ["random", "lmax"])
def test_program_is_k8(pattern):
    """The scheduled program with a flag equals K8's plain body with that
    flag, bit for bit, on redundant limbs and with the flag set on rows
    where u ≠ 0: it runs K8's op sequence."""
    gen = np.random.default_rng(20261119)
    if pattern == "lmax":
        u = np.full((2, 32, 16), fp.LMAX, np.int32)
    else:
        u = gen.integers(0, fp.LMAX + 1, (2, 32, 16), dtype=np.int32)
    w = torch.from_numpy((np.arange(16) % 3 == 0).astype(np.int32))
    ut = torch.from_numpy(u)
    for cfg in (None, *SWEEP):
        got = mp.sswu_run_plain(mp.sswu_program(cfg), ut, w)
        assert torch.equal(got, cuda_h2c.sswu_plain(ut, w)), cfg


def test_pack_u_limbs_equal_to_limbs():
    gen = np.random.default_rng(20261120)
    vals = [(0, P - 1), (P - 1, 0), (1, 2 ** 380), (2 ** 12 - 1, 2 ** 12)]
    vals += [(_coeff(gen), _coeff(gen)) for _ in range(60)]
    u = cuda_h2c._pack_u([FQ2(list(v)) for v in vals])
    want = np.stack([np.stack([fp.to_limbs(c) for c in v]) for v in vals])
    assert u.dtype == np.int32 and u.flags.c_contiguous
    np.testing.assert_array_equal(u, want.transpose(1, 2, 0))
    assert cuda_h2c._pack_u([]).shape == (2, 32, 0)


def test_pack_messages_returns_u_only():
    m = len(MSGS)
    u = cuda_h2c.pack_messages(MSGS)
    assert isinstance(u, np.ndarray) and u.shape == (2, 32, 2 * m)
    j_u, j_exc, j_sgn = pallas_h2c.pack_messages(MSGS, DST_G2, m)
    np.testing.assert_array_equal(
        u, convert.h2c_inputs_from_jax(j_u, j_exc, j_sgn)[0])


def test_wrapper_takes_the_plain_path_on_the_cpu():
    u = torch.from_numpy(_inputs("c1_zero")[0])
    cuda_h2c.reset_launches()
    out, sgn = cuda_h2c.h2c_sswu_head(u)
    want, want_sgn = cuda_h2c.sswu_head_plain(u)
    assert torch.equal(out, want) and torch.equal(sgn, want_sgn)
    assert all(n == 0 for n in cuda_h2c.LAUNCHES.values())
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_h2c.h2c_sswu_head(u.to("meta"))


def _refuse(what: str):
    def wrapper(*_, **__):
        raise AssertionError(f"the {what} wrapper was called")
    return wrapper


def test_hash_batch_calls_k24_once_and_k8_never(monkeypatch):
    calls = []
    head = cuda_h2c.h2c_sswu_head

    def spy(*args, **kw):
        calls.append(args[0].shape[-1])
        return head(*args, **kw)

    monkeypatch.setattr(cuda_h2c, "h2c_sswu_head", spy)
    monkeypatch.setattr(cuda_h2c, "h2c_sswu", _refuse("K8 h2c_sswu"))
    monkeypatch.setattr(cuda_h2c, "sswu_plain", _refuse("K8 sswu_plain"))
    msgs = [b"charon-tpu-torch K24: slot 41", b"charon-tpu-torch K24: 42"]
    pts = cuda_h2c.hash_to_g2_rows(torch.from_numpy(
        cuda_h2c.pack_messages(msgs)))
    assert calls == [2 * len(msgs)]
    monkeypatch.undo()
    planes = backend_cuda._affine_planes(cuda_g2.as_points(pts)).numpy()
    for k, msg in enumerate(msgs):
        np.testing.assert_array_equal(
            planes[..., k], tcurve.g2_pack([hash_to_g2(msg)])[..., 0])
