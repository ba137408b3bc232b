"""Kernel K23 (the map's tail in one launch, csrc/h2c_map.cu): its CPU
side, where the wrapper runs its plain version.

- `cuda_h2c.map_tail_plain` — x's select by ok₁, the RFC 9380 sgn0 sign
  fix, the 3-isogeny as ops/miller_program.py's scheduled `iso3_dag`
  executed on tensors, the ∞ guard — against the JAX package's tail of
  `pallas_h2c.map_to_g2_rows` (:601-612: `f2_sgn0_rows`, `_f2_neg_t`, the
  `h2c_iso3` kernel body in DIRECT mode, `f2_is_zero_rows`,
  `pallas_g2._INF_PLANES`), bit for bit, at 128 rows: rows with the flip
  set and clear, both choices of ok₁, the affine point of u = 0 (the
  exceptional SSWU row), an x that is a root of the isogeny's
  x-denominator x² + k₂₁x + k₂₀ (the exact ∞ must come out), y = 0, and
  all-LMAX and random limbs; the same rows in value against the
  pure-Python `sswu.iso3`.
- The program under the smoke run's lane sweep gives the same bits; its
  invariants (`check`, MUL2 and LIN only, 13 products and 11 sums); the
  wrapper's CPU route and its refusal of other devices.
- One hash batch calls K23 once, and K9 and the K1 wrappers never.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.ops import pallas_g2, pallas_h2c
from charon_tpu_torch import convert
from charon_tpu_torch.ops import cuda_fp, cuda_g2, cuda_h2c, fp
from charon_tpu_torch.ops import curve as tcurve
from charon_tpu_torch.ops import miller_program as mp
from charon_tpu_torch.tbls import backend_cuda
from charon_tpu_torch.tbls.ref import sswu
from charon_tpu_torch.tbls.ref.fields import FQ2, P
from charon_tpu_torch.tbls.ref.hash_to_curve import hash_to_g2

ROWS = 128  # S = 1
#: the smoke run's sweep of K23's (lanes, slots, look-ahead)
SWEEP = [(4, 20, 40), (8, 16, 40), (16, 20, 40)]
#: special rows: the affine points of u = 0 and of three random u, each
#: given with the wrong sign of y; the isogeny-∞ x; y = 0
U_ROWS = (0, 1, 2, 3)
INF_ROW, Y0_ROW = 4, 5
U_VALUES = [FQ2.zero(), FQ2([5, 9]), FQ2([P - 2, 1]), FQ2([123456789, 0])]


@pytest.fixture(autouse=True)
def direct_mode():
    pallas_g2.DIRECT = True
    yield
    pallas_g2.DIRECT = False


def _f2_limbs(x: FQ2) -> np.ndarray:
    return np.stack([fp.to_limbs(int(c) % P) for c in x.coeffs])


def _isogeny_inf_x() -> FQ2:
    """A root of x² + k₂₁x + k₂₀, the isogeny's x-denominator."""
    k20, k21 = sswu._XD[0], sswu._XD[1]
    s = (k21 * k21 - k20 * 4).sqrt()
    assert s is not None
    x = (-k21 + s) * FQ2([(P + 1) // 2, 0])
    assert x * x + k21 * x + k20 == FQ2.zero()
    return x


def _inputs():
    """(aff [6, 32, 128] = (x₁, x₂, y), ok1 [128] bool, sgn [128] int32)."""
    gen = np.random.default_rng(20261103)
    aff = gen.integers(0, fp.LMAX + 1, (6, 32, ROWS), dtype=np.int32)
    ok1 = gen.integers(0, 2, ROWS).astype(bool)
    sgn = gen.integers(0, 2, ROWS).astype(np.int32)
    for r, u in zip(U_ROWS, U_VALUES):
        x, y = sswu.map_to_curve_sswu(u)
        aff[0:2, :, r] = aff[2:4, :, r] = _f2_limbs(x)
        aff[4:6, :, r] = _f2_limbs(-y)
        sgn[r] = sswu._sgn0(u)
    aff[0:2, :, INF_ROW] = aff[2:4, :, INF_ROW] = _f2_limbs(_isogeny_inf_x())
    aff[4:6, :, Y0_ROW] = 0
    aff[:, :, 6:10] = fp.LMAX
    return aff, ok1, sgn


def _jax_tail(aff, ok1, sgn) -> np.ndarray:
    """pallas_h2c.map_to_g2_rows after its affine step, line for line."""
    fc = jnp.asarray(pallas_g2.fold_consts())
    hc = jnp.asarray(pallas_h2c.h2c_consts())
    x_aff = convert.planes_to_jax(np.where(ok1, aff[0:2], aff[2:4]))
    y_aff = jnp.asarray(convert.planes_to_jax(aff[4:6]))
    sgn_u = jnp.asarray(sgn.reshape(1, ROWS))
    flip = pallas_h2c.f2_sgn0_rows(y_aff) != (sgn_u != 0)
    y_aff = jnp.where(flip[None, None], pallas_h2c._f2_neg_t(fc, y_aff),
                      y_aff)
    pt = pallas_h2c._run("h2c_iso3", fc, hc,
                         jnp.concatenate([jnp.asarray(x_aff), y_aff], axis=0))
    inf_flag = pallas_h2c.f2_is_zero_rows(pt[4:6])
    inf_pt = jnp.asarray(pallas_g2._INF_PLANES)[:, :, None, None]
    out = jnp.where(inf_flag[None, None], inf_pt, pt)
    return convert.planes_from_jax(np.asarray(out))


@pytest.fixture(scope="module")
def tail():
    aff, ok1, sgn = _inputs()
    pallas_g2.DIRECT = True
    try:
        want = _jax_tail(aff, ok1, sgn)
    finally:
        pallas_g2.DIRECT = False
    got = cuda_h2c.map_tail_plain(torch.from_numpy(aff),
                                  torch.from_numpy(ok1),
                                  torch.from_numpy(sgn))
    return aff, ok1, sgn, got, want


def test_plain_version_equals_jax(tail):
    aff, ok1, sgn, got, want = tail
    assert tuple(got.shape) == (6, 32, ROWS)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rows_of_every_kind(tail):
    """Both flips and both choices of ok₁ occur; the u rows needed the
    flip; the isogeny-∞ row is the exact (0 : 1 : 0) of the complete
    law."""
    aff, ok1, sgn, got, _ = tail
    flip = (cuda_h2c.f2_sgn0_rows(torch.from_numpy(aff[4:6])).numpy()
            != (sgn != 0))
    assert flip.any() and not flip.all() and ok1.any() and not ok1.all()
    assert flip[list(U_ROWS)].all()
    np.testing.assert_array_equal(got.numpy()[..., INF_ROW],
                                  cuda_g2._INF_PLANES)
    inf = cuda_h2c.f2_is_zero_rows(got[4:6]).numpy()
    assert inf.tolist().count(True) == 1


def _affine(pt: np.ndarray, r: int):
    """Row r of projective planes [6, 32, R] → the oracle's affine point."""
    x, y, z = (FQ2([fp.from_limbs(pt[2 * c + h, :, r]) % P for h in (0, 1)])
               for c in range(3))
    return None if z == FQ2.zero() else (x / z, y / z)


def test_u_rows_equal_the_oracle(tail):
    """The affine points of u (u = 0, the exceptional SSWU row, among
    them) come out as the pure-Python map's isogeny image; the ∞ row as
    its None."""
    _, _, _, got, _ = tail
    pts = got.numpy()
    for r, u in zip(U_ROWS, U_VALUES):
        assert _affine(pts, r) == sswu.iso3(sswu.map_to_curve_sswu(u)), r
    x = _isogeny_inf_x()
    y = (x * x * x + sswu.A_PRIME * x + sswu.B_PRIME).sqrt() or FQ2.one()
    assert sswu.iso3((x, y)) is None and _affine(pts, INF_ROW) is None


@pytest.mark.parametrize("cfg", SWEEP)
def test_sweep_configurations_give_the_same_bits(tail, cfg):
    aff, ok1, sgn, got, _ = tail
    out = cuda_h2c.h2c_map_tail(*(torch.from_numpy(a)
                                  for a in (aff, ok1, sgn)), cfg)
    assert torch.equal(out, got)


@pytest.mark.parametrize("cfg", [None, *SWEEP])
def test_program_invariants(cfg):
    prog = mp.map_tail_program(cfg)
    mp.check(prog)
    assert prog.preset == (0, 1, 2, 3) and len(prog.out) == 6
    assert prog.consts.shape == (mp.MT_CONST_PLANES, 32)
    kind = mp._fields(prog.code)[0]
    assert set(kind.ravel().tolist()) <= {mp.NOP, mp.MUL2, mp.LIN}
    assert int((kind == mp.MUL2).sum()) == 13
    assert int((kind == mp.LIN).sum()) == 22


def test_program_is_k9_iso3():
    """The scheduled isogeny alone equals K9 ISO3's plain body bit for bit
    (its Horner chains keep their operands)."""
    gen = np.random.default_rng(20261104)
    xy = torch.from_numpy(gen.integers(0, fp.LMAX + 1, (4, 32, 16),
                                       dtype=np.int32))
    got = mp.map_tail_run_plain(mp.map_tail_program(), xy[0:2], xy[2:4])
    assert torch.equal(got, cuda_h2c.iso3_plain(xy))


def test_wrapper_takes_the_plain_path_on_the_cpu(tail):
    aff, ok1, sgn, got, _ = tail
    cuda_h2c.reset_launches()
    args = [torch.from_numpy(a) for a in (aff, ok1, sgn)]
    assert torch.equal(cuda_h2c.h2c_map_tail(*args), got)
    assert torch.equal(cuda_h2c.map_tail_steps(*args), got)
    assert all(n == 0 for n in cuda_h2c.LAUNCHES.values())
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_h2c.h2c_map_tail(*[a.to("meta") for a in args])


def _refuse(what: str):
    def wrapper(*_, **__):
        raise AssertionError(f"the {what} wrapper was called")
    return wrapper


def test_hash_batch_calls_k23_once_and_no_k9_or_k1(monkeypatch):
    calls = []
    tail_fn = cuda_h2c.h2c_map_tail

    def spy(*args, **kw):
        calls.append(args[0].shape[-1])
        return tail_fn(*args, **kw)

    monkeypatch.setattr(cuda_h2c, "h2c_map_tail", spy)
    for name in ("h2c_iso3", "h2c_psi"):
        monkeypatch.setattr(cuda_h2c, name, _refuse(f"K9 {name}"))
    for name in cuda_fp.OPS:
        monkeypatch.setattr(cuda_fp, name[3:], _refuse(f"K1 {name}"))
    msgs = [b"charon-tpu-torch K23: slot 31", b"charon-tpu-torch K23: 32"]
    u = torch.from_numpy(cuda_h2c.pack_messages(msgs))
    pts = cuda_h2c.hash_to_g2_rows(u)
    assert calls == [2 * len(msgs)]
    monkeypatch.undo()
    planes = backend_cuda._affine_planes(cuda_g2.as_points(pts)).numpy()
    for k, msg in enumerate(msgs):
        np.testing.assert_array_equal(
            planes[..., k], tcurve.g2_pack([hash_to_g2(msg)])[..., 0])
