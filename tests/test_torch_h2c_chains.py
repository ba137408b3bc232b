"""Kernels K18 (the Fp2 root, inverse and affine step of hash-to-G2 as one
launch each, csrc/f2_chain.cu), K19 (the G2 normalisation in one launch,
csrc/normalize.cu) and K20 (the RLC tables in one launch,
csrc/g1_tables.cu): their CPU side, where each wrapper runs its plain
version.

- K18's programs (ops/miller_program.py `chain_program`) executed on CPU
  tensors (`chain_run_plain`): the square root against the JAX package's
  `pallas_h2c.f2_sqrt_rows` and the inverse against `f2_inv_rows` (DIRECT
  mode) at 128 rows with v = 0, rows of the α = −1 branch, squares,
  non-squares and all-LMAX limbs, each under the configuration the path
  runs and a second one (`OTHER`) — exact after `canon_std`: the programs
  split each Fp2 product that JAX runs whole; the affine step against the
  K7 sequence it replaced (`f2_affine_steps`).
- K19's plain version against the JAX package's `codec.g2_normalize`,
  bit for bit (its outputs are canonical), with ∞ rows, Z = (p, 0) and
  rows whose Z ≠ 1; the wrapper against the port's K1 chain.
- K20's plain version against the JAX backend's `_rlc_g1_tables_kernel`
  by value (∞, −g1 and real keys) and against `cuda_pairing._g1_double`
  / `_g1_add` bit for bit.
- The root's exact boundary — α = −1, root² = v and the select, K18's
  epilogue on the card — in plain code (`sqrt_select_plain`) on the
  program's raw outputs against JAX's `f2_sqrt_rows`: ok exactly, the
  branch's root bit for bit.
- `check` on every new program and on the sweep's, and no SEL in K18's
  (its kernel runs the interpreter without it); `hash_to_g2_rows` and
  `_affine_planes` end to end against the JAX pipeline and its
  normalisation at pad = 128, bit for bit; one hash batch calls K18 twice,
  K19 once and no K7 wrapper; the combine normalises through K19 and the
  verify tile builds its tables through K20.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.ops import codec as jcodec
from charon_tpu.ops import pallas_g2, pallas_h2c, pallas_pairing
from charon_tpu.tbls import backend_tpu
from charon_tpu.tbls.ref.hash_to_curve import DST_G2
from charon_tpu_torch import convert
from charon_tpu_torch.ops import (codec, cuda_codec, cuda_g2, cuda_h2c,
                                  cuda_pairing, curve as tcurve, fp)
from charon_tpu_torch.ops import miller_program as mp
from charon_tpu_torch.tbls import backend_cuda
from charon_tpu_torch.tbls.ref import curve as rc
from charon_tpu_torch.tbls.ref.fields import FQ2, P
from charon_tpu_torch.tbls.ref.hash_to_curve import hash_to_g2

ROWS = 128
#: a second configuration of each program: the root's on a batch that
#: leaves the card's SMs mostly idle (`mp.CH_WIDE`), one lane for the
#: inverse, four for the affine step
OTHER = {"sqrt": mp.CH_WIDE["sqrt"], "inv": (1, 18, 40, 4),
         "affine": (4, 18, 40, 4)}


@pytest.fixture(autouse=True)
def direct_mode():
    pallas_g2.DIRECT = True
    yield
    pallas_g2.DIRECT = False


def _consts():
    return (jnp.asarray(pallas_g2.fold_consts()),
            jnp.asarray(pallas_h2c.h2c_consts()))


def _canon(planes) -> np.ndarray:
    """[n, 32, R] → each plane's canonical standard form."""
    t = torch.from_numpy(np.array(planes))
    return torch.stack([fp.canon_std(p) for p in t]).numpy()


def _fp2_rows(vals) -> np.ndarray:
    """FQ2-like (c0, c1) integer pairs → [2, 32, len] limb planes."""
    return np.stack([np.stack([fp.to_limbs(int(c) % P) for c in pair])
                     for pair in vals], axis=-1).astype(np.int32)


def _sqrt_inputs() -> np.ndarray:
    """[2, 32, 128]: v = 0; Fp non-residues (α = −1: the root is u·x0);
    squares of random Fp2 elements; all-LMAX limbs; random limbs (about
    half of them non-squares)."""
    gen = np.random.default_rng(20261027)
    v = gen.integers(0, fp.LMAX + 1, (2, 32, ROWS), dtype=np.int32)
    v[..., 0] = 0
    nonres = [c for c in range(P - 1, P - 60, -1)
              if pow(c, (P - 1) // 2, P) == P - 1][:8]
    v[..., 1:9] = _fp2_rows([(c, 0) for c in nonres])
    xs = [FQ2([int(a), int(b)]) for a, b in gen.integers(1, 2**62, (16, 2))]
    v[..., 9:25] = _fp2_rows([(x * x).coeffs for x in xs])
    v[..., 25:29] = fp.LMAX
    return v


@pytest.fixture(scope="module")
def sqrt_rows():
    v = _sqrt_inputs()
    pallas_g2.DIRECT = True
    try:
        root, ok = pallas_h2c.f2_sqrt_rows(
            *_consts(), jnp.asarray(convert.planes_to_jax(v)))
    finally:
        pallas_g2.DIRECT = False
    return v, convert.planes_from_jax(np.asarray(root)), \
        np.asarray(ok).reshape(-1)


@pytest.mark.parametrize("other", [False, True], ids=["path", "other"])
def test_sqrt_program_equals_jax(sqrt_rows, other):
    v, jroot, jok = sqrt_rows
    root, ok = cuda_h2c.f2_sqrt_rows(torch.from_numpy(v),
                                     OTHER["sqrt"] if other else None)
    np.testing.assert_array_equal(ok.numpy(), jok)
    assert jok[:25].all() and jok[25:].sum() < ROWS - 25
    np.testing.assert_array_equal(_canon(root.numpy()[..., jok]),
                                  _canon(jroot[..., jok]))


@pytest.mark.parametrize("other", [False, True], ids=["path", "other"])
def test_sqrt_epilogue_equals_jax(sqrt_rows, other):
    """The root's exact boundary (K18's epilogue; on the CPU
    `sqrt_select_plain`) on the program's raw outputs: ok is JAX's on
    zero, the α = −1 rows, squares, non-squares and all-LMAX limbs; the
    root is root_u bit for bit where α = −1, root_b elsewhere, and JAX's
    in value where ok."""
    v, jroot, jok = sqrt_rows
    tv = torch.from_numpy(v)
    cfg = OTHER["sqrt"] if other else mp.CH_CONFIG["sqrt"]
    one = fp.const(fp.ONE, "cpu").unsqueeze(-1).expand(32, ROWS)
    raw = mp.chain_run_plain(mp.chain_program("sqrt", cfg), [*tv, one])
    root, ok = cuda_h2c.sqrt_select_plain(raw, tv)
    np.testing.assert_array_equal(ok.numpy(), jok)
    is_m1 = cuda_h2c.f2_eq_const_rows(raw[0:2], cuda_h2c._F2_MINUS_ONE)
    assert is_m1[1:9].all() and not is_m1[9:25].any()
    assert torch.equal(root[..., is_m1], raw[2:4][..., is_m1])
    assert torch.equal(root[..., ~is_m1], raw[4:6][..., ~is_m1])
    np.testing.assert_array_equal(_canon(root.numpy()[..., jok]),
                                  _canon(jroot[..., jok]))
    assert jok[:25].all() and not jok[25:29].all()


@pytest.mark.parametrize("other", [False, True], ids=["path", "other"])
def test_inverse_program_equals_jax(other):
    gen = np.random.default_rng(20261028)
    a = gen.integers(0, fp.LMAX + 1, (2, 32, ROWS), dtype=np.int32)
    a[..., 0] = 0                                     # inv(0) = 0
    a[..., 1] = fp.LMAX
    a[0, :, 2], a[1, :, 2] = fp.to_limbs(P), 0        # zero in value
    got = cuda_h2c.f2_inv_rows(torch.from_numpy(a),
                               OTHER["inv"] if other else None).numpy()
    want = convert.planes_from_jax(np.asarray(pallas_h2c.f2_inv_rows(
        *_consts(), jnp.asarray(convert.planes_to_jax(a)))))
    np.testing.assert_array_equal(_canon(got), _canon(want))
    assert not _canon(got)[..., :1].any() and not _canon(got)[..., 2].any()


@pytest.mark.parametrize("other", [False, True], ids=["path", "other"])
def test_affine_program_equals_the_k7_steps(other):
    gen = np.random.default_rng(20261029)
    x = torch.from_numpy(gen.integers(0, fp.LMAX + 1, (8, 32, 16),
                                      dtype=np.int32))
    x[..., 0] = 0
    got = cuda_h2c.f2_affine_rows(*x.split(2),
                                  OTHER["affine"] if other else None)
    want = cuda_h2c.f2_affine_steps(*x.split(2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_canon(g.numpy()), _canon(w.numpy()))


def _g2_points() -> torch.Tensor:
    """[3, 2, 32, 128] projective G2 rows: real points doubled (Z ≠ 1),
    ∞ as (0 : 1 : 0), Z = (p, 0) (zero in value, not in limbs), and
    random limbs."""
    gen = np.random.default_rng(20261030)
    pts = [rc.multiply(rc.G2_GEN, int(k)) for k in gen.integers(1, 2**40, 6)]
    packed = torch.from_numpy(tcurve.g2_pack(pts + [None, None]))
    real = tcurve.double_point(tcurve.F2_OPS, packed)
    out = gen.integers(0, fp.LMAX + 1, (3, 2, 32, ROWS), dtype=np.int32)
    out[..., :8] = real.numpy()
    out[2, 0, :, 8] = fp.to_limbs(P)
    out[2, 1, :, 8] = 0
    out[2, :, :, 9] = 0
    out[..., 10] = fp.LMAX
    return torch.from_numpy(out)


def test_normalize_plain_equals_jax():
    pt = _g2_points()
    got = cuda_codec.g2_normalize(pt)
    want = jax.jit(jcodec.g2_normalize)(
        jnp.asarray(convert.elems_to_jax(pt.numpy())))
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(),
                                      convert.elems_from_jax(np.asarray(w)))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert got[4].numpy()[6:10].all() and not got[4].numpy()[:6].any()
    assert not any(g.numpy()[..., 6:10].any() for g in got[:4])


def test_normalize_wrapper_equals_the_k1_chain():
    pt = _g2_points()[..., :16].contiguous()
    for g, w in zip(cuda_codec.g2_normalize(pt), codec.g2_normalize(pt)):
        assert torch.equal(g, w)
    for g, w in zip(cuda_codec.g2_normalize_plain(pt),
                    cuda_codec.g2_normalize(pt)):
        assert torch.equal(g, w)


def _g1_keys() -> np.ndarray:
    """[3, 32, 64] G1 keys: real points, ∞, −g1 itself, all-LMAX."""
    gen = np.random.default_rng(20261031)
    pts = [rc.multiply(rc.G1_GEN, int(k)) for k in gen.integers(1, 2**40, 8)]
    keys = tcurve.g1_pack(pts + [None, rc.neg(rc.G1_GEN)])
    out = np.repeat(keys, 7, axis=-1)[..., :64].copy()
    out[..., 63] = fp.LMAX
    return out


def test_g1_tables_equal_jax():
    pks = _g1_keys()
    v = pks.shape[-1]
    jt = backend_tpu._rlc_g1_tables_kernel(
        jnp.asarray(convert.elems_to_jax(pks)))
    jbase, j2, j3 = (convert.elems_from_jax(np.asarray(
        pallas_pairing.untile_planes(t))) for t in jt)
    neg_g1 = np.broadcast_to(backend_cuda._NEG_G1[..., None], (3, 32, v))
    base = torch.from_numpy(np.stack([neg_g1, pks], axis=-1)
                            .reshape(3, 32, 2 * v).copy())
    np.testing.assert_array_equal(base.numpy(), jbase)
    p2, p3 = cuda_pairing.g1_tables(base)
    np.testing.assert_array_equal(_canon(p2.numpy()), _canon(j2))
    np.testing.assert_array_equal(_canon(p3.numpy()), _canon(j3))


def test_g1_tables_plain_is_the_g1_law():
    base = torch.from_numpy(_g1_keys())
    p2, p3 = cuda_pairing.g1_tables_plain(base)
    want2 = cuda_pairing._g1_double(base)
    assert torch.equal(p2, want2)
    assert torch.equal(p3, cuda_pairing._g1_add(want2, base))


@pytest.mark.parametrize("kind, cfg", [
    *[(k, None) for k in mp.CHAINS], *OTHER.items(),
    ("sqrt", (2, 38, 40, 4)), ("sqrt", (8, 38, 40, 4)),
    ("affine", (2, 12, 40, 3)), ("g1_tables", None)])
def test_new_programs_pass_check(kind, cfg):
    prog = (mp.g1_tables_program() if kind == "g1_tables"
            else mp.chain_program(kind, cfg))
    mp.check(prog)
    assert prog.slots <= 38 and prog.out.shape[0] == (
        6 if kind == "g1_tables" else mp.CHAINS[kind][2])


@pytest.mark.parametrize("kind", list(mp.CHAINS))
def test_chain_programs_have_no_sel(kind):
    """K18 runs program.cuh's interpreter without SEL, so its programs
    hold only Fp products and LINs (no whole Fp2 op either)."""
    for cfg in {mp.CH_CONFIG[kind], mp.chain_config(kind, 256, 132)}:
        kinds = set(mp._fields(mp.chain_program(kind, cfg).code)[0]
                    .ravel().tolist())
        assert kinds <= {mp.NOP, mp.MUL, mp.LIN}, (kind, cfg, kinds)


@pytest.fixture(scope="module")
def hashed():
    """16 messages at pad = 128 through the JAX pipeline and its
    normalisation (DIRECT mode) and through the port's."""
    msgs = [bytes([k]) * (k + 3) for k in range(16)]
    u, exc, sgn = pallas_h2c.pack_messages(msgs, DST_G2, ROWS)
    pallas_g2.DIRECT = True
    try:
        ju, jexc, jsgn = convert.h2c_inputs_to_jax(
            *convert.h2c_inputs_from_jax(u, exc, sgn))
        out = pallas_h2c.hash_to_g2_rows(*_consts(), jnp.asarray(ju),
                                         jnp.asarray(jexc), jnp.asarray(jsgn))
        want = jax.jit(jcodec.g2_normalize)(pallas_g2.untile_points(out))
    finally:
        pallas_g2.DIRECT = False
    pu, _, _ = convert.h2c_inputs_from_jax(u, exc, sgn)
    pts = cuda_h2c.hash_to_g2_rows(torch.from_numpy(pu))
    planes = backend_cuda._affine_planes(cuda_g2.as_points(pts)).numpy()
    return msgs, planes, [np.asarray(w) for w in want]


def test_hash_end_to_end_equals_jax(hashed):
    msgs, planes, (xc0, xc1, yc0, yc1, inf) = hashed
    assert not inf.any()
    for got, want in ((planes[0, 0], xc0), (planes[0, 1], xc1),
                      (planes[1, 0], yc0), (planes[1, 1], yc1)):
        np.testing.assert_array_equal(got, convert.elems_from_jax(want))
    np.testing.assert_array_equal(planes[2, 0],
                                  np.broadcast_to(fp.ONE[:, None],
                                                  (32, ROWS)))
    for k in (0, 7, 15):
        want = tcurve.g2_pack([hash_to_g2(msgs[k])])[..., 0]
        np.testing.assert_array_equal(planes[..., k], want)


def _counted(calls: dict, key: str, fn):
    def wrapper(*args, **kw):
        calls[key] += 1
        return fn(*args, **kw)
    return wrapper


def _refuse(what: str):
    def wrapper(*args, **kw):
        raise AssertionError(f"the {what} wrapper was called")
    return wrapper


def test_hash_batch_calls_k18_twice_k19_once_and_no_k7(monkeypatch):
    calls = {"chain": 0, "normalize": 0}
    monkeypatch.setattr(cuda_h2c, "_run_chain",
                        _counted(calls, "chain", cuda_h2c._run_chain))
    monkeypatch.setattr(cuda_codec, "g2_normalize", _counted(
        calls, "normalize", cuda_codec.g2_normalize))
    for name in ("h2c_sqr", "h2c_mul", "h2c_sqr4", "h2c_sqr4mul"):
        monkeypatch.setattr(cuda_h2c, name, _refuse(f"K7 {name}"))
    monkeypatch.setattr(codec, "g2_normalize", _refuse("K1 normalisation"))
    msgs = [b"charon-tpu-torch K18: slot 12", b"charon-tpu-torch K18: 13"]
    u = torch.from_numpy(cuda_h2c.pack_messages(msgs))
    pts = cuda_h2c.hash_to_g2_rows(u)
    planes = backend_cuda._affine_planes(cuda_g2.as_points(pts)).numpy()
    assert calls == {"chain": 2, "normalize": 1}
    for k, msg in enumerate(msgs):
        np.testing.assert_array_equal(
            planes[..., k], tcurve.g2_pack([hash_to_g2(msg)])[..., 0])


def test_combine_normalises_through_k19(monkeypatch):
    calls = {"normalize": 0}
    monkeypatch.setattr(backend_cuda, "ROW_TILE", 8)
    monkeypatch.setattr(cuda_codec, "g2_normalize", _counted(
        calls, "normalize", cuda_codec.g2_normalize))
    monkeypatch.setattr(codec, "g2_normalize", _refuse("K1 normalisation"))
    be = backend_cuda.CUDABackend(device="cpu")
    sigs = [rc.g2_to_bytes(rc.multiply(rc.G2_GEN, 11 + k)) for k in range(2)]
    out = be.threshold_combine_bytes([{1: sigs[0], 3: sigs[1]}])
    assert calls == {"normalize": 1}
    from charon_tpu_torch.tbls import shamir
    lam = shamir.lagrange_coeffs_at_zero([1, 3])
    want = rc.add(rc.multiply(rc.G2_GEN, 11 * lam[1]),
                  rc.multiply(rc.G2_GEN, 12 * lam[3]))
    assert out == [rc.g2_to_bytes(want)]


def test_wrappers_raise_off_the_cpu_route():
    meta = {"dtype": torch.int32, "device": "meta"}
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_h2c.f2_inv_rows(torch.empty((2, 32, 16), **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_codec.g2_normalize(torch.empty((3, 2, 32, 16), **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_pairing.g1_tables(torch.empty((3, 32, 16), **meta))
