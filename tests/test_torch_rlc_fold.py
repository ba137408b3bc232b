"""Kernels K14 (the product fold in one launch, csrc/fold.cu) and K15 (the
RLC scaling in one launch, csrc/g1_scalar_mul.cu): their CPU side.

- The RLC scaling's plain version (`g1_scalar_mul_plain`, the iterated
  K6 window) against the JAX package's `pallas_pairing.
  g1_scalar_mul_rows` in DIRECT mode, bit for bit, at 128 rows: real
  tables {P, 2P, 3P}, ∞ rows, all-LMAX and random limbs, every digit.
- K15's scheduled program (ops/miller_program.py `g1_program`, what each
  lane runs) executed on CPU tensors with the plain field functions
  (`g1_run_plain`) equals the plain windows bit for bit; with y negated
  (`neg_y`, the verify path's Miller p-side) it equals JAX's
  `g1_scalar_mul_rows` followed by JAX's `g1_proj_rows`; its invariants
  (`check`, SEL's operands included); SEL's plain semantics; the small
  multiples of the G1 law as LIN; K13's program unchanged by the
  scheduler's new Fp values and SEL.
- The fold with drop flags (`fold_product(f, drop)`) against `mask_rows`
  then the plain fold, bit for bit, and against the JAX tower's fold by
  value.
- `verify_device_exec` calls K14's and K15's wrappers once per tile, K6
  never and K5 F12MUL only inside the re-check; it takes the p-side from
  K15 (−Y) and the batch verdict from K11, and `g1_proj_rows` only in
  the re-check.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.ops import curve as jcurve
from charon_tpu.ops import fp as jfp
from charon_tpu.ops import pallas_g2
from charon_tpu.ops import pallas_pairing as pp
from charon_tpu.ops import tower as jtower
from charon_tpu_torch import convert
from charon_tpu_torch.ops import cuda_final_exp as cfe
from charon_tpu_torch.ops import cuda_g2
from charon_tpu_torch.ops import cuda_pairing as cp
from charon_tpu_torch.ops import fp as tfp
from charon_tpu_torch.ops import miller_program as mp
from charon_tpu_torch.tbls import backend_cuda
from charon_tpu_torch.tbls.ref import bls, curve as rc

ROWS = 128
NWIN = 32
# rows of the tables: 0–7 real points, 8–11 ∞, 12–15 all-LMAX limbs, the
# rest random limbs
SAMPLE = [0, 1, 8, 9, 12, 13, 40, 41]


@pytest.fixture(autouse=True)
def direct_mode():
    pallas_g2.DIRECT = True
    yield
    pallas_g2.DIRECT = False


def _tables():
    """Three [3, 32, 128] tables and [32, 128] windows with every digit."""
    gen = np.random.default_rng(20261018)
    pts = [rc.multiply(rc.G1_GEN, int(k)) for k in gen.integers(1, 2**40, 8)]
    base = jnp.asarray(jcurve.g1_pack(pts + [None] * 4))
    p2 = jcurve.double_point(jcurve.FP_OPS, base)
    p3 = jcurve.add_points(jcurve.FP_OPS, p2, base)
    tabs = []
    for t in (base, p2, p3):
        port = gen.integers(0, tfp.LMAX + 1, (3, 32, ROWS), dtype=np.int32)
        port[..., :12] = convert.g1_from_jax(np.asarray(t))
        port[..., 12:16] = tfp.LMAX
        tabs.append(port)
    w = gen.integers(0, 4, (NWIN, ROWS), dtype=np.int32)
    assert set(np.unique(w[:, SAMPLE])) == {0, 1, 2, 3}
    return tabs, w


@pytest.fixture(scope="module")
def scaled():
    """(tables, windows, the port's plain rows, JAX's rows)."""
    pallas_g2.DIRECT = True
    try:
        tabs, w = _tables()
        want = pp.g1_scalar_mul_rows(
            jnp.asarray(pallas_g2.fold_consts()),
            *[jnp.asarray(convert.planes_to_jax(t)) for t in tabs],
            jnp.asarray(convert.digits_to_jax(w)))
        got = cp.g1_scalar_mul_rows(*[torch.from_numpy(t) for t in tabs],
                                    torch.from_numpy(w))
        return tabs, w, got, convert.planes_from_jax(np.asarray(want))
    finally:
        pallas_g2.DIRECT = False


def test_scalar_mul_plain_equals_jax(scaled):
    *_, got, want = scaled
    assert tuple(got.shape) == (3, 32, ROWS)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lanes,slots,window", [
    (mp.G1_LANES, mp.G1_SLOTS, mp.G1_WINDOW), (2, 16, 40), (8, 20, 40)])
def test_g1_program_runs_the_windows(scaled, lanes, slots, window):
    """Every lane's ops of K15's program, executed on the CPU with the
    plain field functions, give the plain windows' bits (real, ∞, LMAX
    and random rows)."""
    tabs, w, got, _ = scaled
    prog = mp.g1_program(NWIN, lanes, slots, window)
    out = mp.g1_run_plain(prog, *[torch.from_numpy(t[..., SAMPLE])
                                  for t in tabs],
                          torch.from_numpy(w[:, SAMPLE]))
    np.testing.assert_array_equal(out.numpy(), got.numpy()[..., SAMPLE])


@pytest.mark.parametrize("lanes,slots,window", [
    (mp.G1_LANES, mp.G1_SLOTS, mp.G1_WINDOW), (2, 16, 40), (8, 20, 40)])
def test_g1_program_neg_y_equals_jax_proj_rows(scaled, lanes, slots, window):
    """K15's −Y (one LIN more, fp381 neg's columns) against JAX's scaling
    followed by JAX's `g1_proj_rows`, bit for bit; the wrapper's CPU route
    the same."""
    tabs, w, _, jrows = scaled
    jp = np.asarray(pp.g1_proj_rows(jnp.asarray(
        convert.g1_to_jax(jrows, tiled=False))))
    want = convert.g1_from_jax(jp)[..., SAMPLE]
    prog = mp.g1_program(NWIN, lanes, slots, window, neg_y=True)
    mp.check(prog)
    out = mp.g1_run_plain(prog, *[torch.from_numpy(t[..., SAMPLE])
                                  for t in tabs],
                          torch.from_numpy(w[:, SAMPLE]))
    np.testing.assert_array_equal(out.numpy(), want)
    got = cp.g1_scalar_mul_rows(*[torch.from_numpy(t) for t in tabs],
                                torch.from_numpy(w), neg_y=True)
    np.testing.assert_array_equal(got.numpy()[..., SAMPLE], want)


@pytest.mark.parametrize("lanes,slots,window", [
    (mp.G1_LANES, mp.G1_SLOTS, mp.G1_WINDOW), (2, 16, 40), (8, 20, 40)])
def test_g1_program_invariants(lanes, slots, window):
    prog = mp.g1_program(NWIN, lanes, slots, window)
    mp.check(prog)
    assert prog.code.shape == (prog.steps, lanes, 2)
    assert prog.out.shape == (3,) and int(prog.out.max()) < slots
    dag, _ = mp.g1_dag(NWIN)
    kinds = [op.kind for op in dag.ops]
    assert int((mp._fields(prog.code)[0] != mp.NOP).sum()) == len(kinds)
    # a window: two doublings (8 products, 7 sums or multiples each), one
    # addition (12 products, 20), three table SELs and three result SELs
    assert kinds.count(mp.MUL) == NWIN * 28
    assert kinds.count(mp.LIN) == NWIN * 34
    assert kinds.count(mp.SEL) == NWIN * 6
    kind, _, _, b, win, *_, stride = mp._fields(prog.code)
    sel = kind == mp.SEL
    # table SELs stride over the input planes T1, T2, T3; result SELs
    # choose between two slots
    assert set(stride[sel].tolist()) == {0, mp.G1_STRIDE}
    assert (b[sel & (stride > 0)] >= mp.GLOBAL).all()
    assert set(win[sel].tolist()) == set(range(NWIN))


def test_check_refuses_a_sel_striding_over_slots():
    prog = mp.g1_program(NWIN)
    kind, _, _, b, *_, stride = mp._fields(prog.code)
    s, lane = (int(x[0]) for x in np.nonzero((kind == mp.SEL)
                                             & (stride == 0)))
    bad = mp.Program(prog.code.copy(), prog.kinds, prog.out, prog.lanes,
                     prog.slots)
    bad.code[s, lane, 1] |= mp.G1_STRIDE << 8
    with pytest.raises(AssertionError, match="SEL strides"):
        mp.check(bad)


def _op(kind, out, a, b, w1):
    return np.array([kind | out << 8 | a << 16 | b << 24, w1],
                    np.uint32).view(np.int32)


def test_sel_plain_semantics():
    """SEL writes a where the row's digit of its window is 0, else the
    operand coded b + stride·(d − 1)."""
    gen = np.random.default_rng(5)
    planes = [torch.from_numpy(gen.integers(0, tfp.LMAX + 1, (32, 16),
                                            dtype=np.int32))
              for _ in range(4)]
    d = torch.from_numpy(np.tile(np.arange(4, dtype=np.int32), (2, 4)))
    d[1] = d[1].flip(0)
    g = mp.GLOBAL
    code = np.stack([
        _op(mp.SEL, 0, g + 0, g + 1, 0 | 1 << 8)[None],  # planes[d0]
        _op(mp.SEL, 2, 0, g + 3, 1)[None],               # slot 0 or plane 3
    ])
    prog = mp.Program(code, np.array([mp.SEL, mp.SEL], np.int32),
                      np.array([0, 2], np.int32), 1, 4)
    mp.check(prog)
    out0, out1 = mp.execute(prog, planes, d)
    stack = torch.stack(planes)
    want0 = stack[d[0].long(), :, torch.arange(16)].T
    assert torch.equal(out0, want0)
    assert torch.equal(out1, torch.where(d[1] == 0, want0, planes[3]))


@pytest.mark.parametrize("k", [2, 3, 8, 12])
def test_lin_gives_the_g1_small_multiples(k):
    gen = np.random.default_rng(k)
    a = torch.from_numpy(gen.integers(0, tfp.LMAX + 1, (32, 64),
                                      dtype=np.int32))
    a[:, :4] = tfp.LMAX
    assert torch.equal(mp.lin_plain(a, a, k, 0, 2, 0), cuda_g2._msmall(a, k))


def test_miller_program_unchanged():
    """K13's program is the same bits as before the scheduler learnt Fp
    values and SEL (the Miller graph has neither)."""
    want = {(8, 52, 40): "4a793a2a040efd5d", (4, 52, 60): "c8bd8b4741ce1ad4",
            (16, 110, 100): "15964024137d3396"}
    for cfg, digest in want.items():
        prog = mp.miller_program(*cfg)
        assert hashlib.sha256(prog.code.tobytes()).hexdigest()[:16] == digest
        assert prog.out.shape == (12,)
        assert (prog.out[1::2] == prog.out[0::2] + 1).all()


# ---------------------------------------------------------------------------
# the fold
# ---------------------------------------------------------------------------

FOLD_ROWS = 16


def _fold_rows():
    gen = np.random.default_rng(20261019)
    f = gen.integers(0, tfp.LMAX + 1, (12, 32, FOLD_ROWS), dtype=np.int32)
    f[..., 3] = tfp.LMAX
    drop = np.zeros(FOLD_ROWS, bool)
    drop[[1, 6, 7, 15]] = True
    return torch.from_numpy(f), torch.from_numpy(drop)


def test_fold_with_drop_flags_equals_mask_then_fold():
    f, drop = _fold_rows()
    got = cp.fold_product(f, drop)
    assert tuple(got.shape) == (12, 32, 1)
    assert torch.equal(got, cp.fold_product_plain(cp.mask_rows(f, drop)))
    assert torch.equal(got, cp.fold_product(cp.mask_rows(f, drop)))
    assert torch.equal(cp.fold_product(f), cp.fold_product_plain(f))
    one = cp.fold_product(f[..., :1], torch.tensor([True]))
    assert (one.numpy()[..., 0] == cp._F12_ONE).all()


def test_fold_equals_the_jax_tower_product():
    """By value: the JAX tower multiplies in another order."""
    f, drop = _fold_rows()
    got = cp.fold_product(f, drop)
    masked = cp.mask_rows(f, drop).numpy()
    g = jnp.asarray(convert.f12_to_jax(masked, tiled=False))
    k = g.shape[0]
    while k > 1:
        k //= 2
        g = jax.jit(jtower.f12_mul)(g[:k], g[k:2 * k])
    want = np.asarray(jax.jit(jfp.canon_std)(g.reshape(-1, 32)))
    np.testing.assert_array_equal(tfp.canon_std(got).numpy()[:, :, 0], want)


# ---------------------------------------------------------------------------
# the verify path
# ---------------------------------------------------------------------------

MSG = b"charon-tpu-torch K14/K15: slot 11"
SKS = (0x5151, 0x626262626, 0x73737)
PKS = [rc.g1_to_bytes(bls.sk_to_pk(sk)) for sk in SKS]


def test_verify_tile_launches_k14_and_k15_once(monkeypatch):
    calls = {"fold": 0, "scale": 0, "f12mul": 0}
    in_recheck = []
    fold, scale, f12mul = cp.fold_product, cp.g1_scalar_mul_rows, \
        cp.pp_f12mul
    recheck = backend_cuda.CUDABackend._recheck

    def counted(key, fn):
        def wrapper(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapper

    def k5(*args):
        if not in_recheck:
            raise AssertionError("pp_f12mul called outside the re-check")
        calls["f12mul"] += 1
        return f12mul(*args)

    def k6(*_):
        raise AssertionError("the K6 window wrapper was called")

    def recheck_flagged(self, *args):
        in_recheck.append(True)
        try:
            return recheck(self, *args)
        finally:
            in_recheck.pop()

    monkeypatch.setattr(cp, "fold_product", counted("fold", fold))
    monkeypatch.setattr(cp, "g1_scalar_mul_rows", counted("scale", scale))
    monkeypatch.setattr(cp, "pp_f12mul", k5)
    monkeypatch.setattr(cp, "g1_dblsel", k6)
    monkeypatch.setattr(backend_cuda.CUDABackend, "_recheck",
                        recheck_flagged)
    be = backend_cuda.CUDABackend(device="cpu")
    entries = [(PKS[0], MSG, rc.g2_to_bytes(bls.sign(SKS[0], MSG))),
               (PKS[1], MSG, rc.g2_to_bytes(bls.sign(SKS[2], MSG)))]
    got = be.verify_device_exec(be.verify_host_prep(entries))
    assert got == [True, False]
    # one tile: one fold and one scaling; the failed batch equation sent
    # it to the re-check, whose one product of halves is F12MUL's
    assert calls == {"fold": 1, "scale": 1, "f12mul": 1}
    assert "recheck_s" in be.last_stages


def test_verify_tile_takes_the_p_side_from_k15_and_the_verdict_from_k11(
        monkeypatch):
    """One tile with a bad entry: K15 runs with −Y (no separate negation
    of the scaled rows), K11 once with its verdict for the batch and once
    over the entries in the re-check; `g1_proj_rows` — the unscaled
    p-side's one negation — only inside the re-check; the batch-check's
    verdicts equal the oracle's."""
    calls = {"scale": [], "verdict": [], "proj": 0}
    in_recheck, in_scale = [], []
    scale, verdict, proj = (cp.g1_scalar_mul_rows,
                            cfe.final_exp_is_one, cp.g1_proj_rows)
    recheck = backend_cuda.CUDABackend._recheck

    def scale_spy(*args, **kw):
        calls["scale"].append(kw.get("neg_y", False))
        in_scale.append(True)      # the CPU route's plain −Y
        try:
            return scale(*args, **kw)
        finally:
            in_scale.pop()

    def verdict_spy(f):
        calls["verdict"].append(f.shape[-1])
        return verdict(f)

    def proj_spy(pts):
        if not in_scale:
            if not in_recheck:
                raise AssertionError("g1_proj_rows called outside the "
                                     "re-check")
            calls["proj"] += 1
        return proj(pts)

    def recheck_flagged(self, *args):
        in_recheck.append(True)
        try:
            return recheck(self, *args)
        finally:
            in_recheck.pop()

    monkeypatch.setattr(cp, "g1_scalar_mul_rows", scale_spy)
    monkeypatch.setattr(cfe, "final_exp_is_one", verdict_spy)
    monkeypatch.setattr(cp, "g1_proj_rows", proj_spy)
    monkeypatch.setattr(backend_cuda.CUDABackend, "_recheck",
                        recheck_flagged)
    be = backend_cuda.CUDABackend(device="cpu")
    entries = [(PKS[0], MSG, rc.g2_to_bytes(bls.sign(SKS[0], MSG))),
               (PKS[1], MSG, rc.g2_to_bytes(bls.sign(SKS[1], MSG))),
               (PKS[2], MSG, rc.g2_to_bytes(bls.sign(SKS[0], MSG)))]
    got = be.verify_device_exec(be.verify_host_prep(entries))
    assert got == [True, True, False]
    assert calls == {"scale": [True], "verdict": [1, 4], "proj": 1}
