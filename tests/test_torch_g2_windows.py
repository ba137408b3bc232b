"""Kernels K16 (the combine's Straus loop in one launch, csrc/straus.cu)
and K17 (each [|x|]-multiply of hash-to-G2 in one launch,
csrc/g2_zmul.cu): their CPU side.

- K16's HEAD and TAIL programs (ops/miller_program.py `straus_programs`),
  looped over windows and shares as the kernel loops them
  (`straus_run_plain`), against the iterated plain Straus steps
  (`cuda_g2.straus_msm_plain`) bit for bit at T = 3 shares × 64 rows and
  4 windows with 2, 4 and 8 lanes: every digit −4..3, ∞ rows, a window
  whose digit is 0 on every row, digit rows uniform per share (the
  combine's case).  (The same programs against the JAX package's
  `pallas_g2.straus_combine` are in test_torch_straus.py, beside the
  plain loop's comparison, on its one JAX run.)
- K17's program (`zmul_program`, run by `zmul_run_plain`) against
  `cuda_h2c.zmul_plain`, and that against JAX's `pallas_h2c._zmul` in
  DIRECT mode, at 128 rows of mapped points with ∞ rows.
- `check` on both at each lane count swept; K15's programs pinned by hash
  (K13's are in test_torch_rlc_fold.py); LIN's negation against `_negf`.
- A combine through `CUDABackend(device="cpu")` calls `straus_msm` once
  and the K3 step never; `hash_to_g2_rows` calls `zmul` twice and the
  K10 window never.
"""

import hashlib

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
from charon_tpu_torch import convert
from charon_tpu_torch.ops import cuda_g2, cuda_h2c, curve as tcurve
from charon_tpu_torch.ops import fp as tfp
from charon_tpu_torch.ops import miller_program as mp
from charon_tpu_torch.tbls import backend_cuda
from charon_tpu_torch.tbls.ref import curve as rc
from charon_tpu_torch.tbls.ref.hash_to_curve import hash_to_g2

from test_torch_g2 import _fc, _port, _rows

#: the lane counts the smoke run sweeps, with their slots and look-ahead
STRAUS_CFGS = [(2, 26, 40), (mp.ST_LANES, mp.ST_SLOTS, mp.ST_WINDOW),
               (8, 36, 40)]
ZMUL_CFGS = [(2, 30, 40), (mp.ZM_LANES, mp.ZM_SLOTS, mp.ZM_WINDOW),
             (8, 38, 20)]


@pytest.fixture(autouse=True)
def direct_mode():
    pallas_g2.DIRECT = True
    yield
    pallas_g2.DIRECT = False


# ---------------------------------------------------------------------------
# K16
# ---------------------------------------------------------------------------

T, N, NWIN = 3, 64, 4


@pytest.fixture(scope="module")
def straus_case():
    """(tables, digits, the iterated plain steps' result) at T × N rows:
    points of random limbs, all-LMAX rows and ∞ rows; window 0 holds every
    digit −4..3, window 1 only zeros, window 2 one digit per share (3, 0,
    −4: the combine's uniform rows), window 3 random digits with one warp's
    rows of share 1 zero."""
    gen = np.random.default_rng(20261021)
    pts = torch.from_numpy(gen.integers(0, tfp.LMAX + 1, (6, 32, T * N),
                                        dtype=np.int32))
    pts[..., 5:9] = cuda_g2.inf_planes(4, "cpu")
    pts[..., N + 3] = cuda_g2.inf_planes(1, "cpu")[..., 0]
    pts[..., 2 * N + 7] = tfp.LMAX
    tables = cuda_g2.straus_tables(pts)
    d = gen.integers(-4, 4, (NWIN, T * N), dtype=np.int32)
    d[0, :8] = np.arange(-4, 4)
    d[1] = 0
    d[2] = np.repeat(np.array([3, 0, -4], np.int32), N)
    d[3, N:N + 8] = 0
    d = torch.from_numpy(d)
    return tables, d, cuda_g2.straus_msm_plain(tables, d, T)


@pytest.mark.parametrize("cfg", STRAUS_CFGS)
def test_straus_programs_run_the_loop(straus_case, cfg):
    tables, d, want = straus_case
    head, tail = mp.straus_programs(*cfg)
    got = mp.straus_run_plain(head, tail, tables, d, T)
    assert tuple(got.shape) == (6, 32, N)
    assert torch.equal(got, want)


def test_straus_msm_cpu_route_is_the_plain_loop(straus_case):
    tables, d, want = straus_case
    assert torch.equal(cuda_g2.straus_msm(tables, d, T), want)


@pytest.mark.parametrize("cfg", STRAUS_CFGS)
def test_straus_program_invariants(cfg):
    head, tail = mp.straus_programs(*cfg)
    for prog in (head, tail):
        mp.check(prog)
        assert prog.code.shape == (prog.steps, cfg[0], 2)
        assert prog.preset == tuple(range(6))
        assert prog.out.shape == (6,)
        assert (prog.out[1::2] == prog.out[0::2] + 1).all()
    kinds = [op.kind for op in mp.straus_head_dag()[0].ops]
    # three doublings: 2 squares and 6 products each
    assert (kinds.count(mp.SQR2), kinds.count(mp.MUL2)) == (6, 18)
    assert mp.SEL not in kinds
    kinds = [op.kind for op in mp.straus_tail_dag()[0].ops]
    # one addition (12 products), the table point's 6 planes, y's sign
    # and the kept accumulator: 14 SELs
    assert (kinds.count(mp.MUL2), kinds.count(mp.SEL)) == (12, 14)
    kind, _, _, b, win, *_, stride = mp._fields(tail.code)
    sel = kind == mp.SEL
    assert set(stride[sel].tolist()) == {0, mp.ST_STRIDE}
    assert (b[sel & (stride > 0)] >= mp.GLOBAL).all()
    assert set(win[sel].tolist()) == {mp.ST_ABS, mp.ST_NEG, mp.ST_NZ}


def test_check_refuses_an_output_in_the_preset_slots():
    head, _ = mp.straus_programs()
    bad = mp.Program(head.code, head.kinds, head.out.copy(), head.lanes,
                     head.slots, head.preset)
    bad.out[0] = 1
    with pytest.raises(AssertionError, match="preset"):
        mp.check(bad)


@pytest.mark.parametrize("pattern", ["random", "lmax"])
def test_lin_negation_gives_negf(pattern):
    gen = np.random.default_rng(3)
    a = torch.from_numpy(gen.integers(0, tfp.LMAX + 1, (32, 64),
                                      dtype=np.int32))
    if pattern == "lmax":
        a[:] = tfp.LMAX
    assert torch.equal(mp.lin_plain(a, a, 0, -1, 1, 1), cuda_g2._negf(a))


def test_g1_program_unchanged():
    """K15's program is the same bits as before the scheduler learnt
    pinned slots and the G2 law (the G1 graph has neither)."""
    want = {(4, 20, 40): "f866489ef4a9ae48", (2, 16, 40): "b8e70c84731455e3",
            (8, 20, 40): "4784dd77a2919304"}
    for cfg, digest in want.items():
        prog = mp.g1_program(32, *cfg)
        assert hashlib.sha256(prog.code.tobytes()).hexdigest()[:16] == digest
        assert prog.preset == ()


# ---------------------------------------------------------------------------
# K17
# ---------------------------------------------------------------------------

ZROWS = 128


@pytest.fixture(scope="module")
def zmul_case():
    """(port points, zmul_plain's result, JAX _zmul's result): 128 rows of
    16 mapped points (SSWU + isogeny, not cleared), ∞ every 9th row."""
    gen = np.random.default_rng(20261022)
    pts = [jsswu.map_to_g2(JFQ2([int(x) for x in gen.integers(1, 2**62, 2)]))
           for _ in range(16)]
    for i in range(0, 16, 9):
        pts[i] = None
    rows = _rows(pts, ZROWS)
    q = _port(rows)
    pallas_g2.DIRECT = True
    try:
        want = np.asarray(pallas_h2c._zmul(
            _fc(), jnp.asarray(convert.points_to_jax(q.numpy()))))
    finally:
        pallas_g2.DIRECT = False
    return q, cuda_h2c.zmul_plain(q), want


def test_zmul_plain_equals_jax(zmul_case):
    q, got, want = zmul_case
    assert tuple(got.shape) == (6, 32, ZROWS)
    np.testing.assert_array_equal(got.numpy(),
                                  convert.points_from_jax(want))
    assert torch.equal(cuda_h2c.zmul(q), got)


@pytest.mark.parametrize("cfg", ZMUL_CFGS)
def test_zmul_program_runs_the_windows(zmul_case, cfg):
    q, want, _ = zmul_case
    prog = mp.zmul_program(*cfg)
    mp.check(prog)
    assert prog.code.shape == (prog.steps, cfg[0], 2) and prog.preset == ()
    got = mp.zmul_run_plain(prog, q[..., :24])
    assert torch.equal(got, want[..., :24])


def test_zmul_dag_counts():
    """65 doublings and 6 additions: the table's one of each, two
    doublings a window, one addition per non-zero window of |x|."""
    kinds = [op.kind for op in mp.zmul_dag()[0].ops]
    assert sum(1 for w in mp.Z_WINDOWS if w) == 5
    assert kinds.count(mp.SQR2) == 65 * 2
    assert kinds.count(mp.MUL2) == 65 * 6 + 6 * 12
    assert mp.SEL not in kinds
    assert mp.Z_WINDOWS == pallas_h2c._Z_WINDOWS


# ---------------------------------------------------------------------------
# the paths
# ---------------------------------------------------------------------------

def _counted(calls: dict, key: str, fn):
    def wrapper(*args, **kw):
        calls[key] += 1
        return fn(*args, **kw)
    return wrapper


def _refuse(what: str):
    def wrapper(*_, **__):
        raise AssertionError(f"the {what} wrapper was called")
    return wrapper


def test_combine_launches_k16_once(monkeypatch):
    calls = {"msm": 0}
    monkeypatch.setattr(backend_cuda, "ROW_TILE", 8)
    monkeypatch.setattr(cuda_g2, "straus_msm",
                        _counted(calls, "msm", cuda_g2.straus_msm))
    monkeypatch.setattr(cuda_g2, "straus_step", _refuse("K3 step"))
    be = backend_cuda.CUDABackend(device="cpu")
    sigs = [rc.g2_to_bytes(rc.multiply(rc.G2_GEN, 5 + k)) for k in range(2)]
    out = be.threshold_combine_bytes([{1: sigs[0], 3: sigs[1]}])
    assert len(out) == 1 and len(out[0]) == 96
    assert calls == {"msm": 1}
    assert "straus_s" in be.last_stages


def test_hash_batch_launches_k17_twice(monkeypatch):
    calls = {"zmul": 0}
    monkeypatch.setattr(cuda_h2c, "zmul",
                        _counted(calls, "zmul", cuda_h2c.zmul))
    monkeypatch.setattr(cuda_g2, "dblsel", _refuse("K10 dblsel"))
    msgs = [b"charon-tpu-torch K17: slot 12", b"charon-tpu-torch K17: slot 13"]
    u = torch.from_numpy(cuda_h2c.pack_messages(msgs))
    got = cuda_h2c.hash_to_g2_rows(u)
    assert calls == {"zmul": 2}
    planes = backend_cuda._affine_planes(cuda_g2.as_points(got)).numpy()
    for k, msg in enumerate(msgs):
        np.testing.assert_array_equal(
            planes[..., k], tcurve.g2_pack([hash_to_g2(msg)])[..., 0])


def test_wrappers_raise_off_the_cpu_route():
    """A tensor that is neither on the CPU nor on a card reaches neither
    the plain version nor a kernel."""
    meta = {"dtype": torch.int32, "device": "meta"}
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_h2c.zmul(torch.empty((6, 32, 16), **meta))
    tables = tuple(torch.empty((6, 32, 32), **meta) for _ in range(4))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_g2.straus_msm(tables, torch.empty((3, 32), **meta), 2)
