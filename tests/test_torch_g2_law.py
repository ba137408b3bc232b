"""Kernel K22 (K2's launch sequences on the G2 law, one launch each,
csrc/g2_law.cu): its CPU side.

- Each of the three programs (ops/miller_program.py `law_program`:
  "tables" P → 2P, 3P, 4P; "pre" the halves' sum R, 2R, ψ(R) and
  ψ²(2R); "post" the clearing's five additions with three negations),
  executed plain (`law_run_plain`), bit for bit against the K2 / K9 plain
  sequence it replaced (`cuda_h2c.law_steps`) with 4, 8 and 16 lanes, and
  against the JAX package's `pallas_g2.dbl` / `add` and the `h2c_psi`
  kernel body (applied once and twice) in DIRECT mode (with
  `pallas_h2c._pt_neg_t` for the negations) at 1,024 rows: real points,
  ∞ rows and all-LMAX limbs.  LIN's copy form, which ψ's conjugation
  uses, copies.
- `check` and the op kinds of every program; the graphs' op counts
  pinned.
- One K22 call for a combine's tables through `CUDABackend(device="cpu")`
  and two for a hash batch, with the K2 wrappers made to raise and no ψ
  call (K22's "pre" took both).  (The
  whole pipeline through K22 against JAX's at pad = 128 is in
  test_torch_h2c_pipeline.py, on its one JAX run.)
"""

from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.ops import pallas_g2, pallas_h2c
from charon_tpu_torch import convert
from charon_tpu_torch.ops import cuda_g2, cuda_h2c, curve as tcurve
from charon_tpu_torch.ops import fp as tfp
from charon_tpu_torch.ops import miller_program as mp
from charon_tpu_torch.tbls import backend_cuda, shamir
from charon_tpu_torch.tbls.ref import curve as rc
from charon_tpu_torch.tbls.ref.fields import R
from charon_tpu_torch.tbls.ref.hash_to_curve import hash_to_g2

from test_torch_g2 import _fc, _jax_tiled, _port, _ref_points, _rows

KINDS = ("tables", "pre", "post")
#: lane counts the smoke run sweeps (the default: 8), with their slots
#: and look-ahead
CFGS = [(4, 30, 40), "default", (16, 40, 40)]
N = 1024     # S = 8: JAX's DIRECT kernels take multiples of 1,024 rows


@pytest.fixture(autouse=True)
def direct_mode():
    pallas_g2.DIRECT = True
    yield
    pallas_g2.DIRECT = False


def _block(kind: str, seed: int) -> list[np.ndarray]:
    """The input block's point sets as JAX limb-last rows [N, 3, 2, 32]:
    real points cycling through 16 (∞ among them), all-LMAX rows 5..8 and
    random limbs in rows 9..16."""
    gen = np.random.default_rng(seed)
    pts = []
    for k in range(mp.LAWS[kind][1] // 6):
        p = _rows(_ref_points(16, seed + k), N).copy()
        p[5:9] = tfp.LMAX
        p[9:17] = gen.integers(0, tfp.LMAX + 1, (8, 3, 2, 32))
        pts.append(p)
    return pts


def _block_planes(pts) -> torch.Tensor:
    """The points' planes, one point set after another."""
    return torch.cat([_port(p) for p in pts])


def _prog(kind, cfg):
    return mp.law_program(kind, None if cfg == "default" else cfg)


@pytest.fixture(scope="module")
def blocks():
    return {kind: _block(kind, 3 + 10 * i) for i, kind in enumerate(KINDS)}


@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("kind", KINDS)
def test_program_equals_the_k2_sequence(blocks, kind, cfg):
    blk = _block_planes(blocks[kind])
    got = mp.law_run_plain(_prog(kind, cfg), blk)
    assert tuple(got.shape) == (mp.LAWS[kind][2], 32, N)
    assert torch.equal(got, cuda_h2c.law_steps(kind, blk))


def _jax_law(kind: str, pts):
    """The same sequence on JAX's DIRECT kernels → [planes, 32, N]."""
    fc = _fc()
    t = [_jax_tiled(p) for p in pts]
    if kind == "tables":
        p2 = pallas_g2.dbl(fc, t[0])
        outs = [p2, pallas_g2.add(fc, p2, t[0]), pallas_g2.dbl(fc, p2)]
    elif kind == "pre":
        hc = jnp.asarray(pallas_h2c.h2c_consts())

        def psi(q):
            return pallas_h2c._run("h2c_psi", fc, hc, q)

        r = pallas_g2.add(fc, t[0], t[1])
        d = pallas_g2.dbl(fc, r)
        outs = [r, d, psi(r), psi(psi(d))]
    else:
        t1, t0, p, xpsip, psip, psi2p2 = t

        def neg(q):
            return pallas_h2c._pt_neg_t(fc, q)

        part1 = pallas_g2.add(fc, pallas_g2.add(fc, t1, t0), neg(p))
        part2 = pallas_g2.add(fc, neg(xpsip), neg(psip))
        outs = [pallas_g2.add(fc, pallas_g2.add(fc, part1, part2), psi2p2)]
    return torch.cat([torch.from_numpy(convert.points_from_jax(
        np.asarray(o)).copy()) for o in outs])


@pytest.mark.parametrize("kind", KINDS)
def test_program_equals_jax(blocks, kind):
    got = mp.law_run_plain(mp.law_program(kind), _block_planes(blocks[kind]))
    assert torch.equal(got, _jax_law(kind, blocks[kind]))


@pytest.mark.parametrize("kind", KINDS)
def test_wrapper_cpu_route_is_the_plain_program(blocks, kind):
    blk = _block_planes(blocks[kind])
    cuda_g2.reset_launches()
    want = cuda_h2c.law_steps(kind, blk)
    assert torch.equal(cuda_g2.g2_law(kind, blk), want)
    assert torch.equal(cuda_g2.g2_law(kind, blk, (4, 30, 40)), want)
    assert cuda_g2.LAUNCHES["g2_law"] == 0
    with pytest.raises(ValueError):
        cuda_g2.g2_law(kind, blk[:-1])


@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("kind", KINDS)
def test_program_invariants(kind, cfg):
    prog = _prog(kind, cfg)
    mp.check(prog)
    assert set(prog.kinds.tolist()) <= {mp.MUL2, mp.SQR2, mp.LIN}
    assert len(prog.out) == mp.LAWS[kind][2]


#: (f2_mul, f2_sqr, lin) ops of each graph: a doubling is 6 / 2 / 16, an
#: addition 12 / 0 / 44, a point negation 0 / 0 / 2, ψ 2 / 0 / 6 (three
#: conjugations, each a copy and a negation)
OP_COUNTS = {"tables": (24, 4, 76), "pre": (24, 2, 78),
             "post": (60, 0, 226)}


@pytest.mark.parametrize("kind", KINDS)
def test_graph_op_counts(kind):
    g, outs = mp.LAWS[kind][0]()
    c = Counter(op.kind for op in g.ops)
    assert (c[mp.MUL2], c[mp.SQR2], c[mp.LIN]) == OP_COUNTS[kind]
    assert set(c) == {mp.MUL2, mp.SQR2, mp.LIN} - ({mp.SQR2} if kind ==
                                                   "post" else set())
    dbl, add = mp.Dag(), mp.Dag()
    dbl.g2_double(tuple(dbl.input(2 * c) for c in range(3)))
    add.g2_add(tuple(add.input(2 * c) for c in range(3)),
               tuple(add.input(6 + 2 * c) for c in range(3)))
    steps = {"tables": (2, 1, 0, 0), "pre": (1, 1, 0, 3),
             "post": (0, 5, 3, 0)}
    nd, na, nneg, npsi = steps[kind]
    assert len(g.ops) == (nd * len(dbl.ops) + na * len(add.ops) + 2 * nneg
                          + 8 * npsi)


def _counted(calls: dict, key: str, fn):
    def wrapper(*args, **kw):
        calls[key].append(args[0])
        return fn(*args, **kw)
    return wrapper


def _refuse(what: str):
    def wrapper(*_, **__):
        raise AssertionError(f"the {what} wrapper was called")
    return wrapper


def test_combine_launches_k22_once_for_its_tables(monkeypatch):
    calls = {"law": []}
    monkeypatch.setattr(backend_cuda, "ROW_TILE", 8)
    monkeypatch.setattr(cuda_g2, "g2_law",
                        _counted(calls, "law", cuda_g2.g2_law))
    monkeypatch.setattr(cuda_g2, "dbl", _refuse("K2 dbl"))
    monkeypatch.setattr(cuda_g2, "add", _refuse("K2 add"))
    be = backend_cuda.CUDABackend(device="cpu")
    sigs = [rc.g2_to_bytes(rc.multiply(rc.G2_GEN, 5 + k)) for k in range(2)]
    out = be.threshold_combine_bytes([{1: sigs[0], 3: sigs[1]}])
    assert calls == {"law": ["tables"]}
    assert "tables_s" in be.last_stages
    lam = shamir.lagrange_coeffs_at_zero([1, 3])
    want = rc.multiply(rc.G2_GEN, (lam[1] * 5 + lam[3] * 6) % R)
    assert out == [rc.g2_to_bytes(want)]


def test_lin_copy_form_copies():
    """LIN with iters 0 (ψ's conjugation keeps c0's limbs) copies a
    unreduced; K22's "pre" is the only program that uses it."""
    a = torch.full((32, 4), tfp.LMAX, dtype=torch.int32)
    assert torch.equal(mp.lin_plain(a, a, *mp._COPY), a)
    for kind in KINDS:
        *_, iters, _, _ = mp._fields(mp.law_program(kind).code)
        kinds = mp._fields(mp.law_program(kind).code)[0]
        copies = int(((kinds == mp.LIN) & (iters == 0)).sum())
        assert copies == (9 if kind == "pre" else 0), kind


def test_hash_batch_launches_k22_twice_and_no_k2(monkeypatch):
    calls = {"law": [], "psi": []}
    monkeypatch.setattr(cuda_g2, "g2_law",
                        _counted(calls, "law", cuda_g2.g2_law))
    monkeypatch.setattr(cuda_h2c, "h2c_psi",
                        _counted(calls, "psi", cuda_h2c.h2c_psi))
    monkeypatch.setattr(cuda_g2, "dbl", _refuse("K2 dbl"))
    monkeypatch.setattr(cuda_g2, "add", _refuse("K2 add"))
    msgs = [b"charon-tpu-torch K22: slot 21", b"charon-tpu-torch K22: slot 22"]
    u = torch.from_numpy(cuda_h2c.pack_messages(msgs))
    got = cuda_h2c.hash_to_g2_rows(u)
    assert calls["law"] == ["pre", "post"] and len(calls["psi"]) == 0
    planes = backend_cuda._affine_planes(cuda_g2.as_points(got)).numpy()
    for k, msg in enumerate(msgs):
        np.testing.assert_array_equal(
            planes[..., k], tcurve.g2_pack([hash_to_g2(msg)])[..., 0])


def test_wrapper_raises_off_the_cpu_route():
    meta = torch.empty((6, 32, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_g2.g2_law("tables", meta)
