"""The device code of kernels K11 and K12 run on the CPU: csrc/
fp_lanes.cuh's lane-split field library and the two kernels' own
sources, compiled by g++ against tests/cuda_shim/cuda_runtime.h (a
block's threads as std::threads, each shuffle an exchange over a barrier
of its group's lanes).

- Each lane-split operation (the Fp product, sum, difference, negation
  and small multiple, the Fp2 product, square, ×ξ and ×3b, the G2
  doubling and addition) at 4, 8 and 16 lanes a row against its one-thread
  body in csrc/fp381.cuh, bit for bit, on random and all-LMAX rows.
- csrc/decompress.cu at 8 lanes a row against `cuda_codec.
  g2_decompress_plain` bit for bit (a valid row, ∞, x off the curve and
  an x whose root has α = −1), and csrc/final_exp.cu against
  `cuda_final_exp.final_exp_plain` with its verdict on a random row.

The shim's barriers make these tests slow where the CPU is shared: each
runs one block (≈ 10–30 s alone on 8 cores).
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "charon_tpu_torch" / "csrc"
SHIM = ROOT / "tests" / "cuda_shim"
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from charon_tpu_torch.ops import cuda_codec as cc  # noqa: E402
from charon_tpu_torch.ops import cuda_final_exp as cfe  # noqa: E402
from charon_tpu_torch.ops import fp  # noqa: E402
from charon_tpu_torch.ops import pairing as tpair  # noqa: E402
from charon_tpu_torch.tbls.ref import curve as rc  # noqa: E402
from charon_tpu_torch.tbls.ref.fields import FQ2  # noqa: E402

NL = 32
#: the lane-split operations `_LANE_MAIN` runs, in its output order
OPS = ("mul", "add", "sub", "neg", "mul_small", "f2_mul", "f2_sqr",
       "f2_mul_xi", "f2_mul_b3", "g2_double", "g2_add")

_LANE_MAIN = r"""
#include "cuda_runtime.h"
#include "fp_lanes.cuh"
using namespace fp381;

// rows of 6 Fp2 values (a G2 point p, then a second q); out: per row, per
// op, the op's 6 Fp2 outputs (a result fills from the front, 0 after it)
template <int G>
static void lanes(const int* in, int* out, int n) {
  using A = fpl::F<G>;
  const int rows = 32 / G;
  run_grid((n + rows - 1) / rows, 32, [&] {
    __shared__ fpl::Consts k;
    fpl::load_consts(k, threadIdx.x, 32);
    __syncwarp();
    fpl::Lane<G> l(threadIdx.x, &k);
    const int r = blockIdx.x * rows + threadIdx.x / G;
    if (r >= n) return;
    const int* row = in + (size_t)r * 12 * NL;
    typename A::P2 p, q, o;
    typename A::E2* pv[3] = {&p.x, &p.y, &p.z};
    typename A::E2* qv[3] = {&q.x, &q.y, &q.z};
    for (int i = 0; i < 3; ++i) {
      A::ld2(l, *pv[i], row + 2 * i * NL);
      A::ld2(l, *qv[i], row + (6 + 2 * i) * NL);
    }
    int* res = out + (size_t)r * 11 * 6 * 2 * NL;
    auto put = [&](int op, int slot, const typename A::E2& v) {
      A::st2(l, res + ((size_t)op * 6 + slot) * 2 * NL, v);
    };
    typename A::E2 t;
    A::mul(l, t.c0, p.x.c0, q.x.c0); A::mul(l, t.c1, p.x.c1, p.y.c0); put(0, 0, t);
    A::add(l, t.c0, p.x.c0, q.x.c0); A::add(l, t.c1, p.x.c1, p.y.c0); put(1, 0, t);
    A::sub(l, t.c0, p.x.c0, q.x.c0); A::sub(l, t.c1, p.x.c1, p.y.c0); put(2, 0, t);
    A::neg(l, t.c0, p.x.c0); A::neg(l, t.c1, q.y.c1); put(3, 0, t);
    A::mul_small(l, t.c0, p.x.c0, 12); A::mul_small(l, t.c1, q.z.c1, 16); put(4, 0, t);
    A::f2_mul(l, t, p.x, q.y); put(5, 0, t);
    A::f2_sqr(l, t, p.z); put(6, 0, t);
    A::f2_mul_xi(l, t, q.x); put(7, 0, t);
    A::f2_mul_b3(l, t, p.y); put(8, 0, t);
    A::g2_double(l, o, p); put(9, 0, o.x); put(9, 1, o.y); put(9, 2, o.z);
    A::g2_add(l, o, p, q); put(10, 0, o.x); put(10, 1, o.y); put(10, 2, o.z);
  });
}

// the same on csrc/fp381.cuh's one-thread bodies
static void one_thread(const int* in, int* out, int n) {
  for (int r = 0; r < n; ++r) {
    const int* row = in + (size_t)r * 12 * NL;
    G2 p, q, o;
    F2* pv[3] = {&p.x, &p.y, &p.z};
    F2* qv[3] = {&q.x, &q.y, &q.z};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < NL; ++j) {
        pv[i]->c0[j] = row[2 * i * NL + j];
        pv[i]->c1[j] = row[(2 * i + 1) * NL + j];
        qv[i]->c0[j] = row[(6 + 2 * i) * NL + j];
        qv[i]->c1[j] = row[(7 + 2 * i) * NL + j];
      }
    int* res = out + (size_t)r * 11 * 6 * 2 * NL;
    auto put = [&](int op, int slot, const F2& v) {
      for (int j = 0; j < NL; ++j) {
        res[((size_t)op * 6 + slot) * 2 * NL + j] = v.c0[j];
        res[((size_t)op * 6 + slot) * 2 * NL + NL + j] = v.c1[j];
      }
    };
    F2 t;
    mul(t.c0, p.x.c0, q.x.c0); mul(t.c1, p.x.c1, p.y.c0); put(0, 0, t);
    add(t.c0, p.x.c0, q.x.c0); add(t.c1, p.x.c1, p.y.c0); put(1, 0, t);
    sub(t.c0, p.x.c0, q.x.c0); sub(t.c1, p.x.c1, p.y.c0); put(2, 0, t);
    neg(t.c0, p.x.c0); neg(t.c1, q.y.c1); put(3, 0, t);
    mul_small(t.c0, p.x.c0, 12); mul_small(t.c1, q.z.c1, 16); put(4, 0, t);
    f2_mul(t, p.x, q.y); put(5, 0, t);
    f2_sqr(t, p.z); put(6, 0, t);
    f2_mul_xi(t, q.x); put(7, 0, t);
    f2_mul_b3(t, p.y); put(8, 0, t);
    g2_double(o, p); put(9, 0, o.x); put(9, 1, o.y); put(9, 2, o.z);
    g2_add(o, p, q); put(10, 0, o.x); put(10, 1, o.y); put(10, 2, o.z);
  }
}

extern "C" void run_lanes(int g, const int* in, int* out, int n) {
  if (g == 4) lanes<4>(in, out, n);
  if (g == 8) lanes<8>(in, out, n);
  if (g == 16) lanes<16>(in, out, n);
  if (g == 1) one_thread(in, out, n);
}
"""

_K12_MAIN = r"""
#include "decompress_cut.cc"
extern "C" void run_k12(int g, int* out, unsigned char* ok, const int* a,
                        const int* b, const unsigned char* sg,
                        const unsigned char* in, int n) {
  const int rows = 32 / g, grid = (n + rows - 1) / rows;
  if (g == 8)
    run_grid(grid, 32, [&] { g2_decompress_kernel<8>(out, ok, a, b, sg, in, n); });
}
"""

_K11_MAIN = r"""
#include "final_exp_cut.cc"
extern "C" void run_k11(int* out, const int* in, unsigned char* verdict,
                        int n) {
  run_grid(n, THREADS, [&] { final_exp_kernel<8>(out, verdict, in, n); });
}
"""


def _cut(src: str) -> str:
    """A kernel source up to its launchers (nvcc's <<<…>>>), without the
    attribute query's header."""
    text = (CSRC / src).read_text()
    text = text[:text.index('extern "C"')]
    return '#include "cuda_runtime.h"\n' + text.replace(
        '#include "attrs.cuh"\n', "")


def _build(tmp: Path, name: str, main: str, cut: tuple = ()) -> ctypes.CDLL:
    for src in cut:
        (tmp / f"{Path(src).stem}_cut.cc").write_text(_cut(src))
    (tmp / f"{name}.cc").write_text(main)
    lib = tmp / f"lib{name}.so"
    res = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-w", "-I",
         str(SHIM), "-I", str(CSRC), "-I", str(tmp), "-o", str(lib),
         str(tmp / f"{name}.cc"), "-lpthread"],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def gxx():
    assert shutil.which("g++"), "g++ runs the device code on the CPU"


def test_lane_ops_equal_the_one_thread_bodies(gxx, tmp_path):
    lib = _build(tmp_path, "lanes", _LANE_MAIN)
    lib.run_lanes.argtypes = [ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_int]
    rng = np.random.default_rng(2021)
    n = 4
    x = rng.integers(0, fp.LMAX + 1, (n, 12, NL), dtype=np.int32)
    x[0] = fp.LMAX
    x[1, :, 1::2] = 0
    x = np.ascontiguousarray(x)
    outs = {}
    for g in (1, 4, 8, 16):
        out = np.zeros((n, len(OPS), 6, 2 * NL), dtype=np.int32)
        lib.run_lanes(g, x.ctypes.data, out.ctypes.data, n)
        outs[g] = out
    assert outs[1].any() and outs[1].max() <= fp.LMAX
    for g in (4, 8, 16):
        for k, op in enumerate(OPS):
            np.testing.assert_array_equal(outs[g][:, k], outs[1][:, k],
                                          err_msg=f"{op} at {g} lanes")


def _k12_rows():
    rows = [rc.g2_to_bytes(rc.multiply(rc.G2_GEN, 77)),
            rc.g2_to_bytes(None)]
    x = 1
    while (FQ2([x, 0]) ** 3 + rc.B2).sqrt() is not None:
        x += 1
    rows.append(bytes([0xa0]) + bytes(47) + x.to_bytes(48, "big"))
    rows += cs.alpha_m1_rows(1)
    from charon_tpu_torch.ops import codec

    xc0, xc1, sign, inf, bad = codec.g2_bytes_split(
        np.stack([np.frombuffer(b, np.uint8) for b in rows]))
    assert not bad.any()
    return (torch.from_numpy(np.ascontiguousarray(xc0.T)),
            torch.from_numpy(np.ascontiguousarray(xc1.T)),
            torch.from_numpy(sign), torch.from_numpy(inf))


def test_k12_source_equals_its_plain_version(gxx, tmp_path):
    lib = _build(tmp_path, "k12", _K12_MAIN, ("decompress.cu",))
    lib.run_k12.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [
        ctypes.c_int]
    args = _k12_rows()
    want_pts, want_ok = cc.g2_decompress_plain(*args)
    assert want_ok.tolist() == [True, True, False, False]
    # the four rows in one block of 8 lanes a row (16 lanes a row run the
    # same template: its operations at 16 lanes are the test above's)
    n = args[0].shape[-1]
    pts = torch.zeros((3, 2, NL, n), dtype=torch.int32)
    ok = torch.zeros(n, dtype=torch.bool)
    lib.run_k12(8, pts.data_ptr(), ok.data_ptr(),
                *[a.data_ptr() for a in args], n)
    assert torch.equal(pts, want_pts)
    assert torch.equal(ok, want_ok)


def test_k11_source_equals_its_plain_version(gxx, tmp_path):
    lib = _build(tmp_path, "k11", _K11_MAIN, ("final_exp.cu",))
    lib.run_k11.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    # a random row: the Fp element row of fe_rows is dropped (one block a
    # row; its verdict, one, is the plain tests' and the card's)
    f = cs.fe_rows("cpu", np.random.default_rng(2022), 2)[..., 1:].contiguous()
    want = cfe.final_exp_plain(f)
    out = torch.zeros_like(f)
    verdict = torch.ones(1, dtype=torch.bool)
    lib.run_k11(out.data_ptr(), f.data_ptr(), verdict.data_ptr(), 1)
    assert torch.equal(out, want)
    assert verdict.tolist() == tpair.is_one(want).tolist() == [False]
