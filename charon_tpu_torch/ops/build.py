"""Build the port's CUDA kernels (csrc/*.cu) and load them with ctypes.

Each ``.cu`` source is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` (Hopper); the objects are linked into one shared
library with a plain C interface.  The library lives under
``build/charon_tpu_torch/<hash>/`` at the repository root (listed in
.gitignore), keyed by a hash of the sources and flags, so a changed kernel rebuilds and an
unchanged one loads in milliseconds.  Nothing here runs at import: the
first kernel launch builds and loads.  ``python -m
charon_tpu_torch.ops.build`` builds and prints the compiler's per-kernel
register and spill report.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fp_ops.cu", "g2.cu", "pairing.cu", "h2c.cu", "final_exp.cu",
           "decompress.cu", "miller.cu", "fold.cu", "g1_scalar_mul.cu",
           "straus.cu", "g2_zmul.cu", "f2_chain.cu", "normalize.cu",
           "g1_tables.cu", "g1_decompress.cu", "g2_law.cu", "h2c_map.cu",
           "h2c_sswu.cu")
HEADERS = ("fp381.cuh", "fp381_consts.cuh", "program.cuh", "f12_warp.cuh",
           "fp_inv.cuh")
LIB_NAME = "libcharon_tpu_torch.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

#: filled by `library()`: seconds spent building (0.0 when loaded from an
#: earlier build) and the library's path
INFO: dict = {}


def build_root() -> Path:
    return CSRC.parent.parent / "build" / "charon_tpu_torch"


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH + FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built on the machine with the "
                       "card")


def compile_commands(out_dir: Path) -> list[list[str]]:
    """One nvcc command per source (object files in `out_dir`)."""
    nvcc = nvcc_path()
    return [[nvcc, *ARCH, *FLAGS, "-I", str(CSRC), "-c", str(CSRC / src),
             "-o", str(out_dir / (Path(src).stem + ".o"))]
            for src in SOURCES]


def build() -> Path:
    """Compile and link the library unless this source hash is built;
    returns the library path."""
    final = build_root() / source_hash()
    lib = final / LIB_NAME
    if lib.exists():
        INFO.update(build_seconds=0.0, path=str(lib))
        return lib
    build_root().mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=build_root()))
    try:
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in compile_commands(tmp)]
        logs = []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"$ {' '.join(cmd)}\n{out}")
            if proc.returncode:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   + logs[-1])
        link = [nvcc_path(), *ARCH, "-shared", "-o", str(tmp / LIB_NAME),
                *[str(tmp / (Path(s).stem + ".o")) for s in SOURCES]]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        (tmp / "ptxas.log").write_text("\n".join(logs))
        try:
            os.replace(tmp, final)
        except OSError:      # a concurrent build got there first
            shutil.rmtree(tmp, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    INFO.update(build_seconds=time.perf_counter() - t0, path=str(lib))
    return lib


def _kernel_name(mangled: str) -> str:
    """'_ZN…_pairing_cu_…15f12_step_kernelILi2EE…' → 'pairing.cu
    f12_step_kernel<2>' (the length-prefixed name ending in _kernel)."""
    # the longest source stem in the name: "_decompress_cu_" is also in
    # g1_decompress.cu's names
    stems = [s for s in (Path(x).stem for x in SOURCES)
             if f"_{s}_cu_" in mangled]
    src = f"{max(stems, key=len)}.cu" if stems else "?"
    # the length prefix may follow hash digits: try every suffix of each
    # digit run as the length, and keep the last (innermost) name
    found = f"{src} {mangled}"
    for m in re.finditer(r"\d+", mangled):
        for k in range(m.start(), m.end()):
            name = mangled[m.end():m.end() + int(mangled[k:m.end()])]
            if name.endswith("_kernel") and name[:1].isalpha():
                t = re.match(r"ILi(-?\d+)E", mangled[m.end() + len(name):])
                found = f"{src} {name}" + (f"<{t.group(1)}>" if t else "")
    return found


def ptxas_rows() -> list[dict]:
    """One dict per kernel of the current build — its name, registers,
    stack frame and the largest spill of the kernel or the device
    functions it calls — from the compiler's -Xptxas -v log."""
    log = build_root() / source_hash() / "ptxas.log"
    if not log.exists():
        return []
    rows, cur = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"name": _kernel_name(m.group(1)), "regs": 0, "stack": 0,
                   "spill": 0}
            rows.append(cur)
        elif cur is not None:
            if (m := re.search(r"Used (\d+) registers", line)):
                cur["regs"] = int(m.group(1))
            if (m := re.search(r"(\d+) bytes cumulative stack size", line)):
                cur["stack"] = int(m.group(1))
            if (m := re.search(r"(\d+) bytes spill stores", line)):
                cur["spill"] = max(cur["spill"], int(m.group(1)))
    return rows


def ptxas_report() -> str:
    """One line per kernel of the current build (`ptxas_rows`)."""
    return "\n".join(f"ptxas {r['name']}: {r['regs']} registers, "
                     f"{r['stack']} B stack, {r['spill']} B largest spill"
                     for r in ptxas_rows())


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.charon_fp_op.argtypes = [i, i, p, p, p, i, i, p]
    lib.charon_g2_step.argtypes = [i, p, p, p, i, p]
    lib.charon_straus_step.argtypes = [i, p, p, p, p, p, p, i, p, i, p]
    lib.charon_pp_step.argtypes = [i, p, p, p, i, p]
    lib.charon_f12_step.argtypes = [i, p, p, p, p, i, i, p]
    lib.charon_g1_dblsel.argtypes = [p, p, p, p, p, p, i, p]
    lib.charon_g2_sel.argtypes = [i, p, p, p, p, p, p, i, p]
    lib.charon_f2_chain.argtypes = [i, p, p, p, i, p]
    lib.charon_h2c_sswu.argtypes = [p, p, p, i, p]
    lib.charon_h2c_point.argtypes = [i, p, p, i, p]
    lib.charon_final_exp.argtypes = [p, p, p, i, p]
    lib.charon_g2_decompress.argtypes = [p, p, p, p, p, p, i, p]
    lib.charon_miller_loop.argtypes = [p, p, p, i, p, i, i, i, p]
    lib.charon_miller_thread.argtypes = [p, p, p, i, p]
    lib.charon_f12_fold.argtypes = [p, p, p, p, i, p]
    lib.charon_g1_scalar_mul.argtypes = [p, p, p, i, p, p, i, i, i, p]
    lib.charon_straus_msm.argtypes = [p, p, p, p, p, i, p, p, i, p, i, i, i,
                                      i, i, p]
    lib.charon_g2_zmul.argtypes = [p, p, p, i, p, i, i, i, p]
    lib.charon_f2_chain_program.argtypes = [p, p, p, p, i, p, i, i, i, i,
                                            i, p]
    lib.charon_g2_normalize.argtypes = [p, p, p, i, p]
    lib.charon_g1_tables.argtypes = [p, p, p, i, p, i, i, i, p]
    lib.charon_g1_decompress.argtypes = [p, p, p, p, p, i, p]
    lib.charon_g2_law.argtypes = [i, p, p, p, i, p, i, i, i, p]
    lib.charon_h2c_map_tail.argtypes = [p, p, p, p, p, p, i, p, i, i, i, p]
    lib.charon_h2c_sswu_head.argtypes = [p, p, p, p, p, i, p, i, i, i, p]
    for fn in (lib.charon_fp_op, lib.charon_g2_step, lib.charon_straus_step,
               lib.charon_pp_step, lib.charon_f12_step,
               lib.charon_g1_dblsel, lib.charon_g2_sel, lib.charon_f2_chain,
               lib.charon_h2c_sswu, lib.charon_h2c_point,
               lib.charon_final_exp, lib.charon_g2_decompress,
               lib.charon_miller_loop, lib.charon_miller_thread,
               lib.charon_f12_fold, lib.charon_g1_scalar_mul,
               lib.charon_straus_msm, lib.charon_g2_zmul,
               lib.charon_f2_chain_program, lib.charon_g2_normalize,
               lib.charon_g1_tables, lib.charon_g1_decompress,
               lib.charon_g2_law, lib.charon_h2c_map_tail,
               lib.charon_h2c_sswu_head):
        fn.restype = i


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _LIB = lib
        return _LIB


def _exp_words(e: int) -> list[int]:
    """A fixed exponent as 32-bit words, least significant first."""
    return [(e >> (32 * i)) & 0xFFFFFFFF for i in range(-(-e.bit_length()
                                                           // 32))]


def render_consts_header() -> str:
    """The text of csrc/fp381_consts.cuh, from the Python constant tables
    (the committed header must equal this; a test pins it)."""
    from . import cuda_codec, cuda_final_exp, cuda_g2, cuda_h2c, fp
    from ..tbls.ref.fields import P, R

    def rows(arr) -> str:
        return ",\n".join("    {" + ", ".join(str(int(v)) for v in row) + "}"
                          for row in arr)

    def flat(arr) -> str:
        return ", ".join(str(int(v)) for v in arr)

    def exponent(name: str, e: int, what: str) -> str:
        w = _exp_words(e)
        return (f"// {what}: {e.bit_length()} bits, 32-bit words, least "
                f"significant first\n"
                f"constexpr int {name}_BITS = {e.bit_length()};\n"
                f"static __constant__ unsigned {name}[{len(w)}] = {{\n"
                f"    {', '.join(f'{v}u' for v in w)}}};\n")

    return (
        "// Generated by charon_tpu_torch.ops.build.render_consts_header()\n"
        "// from the tables of ops/fp.py, ops/cuda_g2.py, ops/cuda_h2c.py,\n"
        "// ops/cuda_final_exp.py and ops/cuda_codec.py; a test checks that\n"
        "// this file equals the rendering.  Do not edit by hand.\n"
        "#pragma once\n\n"
        "namespace fp381 {\n\n"
        "// FOLDC[j] = 2^(12·(32+j)) mod p as 32 limbs\n"
        f"static __constant__ int FOLDC[{len(fp.FOLDC)}][32] = {{\n"
        f"{rows(fp.FOLDC)}\n}};\n\n"
        "// 48p in spread form: every low limb >= LMAX\n"
        f"static __constant__ int SPREAD48P[{len(fp.SPREAD48P)}] = "
        f"{{{flat(fp.SPREAD48P)}}};\n\n"
        "// spread multiples of p for the lazy Karatsuba combines\n"
        f"static __constant__ int OFF1[{len(cuda_g2.OFF1)}] = "
        f"{{{flat(cuda_g2.OFF1)}}};\n"
        f"static __constant__ int OFF2[{len(cuda_g2.OFF2)}] = "
        f"{{{flat(cuda_g2.OFF2)}}};\n\n"
        "// hash-to-G2 constants: Fp2 constant i in rows (2i, 2i + 1)\n"
        f"static __constant__ int H2C[{len(cuda_h2c.h2c_consts())}][32] = {{\n"
        f"{rows(cuda_h2c.h2c_consts())}\n}};\n\n"
        "// c·p, c = 0..47, as 34 canonical digits (canon / is_zero)\n"
        f"static __constant__ int PMULT[{len(fp.PMULT)}][34] = {{\n"
        f"{rows(fp.PMULT)}\n}};\n\n"
        "// (p + 1) / 2: sgn(a) = a >= HALF_P1\n"
        f"static __constant__ int HALF_P1[32] = "
        f"{{{flat(fp._HALF_P1[0])}}};\n\n"
        "// Frobenius constants gamma1, gamma2, gammaw (Fp2 i in rows 2i,\n"
        "// 2i+1)\n"
        f"static __constant__ int FE_G[{len(cuda_final_exp.fe_consts())}][32]"
        f" = {{\n{rows(cuda_final_exp.fe_consts())}\n}};\n\n"
        "// decompression constants b', -1, psi's c_x, c_y (Fp2 i in rows\n"
        "// 2i, 2i+1)\n"
        f"static __constant__ int DC[{len(cuda_codec.dc_consts())}][32] = {{\n"
        f"{rows(cuda_codec.dc_consts())}\n}};\n\n"
        + exponent("EXP_PM2", P - 2, "p - 2 (the Fp inverse)")
        + exponent("EXP_P34", cuda_codec.EXP_P34, "(p - 3) / 4")
        + exponent("EXP_P12", cuda_codec.EXP_P12, "(p - 1) / 2")
        + exponent("EXP_P14", cuda_codec.EXP_P14, "(p + 1) / 4 (the Fp root)")
        + exponent("EXP_R", R, "r (the G1 subgroup order)")
        + "\n// |z| and the sign of the BLS parameter z\n"
        f"constexpr unsigned long long ABS_Z = {cuda_codec.ABS_Z}ull;\n"
        f"constexpr int Z_NEG = {int(cuda_codec.Z_NEG)};\n\n"
        "}  // namespace fp381\n")


if __name__ == "__main__":
    path = build()
    print(f"built {path} in {INFO['build_seconds']:.1f} s")
    print(ptxas_report())
