"""Time kernel K12 (csrc/decompress.cu) with blocks of 8, 16 and 32
threads, at a verify tile's 2,048 rows and the combine's 71,680.

Each block size is a copy of decompress.cu with its launcher's fixed
block replaced, built by its own nvcc (all three at once) into
build/k12_block_probe/.  The rows are valid signatures ±k·G2, k =
1..1,024; every variant must give the block-8 build's bits, and the
times are CUDA-event medians of 7 interleaved launches.  Needs a CUDA
card and nvcc:

    python3 tools/k12_block_probe.py

Prints one line per row count, the card's name and power limit, and a
JSON line of the medians and every rep.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from charon_tpu_torch.ops import build, codec  # noqa: E402
from charon_tpu_torch.tbls.ref import curve as rc  # noqa: E402

BLOCKS = (8, 16, 32)
LAUNCHER = "  constexpr int block = 32;\n"


def build_variants(out: Path) -> dict:
    src = (build.CSRC / "decompress.cu").read_text()
    if src.count(LAUNCHER) != 1:
        raise SystemExit("decompress.cu: the launcher's block line moved")
    cu = out / "decompress_block.cu"
    cu.write_text(src.replace(LAUNCHER, "  constexpr int block = BLOCK;\n"))
    procs = {b: subprocess.Popen(
        [build.nvcc_path(), *build.ARCH, "-std=c++17", "-O3", "-Xcompiler",
         "-fPIC", "-shared", f"-DBLOCK={b}", "-I", str(build.CSRC), str(cu),
         "-o", str(out / f"k12_b{b}.so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for b in BLOCKS}
    fns = {}
    for b, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for block {b}:\n{log}")
        fn = ctypes.CDLL(str(out / f"k12_b{b}.so")).charon_g2_decompress
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[b] = fn
    return fns


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k12_block_probe: no CUDA device")
    out = ROOT / "build" / "k12_block_probe"
    out.mkdir(parents=True, exist_ok=True)
    fns = build_variants(out)
    pts, q = [], rc.G2_GEN
    for _ in range(1024):
        pts += [rc.g2_to_bytes(q), rc.g2_to_bytes(rc.neg(q))]
        q = rc.add(q, rc.G2_GEN)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for rows in (2048, 71680):
        raw = np.stack([np.frombuffer(pts[k % len(pts)], np.uint8)
                        for k in range(rows)])
        xc0, xc1, sign, inf, bad = codec.g2_bytes_split(raw)
        assert not bad.any()
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (xc0.T, xc1.T, sign, inf)]

        def run(b):
            p = args[0].new_empty((3, 2, 32, rows))
            ok = torch.empty(rows, dtype=torch.bool, device=dev)
            err = fns[b](p.data_ptr(), ok.data_ptr(),
                         *(a.data_ptr() for a in args), rows, stream)
            if err:
                raise SystemExit(f"block {b}: cudaError {err}")
            return p, ok

        ref = run(8)
        torch.cuda.synchronize()
        assert bool(ref[1].all())
        for b in BLOCKS:
            got = run(b)
            torch.cuda.synchronize()
            assert all(torch.equal(g, r) for g, r in zip(got, ref)), b
        reps = {b: [] for b in BLOCKS}
        for rep in range(7):
            for b in (8, 32, 16) if rep % 2 == 0 else (16, 32, 8):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run(b)
                end.record()
                torch.cuda.synchronize()
                reps[b].append(start.elapsed_time(end))
        res[rows] = {"median_ms": {b: statistics.median(t)
                                   for b, t in reps.items()}, "reps": reps}
        print(rows, "rows:", res[rows]["median_ms"], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(json.dumps(res))


if __name__ == "__main__":
    main()
