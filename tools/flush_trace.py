"""Trace one 10,000-entry verify flush of one checkout of the repository
on the card with torch.profiler, to see how the prep thread's kernels
(hash-to-G2, the pubkey decompression) and the launch thread's verify
kernels share the card.

    python3 tools/flush_trace.py ROOT [OUT_JSON] [--cold | --warm]
                                 [--route bytes|resident]

ROOT is a checkout (this one, or an unpacked `git archive` of another
commit), imported and built as `tools/verify_ab.py` does.  The run builds
the verify pool and the distinct flush of `chip_smoke.verify_distinct_phase`,
runs that flush once untraced, then once under torch.profiler (CUDA
activity only), with the message LRU cleared before each.  With --cold
it traces the pool's own flush (64 messages, hashed once) with the pubkey
LRU emptied before each run instead: the first flush after a node starts,
each tile's key misses decompressed on the prep thread; with --warm the
pool's own flush with nothing emptied.  `--route` (default bytes) picks
the backend's verify route, as `tools/verify_ab.py` does (on
``resident`` the stores are emptied in the LRUs' place).  From the
profiler's chrome trace it reports, per kernel function: its launches,
its summed and median device time and the streams it ran on; the device's
busy and idle share over the traced flush (the union of kernel intervals
against the flush's span, first kernel to last); and, for each kernel of
the verify stages, the share of its device time that overlapped a kernel
of another stream (the prep thread's), with the median duration of its
launches that overlapped one and of those that did not.  Prints the card's
name and power limit, then one JSON line; OUT_JSON (optional) receives the
same object.  Every verdict must be True.
"""

from __future__ import annotations

import asyncio
import json
import re
import statistics
import sys
import tempfile
import time
from pathlib import Path

#: kernel function → the port's kernel name
KERNELS = {
    "fp_op_kernel": "K1", "g2_step_kernel": "K2",
    "straus_step_kernel": "K3", "pp_step_kernel": "K4/K5",
    "f12_step_kernel": "K6", "f2_chain_kernel": "K7",
    "h2c_sswu_kernel": "K8", "h2c_point_kernel": "K9",
    "g2_sel_kernel": "K10", "final_exp_kernel": "K11",
    "g2_decompress_kernel": "K12", "miller_loop_kernel": "K13",
    "miller_thread_kernel": "K13", "f12_fold_kernel": "K14",
    "g1_scalar_mul_kernel": "K15", "g1_dblsel_kernel": "K15",
    "straus_msm_kernel": "K16", "g2_zmul_kernel": "K17",
    "f2_chain_program_kernel": "K18", "g2_normalize_kernel": "K19",
    "g1_tables_kernel": "K20", "g1_decompress_kernel": "K21",
    "g2_law_kernel": "K22", "h2c_map_tail_kernel": "K23",
    "h2c_sswu_head_kernel": "K24",
}
#: the verify stages' kernels, run by the launch thread
VERIFY = ("K11", "K12", "K13", "K14", "K15", "K20")


def kernel_of(name: str) -> str:
    for fn, k in KERNELS.items():
        if re.search(rf"\b{fn}\b", name):
            return f"{k} {fn}"
    return name.split("(")[0][:80]


def overlap(a0: float, a1: float, spans: list[tuple[float, float]]) -> float:
    """Length of [a0, a1) covered by the union of sorted `spans`."""
    cov, cur = 0.0, a0
    for b0, b1 in spans:
        if b1 <= cur:
            continue
        if b0 >= a1:
            break
        lo, hi = max(b0, cur), min(b1, a1)
        if hi > lo:
            cov += hi - lo
            cur = hi
    return cov


def union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for b0, b1 in sorted(spans):
        if out and b0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b1)
        else:
            out.append([b0, b1])
    return [(a, b) for a, b in out]


def analyse(trace: dict) -> dict:
    ev = [e for e in trace.get("traceEvents", [])
          if e.get("ph") == "X" and e.get("cat") == "kernel"]
    if not ev:
        return {"kernels": {}, "note": "the profiler recorded no kernel"}
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
              kernel_of(e["name"]), e.get("args", {}).get("stream"))
             for e in ev]
    t0 = min(s[0] for s in spans)
    t1 = max(s[1] for s in spans)
    busy = sum(b - a for a, b in union([(s[0], s[1]) for s in spans]))
    per: dict[str, dict] = {}
    for a, b, k, st in spans:
        d = per.setdefault(k, {"launches": 0, "us": [], "streams": set()})
        d["launches"] += 1
        d["us"].append(b - a)
        d["streams"].add(st)
    by_stream: dict = {}
    for a, b, k, st in spans:
        by_stream.setdefault(st, []).append((a, b))
    out, others = {}, {}
    for k, d in sorted(per.items(), key=lambda kv: -sum(kv[1]["us"])):
        row = {"launches": d["launches"], "sum_ms": sum(d["us"]) / 1e3,
               "median_ms": statistics.median(d["us"]) / 1e3,
               "streams": sorted(str(s) for s in d["streams"])}
        if k.split()[0] in VERIFY:
            mine = [(a, b, st) for a, b, kk, st in spans if kk == k]
            shared, alone, cov_sum = [], [], 0.0
            for a, b, st in mine:
                if st not in others:
                    others[st] = union([s for o, ss in by_stream.items()
                                        if o != st for s in ss])
                cov = overlap(a, b, others[st])
                cov_sum += cov
                (shared if cov > 0.5 * (b - a) else alone).append(b - a)
            row.update(
                overlapped_share=cov_sum / max(sum(d["us"]), 1e-9),
                median_ms_overlapped=(statistics.median(shared) / 1e3
                                      if shared else None),
                median_ms_alone=(statistics.median(alone) / 1e3
                                 if alone else None),
                launches_overlapped=len(shared))
        out[k] = row
    return {"span_ms": (t1 - t0) / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / (t1 - t0), "kernels": out}


def main() -> int:
    args = sys.argv[1:]
    route = "bytes"
    if "--route" in args:
        at = args.index("--route")
        route = args[at + 1]
        del args[at:at + 2]
    kind = ("cold" if "--cold" in args else
            "warm" if "--warm" in args else "distinct")
    args = [a for a in args if a not in ("--cold", "--warm")]
    root = Path(args[0]).resolve()
    dest = Path(args[1]) if len(args) > 1 else None
    sys.path.insert(0, str(root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from charon_tpu_torch.ops import build
    from charon_tpu_torch.tbls import dispatch

    if not torch.cuda.is_available():
        print("flush_trace: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    build.library()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from verify_ab import make_backend

    backend = make_backend(route)
    resident = route == "resident"
    entries, _, bits = cs.verify_pool(dev, backend)
    if kind != "distinct":
        batch = entries
    else:
        msgs = cs.distinct_messages(len(entries))
        hms = backend._hash_points(msgs, {}, {})
        sigs = cs.sign_on_card(dev, bits, hms)
        batch = [(entries[k][0], msgs[k], sigs[k])
                 for k in range(len(entries))]

    def flush():
        if kind != "warm":
            store = "pk" if kind == "cold" else "hm"
            if resident:
                backend._dev_caches()[store == "hm"].clear()
            else:
                (backend._pk_cache if store == "pk" else
                 backend._hm_cache).clear()
        backend.reset_verify_totals()
        torch.cuda.synchronize()
        t = time.perf_counter()
        oks, _, _ = asyncio.run(cs.verify_round(batch))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if not all(oks):
            raise AssertionError(f"{oks.count(False)} rejected")
        return {"wall_s": wall, **backend.verify_totals}

    untraced = flush()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = flush()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    pipe = dispatch.current_pipeline()
    if pipe is not None:
        pipe.shutdown()
    res = {"root": str(root), "route": route, "flush": kind,
           "untraced": untraced, "traced": traced, **analyse(trace)}
    print(cs.smi("name,power.limit"), flush=True)
    print(json.dumps(res), flush=True)
    if dest is not None:
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
