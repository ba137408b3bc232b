"""Build this checkout's kernels and another checkout's on one card's
host, compare their compiler reports, then run chip_smoke.py's
``contract`` phase on this checkout's build.

    python3 tools/contract_ab.py PARENT [OUT_DIR]

PARENT is a checkout of another commit (an unpacked `git archive`); both
builds run at once, each into its own ``build/`` (nvcc's sources in
parallel as `ops/build.py` starts them).  A change that adds only host
code to ``csrc/`` (an attribute query beside a launcher) must leave every
kernel's ``-Xptxas -v`` row — registers, stack, spill, static shared
memory — as the parent's: the run prints each row that differs and
exits 1 if any does, or if the contract phase finds a violation.  Prints
the card's name and power limit, the build seconds, then one JSON line:
the rows compared and equal, and the contract phase's kernels-line
figures.  Both ptxas logs are copied to OUT_DIR (default
build/contract_ab/).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import Future
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv: list[str]) -> int:
    parent = Path(argv[0]).resolve()
    out = (Path(argv[1]) if len(argv) > 1
           else ROOT / "build" / "contract_ab")
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "from charon_tpu_torch.ops import build; build.library(); "
         "print(build.build_root() / build.source_hash() / 'ptxas.log')"],
        cwd=str(parent), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    import torch

    import chip_smoke
    from charon_tpu_torch.analysis.audit import run_lints
    from charon_tpu_torch.ops import build

    build.library()
    t_change = time.perf_counter() - t0
    text, _ = proc.communicate()
    t_both = time.perf_counter() - t0
    if proc.returncode:
        print(text[-3000:], file=sys.stderr)
        return 1
    parent_log = Path(text.strip().splitlines()[-1]).read_text()
    change_log = build.ptxas_log_path().read_text()
    (out / "ptxas_parent.log").write_text(parent_log)
    (out / "ptxas_change.log").write_text(change_log)
    rows_p = {r["name"]: r for r in build.ptxas_rows(parent_log)}
    rows_c = {r["name"]: r for r in build.ptxas_rows(change_log)}
    differ = sorted(k for k in set(rows_p) | set(rows_c)
                    if rows_p.get(k) != rows_c.get(k))
    for k in differ:
        print(f"differs: {k}: parent {rows_p.get(k)}, change "
              f"{rows_c.get(k)}", flush=True)
    print(chip_smoke.smi("name,power.limit"), flush=True)
    print(f"builds: the change {t_change:.1f} s, both {t_both:.1f} s",
          flush=True)
    lints: Future = Future()
    lints.set_result(run_lints())
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok = not differ
    try:
        figures = chip_smoke.contract_phase(dev, lints, sms)
    except AssertionError as exc:
        print(exc, flush=True)
        figures, ok = None, False
    print(json.dumps({"rows": len(rows_c), "rows_equal": not differ,
                      "figures": figures}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
