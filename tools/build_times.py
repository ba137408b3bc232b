"""Each kernel source's nvcc time, as `ops/build.py` compiles them: every
source's command started at once (the build's critical path is the last
to finish), then the two that finished last each alone (their own
time, with the machine's cores free).

    python3 tools/build_times.py

Run from the root of a checkout on a machine with nvcc; prints one line
per source and the card's name and power limit when `nvidia-smi` is
there.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def timed(cmds: list[list[str]]) -> list[float]:
    """Start every command at once → each one's seconds to finish."""
    out = [0.0] * len(cmds)
    t0 = time.perf_counter()

    def wait(i: int, proc: subprocess.Popen) -> None:
        proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed: {' '.join(cmds[i])}")
        out[i] = time.perf_counter() - t0

    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    threads = [threading.Thread(target=wait, args=(i, p))
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from charon_tpu_torch.ops import build

    try:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    except (OSError, subprocess.CalledProcessError):
        pass
    with tempfile.TemporaryDirectory() as tmp:
        cmds = build.compile_commands(Path(tmp))
        together = timed(cmds)
        last = sorted(range(len(cmds)), key=lambda i: -together[i])[:2]
        alone = {i: timed([cmds[i]])[0] for i in last}
    for i in sorted(range(len(cmds)), key=lambda i: -together[i]):
        print(f"{build.SOURCES[i]:20s} all at once {together[i]:7.1f} s"
              + (f"   alone {alone[i]:6.1f} s" if i in alone else ""))
    print(f"critical path {max(together):.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
