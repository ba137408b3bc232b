"""``python -m charon_tpu_torch.analysis`` — the kernel contract auditor
CLI.

Exit status 0 iff every contract holds: each registered kernel's source
discipline and launch arithmetic at every registered shape, its figures
in the compiler's report (with ``--ptxas-log``, or the current build's
``ptxas.log`` when one exists), the shard pass over the sharded combine
at ``--devices`` CPU shards, and the metric-name, lock-discipline and
event-loop lints.  ``--golden-bad`` audits a known-broken fixture instead
and therefore exits non-zero — the proof that the auditor detects each
bug class, not just that HEAD is clean.

Needs no card: the card-side passes (the runtime's figures, the resident
graph) run from chip_smoke.py's ``contract`` phase.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    from .fixtures import CPU_FIXTURES

    ap = argparse.ArgumentParser(
        prog="python -m charon_tpu_torch.analysis",
        description="Kernel contract auditor (no card needed)")
    ap.add_argument("--golden-bad", choices=CPU_FIXTURES,
                    help="audit a known-broken fixture instead of HEAD "
                         "(expected exit status: non-zero)")
    ap.add_argument("--ptxas-log", type=Path, default=None,
                    help="a -Xptxas -v log to hold the kernels' registers, "
                         "stack and spill against (default: the current "
                         "build's, when there is one)")
    ap.add_argument("--no-shard", action="store_true",
                    help="skip the shard pass")
    ap.add_argument("--devices", type=int, default=2,
                    help="CPU shards for the shard pass")
    ap.add_argument("--no-metrics-lint", action="store_true",
                    help="skip the metric-name lint pass")
    ap.add_argument("--no-concurrency", action="store_true",
                    help="skip the lock-discipline pass")
    ap.add_argument("--no-asyncio-lint", action="store_true",
                    help="skip the event-loop-discipline pass")
    ap.add_argument("--json", action="store_true",
                    help="print the full structured report as JSON")
    args = ap.parse_args(argv)

    if not args.no_shard or args.golden_bad == "replicated_carry":
        import torch

        # the shard pass runs the plain versions on small tensors, where
        # intra-op threads only spin
        torch.set_num_threads(1)
    if args.golden_bad:
        from .fixtures import audit_golden_bad

        report = audit_golden_bad(args.golden_bad)
        print(f"--golden-bad {args.golden_bad} (expected: FAIL)")
    else:
        from .audit import run_audit

        log = (args.ptxas_log.read_text() if args.ptxas_log is not None
               else None)
        report = run_audit(ptxas_log=log,
                           ptxas_path=(str(args.ptxas_log)
                                       if args.ptxas_log else None),
                           shard=not args.no_shard, n_dev=args.devices,
                           metrics=not args.no_metrics_lint,
                           concurrency=not args.no_concurrency,
                           asyncio_lint=not args.no_asyncio_lint)

    if args.json:
        # stdout stays parseable JSON; the human summary goes to stderr
        print(json.dumps(report.to_dict(), indent=2, default=str))
        print(report.summary(), file=sys.stderr)
    else:
        print(report.summary())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
