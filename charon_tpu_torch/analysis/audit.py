"""Audit orchestration: the kernel contract passes and the three source
lints over the port.

`run_audit` is the single entry point of the CLI
(``python -m charon_tpu_torch.analysis``), the tests
(tests/test_torch_analysis.py), chip_smoke.py's ``contract`` phase,
which adds the card-side passes (`audit_card`, `residency`) to the
report it returns, and the multi-card dry run
(`multichip.dryrun_multichip`), which adds the shard pass
(`run_shard_audit`) on its own devices.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field

from . import registry


@dataclass
class AuditReport:
    kernels: list = field(default_factory=list)     # kernel_audit.KernelAudit
    #: violations not of one kernel: the sources' discipline, unregistered
    #: kernels, the report's unregistered rows
    general: list = field(default_factory=list)
    residency_cases: list = field(default_factory=list)
    shard_cases: list = field(default_factory=list)  # ShardCaseAudit
    shapes_checked: list = field(default_factory=list)
    ptxas_log: str | None = None                    # where (c) read from
    metrics_lint: object = None  # metrics_lint.MetricsLintReport | None
    concurrency: object = None   # concurrency.ConcurrencyReport | None
    asyncio_lint: object = None  # asyncio_lint.AsyncLintReport | None

    @property
    def violations(self) -> list:
        out = list(self.general)
        for k in self.kernels:
            out += k.violations
        for r in self.residency_cases:
            out += r.violations
        for c in self.shard_cases:
            out += c.violations
        for lint in (self.metrics_lint, self.concurrency,
                     self.asyncio_lint):
            if lint is not None:
                out += lint.violations
        return out

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "shapes_checked": self.shapes_checked,
            "ptxas_log": self.ptxas_log,
            "kernels": [asdict(k) for k in self.kernels],
            "residency_cases": [asdict(r) for r in self.residency_cases],
            "shard_cases": [asdict(c) for c in self.shard_cases],
            "metrics_lint": (self.metrics_lint.to_dict()
                             if self.metrics_lint is not None else None),
            "concurrency": (self.concurrency.to_dict()
                            if self.concurrency is not None else None),
            "asyncio_lint": (self.asyncio_lint.to_dict()
                             if self.asyncio_lint is not None else None),
            "violations": self.violations,
        }

    def summary(self) -> str:
        lines = []
        for k in self.kernels:
            verdict = "ok" if not k.violations else "FAIL"
            top = max(k.launches.values(), key=lambda g: g["smem"],
                      default=None)
            geo = (f" {top['threads']} threads × {top['rows_per_block']} "
                   f"rows, {top['smem']} B shared, {top['blocks_per_sm']} "
                   f"blocks/SM ({top['limit']})" if top else "")
            comp = (f"; ptxas {k.ptxas['regs']} regs / {k.ptxas['stack']} B "
                    f"stack / {k.ptxas['spill']} B spill"
                    if k.ptxas else "")
            card = (f"; card {k.card['regs']} regs, "
                    f"{k.card['blocks_per_sm']} blocks/SM"
                    if k.card else "")
            lines.append(f"  [{verdict}] {k.name}: "
                         f"{len(k.launches)} row counts{geo}{comp}{card}")
        for r in self.residency_cases:
            verdict = "ok" if not r.violations else "FAIL"
            nodes = (f", nodes {r.nodes}" if r.nodes is not None else "")
            lines.append(f"  [{verdict}] {r.name}: one graph of "
                         f"{r.launches}{nodes}")
        for c in self.shard_cases:
            verdict = "ok" if not c.violations else "FAIL"
            lines.append(f"  [{verdict}] {c.name}: {c.plans_checked} plans "
                         f"on {', '.join(c.devices)}, ops by shard "
                         f"{c.ops}")
        for lint in (self.metrics_lint, self.concurrency,
                     self.asyncio_lint):
            if lint is not None:
                lines.append(lint.summary())
        for v in self.violations:
            lines.append(f"  VIOLATION: {v}")
        status = "PASS" if self.ok else "FAIL"
        source = (f", ptxas log {self.ptxas_log}" if self.ptxas_log
                  else ", no ptxas log")
        lines.append(f"kernel contract audit: {status} "
                     f"({len(self.kernels)} kernels, "
                     f"{len(self.shapes_checked)} shapes{source}, "
                     f"{len(self.residency_cases)} residency cases, "
                     f"{len(self.shard_cases)} shard cases, "
                     f"{len(self.violations)} violations)")
        return "\n".join(lines)


def run_lints(metrics: bool = True, concurrency: bool = True,
              asyncio_lint: bool = True) -> dict:
    """The three AST lints over the package → {report field: report}
    (pure AST, no import of the scanned modules: chip_smoke.py runs it in
    a worker process beside the build)."""
    out: dict = {}
    if metrics:
        from .metrics_lint import lint_package

        out["metrics_lint"] = lint_package()
    if concurrency:
        from .concurrency import check_package

        out["concurrency"] = check_package()
    if asyncio_lint:
        from .asyncio_lint import lint_package as lint_async_package

        out["asyncio_lint"] = lint_async_package()
    return out


def run_audit(ptxas_log: str | None = None, ptxas_path: str | None = None,
              metrics: bool = True, concurrency: bool = True,
              asyncio_lint: bool = True, lints: dict | None = None,
              sms: int | None = None, shard: bool = False,
              n_dev: int | None = None, devices=None) -> AuditReport:
    """Run the kernel contract audit on the CPU.

    ptxas_log  : a ``-Xptxas -v`` log's text for pass (c) (None: the
                 current build's ``ptxas.log`` when one exists, else (c)
                 is skipped); `ptxas_path` names where it came from.
    metrics / concurrency / asyncio_lint : run each AST lint.
    lints      : the lints' reports, already run (`run_lints`).
    sms        : the card's SMs (default an H100's).
    shard      : run the shard pass over the registered sharded programs
                 at `devices` (default `n_dev` CPU shards, 2).
    """
    from ..ops import build
    from .kernel_audit import run_kernel_audit

    registry.ensure_populated()
    report = AuditReport()
    if lints is None:
        lints = run_lints(metrics, concurrency, asyncio_lint)
    for key, lint in lints.items():
        setattr(report, key, lint)
    if ptxas_log is None:
        path = build.ptxas_log_path()
        if path.exists():
            ptxas_log, ptxas_path = path.read_text(), str(path)
    if ptxas_log is not None:
        report.ptxas_log = ptxas_path or "the given text"
    report.kernels, report.general = run_kernel_audit(ptxas_log, sms=sms)
    report.shapes_checked = [s.name for s in registry.workload_shapes()]
    if shard:
        report.shard_cases += run_shard_audit(n_dev, devices, sms)
    return report


def run_shard_audit(n_dev: int | None = None, devices=None,
                    sms: int | None = None, specs=None) -> list:
    """The shard pass (analysis/shard_audit.py) over every registered
    sharded program (or `specs`) at `devices`: default `n_dev` shards on
    the CPU (2)."""
    from .kernel_audit import read_csrc
    from .shard_audit import audit_shard_program

    registry.ensure_populated()
    if devices is None:
        devices = ["cpu"] * (n_dev or 2)
    sources = read_csrc()
    return [audit_shard_program(spec, devices, sms, sources)
            for spec in (registry.shard_programs() if specs is None
                         else specs)]
