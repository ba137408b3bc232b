"""Golden-bad fixtures: known-broken kernels, launches, logs and sources
the auditor MUST flag.  Each re-creates one bug class in miniature, so
that the audit's detection of it is itself pinned by the tests
(tests/test_torch_analysis.py) and demonstrable from the CLI
(``python -m charon_tpu_torch.analysis --golden-bad <fixture>`` exits
non-zero).

Kernel fixtures (the counterparts of the JAX package's):

- `float_leak`: a ``.cu`` kernel whose body converts a limb to float,
  takes its square root and writes it back — the source-discipline pass
  must flag the type, the literal and the call.
- `smem_overflow` (the JAX package's ``r05_vmem``, a 17.48 MiB scoped-VMEM
  overflow that shipped): two program-kernel launches — one passes more
  shared memory than `ops/smem_budget`'s model says its rows take, one
  more than the 227 KB a block can have.
- `spill_over_budget`: a ``-Xptxas -v`` report in which K13 spills more
  than its budget — the compiler's-report pass must flag it.
- `resident_roundtrip`: a verify tile that reads its signatures' flags
  back to the host between K12 and K20 — its capture must fail.  On the
  card only (chip_smoke.py's ``contract`` phase).
- `replicated_carry` (the JAX package's: the r05 sharded combine whose
  loop carry started from a replicated constant): the sharded combine
  with one padding block made by shard 0 and reused by every other shard
  — the shard pass must flag the read across shards (and, on separate
  cards, the operand off the shard's device).

Lint fixtures (copies of the JAX package's, audited with this package's
passes): `bad_buckets`, `unbounded_label`, `undocumented_metric`,
`unguarded_mutation`, `lock_cycle`, `blocking_in_async` and
`waitfor_swallow`.
"""

from __future__ import annotations

from . import registry

#: the fixtures that run on the CPU (`resident_roundtrip` needs the card)
CPU_FIXTURES = ("float_leak", "smem_overflow", "spill_over_budget",
                "replicated_carry", "bad_buckets", "unbounded_label",
                "undocumented_metric", "unguarded_mutation", "lock_cycle",
                "blocking_in_async", "waitfor_swallow")

FLOAT_LEAK_CU = '''\
#include "fp381.cuh"

namespace {

__global__ void __launch_bounds__(32)
    leak_kernel(int* __restrict__ out, const int* __restrict__ in, int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float x = (float)in[r] * 0.5f;     // THE BUG: limb math in float
  out[r] = (int)sqrtf(x);
}

}  // namespace
'''

#: K13's report with a spill over its budget (and a register count over
#: its launch bounds would be the same class)
SPILL_OVER_BUDGET_LOG = '''\
ptxas info    : Compiling entry function \
'_ZN41_GLOBAL__N__f10fb3aa_9_miller_cu_887efb2918miller_loop_kernelEPiPKiPK4\
int2iS2_S2_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__f10fb3aa_9_miller_\
cu_887efb2918miller_loop_kernelEPiPKiPK4int2iS2_S2_iii
    904 bytes stack frame, 860 bytes spill stores, 904 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 904 bytes cumulative \
stack size
'''


def smem_overflow_specs() -> list[registry.KernelSpec]:
    """K13 launched (a) with 4 KB more shared memory than the model's
    rows × row_words(slots) and (b) at one lane a row, 32 rows of 190
    slots a block: 790 KB, over the 227 KB a block can have."""
    from ..ops import smem_budget as sb

    base = next(s for s in _populated() if s.launch == "miller_loop")

    def drift(rows, sms):
        g = base.geometry(rows, sms)
        return registry.Geometry(threads=g.threads, rows=g.rows,
                                 smem=g.smem + 4096, lanes=g.lanes,
                                 slots=g.slots)

    def overflow(rows, sms):
        return registry.Geometry(threads=32, rows=32,
                                 smem=sb.program_smem_bytes(1, 190),
                                 lanes=1, slots=190)

    return [registry.KernelSpec(**{**base.__dict__,
                                   "name": f"golden_bad.{label}",
                                   "geometry": fn})
            for label, fn in (("smem_drift", drift),
                              ("smem_over_227k", overflow))]


def _populated():
    registry.ensure_populated()
    return registry.kernels()


def resident_roundtrip_spec() -> registry.ResidencyProgramSpec:
    """The residency golden-bad: the resident verify tile with a host read
    of the signatures' flags between K12 and K20 — exactly the per-stage
    fetch the one-graph tile exists to remove."""
    from ..ops import cuda_codec
    from ..tbls import backend_cuda

    def roundtrip_tile(pks, hms, xc0, xc1, sign, inf, host_live, windows):
        _, sg_ok = cuda_codec.g2_decompress(xc0, xc1, sign, inf)
        if not bool(sg_ok.any().cpu()):      # THE BUG: a host round trip
            sg_ok = sg_ok.clone()
        return backend_cuda._verify_tile(pks, hms, xc0, xc1, sign, inf,
                                         host_live & sg_ok, windows)

    return registry.ResidencyProgramSpec(
        name="golden_bad.resident_roundtrip",
        build=lambda v, device: backend_cuda._VerifyGraph(
            device, v, tile=roundtrip_tile),
        stages=backend_cuda.VERIFY_TILE_KERNELS,
        cases=(2,))


def replicated_carry_shard_spec() -> registry.ShardProgramSpec:
    """The sharded combine with THE BUG: the first shard's padding block
    (∞ points, zero digits) kept and reused by every later shard, as the
    r05 carry reused one replicated ∞ accumulator on every device."""
    from ..tbls import backend_cuda

    def run(pts_vt, digits_vt, devices=None, scope=None):
        pad: dict = {}

        def make_inputs(src_pts, src_digits, v_local, device):
            if not pad:                     # made by shard 0 ...
                pad["pts"], pad["digits"] = backend_cuda.shard_inputs(
                    src_pts[..., :0, :], src_digits[:, :0, :], v_local,
                    device)
            pts, digits = pad["pts"].clone(), pad["digits"].clone()
            n = src_pts.shape[-2]           # ... and read by the others
            pts[..., :n, :].copy_(src_pts)
            digits[:, :n, :].copy_(src_digits)
            return pts, digits

        return backend_cuda.straus_combine_sharded(
            pts_vt, digits_vt, devices, scope=scope,
            make_inputs=make_inputs)

    prod = next(s for s in _shard_programs()
                if s.name == "backend_cuda.straus_combine_sharded")
    return registry.ShardProgramSpec(**{**prod.__dict__,
                                        "name": "golden_bad.replicated_carry",
                                        "run": run, "cases": ()})


def _shard_programs():
    registry.ensure_populated()
    return registry.shard_programs()


# ---------------------------------------------------------------------------
# lint fixtures: the JAX package's, word for word
# ---------------------------------------------------------------------------

#: Metrics-lint golden-bad sources (audited via lint_sources, never
#: imported).  Non-monotone ladder + explicit infinity in one; guarded
#: labels minted from runtime strings in the other.
BAD_BUCKETS_SRC = '''\
reg.set_buckets("app_fixture_seconds", (0.1, 0.05, 1.0))
reg.set_buckets("app_fixture_inf_seconds", (0.1, float("inf")))
reg.observe("app_fixture_seconds", 0.2)
'''

UNBOUNDED_LABEL_SRC = '''\
reg.inc("app_fixture_errors_total",
        labels={"reason": f"timeout after {secs}s"})
reg.set_gauge("app_fixture_peer_state", 1.0,
              labels={"peer": host + ":" + str(port)})
reg.observe("app_fixture_seconds", 0.1,
            labels={"path": "{}/{}".format(a, b)})
'''

#: Catalogue-drift golden-bad: the code exports a family the doc never
#: mentions AND the doc documents a family no code exports — both
#: directions of drift must be flagged.
UNDOCUMENTED_METRIC_SRC = '''\
reg.inc("app_fixture_documented_total")
reg.set_gauge("app_fixture_undocumented_rows", 3.0)
reg.observe("app_fixture_latency_seconds", 0.2)
'''

UNDOCUMENTED_METRIC_DOC = '''\
# Observability (fixture)

| metric | type | meaning |
|---|---|---|
| `app_fixture_documented_total` | counter | a documented counter |
| `app_fixture_ghost_total` | counter | documented but never exported |

Alert expr: histogram_quantile(0.99,
  rate(app_fixture_latency_seconds_bucket[5m])) — suffix normalises.
'''

#: Concurrency-pass golden-bad: a guarded counter rebound OUTSIDE its
#: declared lock.
UNGUARDED_MUTATION_SRC = '''\
import threading


class FixturePipeline:
    def __init__(self):
        self._lock = threading.Lock()
        self.launches = 0
        self.queue_depth = 0

    def record(self):
        with self._lock:
            self.queue_depth += 1
        self.launches += 1
'''

#: Lock-ordering golden-bad: two module locks taken in opposite orders
#: at two sites — the static graph must reject the cycle.
LOCK_CYCLE_SRC = '''\
import threading

_CACHE_LOCK = threading.Lock()
_STATS_LOCK = threading.Lock()


def commit():
    with _CACHE_LOCK:
        with _STATS_LOCK:
            pass


def snapshot():
    with _STATS_LOCK:
        with _CACHE_LOCK:
            pass
'''

#: Asyncio-lint golden-bads: a sync sleep on the loop, and
#: `asyncio.wait_for` wrapping a bare queue get.
BLOCKING_IN_ASYNC_SRC = '''\
import time


async def refresh():
    time.sleep(0.5)
    return True
'''

WAITFOR_SWALLOW_SRC = '''\
import asyncio


async def consume(queue):
    return await asyncio.wait_for(queue.get(), timeout=1.0)
'''

LINT_SOURCES = {"bad_buckets": BAD_BUCKETS_SRC,
                "unbounded_label": UNBOUNDED_LABEL_SRC,
                "undocumented_metric": UNDOCUMENTED_METRIC_SRC,
                "unguarded_mutation": UNGUARDED_MUTATION_SRC,
                "lock_cycle": LOCK_CYCLE_SRC,
                "blocking_in_async": BLOCKING_IN_ASYNC_SRC,
                "waitfor_swallow": WAITFOR_SWALLOW_SRC}


def fixture_path(which: str) -> str:
    return f"charon_tpu_torch/golden_bad_{which}.py"


def lint_golden_bad(which: str):
    """Run the metrics lint over one known-bad source fixture."""
    from .metrics_lint import lint_sources

    src = {fixture_path(which): LINT_SOURCES[which]}
    if which == "undocumented_metric":
        return lint_sources(src, catalogue_doc=UNDOCUMENTED_METRIC_DOC)
    return lint_sources(src)


def concurrency_golden_bad(which: str):
    """Run the lock-discipline pass over one known-bad source fixture."""
    from .concurrency import SharedStateSpec, check_sources

    path = fixture_path(which)
    specs = ()
    if which == "unguarded_mutation":
        specs = (SharedStateSpec(file=path, scope="FixturePipeline",
                                 lock="_lock",
                                 attrs=("launches", "queue_depth")),)
    return check_sources({path: LINT_SOURCES[which]}, specs=specs)


def asyncio_golden_bad(which: str):
    """Run the asyncio lint over one known-bad source fixture."""
    from .asyncio_lint import lint_sources

    return lint_sources({fixture_path(which): LINT_SOURCES[which]})


def audit_golden_bad(which: str, device=None):
    """Audit one golden-bad fixture; the returned report must NOT be ok.
    `resident_roundtrip` needs a card (`device`, default the current);
    `replicated_carry` runs its two shards on `device` (default the
    CPU)."""
    from . import kernel_audit
    from .audit import AuditReport

    report = AuditReport()
    if which in ("bad_buckets", "unbounded_label", "undocumented_metric"):
        report.metrics_lint = lint_golden_bad(which)
    elif which in ("unguarded_mutation", "lock_cycle"):
        report.concurrency = concurrency_golden_bad(which)
    elif which in ("blocking_in_async", "waitfor_swallow"):
        report.asyncio_lint = asyncio_golden_bad(which)
    elif which == "float_leak":
        text = kernel_audit.strip_comments(FLOAT_LEAK_CU)
        report.general += kernel_audit.discipline_violations(
            "golden_bad_float_leak.cu", text)
    elif which == "smem_overflow":
        sources = kernel_audit.read_csrc()
        for spec in smem_overflow_specs():
            audit = kernel_audit.KernelAudit(name=spec.name,
                                             source=spec.source,
                                             launch=spec.launch)
            kernel_audit.audit_launch(spec, [4096], sources,
                                      spec.budget[0], 132, audit)
            report.kernels.append(audit)
    elif which == "spill_over_budget":
        kernels, general = kernel_audit.run_kernel_audit(
            ptxas_log=SPILL_OVER_BUDGET_LOG)
        # the log holds K13 alone: the fixture is about K13's budget
        report.kernels += [k for k in kernels
                           if k.launch == "miller_loop"]
    elif which == "replicated_carry":
        from .audit import run_shard_audit

        devices = [device or "cpu"] * 2
        report.shard_cases += run_shard_audit(
            devices=devices, specs=[replicated_carry_shard_spec()])
    elif which == "resident_roundtrip":
        from .residency import audit_residency_case

        spec = resident_roundtrip_spec()
        for v in spec.cases:
            report.residency_cases.append(
                audit_residency_case(spec, v, device or _card()))
    else:
        raise ValueError(f"unknown golden-bad fixture {which!r}")
    return report


def _card():
    import torch

    return torch.device("cuda", torch.cuda.current_device())
