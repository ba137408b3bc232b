"""The port's kernel contract auditor (charon_tpu_torch/analysis), on the
CPU: the counterpart of tests/test_static_analysis.py.

It checks that (a) every ``__global__`` instantiation of csrc/ is
registered with its budget, and every row of PERF.md's kernel table maps
to one; (b) the audit is clean at HEAD — each kernel's device code, its
launch arithmetic at every registered shape, its figures in a
``-Xptxas -v`` report of sm_90a (tests/testdata/ptxas_sm90a.log, the
build of this tree's kernels on an H100 host), and the three source
lints; (c) every CPU golden-bad fixture is flagged and makes the CLI exit
non-zero, and mutations of the real sources are flagged too; (d) the
port's lints report what the JAX package's report on the same sources,
with the package prefix mapped.  The card-side passes (the runtime's
figures, the resident graph) run in chip_smoke.py's ``contract`` phase.
"""

import dataclasses
import importlib
import json
import re
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

# one intra-op thread: the shard pass runs the plain versions on small
# tensors, and several workers share the cores
torch.set_num_threads(1)

from charon_tpu_torch.analysis import fixtures, kernel_audit, registry
from charon_tpu_torch.analysis.__main__ import main as analysis_main

ROOT = Path(__file__).resolve().parent.parent
PTXAS_LOG = (ROOT / "tests" / "testdata" / "ptxas_sm90a.log").read_text()


@pytest.fixture(scope="module")
def head_audit():
    from charon_tpu_torch.analysis.audit import run_audit

    return run_audit(ptxas_log=PTXAS_LOG, ptxas_path="ptxas_sm90a.log")


def test_registry_population():
    """Every __global__ function of csrc/ is registered (25 functions,
    43 instantiations), every registered instantiation is in the report
    and every report row is registered, and rows 1–38 of PERF.md's kernel
    table each map to a spec."""
    from charon_tpu_torch.ops import build

    registry.ensure_populated()
    specs = registry.kernels()
    sources = kernel_audit.read_csrc()
    assert kernel_audit.unregistered_globals(sources) == []
    assert len(kernel_audit.global_instantiations(sources)) == 25
    rows = build.ptxas_rows(PTXAS_LOG)
    assert {r["name"] for r in rows} == {s.name for s in specs}
    assert len(specs) == 43
    assert kernel_audit.unregistered_rows(rows) == []
    served = {row for s in specs for row in s.perf_rows}
    assert served == set(range(1, 39))
    perf = (ROOT / "PERF.md").read_text()
    table = re.findall(r"^\| (\d+) \|", perf, re.M)
    assert {int(n) for n in table} >= served
    # the kernels line's 38 entries, one a PERF.md row 1–38 served
    line = registry.line_kernels()
    assert len(line) == 38
    assert all(s.replaces and s.replaces.startswith("charon_tpu/")
               for s in line.values())
    # the main path's shapes, as the issue's list names them
    shapes = {s.name for s in registry.workload_shapes()}
    assert {"verify v=2048", "verify v=1024", "verify v=1", "verify v=4",
            "combine v=10000 t=7", "hash m=64", "hash m=2048"} <= shapes
    combine = dict(next(s for s in registry.workload_shapes()
                        if s.name == "combine v=10000 t=7").rows)
    assert combine["straus.cu straus_msm_kernel"] == 10_240
    assert combine["decompress.cu g2_decompress_kernel<8>"] == 71_680
    verify = dict(next(s for s in registry.workload_shapes()
                       if s.name == "verify v=2048").rows)
    assert verify["miller.cu miller_loop_kernel"] == 4_096


def test_registry_imports_no_torch():
    code = ("import sys, charon_tpu_torch.analysis.registry\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'charon_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr


def test_arithmetic_audit_clean_for_every_registered_shape(head_audit):
    assert head_audit.general == []
    by_name = {k.name: k for k in head_audit.kernels}
    assert len(by_name) == 43
    for shape in registry.workload_shapes():
        for name, rows in shape.rows:
            assert rows in by_name[name].launches, (shape.name, name)
    for k in head_audit.kernels:
        assert k.violations == [], k.violations
        assert k.ptxas is not None
    # the figures PERF.md's table gives: K13 52 slots = 6,816 B a row,
    # 4 rows a block, 8 blocks an SM; K16 34 slots = 4,512 B a row, 8
    # rows, 6 blocks an SM (its shared memory the limit)
    k13 = by_name["miller.cu miller_loop_kernel"].launches[4096]
    assert (k13["smem"], k13["rows_per_block"], k13["blocks_per_sm"]) \
        == (4 * 6816, 4, 8)
    k16 = by_name["straus.cu straus_msm_kernel"].launches[10_240]
    assert (k16["smem"], k16["blocks_per_sm"], k16["limit"]) \
        == (8 * 4512, 6, "by_smem")
    k18 = by_name["f2_chain.cu f2_chain_program_kernel<1>"].launches
    assert (k18[8192]["lanes"], k18[256]["lanes"]) == (2, 4)


def test_smem_budget_model():
    from charon_tpu_torch.ops import smem_budget as sb

    assert [sb.row_words(s) * 4 for s in (52, 34, 20, 24)] \
        == [6816, 4512, 2720, 3232]
    # K1's mul: 122 registers, 128 threads → 4 blocks an SM by registers
    assert sb.blocks_per_sm(122, 128, 0)["blocks"] == 4
    # a 255-register warp: 8 an SM (K14's co-resident blocks)
    assert sb.blocks_per_sm(255, 32, 0) == {
        "blocks": 8, "by_threads": 32, "by_regs": 8, "by_smem": 228,
        "limit": "by_regs"}
    assert sb.blocks_per_sm(32, 32, sb.SMEM_PER_BLOCK_MAX + 4)["blocks"] \
        == 0
    assert sb.cooperative_grid(4096, 8) == 1056
    assert sb.cooperative_grid(2, 8) == 1


@pytest.mark.parametrize("lint", ["metrics_lint", "concurrency",
                                  "asyncio_lint"])
def test_lint_clean_at_head(head_audit, lint):
    report = getattr(head_audit, lint)
    assert report.ok, "\n".join(report.violations)


def test_catalogue_drift_both_directions():
    """Every exported family is in docs/observability_torch.md and every
    documented one is exported — the six families the JAX catalogue
    lacks are there, the six it has that the port never exports are
    not."""
    from charon_tpu_torch.analysis.metrics_lint import (lint_package,
                                                        lint_sources)

    report = lint_package()
    assert report.ok, report.violations
    doc = (ROOT / "docs" / "observability_torch.md").read_text()
    for name in ("app_boot_seconds", "app_cuda_build_seconds",
                 "app_cuda_graph_capture_seconds", "app_cuda_graphs_total",
                 "app_cuda_kernel_launches_total",
                 "charon_tpu_hbm_sample_errors_total"):
        assert name in report.exported_names() and name in doc
    for name in ("app_xla_compile_seconds", "core_verify_packed_flushes",
                 "core_verify_rows_per_s"):
        assert name not in doc
    code = 'reg.observe("app_lat_seconds", 0.1)\nreg.inc("app_undoc_total")\n'
    drift = lint_sources(
        {"charon_tpu_torch/fake.py": code},
        catalogue_doc=("| `app_lat_seconds` | histogram | x |\n"
                       "| `app_ghost_total` | counter | stale |\n"
                       "`python -m charon_tpu_torch.analysis`\n"))
    text = "\n".join(drift.violations)
    assert "'app_undoc_total' is missing from the" in text
    assert "'app_ghost_total' which no code exports" in text
    assert len(drift.violations) == 2      # the package name is no metric


@pytest.mark.parametrize("which", fixtures.CPU_FIXTURES)
def test_golden_bad_fixture_flagged(which):
    report = fixtures.audit_golden_bad(which)
    assert not report.ok
    assert "FAIL" in report.summary()
    assert analysis_main(["--golden-bad", which]) == 1


def test_golden_bad_kernel_fixtures_name_their_bug():
    leak = "\n".join(fixtures.audit_golden_bad("float_leak").violations)
    assert "'float'" in leak and "0.5f" in leak and "sqrtf()" in leak
    smem = "\n".join(fixtures.audit_golden_bad("smem_overflow").violations)
    assert "the smem_budget model 27264 B" in smem
    assert "exceed the 232448 B" in smem
    spill = "\n".join(
        fixtures.audit_golden_bad("spill_over_budget").violations)
    assert "860 spill bytes over its budget of 172" in spill
    assert "904 stack bytes over its budget of 216" in spill


def _mutated(old: str, new: str, name: str) -> list:
    sources = kernel_audit.read_csrc()
    assert old in sources[name], old
    sources[name] = sources[name].replace(old, new, 1)
    audits, general = kernel_audit.run_kernel_audit(PTXAS_LOG, sources)
    return general + [v for a in audits for v in a.violations]


@pytest.mark.parametrize("name,old,new,needle", [
    ("decompress.cu", "if (r >= n) return;", "", "run unguarded"),
    ("miller.cu", "if (r >= n) return;", "", "run unguarded"),
    ("program.cuh", "const int rr = r < n ? r : n - 1;",
     "const int rr = r;", None),
    ("program.cuh", "rows * row_words(slots) * (int)sizeof(int)",
     "rows * row_words(slots + 2) * (int)sizeof(int)",
     "does not size its shared memory"),
    ("g2.cu", "constexpr int BLOCK = 64;", "constexpr int BLOCK = 128;",
     "launches 128 threads a block"),
    ("fp_ops.cu", "__launch_bounds__(128)", "__launch_bounds__(64)",
     "exceed its __launch_bounds__(64)"),
    ("normalize.cu", "BLOCK, 0,", "BLOCK, 64,", "passes shared memory"),
    ("fp381.cuh", "constexpr int NL = 32;",
     "constexpr int NL = 32;\n__device__ double scale(int x) { return x; }",
     "floating-point type 'double'"),
    ("h2c.cu", "\nh2c_sswu_kernel(", "\nh2c_sswu2_kernel(",
     "__global__ h2c_sswu2_kernel is not registered"),
])
def test_source_mutations_flagged(name, old, new, needle):
    """Mutations of the real sources that the audit must flag: a dropped
    tail guard, a launcher sizing its shared memory off the model, a
    block size or launch bound changed under the spec, a float in device
    code, an unregistered kernel.  (Dropping program.cuh's `r < n` alone
    leaves its `if (r < n)` store guard: still guarded, not flagged.)"""
    found = "\n".join(_mutated(old, new, name))
    if needle is None:
        assert found == ""
    else:
        assert needle in found, found


def test_ptxas_budget_and_registration_in_report():
    """A report row over its budget, one missing, and one unregistered
    are each flagged."""
    grown = PTXAS_LOG.replace(
        "216 bytes stack frame, 172 bytes spill stores", "216 bytes stack "
        "frame, 176 bytes spill stores", 1)
    audits, general = kernel_audit.run_kernel_audit(grown)
    assert any("176 spill bytes over its budget of 172" in v
               for a in audits for v in a.violations)
    rows = PTXAS_LOG.split("ptxas info    : Compiling entry function")
    dropped = "ptxas info    : Compiling entry function".join(
        r for r in rows if "fp_op_kernelILi4" not in r)
    audits, _ = kernel_audit.run_kernel_audit(dropped)
    assert any("registered but not in the compiler's report" in v
               for a in audits for v in a.violations)
    extra = PTXAS_LOG + rows[1].replace("fp_op_kernelILi4",
                                        "fp_op_kernelILi7").join(
        ["ptxas info    : Compiling entry function", ""])
    _, general = kernel_audit.run_kernel_audit(extra)
    assert any("fp_op_kernel<7>: in the compiler's report but not "
               "registered" in v for v in general)


def test_cli_exits_zero_at_head_and_nonzero_for_a_fixture():
    ok = subprocess.run(
        [sys.executable, "-m", "charon_tpu_torch.analysis", "--ptxas-log",
         str(ROOT / "tests" / "testdata" / "ptxas_sm90a.log"), "--json"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert ok.returncode == 0, ok.stdout[-2000:] + ok.stderr[-2000:]
    report = json.loads(ok.stdout)
    assert report["ok"] and len(report["kernels"]) == 43
    assert "PASS" in ok.stderr
    bad = subprocess.run(
        [sys.executable, "-m", "charon_tpu_torch.analysis", "--golden-bad",
         "unguarded_mutation"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert bad.returncode == 1 and "FAIL" in bad.stdout


def test_cli_lint_switches():
    assert analysis_main(["--ptxas-log",
                          str(ROOT / "tests" / "testdata" /
                              "ptxas_sm90a.log"),
                          "--no-metrics-lint", "--no-concurrency",
                          "--no-asyncio-lint"]) == 0


# ---------------------------------------------------------------------------
# the lints held against the JAX package's
# ---------------------------------------------------------------------------

def _jax_twin(module: str):
    return importlib.import_module(f"charon_tpu.analysis.{module}")


def _port(module: str):
    return importlib.import_module(f"charon_tpu_torch.analysis.{module}")


def _mapped(obj) -> str:
    """A report's dict with the port's package prefix and catalogue mapped
    to the JAX package's; each violation to its location and its rule
    (the text before " — "; the explanations name each package's own
    tools)."""
    d = obj.to_dict()
    d["violations"] = [v.split(" — ")[0] for v in d["violations"]]
    text = json.dumps(d, sort_keys=True, default=str)
    return (text.replace("charon_tpu_torch/", "charon_tpu/")
            .replace("observability_torch.md", "observability.md"))


PAIRS = ["core/verify.py", "core/sigagg.py", "tbls/dispatch.py",
         "app/monitoring.py", "app/serving.py", "tbls/devcache.py"]


def _sources(pkg: str, rel: str) -> str:
    return (ROOT / pkg / rel).read_text()


@pytest.mark.parametrize("which", ["bad_buckets", "unbounded_label",
                                   "undocumented_metric"])
def test_metrics_lint_matches_jax_on_fixtures(which):
    port = fixtures.lint_golden_bad(which)
    twin = _jax_twin("metrics_lint")
    src = {f"charon_tpu/golden_bad_{which}.py": fixtures.LINT_SOURCES[which]}
    doc = (fixtures.UNDOCUMENTED_METRIC_DOC
           if which == "undocumented_metric" else None)
    assert _mapped(port) == _mapped(twin.lint_sources(src,
                                                      catalogue_doc=doc))


@pytest.mark.parametrize("rel", PAIRS)
@pytest.mark.parametrize("pkg", ["charon_tpu_torch", "charon_tpu"])
def test_lints_match_jax_on_module_pairs(pkg, rel):
    """Each package's module under both implementations of each lint:
    the same report, prefix mapped."""
    src = _sources(pkg, rel)
    port_src = {f"charon_tpu_torch/{rel}": src}
    jax_src = {f"charon_tpu/{rel}": src}
    assert _mapped(_port("metrics_lint").lint_sources(port_src)) \
        == _mapped(_jax_twin("metrics_lint").lint_sources(jax_src))
    assert _mapped(_port("asyncio_lint").lint_sources(port_src)) \
        == _mapped(_jax_twin("asyncio_lint").lint_sources(jax_src))
    port_specs = tuple(s for s in _port("concurrency").SHARED_STATE_SPECS
                       if s.file == f"charon_tpu_torch/{rel}")
    if pkg == "charon_tpu":
        port_specs = tuple(
            dataclasses.replace(s, file=f"charon_tpu_torch/{rel}")
            for s in _jax_twin("concurrency").SHARED_STATE_SPECS
            if s.file == f"charon_tpu/{rel}")
    jax_specs = tuple(dataclasses.replace(
        _jax_twin("concurrency").SharedStateSpec(**{
            f.name: getattr(s, f.name)
            for f in dataclasses.fields(s)}),
        file=f"charon_tpu/{rel}") for s in port_specs)
    assert _mapped(_port("concurrency").check_sources(port_src, port_specs)) \
        == _mapped(_jax_twin("concurrency").check_sources(jax_src,
                                                          jax_specs))


@pytest.mark.parametrize("which", ["unguarded_mutation", "lock_cycle",
                                   "blocking_in_async", "waitfor_swallow"])
def test_concurrency_and_asyncio_match_jax_on_fixtures(which):
    src = fixtures.LINT_SOURCES[which]
    path = f"charon_tpu/golden_bad_{which}.py"
    if which in ("blocking_in_async", "waitfor_swallow"):
        twin = _jax_twin("asyncio_lint").lint_sources({path: src})
        port = fixtures.asyncio_golden_bad(which)
    else:
        jc = _jax_twin("concurrency")
        specs = ((jc.SharedStateSpec(file=path, scope="FixturePipeline",
                                     lock="_lock",
                                     attrs=("launches", "queue_depth")),)
                 if which == "unguarded_mutation" else ())
        twin = jc.check_sources({path: src}, specs=specs)
        port = fixtures.concurrency_golden_bad(which)
    assert not port.ok
    assert _mapped(port) == _mapped(twin)


# ---------------------------------------------------------------------------
# what the passes found at HEAD, pinned
# ---------------------------------------------------------------------------

def test_every_lock_of_the_port_is_declared():
    """The six locks no spec declared before the port's pass: the
    backend's totals and caches, a resident bucket's lock and the
    buckets' map, the build's lock and the launch counters' — and no
    JAX-only spec is left in the port's table."""
    from charon_tpu_torch.analysis.concurrency import SHARED_STATE_SPECS

    declared = {(s.file.split("/", 1)[1], s.scope, s.lock)
                for s in SHARED_STATE_SPECS}
    for want in (("tbls/backend_cuda.py", "CUDABackend", "_totals_lock"),
                 ("tbls/backend_cuda.py", "CUDABackend", "_cache_lock"),
                 ("tbls/backend_cuda.py", "_VerifyGraph", "lock"),
                 ("tbls/backend_cuda.py", "", "_GRAPHS_LOCK"),
                 ("ops/build.py", "", "_LOCK"),
                 ("ops/launch_count.py", "", "_LOCK")):
        assert want in declared, want
    for s in SHARED_STATE_SPECS:
        assert s.file.startswith("charon_tpu_torch/")
        assert (ROOT / s.file).is_file(), s.file
        assert "backend_tpu" not in s.file


@pytest.mark.parametrize("module", ["cuda_fp", "cuda_g2", "cuda_pairing",
                                    "cuda_h2c", "cuda_final_exp",
                                    "cuda_codec"])
def test_launch_count_reset_takes_the_counting_lock(module):
    """A wrapper's `reset_launches()` zeroes its counts under the lock
    `launch_count.bump` counts under: a reset that did not (each wrapper
    wrote `LAUNCHES[name] = 0` bare) could interleave with another
    thread's read-modify-write and lose the reset or the launch."""
    from charon_tpu_torch.ops import launch_count

    mod = importlib.import_module(f"charon_tpu_torch.ops.{module}")
    name = next(iter(mod.LAUNCHES))
    before = dict(mod.LAUNCHES)
    mod.LAUNCHES[name] = 5
    done = threading.Event()
    with launch_count._LOCK:
        t = threading.Thread(target=lambda: (mod.reset_launches(),
                                             done.set()))
        t.start()
        assert not done.wait(0.3), "reset ran without the counting lock"
        assert mod.LAUNCHES[name] == 5
    t.join(5)
    assert done.is_set() and mod.LAUNCHES[name] == 0
    mod.LAUNCHES.update(before)


def test_run_waives_its_boot_read():
    """app/run.py's boot-time read of the identity key keeps its waiver
    (the JAX package's run.py has it)."""
    from charon_tpu_torch.analysis.asyncio_lint import lint_package

    report = lint_package()
    assert any(w.startswith("charon_tpu_torch/app/run.py:")
               for w in report.waived)
    assert report.ok, report.violations


# ---------------------------------------------------------------------------
# the shard pass (analysis/shard_audit.py) over the sharded combine
# ---------------------------------------------------------------------------

def _sharded_spec():
    registry.ensure_populated()
    (spec,) = registry.shard_programs()
    assert spec.name == "backend_cuda.straus_combine_sharded"
    return spec


@pytest.mark.parametrize("n", [1, 2, 4])
def test_shard_pass_clean_on_the_sharded_combine(n):
    """The plan at every registered (V, T) and one isolated run of n CPU
    shards: no violation, every shard's ops recorded."""
    from charon_tpu_torch.analysis.audit import run_shard_audit

    (case,) = run_shard_audit(n_dev=n)
    assert case.violations == [], case.violations
    assert case.plans_checked == len(_sharded_spec().cases) == 6
    assert case.devices == ["cpu"] * n
    assert sorted(case.ops) == list(range(n)) and all(case.ops.values())


def test_shard_pass_names_the_replicated_carry():
    """The golden-bad's one padding block, made by shard 0: shard 1's read
    of it is the finding, and nothing else is."""
    bad = fixtures.audit_golden_bad("replicated_carry")
    text = "\n".join(bad.violations)
    assert "shard 1: aten.clone.default reads a tensor made by shard 0" \
        in text
    assert all("made by shard 0" in v for v in bad.violations), text
    res = subprocess.run(
        [sys.executable, "-m", "charon_tpu_torch.analysis", "--golden-bad",
         "replicated_carry"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert res.returncode == 1 and "FAIL" in res.stdout, res.stdout[-2000:]


def test_shard_pass_flags_a_bad_plan_and_bad_pads():
    """A split whose v_local is off the granularity and leaves validators
    out; pads of zeros instead of ∞ with digits that are not zero."""
    import torch

    from charon_tpu_torch.analysis import shard_audit
    from charon_tpu_torch.tbls import backend_cuda

    spec = _sharded_spec()

    def short_plan(v, t, devices):
        v_local, spans = backend_cuda.shard_plan(v, t, devices)
        if v == 1:
            return v_local, spans
        return v_local - 1, [(lo, min(hi, v - 1)) for lo, hi in spans]

    def zero_pads(src_pts, src_digits, v_local, device):
        pts, digits = backend_cuda.shard_inputs(src_pts, src_digits,
                                                v_local, device)
        n = src_pts.shape[-2]
        pts[..., n:, :] = 0
        digits[:, n:, :] = 1
        return pts, digits

    audit = shard_audit.ShardCaseAudit(name="mutant", devices=["cpu"] * 2)
    shard_audit.check_plan(dataclasses.replace(spec, plan=short_plan),
                           [torch.device("cpu")] * 2, audit)
    text = "\n".join(audit.violations)
    assert "is not a positive multiple of 512" in text
    assert "are not [0, 10000) in order" in text
    pts, digits = shard_audit.small_inputs(300, 2, 2, "cpu")
    shard_audit.check_pads(dataclasses.replace(spec, shard_inputs=zero_pads),
                           [torch.device("cpu")] * 2, pts, digits, audit)
    assert sum("a pad row is not ∞ with zero digits" in v
               for v in audit.violations) == 2


def test_shard_recorder_device_rule():
    """An operand off the shard's device is a violation; the copy that
    brings the shard a slice no shard made is not."""
    import torch

    from charon_tpu_torch.analysis.shard_audit import ShardRecorder

    host = torch.ones(4, dtype=torch.int32)
    rec = ShardRecorder()
    with rec:
        with rec.scope(0, torch.device("meta")):
            mine = torch.empty(4, dtype=torch.int32, device="meta")
            mine.copy_(host)                     # the transfer: allowed
            torch.add(host, 1)                   # off the shard's device
    assert rec.ops == {0: 3}
    assert rec.violations == [
        "shard 0: aten.add.Tensor has an operand on cpu, the shard runs on "
        "meta"]


def test_sharded_shapes_pass_the_launch_audit(head_audit):
    """K22 and K16 at every registered shard: (V, T) of the JAX package's
    AUDIT_VT_SHAPES over 1, 2, 4 and 8 cards, v_local on the card's
    1,024-validator grid."""
    by_name = {k.name: k for k in head_audit.kernels}
    shapes = {s.name: dict(s.rows) for s in registry.workload_shapes()
              if s.origin == "sharded"}
    assert len(shapes) == 24
    for n in (1, 2, 4, 8):
        for v, t in ((1, 1), (100, 3), (1024, 2), (4096, 4), (10_000, 7),
                     (50_000, 10)):
            rows = shapes[f"sharded v={v} t={t} n={n}"]
            v_local = -(-max(1, -(-v // n)) // 1024) * 1024
            assert rows == {"g2_law.cu g2_law_kernel<6>": t * v_local,
                            "straus.cu straus_msm_kernel": v_local}
            for name, r in rows.items():
                assert r in by_name[name].launches
                assert by_name[name].violations == []
