"""Kernel contract audit — what the JAX package's jaxpr_audit.py and
vmem_audit.py check of a Pallas kernel, checked of the port's CUDA
kernels on their own artefacts: the ``csrc/`` sources, the compiler's
``-Xptxas -v`` report and, on the card, the runtime's figures.

(a) **Source discipline** (`audit_sources`): the device code of each
    registered kernel's source and of the ``.cuh`` files it includes —
    every ``__global__`` and ``__device__`` body and ``__constant__``
    table, comments stripped — holds no floating-point type, literal or
    math function, no ``printf`` / ``malloc`` / ``assert`` / ``new``, and
    no runtime call.  The 12-bit-limb field arithmetic is int32 through
    and through: a float that crept in would be silently wrong, not
    slow (JAX: `FORBIDDEN_KERNEL_PRIMS` and the allowed-dtype screen).
(b) **Launch arithmetic** (`audit_launch`), at every registered
    workload shape: the grid covers the rows; the rows past the last
    are guarded in the kernel's body; the shared memory a block is at
    most 227 KB and equals `ops/smem_budget`'s model, and the launcher
    passes exactly that (its ``<<<…>>>`` read from the source); the
    threads a block are within the kernel's ``__launch_bounds__``; at
    least one block fits an SM; K14's cooperative grid is at most SMs ×
    co-resident blocks (JAX: grid/BlockSpec divisibility and the
    scoped-VMEM budget).
(c) **The compiler's report** (`audit_ptxas`, given a log text): every
    ``__global__`` instantiation in the log is registered and every
    registered one is in the log; registers are at most 255 and within
    the launch bounds; registers, stack and spill are within each
    spec's budget.
(d) **The card's figures** (`audit_card`, chip_smoke.py's ``contract``
    phase): ``cudaFuncGetAttributes`` (registers, local memory, static
    shared memory, the threads a block) equals the compiler's report,
    and ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the launch
    geometry equals `smem_budget.blocks_per_sm`; csrc/program.cuh's
    ``row_words`` on the host equals the model's.

(a)–(c) run on the CPU; (d) needs the built library and a card.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path

from ..ops.build import CSRC
from . import registry

#: floating-point types: none belongs in the limb arithmetic
FLOAT_TYPES = frozenset({
    "float", "double", "__half", "__half2", "__nv_bfloat16",
    "__nv_bfloat162", "float2", "float3", "float4", "double2", "double3",
    "double4", "long double",
})

#: calls that must not appear in device code: floating-point math,
#: console and heap, assertions, and the device-side runtime
FORBIDDEN_CALLS = frozenset({
    "sqrt", "sqrtf", "rsqrt", "rsqrtf", "cbrt", "cbrtf", "exp", "expf",
    "exp2", "exp2f", "expm1", "log", "logf", "log2", "log2f", "log10",
    "log1p", "pow", "powf", "sin", "sinf", "cos", "cosf", "tan", "tanf",
    "asin", "acos", "atan", "atan2", "sinh", "cosh", "tanh", "erf", "erff",
    "erfc", "lgamma", "tgamma", "fma", "fmaf", "floor", "floorf", "ceil",
    "ceilf", "round", "roundf", "trunc", "truncf", "fabs", "fabsf", "fmod",
    "fmodf", "frexp", "ldexp", "__expf", "__logf", "__powf", "__sinf",
    "__cosf", "__fdividef", "__saturatef", "__int2float_rn",
    "__float2int_rn", "__fmul_rn", "__fadd_rn", "__dmul_rn",
    "printf", "malloc", "free", "assert", "__assertfail",
})

_FLOAT_LITERAL = re.compile(
    r"(?<![\w.])(\d+\.\d*|\.\d+|\d+(?=[eE][+-]?\d))([eE][+-]?\d+)?[fFlL]?"
    r"(?![\w.])|(?<![\w.])\d+[fF](?!\w)")
_CALL = re.compile(r"\b([A-Za-z_]\w*)\s*\(")
_TYPE = re.compile(r"\b(" + "|".join(sorted(
    (t for t in FLOAT_TYPES if " " not in t), key=len, reverse=True))
    + r")\b|\blong\s+double\b")
_RUNTIME_CALL = re.compile(r"\bcuda[A-Z]\w*\s*\(")
_HEAP = re.compile(r"\b(new|delete)\b")
_GUARD = re.compile(r"\b\w+\s*(>=|<)\s*n\b")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
_CONST = re.compile(r"\b(?:constexpr|const)\s+int\s+(\w+)\s*=\s*(\d+)\s*;")
_LAUNCH_BOUNDS = re.compile(r"__launch_bounds__\s*\(\s*(\w+)\s*\)")
_GLOBAL = re.compile(r"\b__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)\s*\(")


@dataclass
class KernelAudit:
    name: str
    source: str
    launch: str
    shapes_checked: list = field(default_factory=list)
    #: rows → {threads, rows_per_block, grid, smem, blocks_per_sm, limit}
    launches: dict = field(default_factory=dict)
    ptxas: dict | None = None
    card: dict | None = None
    violations: list = field(default_factory=list)


# ---------------------------------------------------------------------------
# C++ source helpers (enough of the language for csrc/)
# ---------------------------------------------------------------------------

def strip_comments(text: str) -> str:
    """`text` with // and /* */ comments blanked (newlines kept, so line
    numbers still hold); string and character literals are kept."""
    out, i, n = [], 0, len(text)
    while i < n:
        c = text[i]
        if text.startswith("//", i):
            j = text.find("\n", i)
            i = n if j < 0 else j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append(re.sub(r"[^\n]", " ", text[i:j]))
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and text[j] != c:
                j += 2 if text[j] == "\\" else 1
            out.append(text[i:j + 1])
            i = j + 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _match_brace(text: str, open_at: int) -> int:
    """Index one past the brace that closes the one at `open_at`."""
    depth = 0
    for j in range(open_at, len(text)):
        if text[j] == "{":
            depth += 1
        elif text[j] == "}":
            depth -= 1
            if depth == 0:
                return j + 1
    return len(text)


def device_regions(text: str) -> list[tuple[int, str]]:
    """(first line, text) of every ``__global__`` / ``__device__``
    function (its whole definition) and ``__constant__`` table of
    comment-stripped `text`."""
    out = []
    for m in re.finditer(r"\b(__global__|__device__|__constant__)\b", text):
        start = text.rfind("\n", 0, m.start()) + 1
        semi = text.find(";", m.end())
        brace = text.find("{", m.end())
        if brace < 0 or (0 <= semi < brace):
            end = semi + 1                      # a declaration
        elif "=" in text[m.end():brace] and "(" not in text[m.end():brace]:
            end = text.find(";", _match_brace(text, brace)) + 1   # a table
        else:
            end = _match_brace(text, brace)     # a function
        out.append((text.count("\n", 0, start) + 1, text[start:end]))
    return out


def function_body(text: str, name: str, kind: str = "__global__") -> str:
    """The definition of `kind` function `name` in comment-stripped
    `text` ("" if none)."""
    m = re.search(rf"\b{kind}\b[^;{{]*?\b{re.escape(name)}\s*\(", text)
    if m is None:
        return ""
    return text[m.start():_match_brace(text, text.find("{", m.end()))]


def extern_c_functions(text: str) -> dict[str, str]:
    """name → definition of every ``extern "C"`` function of `text`."""
    out = {}
    for m in re.finditer(r'extern\s+"C"[^;{]*?\b(\w+)\s*\(', text):
        brace = text.find("{", m.end())
        out[m.group(1)] = text[m.start():_match_brace(text, brace)]
    return out


def included(name: str, sources: dict[str, str]) -> list[str]:
    """The local headers source `name` includes, transitively, in order."""
    seen: list[str] = []

    def walk(n: str) -> None:
        for inc in _INCLUDE.findall(sources.get(n, "")):
            if inc in sources and inc not in seen:
                seen.append(inc)
                walk(inc)

    walk(name)
    return seen


def constants(text: str) -> dict[str, int]:
    return {k: int(v) for k, v in _CONST.findall(text)}


def read_csrc(root: Path = CSRC) -> dict[str, str]:
    """Every ``.cu`` / ``.cuh`` of csrc/, comments stripped."""
    return {p.name: strip_comments(p.read_text())
            for p in sorted(root.iterdir()) if p.suffix in (".cu", ".cuh")}


def global_instantiations(sources: dict[str, str]) -> dict[str, str]:
    """symbol → source of every ``__global__`` function of the ``.cu``
    files."""
    out = {}
    for name, text in sources.items():
        if name.endswith(".cu"):
            for m in _GLOBAL.finditer(text):
                out[m.group(1)] = name
    return out


# ---------------------------------------------------------------------------
# (a) source discipline
# ---------------------------------------------------------------------------

def discipline_violations(name: str, text: str) -> list[str]:
    """Floating point, console, heap, assertions and runtime calls in the
    device code of comment-stripped `text` (file `name`)."""
    out = []
    for line0, region in device_regions(text):
        for k, line in enumerate(region.splitlines()):
            where = f"csrc/{name}:{line0 + k}"
            for m in _TYPE.finditer(line):
                out.append(f"{where}: floating-point type "
                           f"'{m.group(0)}' in device code — the limb "
                           f"arithmetic is int32 only")
            for m in _FLOAT_LITERAL.finditer(line):
                out.append(f"{where}: floating-point literal "
                           f"'{m.group(0)}' in device code")
            for m in _CALL.finditer(line):
                if m.group(1) in FORBIDDEN_CALLS:
                    out.append(f"{where}: forbidden call "
                               f"{m.group(1)}() in device code "
                               f"(floating-point math, console, heap or "
                               f"assertion)")
            for m in _RUNTIME_CALL.finditer(line):
                out.append(f"{where}: runtime call "
                           f"{m.group(0).rstrip('( ')}() in device code")
            for m in _HEAP.finditer(line):
                out.append(f"{where}: '{m.group(1)}' in device code")
    return out


def audit_sources(sources: dict[str, str] | None = None) -> dict:
    """(a) over the registered kernels' sources → {file: [violations]}
    (each header once, whichever source includes it)."""
    sources = read_csrc() if sources is None else sources
    files: list[str] = []
    for spec in registry.kernels():
        src = Path(spec.source).name
        for f in [src] + included(src, sources):
            if f not in files:
                files.append(f)
    return {f: discipline_violations(f, sources.get(f, "")) for f in files}


# ---------------------------------------------------------------------------
# (b) launch arithmetic
# ---------------------------------------------------------------------------

def _split_args(s: str) -> list[str]:
    """Comma-separated arguments at parenthesis depth 0."""
    out, depth, cur = [], 0, ""
    for c in s:
        depth += (c in "([") - (c in ")]")
        if c == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += c
    out.append(cur.strip())
    return out


def launcher_of(spec: registry.KernelSpec, sources: dict[str, str]
                ) -> tuple[str, str]:
    """(launcher name, the text its launch lives in) of `spec`: the
    ``extern "C"`` function of its source that names the kernel — and,
    where that hands it to ``program::launch``, program.cuh's `launch`."""
    text = sources.get(Path(spec.source).name, "")
    for name, body in extern_c_functions(text).items():
        if name.endswith("_attrs") or not re.search(
                rf"\b{spec.symbol}\b", body):
            continue
        if "program::launch(" in body:
            lib = sources.get("program.cuh", "")
            m = re.search(r"\binline\s+int\s+launch\s*\(", lib)
            return name, lib[m.start():_match_brace(
                lib, lib.find("{", m.end()))] if m else ""
        return name, body
    return "", ""


def launch_configs(body: str) -> list[list[str]]:
    """The ``<<<grid, block, smem, stream>>>`` arguments of every launch
    in `body`, and a cooperative launch's as [grid, block, smem]."""
    out = [_split_args(m.group(1))
           for m in re.finditer(r"<<<(.*?)>>>", body, re.S)]
    for m in re.finditer(r"cudaLaunchCooperativeKernel\s*\((.*?)\)\s*;",
                         body, re.S):
        args = _split_args(m.group(1))
        out.append([args[1], args[2], args[4]])
    return out


def _resolve(expr: str, consts: dict[str, int]) -> int | None:
    expr = re.sub(r"\bdim3\s*\((\w+)\)", r"\1", expr.strip())
    if re.fullmatch(r"\d+", expr):
        return int(expr)
    return consts.get(expr)


_PROGRAM_BYTES = re.compile(
    r"\bbytes\s*=\s*rows\s*\*\s*(program::)?row_words\(slots\)\s*\*\s*"
    r"\(int\)sizeof\(int\)")
_PROGRAM_ROWS = re.compile(r"\brows\s*=\s*WARP\s*/\s*lanes\b")
_CEIL = re.compile(r"^\(\s*n\s*\+\s*(\w+)\s*-\s*1\s*\)\s*/\s*(\w+)$")


def _kernel_source(spec: registry.KernelSpec, sources: dict
                   ) -> tuple[str, dict, int | None]:
    """`spec`'s ``__global__`` definition, the int constants its source
    and headers define, and its ``__launch_bounds__`` threads (None where
    the audit cannot resolve them)."""
    src = Path(spec.source).name
    consts: dict = {}
    for f in included(src, sources) + [src]:
        consts.update(constants(sources.get(f, "")))
    body = function_body(sources.get(src, ""), spec.symbol)
    bound = _LAUNCH_BOUNDS.search(body[:body.find("{")]) if body else None
    return body, consts, _resolve(bound.group(1), consts) if bound else None


def audit_launch(spec: registry.KernelSpec, rows_list, sources: dict,
                 regs: int, sms: int, audit: KernelAudit,
                 static_smem: int = 0) -> None:
    """(b) for `spec` at every row count of `rows_list`, `regs` registers
    a thread and `static_smem` bytes of static shared memory a block (the
    compiler's, else the budget's and none), on `sms` SMs."""
    from ..ops import smem_budget as sb

    body, consts, bound_threads = _kernel_source(spec, sources)
    if not body:
        audit.violations.append(f"{spec.name}: no __global__ "
                                f"{spec.symbol} in {spec.source}")
        return
    if bound_threads is None:
        audit.violations.append(f"{spec.name}: no __launch_bounds__ the "
                                f"audit can resolve")
    guard_text = body
    if "run<" in body or "program::run" in body:
        guard_text += function_body(sources.get("program.cuh", ""), "run",
                                    "__device__")
    guarded = bool(_GUARD.search(guard_text))
    launcher, ltext = launcher_of(spec, sources)
    configs = launch_configs(ltext)
    if not configs:
        audit.violations.append(f"{spec.name}: no launch of it found in "
                                f"{spec.source}'s launchers")
    smem_args = {c[2] for c in configs if len(c) > 2}
    program = bool(_PROGRAM_BYTES.search(ltext)) and bool(
        _PROGRAM_ROWS.search(ltext))

    for rows in sorted(set(rows_list)):
        g = spec.geometry(rows, sms)
        where = f"{spec.name} at {rows} rows"
        if bound_threads is not None and g.threads > bound_threads:
            audit.violations.append(
                f"{where}: {g.threads} threads a block exceed its "
                f"__launch_bounds__({bound_threads})")
        for c in configs:
            block = _resolve(c[1], consts)
            if block is not None and block != g.threads:
                audit.violations.append(
                    f"{where}: {launcher} launches {block} threads a "
                    f"block, the spec {g.threads}")
        # the shared memory the launcher passes against the model
        if g.lanes:
            model = sb.program_smem_bytes(g.lanes, g.slots)
            if not program or smem_args != {"bytes"}:
                audit.violations.append(
                    f"{where}: {launcher} does not size its shared memory "
                    f"as rows × row_words(slots) (the model)")
        else:
            model = 0
            if smem_args - {"0"}:
                audit.violations.append(
                    f"{where}: {launcher} passes shared memory "
                    f"{sorted(smem_args)}, the model none")
        if g.smem != model:
            audit.violations.append(
                f"{where}: the launch passes {g.smem} B of shared memory a "
                f"block, the smem_budget model {model} B")
        if g.smem + static_smem > sb.SMEM_PER_BLOCK_MAX:
            audit.violations.append(
                f"{where}: {g.smem + static_smem} B of shared memory a "
                f"block exceed the {sb.SMEM_PER_BLOCK_MAX} B a block may "
                f"use")
        occ = sb.blocks_per_sm(regs, g.threads, g.smem, static_smem)
        if occ["blocks"] < 1:
            audit.violations.append(
                f"{where}: no block fits an SM ({occ})")
        if spec.cooperative:
            grid = sb.cooperative_grid(rows, occ["blocks"], sms)
            if rows & (rows - 1):
                audit.violations.append(
                    f"{where}: the cooperative fold takes a power of two "
                    f"rows")
            if grid > sms * occ["blocks"]:
                audit.violations.append(
                    f"{where}: cooperative grid {grid} exceeds {sms} SMs × "
                    f"{occ['blocks']} co-resident blocks")
        else:
            grid = -(-rows // g.rows)
            if grid * g.rows < rows:
                audit.violations.append(
                    f"{where}: grid {grid} × {g.rows} rows a block does "
                    f"not cover the rows")
            if not spec.tail and g.rows != 1:
                audit.violations.append(
                    f"{where}: declared tail-free but a block covers "
                    f"{g.rows} rows")
            if grid * g.rows > rows and spec.tail and not guarded:
                audit.violations.append(
                    f"{where}: {grid * g.rows - rows} rows past the last "
                    f"run unguarded (no `r >= n` / `r < n` test in "
                    f"{spec.symbol})")
            for c in configs:
                m = _CEIL.match(c[0])
                if m and m.group(1) == m.group(2):
                    per = (g.rows if m.group(1) == "rows" and program
                           else _resolve(m.group(1), consts))
                elif c[0] == "n":
                    per = 1
                elif c[0] in ("grid", "grid_of(n)") \
                        or c[0].startswith("grid_of(n, "):
                    per = _resolve(c[0][len("grid_of(n, "):-1], consts) \
                        if c[0].startswith("grid_of(n, ") else g.rows
                else:
                    per = None
                if per != g.rows:
                    audit.violations.append(
                        f"{where}: {launcher}'s grid {c[0]!r} is not the "
                        f"rows over the spec's {g.rows} rows a block")
        if grid >= 2 ** 31:
            audit.violations.append(f"{where}: grid {grid} exceeds 2^31 − 1")
        audit.launches[rows] = {
            "threads": g.threads, "rows_per_block": g.rows, "grid": grid,
            "smem": g.smem, "lanes": g.lanes, "slots": g.slots,
            "blocks_per_sm": occ["blocks"], "limit": occ["limit"]}


# ---------------------------------------------------------------------------
# (c) the compiler's report
# ---------------------------------------------------------------------------

def audit_ptxas(spec: registry.KernelSpec, row: dict | None,
                audit: KernelAudit, bound_threads: int | None) -> None:
    """(c) for `spec` against its row of the -Xptxas -v report."""
    from ..ops import smem_budget as sb

    if row is None:
        audit.violations.append(f"{spec.name}: registered but not in the "
                                f"compiler's report")
        return
    audit.ptxas = dict(row)
    regs, stack, spill = spec.budget
    if row["regs"] > sb.REGS_PER_THREAD_MAX:
        audit.violations.append(f"{spec.name}: {row['regs']} registers "
                                f"exceed {sb.REGS_PER_THREAD_MAX}")
    if bound_threads and row["regs"] * _round32(bound_threads) \
            > sb.REGS_PER_BLOCK:
        audit.violations.append(
            f"{spec.name}: {row['regs']} registers × {bound_threads} "
            f"threads exceed a block's {sb.REGS_PER_BLOCK}")
    for what, got, cap in (("registers", row["regs"], regs),
                           ("stack bytes", row["stack"], stack),
                           ("spill bytes", row["spill"], spill)):
        if got > cap:
            audit.violations.append(
                f"{spec.name}: {got} {what} over its budget of {cap} — "
                f"the kernel grew; change the spec with a reason, or "
                f"the kernel back")


def _round32(n: int) -> int:
    return -(-n // 32) * 32


def unregistered_rows(rows: list[dict]) -> list[str]:
    """Violations for report rows of the package's sources that no spec
    names."""
    from ..ops import build

    ours = {f"{Path(s).stem}.cu" for s in build.SOURCES}
    names = {s.name for s in registry.kernels()}
    return [f"{r['name']}: in the compiler's report but not registered"
            for r in rows
            if r["name"].split()[0] in ours and r["name"] not in names]


def unregistered_globals(sources: dict[str, str]) -> list[str]:
    """``__global__`` functions of csrc/ that no spec names."""
    symbols = {s.symbol for s in registry.kernels()}
    return [f"csrc/{src}: __global__ {sym} is not registered"
            for sym, src in sorted(global_instantiations(sources).items())
            if sym not in symbols]


# ---------------------------------------------------------------------------
# (d) the card's figures
# ---------------------------------------------------------------------------

def audit_card(spec: registry.KernelSpec, rows: int, sms: int,
               audit: KernelAudit) -> dict:
    """(d) for `spec` at its geometry for `rows` rows: the runtime's
    figures against the compiler's report (`audit.ptxas`) and the
    occupancy model → the figures (shared memory a block, blocks an SM)."""
    from ..ops import build
    from ..ops import smem_budget as sb

    g = spec.geometry(rows, sms)
    attrs = build.kernel_attrs(Path(spec.source).stem, spec.attr_index,
                               g.threads, g.smem)
    row = audit.ptxas or {}
    model = sb.blocks_per_sm(row.get("regs", attrs["regs"]), g.threads,
                             g.smem, attrs["static_smem"])
    card = {"rows": rows, "threads": g.threads,
            "smem_block": g.smem + attrs["static_smem"],
            **attrs, "model_blocks_per_sm": model["blocks"],
            "limit": model["limit"]}
    audit.card = card
    where = f"{spec.name} on the card"
    for what, key, want in (("registers", "regs", row.get("regs")),
                            ("local bytes", "local_bytes", row.get("stack")),
                            ("static shared bytes", "static_smem",
                             row.get("smem"))):
        if want is not None and attrs[key] != want:
            audit.violations.append(
                f"{where}: {what} {attrs[key]}, the compiler's report "
                f"{want}")
    if attrs["max_threads"] < g.threads:
        audit.violations.append(
            f"{where}: takes at most {attrs['max_threads']} threads a "
            f"block, launched with {g.threads}")
    if g.smem + attrs["static_smem"] > sb.SMEM_PER_BLOCK_MAX:
        audit.violations.append(
            f"{where}: {g.smem + attrs['static_smem']} B of shared memory "
            f"a block exceed {sb.SMEM_PER_BLOCK_MAX} B")
    if attrs["blocks_per_sm"] != model["blocks"]:
        audit.violations.append(
            f"{where}: the card holds {attrs['blocks_per_sm']} blocks an "
            f"SM at {g.threads} threads and {g.smem} B, the model "
            f"{model['blocks']} ({model['limit']})")
    if attrs["blocks_per_sm"] < 1:
        audit.violations.append(f"{where}: no block fits an SM")
    if spec.cooperative:
        grid = sb.cooperative_grid(rows, attrs["blocks_per_sm"], sms)
        card["grid"] = grid
        if grid > sms * attrs["blocks_per_sm"]:
            audit.violations.append(
                f"{where}: cooperative grid {grid} exceeds {sms} SMs × "
                f"{attrs['blocks_per_sm']} co-resident blocks")
    if g.lanes and build.row_words(g.slots) != sb.row_words(g.slots):
        audit.violations.append(
            f"{where}: program.cuh's row_words({g.slots}) = "
            f"{build.row_words(g.slots)}, the model's "
            f"{sb.row_words(g.slots)}")
    return card


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

#: rows a kernel that no registered shape names is checked at (the
#: kernels phase's: one row, a verify tile's Miller rows)
DEFAULT_ROWS = (1, 4096)


def shape_rows() -> dict[str, list[tuple[str, int]]]:
    """spec name → [(shape name, rows)] over the registered shapes."""
    out: dict[str, list] = {}
    for shape in registry.workload_shapes():
        for name, rows in shape.rows:
            out.setdefault(name, []).append((shape.name, rows))
    return out


def run_kernel_audit(ptxas_log: str | None = None,
                     sources: dict[str, str] | None = None,
                     sms: int | None = None) -> tuple[list, list]:
    """(a)–(c) over every registered kernel → (their `KernelAudit`s,
    violations of the sources and of the report as a whole).  `ptxas_log`
    is a -Xptxas -v log's text (None: (c) is skipped); `sms` the card's
    SMs (default H100's)."""
    from ..ops import build
    from ..ops import smem_budget as sb

    registry.ensure_populated()
    sources = read_csrc() if sources is None else sources
    sms = sms or sb.SMS
    general = [v for vs in audit_sources(sources).values() for v in vs]
    general += unregistered_globals(sources)
    report = None
    if ptxas_log is not None:
        rows = build.ptxas_rows(ptxas_log)
        report = {r["name"]: r for r in rows}
        general += unregistered_rows(rows)
    by_spec = shape_rows()
    audits = []
    for spec in registry.kernels():
        audit = KernelAudit(name=spec.name, source=spec.source,
                            launch=spec.launch)
        shapes = by_spec.get(spec.name) or [("kernels phase", r)
                                            for r in DEFAULT_ROWS]
        audit.shapes_checked = [f"{n} ({r} rows)" for n, r in shapes]
        bound_threads = _kernel_source(spec, sources)[2]
        regs, static_smem = spec.budget[0], 0
        if report is not None:
            audit_ptxas(spec, report.get(spec.name), audit, bound_threads)
            row = report.get(spec.name) or {}
            regs = row.get("regs", regs)
            static_smem = row.get("smem", 0)
        audit_launch(spec, [r for _, r in shapes], sources, regs, sms, audit,
                     static_smem)
        audits.append(audit)
    return audits, general
