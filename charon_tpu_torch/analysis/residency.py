"""Residency pass — the counterpart of the JAX package's "the whole chain
traces into ONE jaxpr": the resident verify tile must capture as ONE
CUDA graph that holds its kernels in order, with no host round trip
between them.  On the card only.

The resident route (`tbls/backend_cuda._VerifyGraph`) replays one
captured graph per padded bucket: K12, K20, K15, K13, K14 and K11 with
the live mask and drop row computed on the card in between.  A host
round trip inside — a ``.item()``, a ``.cpu()``, a synchronising copy —
fails the capture itself (a capture in thread-local mode refuses a
synchronising call), so the pass captures each registered bucket through
the backend's own `capture` and checks:

- the capture succeeds (its failure IS the finding, reported against the
  registered stage chain);
- the launches the wrappers recorded inside it are exactly the
  registered stages, in order (`launch_count.capture`);
- where torch keeps the graph's handle (``CUDAGraph(keep_graph=True)``,
  ``raw_cuda_graph()``), its nodes, read with libcuda's
  ``cuGraphGetNodes`` / ``cuGraphNodeGetType`` / ``cuGraphGetEdges``
  through ctypes, hold no host node, and its kernel nodes in dependency
  order name the stages' kernels in the same order
  (``cuGraphKernelNodeGetParams`` → ``cuFuncGetName``).

A golden-bad fixture (`fixtures.resident_roundtrip_spec`, the
``contract`` phase of chip_smoke.py) pins detection: a tile that reads
an intermediate back between two stages must be flagged.
"""

from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass, field

from . import registry

#: CUgraphNodeType values (cuda.h)
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
              4: "graph", 5: "empty", 6: "wait_event", 7: "event_record",
              8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
              11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)."""

    _fields_ = [("func", ctypes.c_void_p),
                ("gridDimX", ctypes.c_uint), ("gridDimY", ctypes.c_uint),
                ("gridDimZ", ctypes.c_uint), ("blockDimX", ctypes.c_uint),
                ("blockDimY", ctypes.c_uint), ("blockDimZ", ctypes.c_uint),
                ("sharedMemBytes", ctypes.c_uint),
                ("kernelParams", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


@dataclass
class ResidencyAudit:
    """Result of capturing one bucket."""

    name: str
    v: int
    stages: tuple = ()
    launches: list = field(default_factory=list)
    #: node type → count, and the kernel nodes' names in dependency order
    #: (None where the graph's handle or libcuda's names are missing)
    nodes: dict | None = None
    kernel_nodes: list | None = None
    capture_seconds: float | None = None
    violations: list = field(default_factory=list)


def _libcuda():
    lib = ctypes.CDLL("libcuda.so.1")
    p, sz = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
    lib.cuGraphGetNodes.argtypes = [p, p, sz]
    lib.cuGraphGetEdges.argtypes = [p, p, p, sz]
    lib.cuGraphNodeGetType.argtypes = [p, ctypes.POINTER(ctypes.c_int)]
    lib.cuGraphKernelNodeGetParams_v2.argtypes = [
        p, ctypes.POINTER(_KernelNodeParams)]
    lib.cuFuncGetName.argtypes = [ctypes.POINTER(ctypes.c_char_p), p]
    if hasattr(lib, "cuKernelGetName"):
        lib.cuKernelGetName.argtypes = [ctypes.POINTER(ctypes.c_char_p), p]
    return lib


def graph_nodes(handle: int) -> tuple[dict, list]:
    """The nodes of the CUDA graph `handle` (a ``cudaGraph_t``) → (node
    type → count, [each kernel node's mangled name, in dependency
    order; None where libcuda gives none])."""
    lib = _libcuda()
    n = ctypes.c_size_t(0)
    if lib.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if lib.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    order = {nodes[i]: i for i in range(n.value)}
    e = ctypes.c_size_t(0)
    lib.cuGraphGetEdges(handle, None, None, ctypes.byref(e))
    src = (ctypes.c_void_p * max(e.value, 1))()
    dst = (ctypes.c_void_p * max(e.value, 1))()
    if e.value and lib.cuGraphGetEdges(handle, src, dst, ctypes.byref(e)):
        raise RuntimeError("cuGraphGetEdges failed")
    deps = {i: 0 for i in range(n.value)}
    succ: dict[int, list] = {i: [] for i in range(n.value)}
    for k in range(e.value):
        a, b = order[src[k]], order[dst[k]]
        succ[a].append(b)
        deps[b] += 1
    # Kahn's algorithm, ties broken by cuGraphGetNodes's order
    ready = sorted(i for i, d in deps.items() if d == 0)
    topo = []
    while ready:
        i = ready.pop(0)
        topo.append(i)
        for j in succ[i]:
            deps[j] -= 1
            if deps[j] == 0:
                ready.append(j)
                ready.sort()
    counts: dict[str, int] = {}
    kernels = []
    for i in topo:
        t = ctypes.c_int(-1)
        lib.cuGraphNodeGetType(nodes[i], ctypes.byref(t))
        kind = NODE_TYPES.get(t.value, str(t.value))
        counts[kind] = counts.get(kind, 0) + 1
        if kind != "kernel":
            continue
        params = _KernelNodeParams()
        name = ctypes.c_char_p()
        if lib.cuGraphKernelNodeGetParams_v2(nodes[i], ctypes.byref(params)):
            kernels.append(None)
        elif params.func and not lib.cuFuncGetName(ctypes.byref(name),
                                                   params.func):
            kernels.append(name.value.decode())
        elif params.kern and hasattr(lib, "cuKernelGetName") \
                and not lib.cuKernelGetName(ctypes.byref(name), params.kern):
            kernels.append(name.value.decode())
        else:
            kernels.append(None)
    return counts, kernels


def audit_residency_case(spec: registry.ResidencyProgramSpec, v: int,
                         device) -> ResidencyAudit:
    """Capture bucket `v` of `spec` on `device` and check the contract."""
    import torch

    from ..ops import build

    audit = ResidencyAudit(name=f"{spec.name}[v={v}]", v=v,
                           stages=tuple(spec.stages))
    bucket = spec.build(v, device)
    t0 = time.perf_counter()
    try:
        bucket.capture(keep_graph=True)
    except Exception as exc:  # noqa: BLE001 — the failure IS the finding
        torch.cuda.synchronize(device)
        audit.violations.append(
            f"{audit.name}: the tile does not capture as one graph — a "
            f"host round trip (or another capture error) between the "
            f"stages {audit.stages}: {type(exc).__name__}: "
            f"{str(exc).splitlines()[0] if str(exc) else ''}")
        return audit
    audit.capture_seconds = round(time.perf_counter() - t0, 4)
    audit.launches = [name for _, name in bucket.launches]
    if tuple(audit.launches) != audit.stages:
        audit.violations.append(
            f"{audit.name}: the capture launched {audit.launches}, the "
            f"registered stages are {list(audit.stages)}")
    graph = bucket.graph
    if graph is None or not hasattr(graph, "raw_cuda_graph"):
        return audit
    audit.nodes, names = graph_nodes(graph.raw_cuda_graph())
    specs = {s.name: s.launch for s in registry.kernels()}
    audit.kernel_nodes = [build.kernel_name(n) if n else None
                          for n in names]
    if audit.nodes.get("host"):
        audit.violations.append(
            f"{audit.name}: {audit.nodes['host']} host node(s) inside the "
            f"captured graph")
    if None not in names:
        ours = [specs[k] for k in audit.kernel_nodes if k in specs]
        if tuple(ours) != audit.stages:
            audit.violations.append(
                f"{audit.name}: the graph's kernel nodes name "
                f"{ours}, the registered stages are {list(audit.stages)}")
    return audit


def run_residency_audit(device=None, cases=None) -> list:
    """The pass over every registered residency program (on the card)."""
    import torch

    registry.ensure_populated()
    device = device or torch.device("cuda", torch.cuda.current_device())
    out = []
    for spec in registry.residency_programs():
        for v in (cases if cases is not None else spec.cases):
            out.append(audit_residency_case(spec, v, device))
    return out
