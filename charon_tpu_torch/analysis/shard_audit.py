"""Shard audit — the shard pass of the kernel contract checks, the
counterpart of the JAX package's analysis/shard_audit.py.

The JAX pass re-traces each shard_map program and checks its loop carries:
a carry whose init is a replicated constant while the body's output
varies over the mesh (the round-5 carry mismatch) is a value made once
and shared by every device.  The port has no trace: its sharded program
is a host loop that runs each shard on its own device and stream
(`tbls/backend_cuda.straus_combine_sharded`).  What goes wrong there is
the same kind of thing in the port's terms — state one shard makes and
another reads — and this pass checks for it, for every registered
program (`registry.ShardProgramSpec`) at n shards:

(a) **The plan.**  At every registered (V, T): each shard's v_local is a
    positive multiple of the granularity, the shards' real validators
    are [0, V) in order, each at most v_local (so Σ v_local ≥ V); and
    each shard's K22 and K16 rows pass the kernel audit's launch
    arithmetic (`kernel_audit.audit_launch`).  At the small case, every
    shard's padded inputs hold its own validators, then ∞ points with
    zero digits.
(b) **Isolation.**  The program runs once at the small case under a
    recorder (`ShardRecorder`, a ``TorchDispatchMode``) that tags every
    tensor an op makes with the shard that made it: no op of shard j may
    read a tensor made by shard i ≠ j, and every operand of shard j's ops
    lies on shard j's device — except the copy that brings the shard its
    slice of the global input, which no shard made.  What is made before
    any shard (the fold constants, the programs: `spec.prime`) carries no
    tag.  On the CPU every shard's device is ``cpu`` and the tags alone
    tell them apart.

The golden-bad `replicated_carry` (analysis/fixtures.py) is the r05 carry
in these terms: one padding block made by shard 0 and reused by the
others.  On the card the recorder sees the torch operations around each
launch (each wrapper's checks, allocations and repacks), not the kernel's
own loads: `cuda_g2._cuda_ready` refuses an operand off the current
device there.
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import registry

#: the ops that may read a tensor off the shard's device: the copy of the
#: shard's slice of the global input (an operand no shard made)
TRANSFER_OPS = ("aten._to_copy.default", "aten.copy_.default")


def _tensors(obj):
    """The tensors of an op's arguments or results (flat, or in a list or
    tuple: the forms aten ops take and give)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            if isinstance(x, torch.Tensor):
                yield x
            elif isinstance(x, (list, tuple)):
                yield from _tensors(x)


@dataclass
class ShardCaseAudit:
    name: str
    devices: list
    plans_checked: int = 0
    #: ops the recorder saw a shard run, by shard
    ops: dict = field(default_factory=dict)
    violations: list = field(default_factory=list)


class ShardRecorder(TorchDispatchMode):
    """Tags each tensor an op makes with the shard in scope (None outside
    every shard) and, inside shard j, records a violation for an operand
    made by another shard or lying off shard j's device."""

    def __init__(self):
        super().__init__()
        self.shard: int | None = None
        self.device: torch.device | None = None
        self.ops: dict[int, int] = {}
        self.violations: list[str] = []
        self._tags: dict[int, tuple] = {}

    @contextlib.contextmanager
    def scope(self, j: int, device: torch.device):
        """Shard j's work (`ShardProgramSpec.run`'s scope)."""
        prev = self.shard, self.device
        self.shard, self.device = j, torch.device(device)
        self.ops.setdefault(j, 0)
        try:
            yield
        finally:
            self.shard, self.device = prev

    def _tag(self, t: torch.Tensor):
        for x in (t, t._base):
            e = self._tags.get(id(x)) if x is not None else None
            if e is not None and e[0]() is x:
                return e[1]
        return None

    def _note(self, msg: str) -> None:
        if msg not in self.violations:
            self.violations.append(msg)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        j = self.shard
        if j is not None:
            self.ops[j] += 1
            name = str(func)
            for t in _tensors((args, tuple(kwargs.values()))):
                tag = self._tag(t)
                if tag is not None and tag != j:
                    self._note(f"shard {j}: {name} reads a tensor made by "
                               f"shard {tag} — state carried from one "
                               f"shard to another")
                if t.device != self.device and not (
                        (name in TRANSFER_OPS and tag is None)
                        or (t.dim() == 0 and t.device.type == "cpu")):
                    self._note(f"shard {j}: {name} has an operand on "
                               f"{t.device}, the shard runs on "
                               f"{self.device}")
        out = func(*args, **kwargs)
        for t in _tensors(out):
            if j is None:
                self._tags.pop(id(t), None)
            else:
                self._tags[id(t)] = (weakref.ref(t), j)
        return out


def small_inputs(v: int, t: int, nwin: int, device, seed: int = 0):
    """Seeded points [3, 2, 32, v, t] (12-bit limbs, valid redundant
    residues) and balanced base-8 digits [nwin, v, t] on `device`."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 1 << 12, (3, 2, 32, v, t), dtype=np.int32)
    digits = rng.integers(-4, 4, (nwin, v, t), dtype=np.int32)
    return (torch.from_numpy(pts).to(device),
            torch.from_numpy(digits).to(device))


def check_plan(spec: registry.ShardProgramSpec, devices, audit: ShardCaseAudit,
               sms: int | None = None, sources: dict | None = None) -> None:
    """(a) at every (V, T) of `spec.cases`: the split and each shard's
    launch arithmetic."""
    from ..ops import smem_budget as sb
    from . import kernel_audit

    sources = kernel_audit.read_csrc() if sources is None else sources
    specs = {k.name: k for k in registry.kernels()}
    n = len(devices)
    for v, t in spec.cases:
        where = f"{spec.name}[v={v}, t={t}, n={n}]"
        v_local, spans = spec.plan(v, t, devices)
        gran = spec.plan(1, t, devices[:1])[0]
        if v_local < gran or v_local % gran:
            audit.violations.append(f"{where}: v_local {v_local} is not a "
                                    f"positive multiple of {gran}")
        if len(spans) != n or spans[0][0] != 0 or spans[-1][1] != v or any(
                a[1] != b[0] for a, b in zip(spans, spans[1:])) or any(
                not 0 <= hi - lo <= v_local for lo, hi in spans):
            audit.violations.append(f"{where}: the shards' validators "
                                    f"{spans} are not [0, {v}) in order, "
                                    f"at most {v_local} a shard")
        for name, rows in spec.rows(v_local, t).items():
            k = specs.get(name)
            if k is None:
                audit.violations.append(f"{where}: {name} is not a "
                                        f"registered kernel")
                continue
            ka = kernel_audit.KernelAudit(name=k.name, source=k.source,
                                          launch=k.launch)
            kernel_audit.audit_launch(k, [rows], sources, k.budget[0],
                                      sms or sb.SMS, ka)
            audit.violations += [f"{where}: {x}" for x in ka.violations]
        audit.plans_checked += 1


def check_pads(spec: registry.ShardProgramSpec, devices, pts, digits,
               audit: ShardCaseAudit) -> None:
    """(a) at the small case: each shard's padded inputs."""
    v, t = pts.shape[-2:]
    v_local, spans = spec.plan(v, t, devices)
    for j, (d, (lo, hi)) in enumerate(zip(devices, spans)):
        p, dg = spec.shard_inputs(pts[..., lo:hi, :], digits[:, lo:hi, :],
                                  v_local, d)
        n = hi - lo
        p, dg, inf = (p.cpu(), dg.cpu(),
                      spec.shard_inputs(pts[..., :0, :], digits[:, :0, :],
                                        1, "cpu")[0])
        where = f"{spec.name} shard {j}"
        if tuple(p.shape[-2:]) != (v_local, t) or not torch.equal(
                p[..., :n, :], pts[..., lo:hi, :].cpu()) or not torch.equal(
                dg[:, :n, :], digits[:, lo:hi, :].cpu()):
            audit.violations.append(f"{where}: its inputs are not its "
                                    f"validators [{lo}, {hi}) in front")
        if not torch.equal(p[..., n:, :],
                           inf.expand(*inf.shape[:3], v_local - n, t)) \
                or bool(dg[:, n:, :].any()):
            audit.violations.append(f"{where}: a pad row is not ∞ with "
                                    f"zero digits")


def check_isolation(spec: registry.ShardProgramSpec, devices,
                    audit: ShardCaseAudit, pts, digits) -> torch.Tensor:
    """(b) one run at the small case under the recorder → its output."""
    t, nwin = spec.small
    spec.prime(t, nwin, devices)
    rec = ShardRecorder()
    with rec:
        out = spec.run(pts, digits, devices, scope=rec.scope)
    audit.ops = dict(rec.ops)
    audit.violations += [f"{spec.name}: {x}" for x in rec.violations]
    v_local, spans = spec.plan(pts.shape[-2], t, devices)
    for j, (lo, hi) in enumerate(spans):
        if hi > lo and not rec.ops.get(j):
            audit.violations.append(f"{spec.name}: the recorder saw no op "
                                    f"of shard {j}")
    return out


def audit_shard_program(spec: registry.ShardProgramSpec, devices,
                        sms: int | None = None,
                        sources: dict | None = None) -> ShardCaseAudit:
    """(a) and (b) for one program at len(devices) shards."""
    devices = [torch.device(d) for d in devices]
    audit = ShardCaseAudit(
        name=f"{spec.name}[n={len(devices)}]",
        devices=[str(d) for d in devices])
    check_plan(spec, devices, audit, sms, sources)
    # the small case: every shard but the last full, the last one partial
    t, nwin = spec.small
    v_local, _ = spec.plan(1, t, devices[:1])
    v = (len(devices) - 1) * v_local + 1
    pts, digits = small_inputs(v, t, nwin, devices[0])
    check_pads(spec, devices, pts, digits, audit)
    try:
        out = check_isolation(spec, devices, audit, pts, digits)
    except Exception as exc:  # noqa: BLE001 — a failed run is a finding
        audit.violations.append(f"{spec.name}: the run failed: "
                                f"{type(exc).__name__}: {exc}")
        return audit
    if tuple(out.shape) != (3, 2, 32, v) or out.device != devices[0]:
        audit.violations.append(f"{spec.name}: output {tuple(out.shape)} on "
                                f"{out.device}, not [3, 2, 32, {v}] on "
                                f"{devices[0]}")
    return audit
