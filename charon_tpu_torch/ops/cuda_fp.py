"""Kernel K1 — the Fp ring ops on the card (csrc/fp_ops.cu).

The counterpart of the JAX package's ops/pallas_fp.py (`_mul_kernel`,
`_add_kernel`, `_sub_kernel`, `_neg_kernel`, `_small_kernel_factory`).
One thread per Fp row reads its 32 limbs of each operand, runs the whole
convolution / carry / fold schedule of ops/fp.py in registers and writes
the 32 reduced limbs: bit-identical to the plain versions `fp.*_plain`.

No flush and no combine launches K1: the kernels that produce the
operands hold their exact boundaries.  The re-check of a rejected tile
negates its unscaled p-side here, and the smoke run holds K1 against its
plain versions.  Every wrapper takes contiguous int32 tensors ``[..., 32, R]`` of one
shape.  A CPU tensor goes to the plain version; a CUDA tensor launches
the kernel on the current stream, or raises.  `LAUNCHES` counts kernel
launches per op (plain-version calls are not counted).
"""

from __future__ import annotations

import torch

from . import build, launch_count
from . import fp as _fp

OPS = {"fp_mul": 0, "fp_add": 1, "fp_sub": 2, "fp_neg": 3, "fp_mul_small": 4}

#: kernel launches per op since the last `reset_launches()` (all threads;
#: `launch_count.this_thread()` has the calling thread's own)
LAUNCHES = {name: 0 for name in OPS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, *ts: torch.Tensor) -> None:
    a = ts[0]
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: int32 limbs expected, got {t.dtype}")
        if t.device != a.device or t.shape != a.shape:
            raise ValueError(f"{name}: operands differ in device or shape "
                             f"({t.device} {tuple(t.shape)} vs "
                             f"{a.device} {tuple(a.shape)})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if a.dim() < 2 or a.shape[-2] != _fp.NLIMBS or a.numel() == 0:
        raise ValueError(f"{name}: expected [..., 32, R], got {tuple(a.shape)}")
    if a.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {a.numel()} limbs exceed the int index")


def _launch(name: str, a: torch.Tensor, b: torch.Tensor | None,
            k: int = 0) -> torch.Tensor:
    _check(name, *((a,) if b is None else (a, b)))
    if a.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a.device}")
    if a.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensor on {a.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    lib = build.library()
    out = torch.empty_like(a)
    r = a.shape[-1]
    rows = a.numel() // _fp.NLIMBS
    err = lib.charon_fp_op(
        OPS[name], k, out.data_ptr(), a.data_ptr(),
        0 if b is None else b.data_ptr(), rows, r,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    launch_count.bump(LAUNCHES, name)
    return out


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return _fp.mul_plain(a, b)
    return _launch("fp_mul", a, b)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return _fp.add_plain(a, b)
    return _launch("fp_add", a, b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return _fp.sub_plain(a, b)
    return _launch("fp_sub", a, b)


def neg(a: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return _fp.neg_plain(a)
    return _launch("fp_neg", a, None)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    if not 1 <= k <= 16:
        raise ValueError(f"fp_mul_small: k={k} outside 1..16")
    if a.device.type == "cpu":
        return _fp.mul_small_plain(a, k)
    return _launch("fp_mul_small", a, None, k)
