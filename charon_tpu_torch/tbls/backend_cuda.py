"""CUDA tbls backend: the threshold-combine path on the card.

The counterpart of the JAX package's TPU backend for slice 1 (its fused
Straus bytes path).  `threshold_combine_bytes` is the composition of two
stages, so the dispatch pipeline can overlap batch k+1's host prep with
batch k's device work:

- `combine_host_prep` (host): split the 96-byte signatures into 12-bit
  limb planes (vectorised numpy), reject malformed encodings, look up the
  per-index-set Lagrange digit rows, lay rows out T-MAJOR (row =
  t·Vpad + v) with validators padded to a multiple of `ROW_TILE`.
- `combine_device_exec` (card): decompress (Fp2 square roots + ψ
  subgroup check, kernel K1), the Straus tables (K2) and window loop
  (K3), normalisation (K1), then the host compresses the affine points.

A failed launch raises; there is no fallback path.  The device stages
synchronise at their boundaries and record their seconds in
`last_stages` and each kernel's launches in `last_launches` (the smoke
run's per-stage breakdown).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import dispatch, shamir
from ..ops import codec, cuda_fp, cuda_g2
from ..ops import curve as tcurve

_G2_INF_BYTES = np.zeros(96, np.uint8)
_G2_INF_BYTES[0] = 0xC0

#: balanced base-8 digits of a 256-bit scalar: ⌈258/3⌉ + 1 carry digit
STRAUS_NWIN = 87

#: validators pad to a multiple of this (10,000 → 10,240, the JAX fused
#: path's padding)
ROW_TILE = 1024

# Lagrange digit rows cached per share-index set: within a slot every
# validator aggregates the same share indices.
_LAG_DIGITS: dict[tuple[int, ...], np.ndarray] = {}


def _lagrange_digits(idxs: tuple[int, ...]) -> np.ndarray:
    """Balanced base-8 digit rows [t, 87] of the Lagrange coefficients."""
    out = _LAG_DIGITS.get(idxs)
    if out is None:
        lam = shamir.lagrange_coeffs_at_zero(list(idxs))
        bits = tcurve.scalars_to_bits([lam[i] for i in idxs])
        out = cuda_g2.signed_digit_rows(bits)
        _LAG_DIGITS[idxs] = out
    return out


class CUDABackend:
    """Batched device backend for the tbls API (api.register_backend)."""

    name = "cuda"

    def __init__(self, device=None):
        """`device` defaults to the current CUDA device and raises when
        there is none: the CPU runs only when asked for (``"cpu"``), and
        then every kernel wrapper takes its plain version."""
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CUDABackend: no CUDA device is available (pass "
                    "device='cpu' to run the plain versions on the CPU)")
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = torch.device(device)
        #: seconds per device stage of the last combine
        self.last_stages: dict[str, float] = {}
        #: kernel launches per device stage of the last combine
        self.last_launches: dict[str, dict[str, int]] = {}

    # -- attribution --------------------------------------------------------

    def combine_path(self) -> str:
        return "straus"

    def combine_padded_rows(self, v: int, t: int) -> int:
        """Validator rows a combine launches (padded to `ROW_TILE`)."""
        return -(-v // ROW_TILE) * ROW_TILE

    # -- verification comes with slice 2 -----------------------------------

    def batch_verify(self, entries) -> list[bool]:
        raise NotImplementedError(
            "batch verification on the CUDA backend comes with slice 2 (the "
            "pairing kernels); use the cpu backend")

    # -- aggregation --------------------------------------------------------

    def combine_host_prep(self, batch) -> dict:
        """Host stage of `threshold_combine_bytes`."""
        if not batch:
            return {"kind": "empty"}
        t0 = time.perf_counter()
        nv = len(batch)
        vpad = self.combine_padded_rows(nv, 0)
        t = max(len(sigs) for sigs in batch)
        raw = np.broadcast_to(_G2_INF_BYTES, (t, vpad, 96)).copy()
        digits = np.zeros((t, vpad, STRAUS_NWIN), np.int32)
        counts = np.zeros(vpad, np.int32)
        for col, sigs in enumerate(batch):
            idxs = tuple(sigs)
            if any(len(sigs[i]) != 96 for i in idxs):
                raise ValueError("G2 compressed signature must be 96 bytes")
            raw[: len(idxs), col] = np.frombuffer(
                b"".join(sigs[i] for i in idxs), np.uint8).reshape(-1, 96)
            digits[: len(idxs), col] = _lagrange_digits(idxs)
            counts[col] = len(idxs)
        xc0, xc1, sign, inf, bad = codec.g2_bytes_split(raw.reshape(-1, 96))
        real = (np.arange(t)[:, None] < counts[None, :]).reshape(-1)
        if (bad & real).any():
            raise ValueError("malformed compressed G2 signature in batch")
        return {
            "kind": "straus", "nv": nv, "vpad": vpad, "t": t,
            # port layout: limbs × rows, digits iteration-major
            "xc0": np.ascontiguousarray(xc0.T),
            "xc1": np.ascontiguousarray(xc1.T),
            "sign": sign, "inf": inf, "real": real,
            "digits": np.ascontiguousarray(
                digits.reshape(t * vpad, STRAUS_NWIN).T),
            "host_prep_s": time.perf_counter() - t0,
        }

    def combine_device_exec(self, prepared: dict) -> list[bytes]:
        """Device stage of `threshold_combine_bytes` (launch thread)."""
        if prepared["kind"] == "empty":
            return []
        dispatch.assert_off_loop("tbls.backend_cuda.combine_device_exec")
        p, dev = prepared, self.device
        stages = {"host_prep_s": p["host_prep_s"]}
        launches: dict[str, dict[str, int]] = {}
        clock = _StageClock(dev, stages, launches)

        def put(a):
            return torch.from_numpy(a).to(dev)

        pts, ok = codec.g2_decompress(put(p["xc0"]), put(p["xc1"]),
                                      put(p["sign"]), put(p["inf"]))
        ok = ok.cpu().numpy()
        clock.lap("decompress_s")
        if not (ok | ~p["real"]).all():
            raise ValueError("signature bytes not on the G2 curve or not "
                             "in the G2 subgroup")
        tables = cuda_g2.straus_tables(cuda_g2.as_planes(pts))
        clock.lap("tables_s")
        out = cuda_g2.straus_loop(tables, put(p["digits"]), p["t"])
        clock.lap("straus_s")
        xc0, xc1, yc0, yc1, inf = codec.g2_normalize(cuda_g2.as_points(out))
        host = [a.cpu().numpy() for a in (xc0, xc1, yc0, yc1)]
        inf = inf.cpu().numpy()
        clock.lap("normalize_s")
        comp = codec.g2_compress_np(*[a.T for a in host], inf)
        res = [comp[k].tobytes() for k in range(p["nv"])]
        clock.lap("compress_s")
        self.last_stages = stages
        self.last_launches = launches
        return res

    def threshold_combine_bytes(self, batch) -> list[bytes]:
        """batch: list of {share_idx: 96-byte sig} → 96-byte group
        signatures, Σᵢ λᵢ·Sᵢ per validator."""
        return self.combine_device_exec(self.combine_host_prep(batch))


def _launch_counts() -> dict[str, int]:
    return {**cuda_fp.LAUNCHES, **cuda_g2.LAUNCHES}


class _StageClock:
    """Host seconds and kernel launches between stage boundaries, each
    ended by a device synchronise (so a stage's time includes its
    kernels)."""

    def __init__(self, device: torch.device, seconds: dict, launches: dict):
        self._device = device
        self._seconds = seconds
        self._launches = launches
        self._t = time.perf_counter()
        self._n = _launch_counts()

    def lap(self, name: str) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        now, n = time.perf_counter(), _launch_counts()
        self._seconds[name] = now - self._t
        self._launches[name] = {k: n[k] - self._n[k] for k in n}
        self._t, self._n = now, n
