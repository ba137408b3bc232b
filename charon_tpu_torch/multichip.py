"""The multi-card entry points — the port's counterpart of the JAX
package's ``__graft_entry__.py``.

- `entry()`: one threshold-combine step — V = 4 validators' T = 3
  partial signatures combined into group signatures through the port's
  `curve.msm` (the JAX entry's step, on the card unless asked for the
  CPU).
- `dryrun_multichip(n)`: the validator batch — the data-parallel axis,
  SURVEY.md §2.9 — over n devices: the kernel contract audit with its
  shard pass at n shards, then n validators' real Shamir partials
  combined by `tbls/backend_cuda.straus_combine_sharded` (the production
  multi-card combine: K22's tables and K16's window loop on every shard's
  device), then each validator's signature verified on its own device
  (the batch split evenly, a validator a device, as the JAX dry run's
  verify step is), e(−g1, sig)·e(pk, H(m)) == 1 — on the card by the
  kernels of the verify path's re-check (K19 normalises, K1's negation,
  K13, K5's product, K11), on the CPU by the plain `ops/pairing`.

    python -m charon_tpu_torch.multichip [--devices N]

runs `dryrun_multichip(N)` on the first N cards (default: every visible
card); the tests run it on CPU shards (``devices=["cpu", "cpu"]``).
"""

from __future__ import annotations

import argparse
import random
import sys
import time

import numpy as np
import torch

from .ops import cuda_g2, fp, pairing
from .ops import curve as tcurve
from .ops.curve import F2_OPS
from .tbls import backend_cuda, shamir
from .tbls.ref import curve as refcurve
from .tbls.ref.hash_to_curve import hash_to_g2

NL = fp.NLIMBS


def _default_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass device='cpu' "
                           "to run the plain versions on the CPU)")
    return torch.device("cuda", torch.cuda.current_device())


def entry(device=None):
    """→ (fn, args): fn(pts, bits) combines [T, 3, 2, 32, V] partial
    signatures (share t's for every validator) with [256, T, V] Lagrange
    bit planes of the share indices 1..T into [3, 2, 32, V] group
    signatures, Σ_t λ_t·P_t; args are V = 4 validators' partials
    (7 + v + t)·G2 and the bits, on `device` (default the current card)."""
    device = torch.device(device) if device is not None \
        else _default_device()
    v_count, t_count = 4, 3

    def threshold_combine_step(pts, bits):
        return tcurve.msm(F2_OPS, pts, bits, axis=0)

    base = refcurve.G2_GEN
    pts = np.stack([tcurve.g2_pack([refcurve.multiply(base, 7 + v + t)
                                    for v in range(v_count)])
                    for t in range(t_count)])
    lam = shamir.lagrange_coeffs_at_zero(list(range(1, t_count + 1)))
    bits = tcurve.scalars_to_bits([lam[i] for i in range(1, t_count + 1)])
    bits = np.ascontiguousarray(np.broadcast_to(
        bits.T[:, :, None], bits.T.shape + (v_count,)))
    return threshold_combine_step, (torch.from_numpy(pts).to(device),
                                    torch.from_numpy(bits).to(device))


def _verify_on(device: torch.device, sigs, pks, hms) -> np.ndarray:
    """e(−g1, sig_k)·e(pk_k, H(m)) == 1 for the rows of one shard, on its
    device: projective sigs [3, 2, 32, m], pks [3, 32, m] and affine H(m)
    [3, 2, 32, m] → [m] bool."""
    m = sigs.shape[-1]
    if device.type == "cuda":
        with torch.cuda.device(device):
            backend = backend_cuda.CUDABackend(device=device, resident=False)
            aff = backend_cuda._affine_planes(sigs)
            live = torch.ones(m, dtype=torch.bool, device=device)
            return backend._recheck(pks, aff, hms, live)
    sx, sy, sinf = tcurve.to_affine(F2_OPS, sigs)
    aff = tcurve.from_affine(F2_OPS, sx, sy, inf=sinf)
    neg_g1 = torch.from_numpy(tcurve.g1_pack(
        [refcurve.neg(refcurve.G1_GEN)])).expand(3, NL, m)
    ps = torch.stack([neg_g1.to(device), pks])
    qs = torch.stack([aff, hms])
    return pairing.pairing_product_is_one(ps, qs).numpy()


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """The multi-card combine and verify over n devices (module
    docstring) → its report: the devices, the audit, the combined points
    [3, 2, 32, V] (on the CPU), every verdict and the seconds of each
    step.  Raises when the audit finds a violation (nothing is driven
    then) or a validator fails to verify.  `devices` (default the first
    n cards) may repeat a device."""
    if devices is None:
        cards = backend_cuda.shard_devices(None)
        if len(cards) < n_devices:
            raise RuntimeError(f"dryrun_multichip: need {n_devices} cards, "
                               f"have {len(cards)}")
        devices = cards[:n_devices]
    devs = backend_cuda.shard_devices(devices)
    if len(devs) != n_devices:
        raise ValueError(f"dryrun_multichip: {len(devs)} devices given for "
                         f"{n_devices}")
    v_count, t_count = n_devices, 2        # a validator a shard, 2-of-2
    report: dict = {"devices": [str(d) for d in devs], "v": v_count,
                    "t": t_count}

    # 0. the kernel contract audit with its shard pass at these devices:
    # no shard is driven if a kernel or the split breaks its contract
    from .analysis.audit import run_audit

    t0 = time.perf_counter()
    audit = run_audit(metrics=False, concurrency=False, asyncio_lint=False,
                      shard=True, devices=devs)
    report["audit_s"] = time.perf_counter() - t0
    report["audit"] = audit
    if not audit.ok:
        raise AssertionError("kernel contract audit failed — not driving "
                             "the sharded combine:\n" + audit.summary())
    print(f"dryrun_multichip({n_devices}): kernel contract audit PASS "
          f"({len(audit.kernels)} kernels, {len(audit.shard_cases)} shard "
          f"programs on {report['devices']})", flush=True)

    # real keys and 2-of-2 Shamir partials of one message
    msg = b"dryrun-attestation"
    hm = hash_to_g2(msg)
    lam = shamir.lagrange_coeffs_at_zero([1, 2])
    lam_digits = cuda_g2.signed_digit_rows(
        tcurve.scalars_to_bits([lam[1], lam[2]]))         # [T, nwin]
    rng = random.Random(n_devices)
    sks = [1000 + v for v in range(v_count)]
    partials = []
    for sk in sks:
        shares = shamir.split_secret(sk, 2, 2, rng)[0]
        partials += [refcurve.multiply(hm, shares[1]),
                     refcurve.multiply(hm, shares[2])]
    pts = tcurve.g2_pack(partials).reshape(3, 2, NL, v_count, t_count)
    digits = np.ascontiguousarray(np.broadcast_to(
        lam_digits.T[:, None, :], (lam_digits.shape[1], v_count, t_count)))
    pks = torch.from_numpy(tcurve.g1_pack(
        [refcurve.multiply(refcurve.G1_GEN, sk) for sk in sks]))
    hms = torch.from_numpy(tcurve.g2_pack([hm] * v_count))

    # 1. the sharded combine
    dev0 = devs[0]
    t0 = time.perf_counter()
    combined = backend_cuda.straus_combine_sharded(
        torch.from_numpy(pts).to(dev0), torch.from_numpy(digits).to(dev0),
        devs)
    if dev0.type == "cuda":
        torch.cuda.synchronize(dev0)
    report["combine_s"] = time.perf_counter() - t0

    # 2. each validator verified on its shard's device: the batch split
    # evenly, a validator a device
    t0 = time.perf_counter()
    ok = np.zeros(v_count, bool)
    per = -(-v_count // n_devices)
    for j, d in enumerate(devs):
        lo, hi = j * per, min((j + 1) * per, v_count)
        if lo < hi:
            ok[lo:hi] = _verify_on(
                d, *(x[..., lo:hi].to(d).contiguous()
                     for x in (combined, pks, hms)))
    report["verify_s"] = time.perf_counter() - t0
    report["combined"] = combined.cpu()
    report["verdicts"] = ok.tolist()
    if not ok.all():
        raise AssertionError(f"dryrun_multichip: verification failed: "
                             f"{ok.tolist()}")
    print(f"dryrun_multichip({n_devices}): sharded straus combine + verify "
          f"OK on {report['devices']} (audit {report['audit_s']:.2f} s, "
          f"combine {report['combine_s']:.2f} s, verify "
          f"{report['verify_s']:.2f} s)", flush=True)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m charon_tpu_torch.multichip",
        description="The multi-card combine's dry run on the first N cards")
    ap.add_argument("--devices", type=int, default=None,
                    help="cards to shard over (default: every visible card)")
    args = ap.parse_args(argv)
    n = args.devices or len(backend_cuda.shard_devices(None))
    dryrun_multichip(n)
    return 0


if __name__ == "__main__":  # importing the module (a package walk) runs nothing
    sys.exit(main())
