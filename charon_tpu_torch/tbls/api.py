"""Public threshold-BLS API of the port — the fixed interface the duty
pipeline calls.

A copy of the JAX package's tbls/api.py: GenerateTSS, SplitSecret,
CombineShares, PartialSign, Sign, Verify, Aggregate, VerifyAndAggregate,
the Feldman helpers the DKG uses, and the batch entry points the card
accelerates (BatchVerify, ThresholdCombine, and their prep / exec stages
for the dispatch pipeline), plus the boot `prewarm`.  Keys and signatures
cross this boundary as canonical ZCash-format bytes (48-byte G1 pubkeys,
96-byte G2 signatures, 32-byte scalars), so backends choose their own
internal representation.  Backends: ``"cuda"``, the default
(tbls/backend_cuda.py, created on first use on the current CUDA device —
it raises when there is none), and ``"cpu"`` (the pure-Python oracle, a
loop per entry or validator), which runs only after `set_backend("cpu")`.
The ``"insecure-test"`` scheme (`set_scheme`) replaces the curve with
plain scalars for pipeline tests.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field

from . import dispatch, shamir
from .ref import bls, curve
from .ref.fields import R

PubKey = bytes      # 48-byte compressed G1
Signature = bytes   # 96-byte compressed G2
PrivKey = bytes     # 32-byte big-endian scalar


def privkey_to_int(sk: PrivKey) -> int:
    return int.from_bytes(sk, "big") % R


def int_to_privkey(n: int) -> PrivKey:
    return (n % R).to_bytes(32, "big")


@dataclass(frozen=True)
class TSS:
    """Threshold scheme metadata: group key + per-share pubkeys derived
    from the Feldman commitments."""

    group_pubkey: PubKey
    commitments: tuple[PubKey, ...]  # a_j·G1 for each polynomial coefficient
    num_shares: int

    @property
    def threshold(self) -> int:
        return len(self.commitments)

    def public_share(self, idx: int) -> PubKey:
        """The commitment polynomial evaluated in the exponent at idx."""
        if not 1 <= idx <= self.num_shares:
            raise ValueError(f"share index {idx} out of range")
        if self.commitments[0][0] == 0x1F:  # insecure-test scheme
            acc, x = 0, 1
            for c in self.commitments:
                acc = (acc + _InsecureScheme.pk_to_sk(c) * x) % R
                x = x * idx % R
            return _InsecureScheme.sk_to_pk(acc)
        acc = None
        x = 1
        for c_bytes in self.commitments:
            pt = curve.g1_from_bytes(c_bytes)
            acc = curve.add(acc, curve.multiply(pt, x))
            x = x * idx % R
        return curve.g1_to_bytes(acc)

    _share_cache: dict = field(default_factory=dict, compare=False, hash=False)

    def public_shares(self) -> dict[int, PubKey]:
        if not self._share_cache:
            for i in range(1, self.num_shares + 1):
                self._share_cache[i] = self.public_share(i)
        return dict(self._share_cache)


# ---------------------------------------------------------------------------
# Scheme operations (the pure-Python oracle; the card serves the batches)
# ---------------------------------------------------------------------------

def generate_tss(threshold: int, num_shares: int,
                 seed: bytes | None = None) -> tuple[TSS, dict[int, PrivKey]]:
    """Trusted-dealer keygen: split a fresh secret t-of-n (reproducible
    with a seed)."""
    rng = random.Random(seed) if seed is not None else None
    sk = bls.keygen(seed)
    shares, coeffs = shamir.split_secret(sk, threshold, num_shares, rng)
    commitments = tuple(_commit(a) for a in coeffs)
    tss = TSS(group_pubkey=commitments[0], commitments=commitments,
              num_shares=num_shares)
    return tss, {i: int_to_privkey(s) for i, s in shares.items()}


def _commit(coeff: int) -> PubKey:
    """Feldman commitment of one polynomial coefficient."""
    if _scheme == "insecure-test":
        return _InsecureScheme.sk_to_pk(coeff)
    return curve.g1_to_bytes(curve.multiply(curve.G1_GEN, coeff))


def split_secret(secret: PrivKey, threshold: int,
                 num_shares: int, rng=None) -> tuple[TSS, dict[int, PrivKey]]:
    """t-of-n split of an existing secret; `rng` (a random.Random) makes
    the polynomial reproducible."""
    shares, coeffs = shamir.split_secret(privkey_to_int(secret), threshold,
                                         num_shares, rng)
    commitments = tuple(_commit(a) for a in coeffs)
    return (TSS(group_pubkey=commitments[0], commitments=commitments,
                num_shares=num_shares),
            {i: int_to_privkey(s) for i, s in shares.items()})


def commit_coeff(coeff: int) -> PubKey:
    """Feldman commitment of one polynomial coefficient (public)."""
    return _commit(coeff % R)


def feldman_eval(commitments: tuple[PubKey, ...], idx: int) -> PubKey:
    """The commitment polynomial evaluated in the exponent at idx: the
    public key of share idx under those commitments."""
    tss = TSS(group_pubkey=commitments[0], commitments=tuple(commitments),
              num_shares=max(idx, 1))
    return tss.public_share(idx)


def feldman_verify(share: PrivKey, idx: int,
                   commitments: tuple[PubKey, ...]) -> bool:
    """A received DKG share against the dealer's commitments:
    share·G == Σ A_j·idx^j."""
    return privkey_to_pubkey(share) == feldman_eval(commitments, idx)


def add_pubkeys(pubkeys: list[PubKey]) -> PubKey:
    """Group-law sum of public keys (aggregating DKG contributions)."""
    if _scheme == "insecure-test":
        total = sum(_InsecureScheme.pk_to_sk(pk) for pk in pubkeys) % R
        return _InsecureScheme.sk_to_pk(total)
    acc = None
    for pk in pubkeys:
        acc = curve.add(acc, curve.g1_from_bytes(pk))
    return curve.g1_to_bytes(acc)


def add_privkeys(privkeys: list[PrivKey]) -> PrivKey:
    return int_to_privkey(sum(privkey_to_int(sk) for sk in privkeys) % R)


def aggregate_signatures(sigs: list[Signature]) -> Signature:
    """Plain (non-threshold) BLS aggregate: Σ signatures (the lock-hash
    multi-signature)."""
    if _scheme == "insecure-test":
        total = sum(int.from_bytes(s, "big") for s in sigs) % R
        return total.to_bytes(96, "big")
    acc = None
    for s in sigs:
        acc = curve.add(acc, curve.g2_from_bytes(s))
    return curve.g2_to_bytes(acc)


def combine_shares(shares: dict[int, PrivKey]) -> PrivKey:
    return int_to_privkey(shamir.combine_shares(
        {i: privkey_to_int(s) for i, s in shares.items()}))


def generate_privkey() -> PrivKey:
    return int_to_privkey(bls.keygen())


def privkey_to_pubkey(sk: PrivKey) -> PubKey:
    if _scheme == "insecure-test":
        return _InsecureScheme.sk_to_pk(privkey_to_int(sk))
    return curve.g1_to_bytes(bls.sk_to_pk(privkey_to_int(sk)))


def sign(sk: PrivKey, msg: bytes) -> Signature:
    if _scheme == "insecure-test":
        return _InsecureScheme.sign(privkey_to_int(sk), msg)
    return curve.g2_to_bytes(bls.sign(privkey_to_int(sk), msg))


#: a partial signature is a signature with a share key
partial_sign = sign


def verify(pubkey: PubKey, msg: bytes, sig: Signature) -> bool:
    """One (pubkey, msg, signature) check; malformed bytes verify False."""
    if _scheme == "insecure-test":
        return _InsecureScheme.verify(pubkey, msg, sig)
    be = _backend()
    if hasattr(be, "batch_verify_bytes"):
        return be.batch_verify_bytes([(pubkey, msg, sig)])[0]
    try:
        pk = curve.g1_from_bytes(pubkey)
        s = curve.g2_from_bytes(sig)
    except ValueError:
        return False
    return be.verify(pk, msg, s)


def aggregate(partial_sigs: dict[int, Signature]) -> Signature:
    """Lagrange-interpolate ≥ t partial signatures into the group
    signature."""
    [out] = threshold_combine([partial_sigs])
    return out


def verify_and_aggregate(tss: TSS, partial_sigs: dict[int, Signature],
                         msg: bytes) -> tuple[Signature, list[int]]:
    """Verify each partial against its pubshare, then combine the first t
    valid ones.  → (group signature, the share indices used)."""
    if len(partial_sigs) < tss.threshold:
        raise ValueError("insufficient partial signatures")
    entries = [(tss.public_share(i), msg, s) for i, s in partial_sigs.items()]
    oks = batch_verify(entries)
    valid = {i: s for (i, s), ok in zip(partial_sigs.items(), oks) if ok}
    if len(valid) < tss.threshold:
        raise ValueError("insufficient valid partial signatures")
    take = dict(list(valid.items())[: tss.threshold])
    sig = aggregate(take)
    if not verify(tss.group_pubkey, msg, sig):
        raise ValueError("aggregated signature failed group verification")
    return sig, sorted(take)


# ---------------------------------------------------------------------------
# Batch entry points (what the card accelerates)
# ---------------------------------------------------------------------------

def batch_verify(entries: list[tuple[PubKey, bytes, Signature]]
                 ) -> list[bool]:
    """Verify a batch of (pubkey, msg, signature) triples.  Blocking — run
    it off the event loop (`dispatch.DispatchPipeline`)."""
    dispatch.assert_off_loop("tbls.batch_verify")
    if _scheme == "insecure-test":
        return [_InsecureScheme.verify(pk, msg, sig)
                for pk, msg, sig in entries]
    be = _backend()
    if hasattr(be, "batch_verify_bytes"):
        return be.batch_verify_bytes(entries)
    parsed, oks = [], []
    for pk_b, msg, sig_b in entries:
        try:
            parsed.append((curve.g1_from_bytes(pk_b), msg,
                           curve.g2_from_bytes(sig_b)))
            oks.append(True)
        except ValueError:
            oks.append(False)
    it = iter(be.batch_verify(parsed))
    return [ok and next(it) for ok in oks]


def threshold_combine(
        batch: list[dict[int, Signature]]) -> list[Signature]:
    """Lagrange-combine many validators' partial-signature sets at once.
    Blocking — run it off the event loop (`dispatch.DispatchPipeline`)."""
    dispatch.assert_off_loop("tbls.threshold_combine")
    if _scheme == "insecure-test":
        return [_InsecureScheme.combine(sigs) for sigs in batch]
    be = _backend()
    if hasattr(be, "threshold_combine_bytes"):
        return be.threshold_combine_bytes(batch)
    parsed = [{i: curve.g2_from_bytes(s) for i, s in sigs.items()}
              for sigs in batch]
    return [curve.g2_to_bytes(pt) for pt in be.threshold_combine(parsed)]


def verify_stages():
    """(host_prep, device_exec) callables for one verify payload:
    ``device_exec(host_prep(entries)) == batch_verify(entries)``.  A
    backend without the split, or the insecure-test scheme, runs whole in
    the exec stage.  Resolved per call, so scheme and backend switches take
    effect between flushes."""
    if _scheme != "insecure-test":
        be = _backend()
        if hasattr(be, "verify_host_prep"):
            return be.verify_host_prep, be.verify_device_exec
    return (lambda entries: entries), batch_verify


def combine_stages():
    """(host_prep, device_exec) callables for one combine payload:
    ``device_exec(host_prep(batch)) == threshold_combine(batch)``."""
    if _scheme != "insecure-test":
        be = _backend()
        if hasattr(be, "combine_host_prep"):
            return be.combine_host_prep, be.combine_device_exec
    return (lambda batch: batch), threshold_combine


def prewarm(pubshares: list[PubKey], num_validators: int,
            threshold: int) -> dict:
    """Build the kernels, seed the pubkey cache with the cluster's
    pubshares and run one verify and one combine at the cluster's (V, T),
    so the first duty after boot pays none of it.  Blocking — callers run
    it on a thread of its own (`DispatchPipeline.prewarm`).  A backend
    without a device prewarm is skipped, with the reason."""
    if _scheme == "insecure-test":
        return {"skipped": "insecure-test scheme"}
    be = _backend()
    fn = getattr(be, "prewarm", None)
    if fn is None:
        return {"skipped": f"backend {be.name!r} has no device programs"}
    return fn(pubshares, num_validators, threshold)


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------

class CPUBackend:
    """Loop-based oracle backend (pure Python)."""

    name = "cpu"

    def verify(self, pk, msg: bytes, sig) -> bool:
        return bls.verify(pk, msg, sig)

    def batch_verify(self, entries) -> list[bool]:
        return [bls.verify(pk, msg, sig) for pk, msg, sig in entries]

    def threshold_combine(self, batch):
        out = []
        for sigs in batch:
            lam = shamir.lagrange_coeffs_at_zero(list(sigs))
            acc = None
            for i, pt in sigs.items():
                acc = curve.add(acc, curve.multiply(pt, lam[i]))
            out.append(acc)
        return out


_BACKENDS: dict[str, object] = {"cpu": CPUBackend()}
_current_name = "cuda"


def register_backend(name: str, backend) -> None:
    _BACKENDS[name] = backend


def set_backend(name: str) -> None:
    """Select a backend; ``"cuda"`` is created on first use (on the
    current CUDA device — it raises when there is none)."""
    global _current_name
    if name != "cuda" and name not in _BACKENDS:
        raise KeyError(f"unknown tbls backend {name!r}")
    _current_name = name
    _backend()


def _backend():
    if _current_name == "cuda" and "cuda" not in _BACKENDS:
        from .backend_cuda import CUDABackend

        register_backend("cuda", CUDABackend())
    return _BACKENDS[_current_name]


def backend_name() -> str:
    return _backend().name


def verify_path(n: int) -> str:
    """Which verify implementation `batch_verify` takes for an n-entry
    batch (the BatchVerifier's per-path counters)."""
    if _scheme == "insecure-test":
        return "insecure-test"
    be = _backend()
    fn = getattr(be, "verify_path", None)
    return fn(n) if fn is not None else be.name


def devcache_path() -> str:
    """Which cache residency serves verifies: ``resident`` (the device
    stores, tbls/devcache.py) or ``bytes`` (the host LRUs); ``n/a`` for a
    backend without device caches."""
    if _scheme == "insecure-test":
        return "insecure-test"
    fn = getattr(_backend(), "devcache_path", None)
    return fn() if fn is not None else "n/a"


def verify_padded_rows(n: int) -> int:
    """Entries an n-entry `batch_verify` launches after padding."""
    if _scheme == "insecure-test":
        return n
    be = _backend()
    fn = getattr(be, "verify_padded_rows", None)
    return fn(n) if fn is not None else n


def combine_path() -> str:
    """Which combine implementation `threshold_combine` takes (span and
    metrics attribution)."""
    if _scheme == "insecure-test":
        return "insecure-test"
    be = _backend()
    fn = getattr(be, "combine_path", None)
    return fn() if fn is not None else be.name


def combine_padded_rows(v: int, t: int) -> int:
    """Validator rows a [v × t-share] combine launches after padding."""
    if _scheme == "insecure-test":
        return v
    be = _backend()
    fn = getattr(be, "combine_padded_rows", None)
    return fn(v, t) if fn is not None else v


# ---------------------------------------------------------------------------
# Insecure test scheme — pipeline tests only.
#
# Curve points become plain scalars mod r: pk = sk "in the open",
# sign(m) = sk·h(m) mod r.  Signatures stay linear as in BLS, so Shamir
# splitting, Lagrange combination, pubshare derivation and every threshold
# code path behave exactly as under the real scheme, at microsecond cost.
# ---------------------------------------------------------------------------

def _h_insecure(msg: bytes) -> int:
    return int.from_bytes(hashlib.sha256(b"insecure-h2c" + msg).digest(),
                          "big") % R


class _InsecureScheme:
    name = "insecure-test"

    @staticmethod
    def sk_to_pk(sk: int) -> bytes:
        return b"\x1f" + sk.to_bytes(47, "big")  # flag byte marks fake keys

    @staticmethod
    def pk_to_sk(pk: bytes) -> int:
        if pk[:1] != b"\x1f":
            raise ValueError("not an insecure-test pubkey")
        return int.from_bytes(pk[1:], "big")

    @staticmethod
    def sign(sk: int, msg: bytes) -> bytes:
        return (sk * _h_insecure(msg) % R).to_bytes(96, "big")

    @classmethod
    def verify(cls, pk: bytes, msg: bytes, sig: bytes) -> bool:
        try:
            sk = cls.pk_to_sk(pk)
        except ValueError:
            return False
        return cls.sign(sk, msg) == sig

    @staticmethod
    def combine(sigs: dict[int, bytes]) -> bytes:
        lam = shamir.lagrange_coeffs_at_zero(list(sigs))
        total = sum(lam[i] * int.from_bytes(s, "big") for i, s in sigs.items())
        return (total % R).to_bytes(96, "big")


_scheme = "bls"


def set_scheme(name: str) -> None:
    """``"bls"`` (the default) or ``"insecure-test"`` (pipeline tests)."""
    global _scheme
    if name not in ("bls", "insecure-test"):
        raise ValueError(f"unknown tbls scheme {name!r}")
    _scheme = name


def scheme_name() -> str:
    return _scheme
