"""Public threshold-BLS API of the port — the part the combine and verify
slices use.

A trimmed copy of the JAX package's tbls/api.py: keys and signatures
cross this boundary as canonical ZCash-format bytes (48-byte G1 pubkeys,
96-byte G2 signatures, 32-byte scalars), so backends choose their own
internal representation.  Backends: ``"cuda"``, the default
(tbls/backend_cuda.py, created on first use on the current CUDA device —
it raises when there is none), and ``"cpu"`` (the pure-Python oracle, a
loop per entry or validator), which runs only after `set_backend("cpu")`.
"""

from __future__ import annotations

from dataclasses import dataclass

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
    """Threshold scheme metadata: group key + Feldman commitments."""

    group_pubkey: PubKey
    commitments: tuple[PubKey, ...]  # a_j·G1 for each polynomial coefficient
    num_shares: int

    @property
    def threshold(self) -> int:
        return len(self.commitments)


def _commit(coeff: int) -> PubKey:
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


def sign(sk: PrivKey, msg: bytes) -> Signature:
    return curve.g2_to_bytes(bls.sign(privkey_to_int(sk), msg))


def verify(pubkey: PubKey, msg: bytes, sig: Signature) -> bool:
    """One (pubkey, msg, signature) check; malformed bytes verify False."""
    be = _backend()
    if hasattr(be, "batch_verify_bytes"):
        return be.batch_verify_bytes([(pubkey, msg, sig)])[0]
    try:
        pk = curve.g1_from_bytes(pubkey)
        s = curve.g2_from_bytes(sig)
    except ValueError:
        return False
    return be.verify(pk, msg, s)


def batch_verify(entries: list[tuple[PubKey, bytes, Signature]]
                 ) -> list[bool]:
    """Verify a batch of (pubkey, msg, signature) triples.  Blocking — run
    it off the event loop (`dispatch.DispatchPipeline`)."""
    dispatch.assert_off_loop("tbls.batch_verify")
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


def verify_stages():
    """(host_prep, device_exec) callables for one verify payload:
    ``device_exec(host_prep(entries)) == batch_verify(entries)``.  A
    backend without the split runs whole in the exec stage."""
    be = _backend()
    if hasattr(be, "verify_host_prep"):
        return be.verify_host_prep, be.verify_device_exec
    return (lambda entries: entries), batch_verify


def threshold_combine(
        batch: list[dict[int, Signature]]) -> list[Signature]:
    """Lagrange-combine many validators' partial-signature sets at once.
    Blocking — run it off the event loop (`dispatch.DispatchPipeline`)."""
    dispatch.assert_off_loop("tbls.threshold_combine")
    be = _backend()
    if hasattr(be, "threshold_combine_bytes"):
        return be.threshold_combine_bytes(batch)
    parsed = [{i: curve.g2_from_bytes(s) for i, s in sigs.items()}
              for sigs in batch]
    return [curve.g2_to_bytes(pt) for pt in be.threshold_combine(parsed)]


def combine_stages():
    """(host_prep, device_exec) callables for one combine payload:
    ``device_exec(host_prep(batch)) == threshold_combine(batch)``.  A
    backend without the split runs whole in the exec stage."""
    be = _backend()
    if hasattr(be, "combine_host_prep"):
        return be.combine_host_prep, be.combine_device_exec
    return (lambda batch: batch), threshold_combine


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
    be = _backend()
    fn = getattr(be, "verify_path", None)
    return fn(n) if fn is not None else be.name


def verify_padded_rows(n: int) -> int:
    """Entries an n-entry `batch_verify` launches after padding."""
    be = _backend()
    fn = getattr(be, "verify_padded_rows", None)
    return fn(n) if fn is not None else n


def combine_path() -> str:
    """Which combine implementation `threshold_combine` takes (span and
    metrics attribution)."""
    be = _backend()
    fn = getattr(be, "combine_path", None)
    return fn() if fn is not None else be.name


def combine_padded_rows(v: int, t: int) -> int:
    """Validator rows a [v × t-share] combine launches after padding."""
    be = _backend()
    fn = getattr(be, "combine_padded_rows", None)
    return fn(v, t) if fn is not None else v
