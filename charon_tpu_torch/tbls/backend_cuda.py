"""CUDA tbls backend: threshold combine and batched verification on the
card.

The counterpart of the JAX package's TPU backend: its fused Straus bytes
path (slice 1) and its fused RLC batch verification (slice 2).  Each
bytes entry point is the composition of two stages, so the dispatch
pipeline can overlap batch k+1's host prep with batch k's device work.

Combine (`threshold_combine_bytes`):

- `combine_host_prep` (host): split the 96-byte signatures into 12-bit
  limb planes (vectorised numpy), reject malformed encodings, look up the
  per-index-set Lagrange digit rows, lay rows out T-MAJOR (row =
  t·Vpad + v) with validators padded to a multiple of `ROW_TILE`.
- `combine_device_exec` (card): decompress (Fp2 square roots + ψ
  subgroup check, one launch of kernel K12), the Straus tables (one K22
  launch) and window loop (one K16 launch), normalisation (one K19
  launch), then the host compresses the affine points.

Verify (`batch_verify_bytes`), one RLC batch check per call:

    Π_k [ e(−g1, sig_k) · e(pk_k, H(m_k)) ]^{r_k}  ==  1

- `verify_host_prep` (host): split the signatures into limb planes; look
  up the decompressed-pubkey LRU (a batch of misses decompresses G1 on
  the card, [r]P subgroup check included, in one K21 launch, once per
  distinct key) and the hashed-message LRU (a batch of 8 or more
  distinct misses hashes to G2 on the card — SHA-256 and hash_to_field
  on the host, then the pipeline of ops/cuda_h2c.py (K8, K18, K23, K17,
  K22) and normalisation (K19); fewer run the
  pure-Python `hash_to_g2`, the JAX backend's size rule); draw FRESH
  64-bit coefficients r_k from OS entropy on every call (a predictable
  coefficient would let a forger cancel rows).
- `verify_device_exec` (card): G2 decompression of the signatures (ψ
  check; one K12 launch), the G1 tables {P, 2P, 3P} of the pair-major rows
  (−g1, pk_k) (one K20 launch), the 32 windows scaling both rows of entry k by r_k
  and negating y for the Miller p-side (one K15 launch), the Miller loop
  over the 2·V rows (one K13 launch), the product fold to one row with
  dropped / ∞ / padding rows read as one (one K14 launch), and ONE final
  exponentiation with its verdict "= 1" (one K11 launch).  If the batch equation fails, every
  entry is re-checked on its own — e(−g1, sig)·e(pk, H(m)) == 1 on the
  unscaled rows: one K13 launch, one K5 product of the two halves, K11
  over the entries — ANDed with the decode mask, so the verdicts are
  exactly the pure-Python oracle's.

Two routes serve verifies; `CUDABackend(resident=None)` takes the
resident route on the card and the bytes route on the CPU (the JAX
backend's ``auto`` rule), and an explicit True or False wins:

- **bytes**: the host LRUs below hold packed numpy planes; every tile
  uploads its pubkey and H(m) planes and runs the stages above eagerly,
  a stage boundary (a synchronise) between kernels, `live` on the host.
- **resident** (the JAX package's tbls/devcache path): two
  `devcache.DeviceRowCache` stores keep the decompressed pubkeys and the
  hashed messages (keyed by the message's SHA-256) on the card; prep
  gathers a batch's rows there, computes only the misses (K21, or the hash
  pipeline, on the prep thread's stream; fewer than `H2C_MIN_BATCH` on the
  host) and splices them into the batch's rows directly, so a concurrent
  commit cannot evict a row the batch reads.  The launch thread copies the
  prepared tensors into the static inputs of its padded bucket's
  `_VerifyGraph` and replays the CUDA graph that one call of
  `_verify_tile` was captured into (on the CPU it calls the function):
  K12 → live = host_live ∧ sg_ok ∧ ¬∞ and the drop mask on the card →
  K20 → K15 → K13 → K14 → K11, the verdict and `live` read back once; a
  rejected tile re-checks from the graph's own buffers before that
  bucket's next replay.  A failed capture, replay or cache operation
  raises: nothing falls back to the bytes route.

A failed launch raises; there is no fallback path.  The device stages
synchronise their thread's stream at their boundaries and record their
seconds in `last_stages` and the launches their thread made in
`last_launches` (the smoke run's per-stage breakdown); the verify stages
also add up in `verify_totals` / `verify_launch_totals` across calls (the
tiles of one flush).  The pubkey-miss decompress runs on the host-prep
thread, on a stream of its own, while the launch thread may be running
the previous tile: its seconds are CUDA-event time on that stream; so
does the device hash of message misses (`h2c_s`, its host half
`h2c_host_s`).  A batch of fewer than `H2C_MIN_BATCH` distinct misses
hashes on the host instead, under `h2c_py_s`, so a call's stages show
which route its misses took.  A stage a call does not run is absent, not
zero.  The resident route has no per-kernel laps: its tile reports
`graph_s` (CUDA events around the replay; its launches are the captured
ones, counted once a replay), `devcache_gather_s` (the two stores'
gathers, CUDA events on the prep stream), the miss stages as above, and
`graph_capture_s` the first time a bucket is used.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from . import devcache, dispatch, shamir
from .ref import curve as refcurve
from .ref.hash_to_curve import hash_to_g2
from ..ops import (build, codec, cuda_codec, cuda_final_exp, cuda_fp,
                   cuda_g2, cuda_h2c, cuda_pairing, fp, launch_count)
from ..ops import curve as tcurve
from ..ops.curve import F2_OPS

_G2_INF_BYTES = np.zeros(96, np.uint8)
_G2_INF_BYTES[0] = 0xC0

#: balanced base-8 digits of a 256-bit scalar: ⌈258/3⌉ + 1 carry digit
STRAUS_NWIN = 87

#: validators pad to a multiple of this (10,000 → 10,240, the JAX fused
#: path's padding)
ROW_TILE = 1024

NL = fp.NLIMBS

#: random-coefficient width of the RLC batch check (a forger's rows cancel
#: with probability ~2^-64)
_RLC_BITS = 64

_NEG_G1 = tcurve.g1_pack([refcurve.neg(refcurve.G1_GEN)])[..., 0]  # [3, 32]
_G1_INF = tcurve.g1_pack([None])[..., 0]


#: distinct message misses at or above which a batch hashes on the card
#: (the JAX backend's `_use_h2c` rule); fewer hash on the host
H2C_MIN_BATCH = 8


def _pad_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


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

    def __init__(self, device=None, resident: bool | None = None,
                 devcache_mb: float = devcache.DEVCACHE_DEFAULT_MB):
        """`device` defaults to the current CUDA device and raises when
        there is none: the CPU runs only when asked for (``"cpu"``), and
        then every kernel wrapper takes its plain version.  `resident`
        chooses the verify route (module docstring): None is the resident
        route on the card and the bytes route on the CPU.  `devcache_mb`
        is the two device stores' budget (pk 1/3, hm 2/3)."""
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CUDABackend: no CUDA device is available (pass "
                    "device='cpu' to run the plain versions on the CPU)")
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = torch.device(device)
        self.resident = (self.device.type == "cuda" if resident is None
                         else bool(resident))
        self._devcache_budget = devcache.devcache_budget_bytes(devcache_mb)
        #: the resident route's device stores (created at first use)
        self._pk_dev: devcache.DeviceRowCache | None = None
        self._hm_dev: devcache.DeviceRowCache | None = None
        #: seconds per device stage of the last combine
        self.last_stages: dict[str, float] = {}
        #: kernel launches per device stage of the last combine
        self.last_launches: dict[str, dict[str, int]] = {}
        #: verify stage seconds / launches summed over calls since the
        #: last `reset_verify_totals()` (the tiles of one flush)
        self.verify_totals: dict[str, float] = {}
        self.verify_launch_totals: dict[str, dict[str, int]] = {}
        self._totals_lock = threading.Lock()
        #: hashed-message LRU: msg → packed affine H(m) [3, 2, 32]
        self._hm_cache: OrderedDict[bytes, np.ndarray] = OrderedDict()
        #: decompressed-pubkey LRU: 48-byte pk → ([3, 32] planes, ok)
        self._pk_cache: OrderedDict[bytes, tuple[np.ndarray, bool]] = \
            OrderedDict()
        self.hm_cache_hits = self.hm_cache_misses = 0
        self.hm_cache_evictions = 0
        self.pk_cache_hits = self.pk_cache_misses = 0
        self.pk_cache_evictions = 0
        # the caches and counters are touched by the host-prep thread and
        # by direct callers; device work for misses runs outside the lock
        self._cache_lock = threading.Lock()
        #: the host-prep thread's stream: the misses' device work, and
        #: every device operation of a resident prep
        self._prep_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    #: LRU capacities (the JAX backend's)
    HM_CACHE_MAX = 4096
    PK_CACHE_MAX = 65536

    # -- attribution --------------------------------------------------------

    def combine_path(self) -> str:
        return "straus"

    def combine_padded_rows(self, v: int, t: int) -> int:
        """Validator rows a combine launches (padded to `ROW_TILE`)."""
        return -(-v // ROW_TILE) * ROW_TILE

    def verify_path(self, n: int) -> str:
        """The verify implementation of an n-entry batch: the fused RLC
        check on the card, message misses hashed on the card.  As the JAX
        backend's ``h2c-dev``, the label names the route a batch of
        `H2C_MIN_BATCH` or more distinct misses takes; which route a call's
        misses took depends on the cache and shows in its stages
        (``h2c_s`` on the card, ``h2c_py_s`` on the host).  ``+res``: the
        resident route serves the verifies."""
        return "cuda-rlc+h2c-dev" + ("+res" if self.resident else "")

    def devcache_path(self) -> str:
        """The cache residency serving verifies: ``resident`` or
        ``bytes``."""
        return "resident" if self.resident else "bytes"

    def devcache_stats(self) -> dict:
        """Occupancy and counters of the resident route's stores (absent
        until first used)."""
        out: dict = {"enabled": self.resident, "path": self.devcache_path()}
        if self._pk_dev is not None:
            out["pk"] = self._pk_dev.stats()
            out["hm"] = self._hm_dev.stats()
        return out

    def verify_padded_rows(self, n: int) -> int:
        """Entries an n-entry verify launches: the next power of two (the
        product fold halves the rows); 2 Miller rows per entry."""
        return 0 if n == 0 else _pad_pow2(n)

    # -- verification -------------------------------------------------------

    def verify(self, pk, msg: bytes, sig) -> bool:
        return self.batch_verify([(pk, msg, sig)])[0]

    def batch_verify(self, entries) -> list[bool]:
        """entries: [(pk point, msg, sig point)] (oracle affine points) →
        [bool], through the bytes path."""
        return self.batch_verify_bytes(
            [(refcurve.g1_to_bytes(pk), msg, refcurve.g2_to_bytes(sig))
             for pk, msg, sig in entries])

    def batch_verify_bytes(self, entries) -> list[bool]:
        """entries: [(48-byte pk, msg bytes, 96-byte sig)] → [bool]."""
        return self.verify_device_exec(self.verify_host_prep(entries))

    def reset_verify_totals(self) -> None:
        with self._totals_lock:
            self.verify_totals = {}
            self.verify_launch_totals = {}

    def _hash_points(self, msgs, stages: dict, launches: dict
                     ) -> np.ndarray:
        """[m messages] → packed affine H(m) [3, 2, 32, m] through the LRU;
        misses are deduplicated and hashed in one batch: on the card when
        there are `H2C_MIN_BATCH` or more (stages ``h2c_host_s`` and
        ``h2c_s``), else on the host (stage ``h2c_py_s``)."""
        out = np.zeros((3, 2, NL, len(msgs)), np.int32)
        miss: dict[bytes, list[int]] = {}
        with self._cache_lock:
            for k, msg in enumerate(msgs):
                hm = self._hm_cache.get(msg)
                if hm is not None:
                    self._hm_cache.move_to_end(msg)
                    out[..., k] = hm
                else:
                    miss.setdefault(msg, []).append(k)
            n_miss = sum(len(v) for v in miss.values())
            self.hm_cache_hits += len(msgs) - n_miss
            self.hm_cache_misses += n_miss
        if not miss:
            return out
        keys = list(miss)
        if len(keys) >= H2C_MIN_BATCH:
            planes = self._hash_on_card(keys, stages, launches)
        else:
            t0 = time.perf_counter()
            planes = tcurve.g2_pack([hash_to_g2(msg) for msg in keys])
            stages["h2c_py_s"] = time.perf_counter() - t0
        with self._cache_lock:
            for j, msg in enumerate(keys):
                if len(self._hm_cache) >= self.HM_CACHE_MAX:
                    self._hm_cache.popitem(last=False)
                    self.hm_cache_evictions += 1
                self._hm_cache[msg] = planes[..., j].copy()
                for k in miss[msg]:
                    out[..., k] = planes[..., j]
        return out

    def _hash_on_card(self, keys, stages: dict, launches: dict
                      ) -> np.ndarray:
        """Distinct messages → packed affine H(m) [3, 2, 32, m] on the
        host (`_hash_rows`, then one copy back on the prep stream: on the
        default stream the copy would queue behind the launch thread's
        tile)."""
        with self._prep_context():
            return self._hash_rows(keys, stages, launches).cpu().numpy()

    def _hash_rows(self, keys, stages: dict, launches: dict
                   ) -> torch.Tensor:
        """Distinct messages → packed affine H(m) [3, 2, 32, m] on the
        device: SHA-256 and hash_to_field on the host, then the device
        pipeline and its normalisation on the prep thread's own stream."""
        t0 = time.perf_counter()
        u = cuda_h2c.pack_messages(keys)
        stages["h2c_host_s"] = time.perf_counter() - t0
        with _own_stream_stage(self._prep_stream, "h2c_s", stages, launches):
            pts = cuda_h2c.hash_to_g2_rows(self._put(u))
            planes = _affine_planes(cuda_g2.as_points(pts))
        return planes

    def _pk_planes_cached(self, pk_bytes_list, stages: dict,
                          launches: dict) -> tuple[np.ndarray, np.ndarray]:
        """[m × 48-byte pk] → (planes [3, 32, m], ok [m]) through the LRU;
        misses are deduplicated and decompressed in one batch on the
        device (curve, [r]P subgroup and non-∞ checks: one K21 launch)."""
        m = len(pk_bytes_list)
        planes = np.zeros((3, NL, m), np.int32)
        ok = np.zeros(m, bool)
        miss: dict[bytes, list[int]] = {}
        with self._cache_lock:
            for k, pk in enumerate(pk_bytes_list):
                hit = self._pk_cache.get(pk)
                if hit is not None:
                    self._pk_cache.move_to_end(pk)
                    planes[..., k], ok[k] = hit
                else:
                    miss.setdefault(pk, []).append(k)
            n_miss = sum(len(v) for v in miss.values())
            self.pk_cache_hits += m - n_miss
            self.pk_cache_misses += n_miss
        if not miss:
            return planes, ok
        keys = list(miss)
        raw = np.frombuffer(b"".join(keys), np.uint8).reshape(-1, 48)
        x, sign, inf, bad = codec.g1_bytes_split(raw)
        with _own_stream_stage(self._prep_stream, "pk_decompress_s", stages,
                               launches):
            pts, dec = cuda_codec.g1_decompress(
                self._put(np.ascontiguousarray(x.T)), self._put(sign),
                self._put(inf))
            pts, dec = pts.cpu().numpy(), dec.cpu().numpy() & ~bad
        with self._cache_lock:
            for j, pk in enumerate(keys):
                if len(self._pk_cache) >= self.PK_CACHE_MAX:
                    self._pk_cache.popitem(last=False)
                    self.pk_cache_evictions += 1
                self._pk_cache[pk] = (pts[..., j].copy(), bool(dec[j]))
                for k in miss[pk]:
                    planes[..., k], ok[k] = pts[..., j], bool(dec[j])
        return planes, ok

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- the resident route's stores ------------------------------------------

    def _dev_caches(self) -> tuple[devcache.DeviceRowCache,
                                   devcache.DeviceRowCache]:
        with self._cache_lock:
            if self._pk_dev is None:
                cap = devcache.devcache_capacity_rows
                b = self._devcache_budget
                self._pk_dev = devcache.DeviceRowCache(
                    "pk", 3, cap(3, devcache.PK_SHARE, b), self.device)
                self._hm_dev = devcache.DeviceRowCache(
                    "hm", 6, cap(6, devcache.HM_SHARE, b), self.device)
        return self._pk_dev, self._hm_dev

    def _prep_context(self):
        """The prep thread's stream as the current one (no-op on the CPU):
        every device operation of a resident prep runs on it."""
        if self._prep_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._prep_stream)

    def _pk_rows_resident(self, pk_bytes_list, stages: dict,
                          launches: dict) -> tuple[torch.Tensor, np.ndarray]:
        """[m × 48-byte pk] → (device rows [3, 32, m], ok bool [m]) through
        the pubkey store: hits gathered by slot, misses deduplicated and
        decompressed in one K21 launch, committed for future batches and
        spliced into this batch's rows directly."""
        pk_dev, _ = self._dev_caches()
        with _own_stream_stage(self._prep_stream, "devcache_gather_s",
                               stages, launches):
            idx, ok, missing, rows = pk_dev.lookup_rows(pk_bytes_list)
        if not missing:
            return rows, ok
        raw = np.frombuffer(b"".join(missing), np.uint8).reshape(-1, 48)
        x, sign, inf, bad = codec.g1_bytes_split(raw)
        with _own_stream_stage(self._prep_stream, "pk_decompress_s", stages,
                               launches):
            pts, dec = cuda_codec.g1_decompress(
                self._put(x.T), self._put(sign), self._put(inf))
            dec_ok = dec.cpu().numpy() & ~bad
        pk_dev.commit(missing, pts, dec_ok)
        pos_of = {key: j for j, key in enumerate(missing)}
        at = np.flatnonzero(idx < 0)
        src = np.array([pos_of[pk_bytes_list[k]] for k in at], np.int64)
        ok[at] = dec_ok[src]
        rows.index_copy_(2, self._put(at), pts.index_select(2,
                                                             self._put(src)))
        return rows, ok

    def _hm_rows_resident(self, msgs, stages: dict, launches: dict
                          ) -> torch.Tensor:
        """[m messages] → device rows [3, 2, 32, m] through the message
        store, keyed by the message's SHA-256: misses hashed in one batch
        (on the card from `H2C_MIN_BATCH` distinct ones, else on the host),
        committed and spliced in as for pubkeys."""
        _, hm_dev = self._dev_caches()
        keys = [hashlib.sha256(msg).digest() for msg in msgs]
        with _own_stream_stage(self._prep_stream, "devcache_gather_s",
                               stages, launches):
            idx, _, missing, rows = hm_dev.lookup_rows(keys)
        rows = rows.view(3, 2, NL, len(msgs))
        if not missing:
            return rows
        first_msg: dict[bytes, bytes] = {}
        for key, msg in zip(keys, msgs):
            first_msg.setdefault(key, msg)
        miss_msgs = [first_msg[key] for key in missing]
        if len(missing) >= H2C_MIN_BATCH:
            planes = self._hash_rows(miss_msgs, stages, launches)
        else:
            t0 = time.perf_counter()
            planes = self._put(tcurve.g2_pack([hash_to_g2(msg)
                                               for msg in miss_msgs]))
            stages["h2c_py_s"] = time.perf_counter() - t0
        hm_dev.commit(missing, planes.reshape(6, NL, len(missing)),
                      np.ones(len(missing), bool))
        pos_of = {key: j for j, key in enumerate(missing)}
        at = np.flatnonzero(idx < 0)
        src = np.array([pos_of[keys[k]] for k in at], np.int64)
        rows.index_copy_(3, self._put(at), planes.index_select(
            3, self._put(src)))
        return rows

    def _rows_resident(self, v: int, rows: list[int], msgs, pk_bytes,
                       host_ok: np.ndarray, stages: dict,
                       launches: dict) -> dict:
        """The resident route's part of a prep: the batch's pubkey and
        H(m) rows [3, 32, v] and [3, 2, 32, v] gathered on the card through
        the stores (misses computed there), ∞ and zero rows elsewhere; they
        stay on the card, and `ready` is an event after their last write
        on the prep stream.  Clears `host_ok` at keys that do not
        decode."""
        ready = None
        with self._prep_context():
            pks = fp.const(_G1_INF, self.device).unsqueeze(-1).expand(
                3, NL, v).clone()
            hms = torch.zeros((3, 2, NL, v), dtype=torch.int32,
                              device=self.device)
            if rows:
                at = self._put(np.asarray(rows, np.int64))
                pk_rows, pk_ok = self._pk_rows_resident(pk_bytes, stages,
                                                        launches)
                hm_rows = self._hm_rows_resident(msgs, stages, launches)
                host_ok[rows] = pk_ok
                pks.index_copy_(2, at, pk_rows)
                hms.index_copy_(3, at, hm_rows)
            if self._prep_stream is not None:
                ready = torch.cuda.Event()
                ready.record(self._prep_stream)
        return {"kind": "resident", "pks": pks, "hms": hms, "ready": ready}

    def _rows_bytes(self, v: int, rows: list[int], msgs, pk_bytes,
                    host_ok: np.ndarray, stages: dict,
                    launches: dict) -> dict:
        """The bytes route's part of a prep: the pubkey and H(m) planes
        through the host LRUs as numpy arrays, uploaded by the exec
        stage.  Clears `host_ok` at keys that do not decode."""
        pks = np.broadcast_to(_G1_INF[..., None], (3, NL, v)).copy()
        hms = np.zeros((3, 2, NL, v), np.int32)
        if rows:
            hms[..., rows] = self._hash_points(msgs, stages, launches)
            planes, pk_ok = self._pk_planes_cached(pk_bytes, stages,
                                                   launches)
            pks[..., rows] = planes
            host_ok[rows] = pk_ok
        return {"kind": "rlc", "pks": pks, "hms": hms}

    def _verify_exec_resident(self, p: dict) -> list[bool]:
        """Device stage of the resident route (launch thread): the prepared
        rows and planes into the bucket's static inputs, one replay (on
        the CPU one call of `_verify_tile`), one readback; a rejected tile
        re-checks from the graph's buffers before the bucket's next
        replay."""
        n, v = p["n"], p["v"]
        if not p["host_ok"].any():
            return [False] * n          # nothing decodes: no device work
        stages = dict(p["stages"])
        launches = dict(p["launches"])
        g = _verify_graph(self.device, v)
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        with g.lock:
            if stream is not None:
                stream.wait_event(p["ready"])
                for t in (p["pks"], p["hms"]):
                    t.record_stream(stream)
            g.load(p)
            if stream is not None and g.graph is None:
                with _own_stream_stage(None, "graph_capture_s", stages,
                                       launches):
                    g.capture()
            with _own_stream_stage(stream, "graph_s", stages, launches):
                flags, sigs, live = g.run()
            flags = flags.cpu().numpy()
            if flags[0]:
                ok = flags[1:]
            else:
                # some live row fails the batch equation: re-check every
                # entry on its own so callers get exact per-entry verdicts
                with _own_stream_stage(stream, "recheck_s", stages,
                                       launches):
                    ok = self._recheck(g.inputs["pks"], sigs,
                                       g.inputs["hms"], live)
        self._note_verify(stages, launches)
        return [bool(b) for b in ok[:n]]

    def verify_host_prep(self, entries, rng=None) -> dict:
        """Host stage of `batch_verify_bytes`: wire bytes → limb planes,
        the two cache lookups (the route's: `_rows_resident` or
        `_rows_bytes`), malformed-entry flags, fresh RLC coefficient
        windows.  `rng` is for tests that need repeatable coefficients;
        the main path never passes it."""
        n = len(entries)
        if n == 0:
            return {"kind": "empty"}
        t0 = time.perf_counter()
        stages: dict[str, float] = {}
        launches: dict[str, dict[str, int]] = {}
        v = self.verify_padded_rows(n)
        sg_raw = np.broadcast_to(_G2_INF_BYTES, (v, 96)).copy()
        host_ok = np.zeros(v, bool)
        rows, msgs, pk_bytes = [], [], []
        for k, (pk, msg, sig) in enumerate(entries):
            if len(pk) != 48 or len(sig) != 96:
                continue            # malformed entry: invalid, not fatal
            sg_raw[k] = np.frombuffer(sig, np.uint8)
            rows.append(k)
            msgs.append(msg)
            pk_bytes.append(pk)
        host_ok[rows] = True
        part = (self._rows_resident if self.resident else self._rows_bytes)(
            v, rows, msgs, pk_bytes, host_ok, stages, launches)
        xc0, xc1, sign, inf, sg_bad = codec.g2_bytes_split(sg_raw)
        # fresh per-entry coefficients every call: a plain product admits
        # adversarial cross-row cancellation; the RLC rejects any invalid
        # subset except with probability ~2^-64.  Both rows of entry k
        # take r_k.
        gen = np.random.default_rng() if rng is None else rng
        r_bits = gen.integers(0, 2, (v, _RLC_BITS)).astype(np.int32)
        windows = cuda_pairing.windows_from_bits(np.repeat(r_bits, 2, axis=0))
        stages["host_prep_s"] = time.perf_counter() - t0 - sum(
            stages.get(k, 0.0)
            for k in ("devcache_gather_s", "pk_decompress_s", "h2c_host_s",
                      "h2c_s", "h2c_py_s"))
        return {**part, "n": n, "v": v,
                "xc0": np.ascontiguousarray(xc0.T),
                "xc1": np.ascontiguousarray(xc1.T), "sign": sign,
                "inf": inf, "host_ok": host_ok & ~sg_bad,
                "windows": windows, "stages": stages, "launches": launches}

    def verify_device_exec(self, prepared: dict) -> list[bool]:
        """Device stage of `batch_verify_bytes` (launch thread)."""
        if prepared["kind"] == "empty":
            return []
        dispatch.assert_off_loop("tbls.backend_cuda.verify_device_exec")
        if prepared["kind"] == "resident":
            return self._verify_exec_resident(prepared)
        p, dev = prepared, self.device
        n, v = p["n"], p["v"]
        if not p["host_ok"].any():
            return [False] * n          # nothing decodes: no device work
        stages = dict(p["stages"])
        launches = dict(p["launches"])
        clock = _StageClock(dev, stages, launches)
        sigs, sg_ok = cuda_codec.g2_decompress(self._put(p["xc0"]),
                                               self._put(p["xc1"]),
                                               self._put(p["sign"]),
                                               self._put(p["inf"]))
        sg_ok = sg_ok & ~tcurve.is_inf(F2_OPS, sigs)
        live = p["host_ok"] & sg_ok.cpu().numpy()
        live[n:] = False
        clock.lap("sig_decompress_s")
        # pair-major G1 rows: (2k, 2k+1) = (−g1, pk_k)
        pks = self._put(p["pks"])
        neg_g1 = fp.const(_NEG_G1, dev).unsqueeze(-1).expand(3, NL, v)
        base = torch.stack([neg_g1, pks], dim=-1).reshape(3, NL, 2 * v)
        p2, p3 = cuda_pairing.g1_tables(base)
        clock.lap("rlc_tables_s")
        # the Miller p-side (xP, −yP, zP): K15 negates y in its program
        p_side = cuda_pairing.g1_scalar_mul_rows(
            base, p2, p3, self._put(p["windows"]), neg_y=True)
        clock.lap("rlc_scalar_mul_s")
        hms = self._put(p["hms"])
        q = torch.stack([sigs, hms], dim=-1).reshape(3, 2, NL, 2 * v)
        f = cuda_pairing.miller_rows(p_side, cuda_pairing.g2_affine_rows(q))
        clock.lap("miller_s")
        prod = cuda_pairing.fold_product(f, self._put(np.repeat(~live, 2)))
        clock.lap("fold_s")
        _, one = cuda_final_exp.final_exp_is_one(prod.reshape(2, 3, 2, NL,
                                                              1))
        all_ok = bool(one[0])
        clock.lap("final_exp_s")
        if all_ok:
            ok = live
        else:
            # some live row fails the batch equation: re-check every entry
            # on its own so callers get exact per-entry verdicts
            ok = self._recheck(pks, sigs, hms, self._put(live))
            clock.lap("recheck_s")
        self._note_verify(stages, launches)
        return [bool(b) for b in ok[:n]]

    def _note_verify(self, stages: dict, launches: dict) -> None:
        """A tile's stages as the last call's, and into the totals."""
        self.last_stages = stages
        self.last_launches = launches
        with self._totals_lock:
            for k, sec in stages.items():
                self.verify_totals[k] = self.verify_totals.get(k, 0.0) + sec
            for k, counts in launches.items():
                tot = self.verify_launch_totals.setdefault(k, {})
                for name, c in counts.items():
                    tot[name] = tot.get(name, 0) + c

    def _recheck(self, pks, sigs, hms, live) -> np.ndarray:
        """e(−g1, sig_k)·e(pk_k, H(m_k)) == 1 for every entry k, on the
        unscaled rows [(−g1, sig_k) for k < v | (pk_k, H(m_k)) for k < v]:
        the p-side's one K1 negation, one Miller launch (K13), rows that
        are not live masked to one, one K5 product of the two halves, one
        K11 over the v rows with its verdicts; ANDed with `live` [v]
        (a device bool row)."""
        v = live.shape[0]
        neg_g1 = fp.const(_NEG_G1, pks.device).unsqueeze(-1).expand(3, NL, v)
        f = cuda_pairing.miller_rows(
            cuda_pairing.g1_proj_rows(torch.cat([neg_g1, pks], dim=-1)),
            cuda_pairing.g2_affine_rows(torch.cat([sigs, hms], dim=-1)))
        f = cuda_pairing.mask_rows(f, (~live).repeat(2))
        prod = cuda_pairing.pp_f12mul(f[..., :v], f[..., v:])
        _, one = cuda_final_exp.final_exp_is_one(prod.reshape(2, 3, 2, NL, v))
        return (one & live).cpu().numpy()

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
        put = self._put
        pts, ok = cuda_codec.g2_decompress(put(p["xc0"]), put(p["xc1"]),
                                           put(p["sign"]), put(p["inf"]))
        ok = ok.cpu().numpy()
        clock.lap("decompress_s")
        if not (ok | ~p["real"]).all():
            raise ValueError("signature bytes not on the G2 curve or not "
                             "in the G2 subgroup")
        tables = cuda_g2.straus_tables(cuda_g2.as_planes(pts))
        clock.lap("tables_s")
        out = cuda_g2.straus_msm(tables, put(p["digits"]), p["t"])
        clock.lap("straus_s")
        xc0, xc1, yc0, yc1, inf = cuda_codec.g2_normalize(
            cuda_g2.as_points(out))
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

    # -- startup prewarm ----------------------------------------------------

    def prewarm(self, pubshares, num_validators: int,
                threshold: int) -> dict:
        """What the first duty after boot would otherwise pay, done at
        boot: build the kernel library, seed the pubkey cache with every
        cluster pubshare (the resident route's device store, else the
        host LRU), run one verify of a tile's bucket — min(V,
        `VERIFY_TILE`) distinct messages, ∞ signatures, verdicts dropped —
        which captures that bucket's graph, and one combine at (V, T).
        Blocking: `dispatch.DispatchPipeline.prewarm` runs it on a thread
        of its own.  → the timing report, with the captured graphs'
        keys."""
        t_start = time.perf_counter()
        v = max(1, int(num_validators))
        t = max(1, int(threshold))
        report: dict = {"v": v, "t": t, "pubshares": len(pubshares),
                        "devcache": self.devcache_path()}
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            build.library()
        report["build_s"] = round(time.perf_counter() - t0, 4)
        if pubshares:
            t0 = time.perf_counter()
            uniq = list(dict.fromkeys(pubshares))
            if self.resident:
                with self._prep_context():
                    self._pk_rows_resident(uniq, {}, {})
            else:
                self._pk_planes_cached(uniq, {}, {})
            report["pubshare_decompress_s"] = round(
                time.perf_counter() - t0, 4)
        nv = min(v, dispatch.VERIFY_TILE)
        pk = (pubshares[0] if pubshares
              else refcurve.g1_to_bytes(refcurve.G1_GEN))
        inf_sig = _G2_INF_BYTES.tobytes()
        t0 = time.perf_counter()
        self.batch_verify_bytes([(pk, b"charon-tpu-prewarm-%d" % k, inf_sig)
                                 for k in range(nv)])
        report["verify_rows"] = nv
        report["verify_path"] = self.verify_path(nv)
        report["verify_s"] = round(time.perf_counter() - t0, 4)
        idxs = tuple(range(1, t + 1))
        t0 = time.perf_counter()
        self.threshold_combine_bytes([{i: inf_sig for i in idxs}
                                      for _ in range(v)])
        report["combine_path"] = self.combine_path()
        report["combine_s"] = round(time.perf_counter() - t0, 4)
        report["graph_keys"] = resident_graph_keys()
        report["total_s"] = round(time.perf_counter() - t_start, 4)
        return report


def _verify_tile(pks, hms, xc0, xc1, sign, inf, host_live, windows):
    """The device side of one resident verify tile of v entries: pks
    [3, 32, v] and hms [3, 2, 32, v] rows, the signatures' x planes
    [32, v] and sign / ∞ flags [v], the host validity flags [v] and the RLC
    windows [32, 2v] → (flags [v + 1] bool: the batch verdict, then `live`;
    the decompressed signatures; `live` [v]).  K12, then live = host_live
    ∧ sg_ok ∧ ¬∞ and the drop mask on the device (no host sync between
    K12 and K11), K20, K15 with −Y, K13, K14, K11 with its verdict row:
    the function the resident route captures into a CUDA graph.  The
    bytes route runs the same kernels eagerly, a stage at a time
    (`verify_device_exec`)."""
    v = pks.shape[-1]
    sigs, sg_ok = cuda_codec.g2_decompress(xc0, xc1, sign, inf)
    live = host_live & sg_ok & ~tcurve.is_inf(F2_OPS, sigs)
    # pair-major G1 rows: (2k, 2k+1) = (−g1, pk_k)
    neg_g1 = fp.const(_NEG_G1, pks.device).unsqueeze(-1).expand(3, NL, v)
    base = torch.stack([neg_g1, pks], dim=-1).reshape(3, NL, 2 * v)
    p2, p3 = cuda_pairing.g1_tables(base)
    # the Miller p-side (xP, −yP, zP): K15 negates y in its program
    p_side = cuda_pairing.g1_scalar_mul_rows(base, p2, p3, windows,
                                             neg_y=True)
    q = torch.stack([sigs, hms], dim=-1).reshape(3, 2, NL, 2 * v)
    f = cuda_pairing.miller_rows(p_side, cuda_pairing.g2_affine_rows(q))
    drop = (~live).unsqueeze(-1).expand(v, 2).reshape(2 * v)
    prod = cuda_pairing.fold_product(f, drop)
    _, one = cuda_final_exp.final_exp_is_one(prod.reshape(2, 3, 2, NL, 1))
    return torch.cat([one, live]), sigs, live


class _VerifyGraph:
    """One padded bucket v of the resident route: the static inputs of
    `_verify_tile` and, on the card, the CUDA graph one call of it was
    captured into.  `lock` is held from `load` until the tile has read
    what it needs of the graph's outputs (its re-check included): the
    launch and prewarm threads share the buckets."""

    def __init__(self, device: torch.device, v: int):
        self.device = device
        self.lock = threading.Lock()
        i32 = {"dtype": torch.int32, "device": device}
        b = {"dtype": torch.bool, "device": device}
        self.inputs = {
            "pks": torch.zeros((3, NL, v), **i32),
            "hms": torch.zeros((3, 2, NL, v), **i32),
            "xc0": torch.zeros((NL, v), **i32),
            "xc1": torch.zeros((NL, v), **i32),
            "sign": torch.zeros(v, **b), "inf": torch.zeros(v, **b),
            "host_live": torch.zeros(v, **b),
            "windows": torch.zeros((_RLC_BITS // 2, 2 * v), **i32)}
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs: tuple | None = None
        #: the launches captured into the graph, counted again each replay
        self.launches: list = []

    def load(self, p: dict) -> None:
        """A prepared tile into the static inputs (the caller's stream):
        its rows device to device, its host planes and fresh windows
        uploaded — never baked into the capture."""
        st = self.inputs
        st["pks"].copy_(p["pks"])
        st["hms"].copy_(p["hms"])
        for key, host in (("xc0", p["xc0"]), ("xc1", p["xc1"]),
                          ("sign", p["sign"]), ("inf", p["inf"]),
                          ("host_live", p["host_ok"]),
                          ("windows", p["windows"])):
            st[key].copy_(torch.from_numpy(np.ascontiguousarray(host)))

    def capture(self) -> None:
        """One eager call (it uploads every constant the body reads: a
        pageable copy inside a capture is an error), then the capture on a
        stream of its own, in thread-local mode so the prep thread's
        allocations and copies go on meanwhile."""
        cur = torch.cuda.current_stream(self.device)
        _verify_tile(**self.inputs)
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side), launch_count.capture() as rec:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outputs = _verify_tile(**self.inputs)
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
        cur.wait_stream(side)
        self.graph, self.outputs, self.launches = graph, outputs, rec

    def run(self) -> tuple:
        """→ `_verify_tile`'s outputs for the loaded inputs: a replay on
        the caller's stream on the card, a call on the CPU."""
        if self.graph is None:
            return _verify_tile(**self.inputs)
        self.graph.replay()
        launch_count.replay(self.launches)
        return self.outputs


#: the resident route's buckets per (device, padded v)
_GRAPHS: dict[tuple[str, int], _VerifyGraph] = {}
_GRAPHS_LOCK = threading.Lock()


def _verify_graph(device: torch.device, v: int) -> _VerifyGraph:
    with _GRAPHS_LOCK:
        g = _GRAPHS.get((str(device), v))
        if g is None:
            g = _GRAPHS[(str(device), v)] = _VerifyGraph(device, v)
        return g


def resident_graph_keys() -> list[str]:
    """The resident route's captured verify graphs (``resident:rlc:v=N``;
    on the CPU, the buckets used)."""
    with _GRAPHS_LOCK:
        return [f"resident:rlc:v={v}" for _, v in sorted(_GRAPHS)]


def _affine_planes(pts: torch.Tensor) -> torch.Tensor:
    """Projective G2 [3, 2, 32, m] → the message LRU's packed affine
    planes [3, 2, 32, m] (canonical x, y and z = 1; ∞ as (0, 1, 0)), the
    layout `curve.g2_pack` gives the host hash: one K19 launch."""
    xc0, xc1, yc0, yc1, inf = cuda_codec.g2_normalize(pts)
    zero = torch.zeros_like(xc0)
    one = fp.elem(fp.ONE, xc0.device).expand_as(xc0)
    x = torch.stack([torch.where(inf, zero, xc0), torch.where(inf, zero, xc1)])
    y = torch.stack([torch.where(inf, one, yc0), torch.where(inf, zero, yc1)])
    z = torch.stack([torch.where(inf, zero, one), zero])
    return torch.stack([x, y, z])


_KERNELS = (*cuda_fp.LAUNCHES, *cuda_g2.LAUNCHES, *cuda_pairing.LAUNCHES,
            *cuda_h2c.LAUNCHES, *cuda_final_exp.LAUNCHES,
            *cuda_codec.LAUNCHES)


def _launch_counts() -> dict[str, int]:
    """The calling thread's launches per kernel (every kernel named)."""
    mine = launch_count.this_thread()
    return {k: mine.get(k, 0) for k in _KERNELS}


@contextlib.contextmanager
def _own_stream_stage(stream, name: str, seconds: dict, launches: dict):
    """Run the body as stage `name` on `stream` (None: host time).  Its
    seconds are CUDA-event time on that stream, so work another thread
    has queued on the card is not waited for; its launches are the
    calling thread's.  A stage run twice in one call adds up."""
    n0 = _launch_counts()
    if stream is None:
        t0 = time.perf_counter()
        yield
        sec = time.perf_counter() - t0
    else:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            start.record(stream)
            yield
            end.record(stream)
        end.synchronize()
        sec = start.elapsed_time(end) / 1e3
    n1 = _launch_counts()
    seconds[name] = seconds.get(name, 0.0) + sec
    mine = launches.setdefault(name, {})
    for k in n1:
        mine[k] = mine.get(k, 0) + n1[k] - n0[k]


class _StageClock:
    """Host seconds and the calling thread's kernel launches between
    stage boundaries, each ended by a synchronise of the thread's current
    stream (so a stage's time includes its kernels, and not another
    thread's)."""

    def __init__(self, device: torch.device, seconds: dict, launches: dict):
        self._device = device
        self._seconds = seconds
        self._launches = launches
        self._t = time.perf_counter()
        self._n = _launch_counts()

    def lap(self, name: str) -> None:
        if self._device.type == "cuda":
            torch.cuda.current_stream(self._device).synchronize()
        now, n = time.perf_counter(), _launch_counts()
        self._seconds[name] = now - self._t
        self._launches[name] = {k: n[k] - self._n[k] for k in n}
        self._t, self._n = now, n
