"""The port's `tbls/devcache.DeviceRowCache` (a torch store, limbs-major
[planes, 32, capacity]) against the JAX package's (a jax store, tiled
[planes, 32, S, 128]) on the CPU, fed the same key and row sequences:
the same slots, misses, evictions and overflows, the same counters and
`ok` flags, and the same rows gathered, bit for bit; `protect`, `clear()`
and the capacity model as well.
"""

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from charon_tpu.ops import vmem_budget
from charon_tpu.tbls import devcache as jdc
from charon_tpu_torch.tbls import devcache as tdc

COUNTERS = ("hits", "misses", "evictions", "inserts", "overflows")


def _pair(n_planes: int, capacity: int):
    return (jdc.DeviceRowCache("t", n_planes, capacity),
            tdc.DeviceRowCache("t", n_planes, capacity))


def _same_state(jc, tc):
    js, ts = jc.stats(), tc.stats()
    for k in ("rows", "capacity_rows", "bytes", "capacity_bytes",
              *COUNTERS):
        assert js[k] == ts[k], k


def _same_rows(jrows, trows):
    """JAX rows [n, P, 32] against the port's [P, 32, n], bit for bit."""
    np.testing.assert_array_equal(np.asarray(jrows),
                                  trows.permute(2, 0, 1).numpy())


@pytest.mark.parametrize("n_planes,capacity", [(3, 128), (6, 256)])
def test_same_slots_counters_and_rows_as_jax(n_planes, capacity):
    """A random run of lookups and commits over a key space twice the
    capacity: every step's slots, misses and ok flags, the counters and
    the gathered rows equal the JAX cache's."""
    jc, tc = _pair(n_planes, capacity)
    rng = np.random.default_rng(capacity + n_planes)
    space = [b"key-%d" % k for k in range(2 * capacity)]
    for step in range(12):
        keys = [space[k] for k in rng.integers(0, len(space), 64)]
        j_idx, j_ok, j_miss, j_rows = jc.lookup_rows(keys)
        t_idx, t_ok, t_miss, t_rows = tc.lookup_rows(keys)
        np.testing.assert_array_equal(j_idx, t_idx)
        np.testing.assert_array_equal(j_ok, t_ok)
        assert j_miss == t_miss
        _same_rows(j_rows, t_rows)
        if j_miss:
            rows = rng.integers(0, 4096, (len(j_miss), n_planes, 32),
                                dtype=np.int32)
            ok = rng.integers(0, 2, len(j_miss)).astype(bool)
            j_slots = jc.commit(j_miss, rows, ok)
            t_slots = tc.commit(
                t_miss, torch.from_numpy(rows.transpose(1, 2, 0).copy()), ok)
            np.testing.assert_array_equal(j_slots, t_slots)
        _same_state(jc, tc)
    assert jc.evictions > 0
    held = [k for k in space if jc.lookup([k])[0][0] >= 0]
    assert held == [k for k in space if tc.lookup([k])[0][0] >= 0]
    idx, _, _ = jc.lookup(held)
    _same_rows(jc.gather(idx), tc.gather(idx))


def test_overflow_and_protect_as_jax():
    """A commit larger than the cache overflows its excess keys as −1;
    `protect` keeps a batch's own slots from eviction."""
    jc, tc = _pair(1, 128)
    keys = [b"a%d" % k for k in range(130)]
    rows = np.arange(130 * 32, dtype=np.int32).reshape(130, 1, 32)
    trows = torch.from_numpy(rows.transpose(1, 2, 0).copy())
    ok = np.ones(130, bool)
    j_slots = jc.commit(keys, rows, ok)
    t_slots = tc.commit(keys, trows, ok)
    np.testing.assert_array_equal(j_slots, t_slots)
    assert (t_slots[128:] == -1).all() and tc.overflows == 2
    idx, _, _ = tc.lookup(keys[:128])
    jc.lookup(keys[:128])
    new = [b"b0", b"b1"]
    j_slots = jc.commit(new, rows[:2], ok[:2], protect=idx)
    t_slots = tc.commit(new, trows[..., :2], ok[:2], protect=idx)
    np.testing.assert_array_equal(j_slots, t_slots)
    assert (t_slots == -1).all() and tc.evictions == 0
    # a protect list that leaves one slot free to evict
    j_slots = jc.commit(new, rows[:2], ok[:2], protect=idx[1:])
    t_slots = tc.commit(new, trows[..., :2], ok[:2], protect=idx[1:])
    np.testing.assert_array_equal(j_slots, t_slots)
    assert t_slots[0] == idx[0] and t_slots[1] == -1
    _same_state(jc, tc)
    _same_rows(jc.gather(j_slots[:1]), tc.gather(t_slots[:1]))


def test_clear_as_jax():
    jc, tc = _pair(3, 128)
    keys = [b"c%d" % k for k in range(40)]
    rows = np.arange(40 * 3 * 32, dtype=np.int32).reshape(40, 3, 32)
    ok = np.arange(40) % 3 != 0
    for c, r in ((jc, rows), (tc, torch.from_numpy(
            rows.transpose(1, 2, 0).copy()))):
        c.commit(keys, r, ok)
        c.lookup(keys[:5])
        c.clear()
    _same_state(jc, tc)
    assert tc.stats()["rows"] == 0 and tc._store is None    # released
    assert tc.hits == 5 and tc.inserts == 40       # cumulative
    j_idx, j_ok, j_miss = jc.lookup(keys)
    t_idx, t_ok, t_miss = tc.lookup(keys)
    assert (t_idx == -1).all() and t_miss == keys
    np.testing.assert_array_equal(j_ok, t_ok)
    # after clear the free list starts again at slot 0
    np.testing.assert_array_equal(jc.commit(keys[:3], rows[:3], ok[:3]),
                                  tc.commit(keys[:3], torch.from_numpy(
                                      rows[:3].transpose(1, 2, 0).copy()),
                                      ok[:3]))
    _, t_ok, _ = tc.lookup(keys[:3])
    np.testing.assert_array_equal(t_ok, ok[:3])


@pytest.mark.parametrize("n_planes,share,mb", [
    (3, 1 / 3, 96.0), (6, 2 / 3, 96.0), (3, 1 / 3, 0.140625),
    (6, 2 / 3, 2.25), (3, 1.0, 0.01), (6, 0.5, 1000.0)])
def test_capacity_model_as_jax(n_planes, share, mb):
    budget = tdc.devcache_budget_bytes(mb)
    assert budget == int(mb * 1024 * 1024)
    assert tdc.devcache_row_bytes(n_planes) == \
        vmem_budget.devcache_row_bytes(n_planes)
    assert tdc.devcache_capacity_rows(n_planes, share, budget) == \
        vmem_budget.devcache_capacity_rows(n_planes, share, budget)


def test_capacity_defaults_and_refusals():
    budget = tdc.devcache_budget_bytes()
    assert budget == vmem_budget.DEVCACHE_DEFAULT_MB * 2 ** 20
    # the 96 MiB default: 87,296 rows each, 33.5 MB of pk and 67 MB of hm
    pk = tdc.devcache_capacity_rows(3, tdc.PK_SHARE, budget)
    hm = tdc.devcache_capacity_rows(6, tdc.HM_SHARE, budget)
    assert pk == hm == 87_296
    assert (pk * tdc.devcache_row_bytes(3), hm * tdc.devcache_row_bytes(6)) \
        == (33_521_664, 67_043_328)
    # the port's per-store budgets: 2.25 MiB gives 2,048 rows a store
    assert tdc.devcache_capacity_rows(
        3, tdc.PK_SHARE, tdc.devcache_budget_bytes(2.25)) == 2048
    with pytest.raises(ValueError):
        tdc.devcache_budget_bytes(0)
    for bad in (0, 100, 129):
        with pytest.raises(ValueError):
            tdc.DeviceRowCache("t", 3, bad)
        with pytest.raises(ValueError):
            jdc.DeviceRowCache("t", 3, bad)
