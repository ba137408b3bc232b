"""Layout conversion between the JAX package's arrays and the port's.

Everything here takes and returns numpy arrays; nothing imports JAX.

- JAX limb-last element batches ``[R, *elem, 32]`` ↔ port ``[*elem, 32, R]``
  (rows move from first to last);
- JAX tiled points ``[6, 32, S, 128]`` or limb-last points ``[R, 3, 2, 32]``
  ↔ port planes ``[6, 32, R]``;
- JAX tiled Straus digits ``[nwin, S, 128]`` ↔ port ``[nwin, R]``;
- JAX tiled plane stacks ``[n, 32, S, 128]`` ↔ port ``[n, 32, R]``, and
  the limb-last Fp12 ``[R, 2, 3, 2, 32]`` and G1 ``[R, 3, 32]`` batches
  ↔ port ``[12, 32, R]`` / ``[3, 32, R]`` planes;
- the hash-to-G2 inputs: JAX `pack_messages` output (u rows ``[R, 2,
  32]``, flags ``[R]``) or the tiled ``[2, 32, S, 128]`` / ``[S, 128]``
  kernel inputs ↔ port ``[2, 32, R]`` / ``[R]``, and the h2c constant
  table ``[42, 32, 128]`` ↔ ``[42, 32]``.
"""

from __future__ import annotations

import numpy as np

LANES = 128


def elems_from_jax(arr) -> np.ndarray:
    """[R, *elem, 32] → [*elem, 32, R]."""
    return np.ascontiguousarray(np.moveaxis(np.asarray(arr), 0, -1))


def elems_to_jax(arr) -> np.ndarray:
    """[*elem, 32, R] → [R, *elem, 32]."""
    return np.ascontiguousarray(np.moveaxis(np.asarray(arr), -1, 0))


def points_from_jax(arr) -> np.ndarray:
    """JAX tiled [6, 32, S, 128] or limb-last [R, 3, 2, 32] → [6, 32, R]."""
    a = np.asarray(arr)
    if a.ndim == 4 and a.shape[:2] == (6, 32):
        return np.ascontiguousarray(a.reshape(6, 32, -1))
    if a.ndim == 4 and a.shape[1:] == (3, 2, 32):
        return elems_from_jax(a).reshape(6, 32, a.shape[0])
    raise ValueError(f"not a JAX point batch: shape {a.shape}")


def points_to_jax(arr, tiled: bool = True) -> np.ndarray:
    """[6, 32, R] → JAX tiled [6, 32, R/128, 128] (tiled=True) or
    limb-last [R, 3, 2, 32]."""
    a = np.asarray(arr)
    r = a.shape[-1]
    if tiled:
        return np.ascontiguousarray(a.reshape(6, 32, r // LANES, LANES))
    return elems_to_jax(a.reshape(3, 2, 32, r))


def digits_from_jax(arr) -> np.ndarray:
    """JAX tiled digits [nwin, S, 128] → [nwin, R]."""
    a = np.asarray(arr)
    return np.ascontiguousarray(a.reshape(a.shape[0], -1))


def digits_to_jax(arr) -> np.ndarray:
    """[nwin, R] → JAX tiled [nwin, R/128, 128]."""
    a = np.asarray(arr)
    return np.ascontiguousarray(a.reshape(a.shape[0], -1, LANES))


def planes_from_jax(arr) -> np.ndarray:
    """JAX tiled plane stack [n, 32, S, 128] → [n, 32, R]."""
    a = np.asarray(arr)
    return np.ascontiguousarray(a.reshape(a.shape[0], a.shape[1], -1))


def planes_to_jax(arr) -> np.ndarray:
    """[n, 32, R] → JAX tiled [n, 32, R/128, 128]."""
    a = np.asarray(arr)
    return np.ascontiguousarray(
        a.reshape(a.shape[0], a.shape[1], -1, LANES))


def f12_from_jax(arr) -> np.ndarray:
    """JAX tiled [12, 32, S, 128] or limb-last [R, 2, 3, 2, 32] → the
    port's Fp12 planes [12, 32, R] (plane m = (k·3 + j)·2 + c)."""
    a = np.asarray(arr)
    if a.ndim == 4 and a.shape[:2] == (12, 32):
        return planes_from_jax(a)
    if a.ndim == 5 and a.shape[1:] == (2, 3, 2, 32):
        return elems_from_jax(a).reshape(12, 32, a.shape[0])
    raise ValueError(f"not a JAX Fp12 batch: shape {a.shape}")


def f12_to_jax(arr, tiled: bool = True) -> np.ndarray:
    """[12, 32, R] → JAX tiled [12, 32, R/128, 128] (tiled=True) or
    limb-last [R, 2, 3, 2, 32]."""
    a = np.asarray(arr)
    if tiled:
        return planes_to_jax(a)
    return elems_to_jax(a.reshape(2, 3, 2, 32, a.shape[-1]))


def g1_from_jax(arr) -> np.ndarray:
    """JAX tiled [3, 32, S, 128] or limb-last [R, 3, 32] → [3, 32, R]."""
    a = np.asarray(arr)
    if a.ndim == 4 and a.shape[:2] == (3, 32):
        return planes_from_jax(a)
    if a.ndim == 3 and a.shape[1:] == (3, 32):
        return elems_from_jax(a)
    raise ValueError(f"not a JAX G1 batch: shape {a.shape}")


def g1_to_jax(arr, tiled: bool = True) -> np.ndarray:
    """[3, 32, R] → JAX tiled [3, 32, R/128, 128] or limb-last [R, 3, 32]."""
    a = np.asarray(arr)
    return planes_to_jax(a) if tiled else elems_to_jax(a)


def h2c_inputs_from_jax(u, exc, sgn):
    """JAX u rows [R, 2, 32] (pack_messages) or tiled [2, 32, S, 128], and
    flags [R] or [S, 128] → port (u [2, 32, R], exc [R], sgn [R])."""
    a = np.asarray(u)
    if a.ndim == 3 and a.shape[1:] == (2, 32):
        planes = elems_from_jax(a)
    elif a.ndim == 4 and a.shape[:2] == (2, 32):
        planes = planes_from_jax(a)
    else:
        raise ValueError(f"not a JAX u batch: shape {a.shape}")
    return (planes, np.ascontiguousarray(np.asarray(exc).reshape(-1)),
            np.ascontiguousarray(np.asarray(sgn).reshape(-1)))


def h2c_inputs_to_jax(u, exc, sgn):
    """Port (u [2, 32, R], exc [R], sgn [R]) → the JAX pipeline's tiled
    inputs (u [2, 32, R/128, 128], exc and sgn [R/128, 128])."""
    r = np.asarray(u).shape[-1]
    return (planes_to_jax(u),
            np.ascontiguousarray(np.asarray(exc).reshape(r // LANES, LANES)),
            np.ascontiguousarray(np.asarray(sgn).reshape(r // LANES, LANES)))


def h2c_consts_from_jax(hc) -> np.ndarray:
    """JAX lane-broadcast table [42, 32, 128] → [42, 32]."""
    return np.ascontiguousarray(np.asarray(hc)[:, :, 0])


def h2c_consts_to_jax(hc) -> np.ndarray:
    """[42, 32] → the JAX kernels' lane-broadcast [42, 32, 128]."""
    a = np.asarray(hc)
    return np.ascontiguousarray(np.broadcast_to(a[:, :, None],
                                                a.shape + (LANES,)))
