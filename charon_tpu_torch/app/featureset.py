"""Feature gates: alpha/beta/stable rollout statuses with per-feature
enable/disable overrides (reference: app/featureset/featureset.go:24-75).

A copy of the JAX package's app/featureset.py."""

from __future__ import annotations

from enum import IntEnum


class Status(IntEnum):
    ALPHA = 0
    BETA = 1
    STABLE = 2


# Feature -> minimum rollout status (reference featureset.go state map).
_FEATURES: dict[str, Status] = {
    "qbft_consensus": Status.STABLE,
    "priority": Status.BETA,
    "relay_discovery": Status.ALPHA,
    "tpu_sigagg": Status.STABLE,        # the batched-kernel backend
    "tpu_batch_verify": Status.BETA,
    "mock_alpha": Status.ALPHA,
}

_min_status = Status.STABLE
_overrides: dict[str, bool] = {}


def init(min_status: Status = Status.STABLE,
         enabled: list[str] = (), disabled: list[str] = ()) -> None:
    """reference: featureset.go Init (called from app wiring)."""
    global _min_status, _overrides
    _min_status = min_status
    _overrides = {}
    for f in enabled:
        _overrides[f] = True
    for f in disabled:
        _overrides[f] = False


def enabled(feature: str) -> bool:
    if feature in _overrides:
        return _overrides[feature]
    status = _FEATURES.get(feature)
    if status is None:
        return False
    return status >= _min_status


def features() -> dict[str, bool]:
    return {f: enabled(f) for f in _FEATURES}
