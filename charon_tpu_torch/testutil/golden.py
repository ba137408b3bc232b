"""Golden-file test helper (reference: testutil/golden.go:39-100).

`require_golden_json(name, obj)` compares `obj` against the committed
snapshot tests/testdata/<name>.json.  A copy of the JAX package's
testutil/golden.py that reads the SAME snapshots and never writes one: the
two packages share their wire formats (cluster files, beacon-API JSON, the
core wire codec), so the port is held to the files the JAX package pins,
and regenerating them is that package's job (``CHARON_TPU_UPDATE_GOLDEN=1``
with its own helper).  A missing snapshot fails.
"""

from __future__ import annotations

import json
import os

_TESTDATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "tests", "testdata")


def require_golden_json(name: str, obj) -> None:
    """Assert obj equals the committed snapshot tests/testdata/<name>.json."""
    path = os.path.join(_TESTDATA, name + ".json")
    if not os.path.exists(path):
        raise AssertionError(f"golden file {name}.json is missing from "
                             f"{_TESTDATA}")
    rendered = json.dumps(obj, indent=2, sort_keys=True)
    with open(path) as f:
        want = f.read().rstrip("\n")
    assert rendered == want, (
        f"golden mismatch for {name}.json — the port's output differs from "
        f"the committed snapshot\n"
        f"got:\n{rendered[:2000]}\nwant:\n{want[:2000]}")
