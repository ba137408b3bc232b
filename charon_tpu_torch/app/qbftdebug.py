"""QBFT debug sniffer — ring buffer of consensus instances served over the
monitoring API.

Mirrors reference core/consensus sniffer + app/qbftdebug.go:35-122: every
QBFT upon-rule firing (message received, rule classified, round) is
recorded per duty instance into a bounded ring; `/debug/qbft` renders the
ring as JSON for post-mortem analysis of stuck/slow consensus rounds.

A copy of the JAX package's app/qbftdebug.py: the sniffer only.  The
`/debug/qbft` endpoint that serves `render_json` waits for the serving
slice (`MonitoringAPI`).
"""

from __future__ import annotations

import json
import time
from collections import OrderedDict, deque
from dataclasses import asdict, dataclass, field

from ..core.types import Duty


@dataclass
class SniffedMsg:
    at: float
    process: int
    round: int
    rule: str
    msg_type: str | None
    source: int | None


@dataclass
class SniffedInstance:
    duty: str
    started: float
    msgs: list = field(default_factory=list)
    decided: bool = False
    # OTLP linkage: the duty's deterministic trace ID + the instance
    # span's ID, so a /debug/qbft entry points straight at the matching
    # trace in the collector (stamped by core.consensus when tracing is
    # wired; empty without it).
    trace_id: str = ""
    span_id: str = ""


class QBFTSniffer:
    """Bounded per-instance message recorder (ring over instances)."""

    def __init__(self, max_instances: int = 128, max_msgs: int = 512):
        self._instances: "OrderedDict[str, SniffedInstance]" = OrderedDict()
        self._max_instances = max_instances
        self._max_msgs = max_msgs

    def on_rule(self, duty: Duty, trace_id: str = "", span_id: str = ""):
        """Returns a qbft.Definition.on_rule hook bound to this duty."""
        key = str(duty)

        def hook(instance, process, round_, msg, rule) -> None:
            inst = self._instances.get(key)
            if inst is None:
                inst = SniffedInstance(duty=key, started=time.time(),
                                       trace_id=trace_id, span_id=span_id)
                self._instances[key] = inst
                while len(self._instances) > self._max_instances:
                    self._instances.popitem(last=False)
            if len(inst.msgs) >= self._max_msgs:
                return
            rule_name = getattr(rule, "name", str(rule))
            inst.msgs.append(SniffedMsg(
                at=time.time(), process=process, round=round_,
                rule=rule_name,
                msg_type=(getattr(msg.type, "name", str(msg.type))
                          if msg is not None else None),
                source=(msg.source if msg is not None else None)))
            # decision fires on quorum commits or a relayed decided msg
            # (core/qbft.py Algorithm 2:8)
            if rule_name in ("QUORUM_COMMITS", "JUSTIFIED_DECIDED"):
                inst.decided = True

        return hook

    def render_json(self) -> bytes:
        out = []
        for inst in self._instances.values():
            out.append({
                "duty": inst.duty,
                "started": inst.started,
                "decided": inst.decided,
                "trace_id": inst.trace_id,
                "span_id": inst.span_id,
                "n_msgs": len(inst.msgs),
                "msgs": [asdict(m) for m in inst.msgs],
            })
        return json.dumps({"instances": out}, indent=1).encode()
