"""The port's QBFT (`charon_tpu_torch.core.qbft`) against the JAX package's
(`charon_tpu.core.qbft`).

(i)  The scenarios of tests/test_qbft.py — happy path, dead leader, lost
     quorum, laggard via DECIDED, n = 3 — run on both modules over the
     same in-memory network.  Each process's decided value and round must
     match, and on the happy path so must each process's sequence of
     upon-rules (rule, round, message type, source).
(ii) The hand-made justification cases of that file (a fake round change,
     DECIDED without a quorum of commits) on both modules.
(iii) A hypothesis test sends random message sets through `classify`,
     `next_min_round`, the `is_justified_*` family, `get_justified_qrc`,
     `get_prepare_quorums` and the helpers on both modules and compares
     the results, messages compared as plain tuples.
"""

import asyncio

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from charon_tpu.core import qbft as jqbft
from charon_tpu_torch.core import qbft as tqbft

MODS = {"jax": jqbft, "port": tqbft}


# -- (i) the cluster scenarios -----------------------------------------------

class Network:
    """In-memory broadcast network with per-process inboxes."""

    def __init__(self, mod, n: int):
        self.mod = mod
        self.queues = {p: asyncio.Queue() for p in range(n)}

    def transport(self, process: int):
        async def broadcast(msg):
            for q in self.queues.values():
                await q.put(msg)
        return self.mod.Transport(broadcast, self.queues[process])


async def run_cluster(mod, n: int, inputs, dead=(), run_for: float = 3.0,
                      late=(), timeout: float = 0.1):
    """→ ({process: (value, round)}, {process: [(rule, round, type,
    source)]}) — tests/test_qbft.py's harness, recording rules too."""
    decided, rules = {}, {p: [] for p in range(n)}

    async def decide(instance, value, justification):
        p = int(asyncio.current_task().get_name().split("-")[1])
        decided.setdefault(p, (value, justification[0].round))

    def on_rule(instance, process, round_, msg, rule):
        rules[process].append((
            rule.name, round_, None if msg is None else msg.type.name,
            None if msg is None else msg.source))

    d = mod.Definition(
        is_leader=lambda inst, rnd, proc: (rnd - 1) % n == proc,
        round_timeout=lambda rnd: timeout * (1 + 0.5 * rnd),
        nodes=n, decide=decide, on_rule=on_rule)
    net = Network(mod, n)
    loop = asyncio.get_running_loop()
    tasks = {}

    def start(p):
        tasks[p] = loop.create_task(
            mod.run(d, net.transport(p), "inst-1", p, inputs[p]),
            name=f"proc-{p}")

    for p in range(n):
        if p not in dead and p not in late:
            start(p)
    if late:
        await asyncio.sleep(timeout * 5)
        for p in late:
            start(p)
    deadline = loop.time() + run_for
    want = n - len(dead)
    while loop.time() < deadline and len(decided) < want:
        await asyncio.sleep(0.02)
    for t in tasks.values():
        t.cancel()
    await asyncio.sleep(0)
    return decided, rules


SCENARIOS = {
    # name: (n, inputs, dead, late, run_for, expected value, round)
    "happy_path": (4, ["v0", "v1", "v2", "v3"], (), (), 3.0, "v0", 1),
    "dead_leader": (4, ["v0", "v1", "v2", "v3"], (0,), (), 3.0, "v1", 2),
    "lost_quorum": (4, ["v0", "v1", "v2", "v3"], (2, 3), (), 1.0, None,
                    None),
    "laggard_via_decided": (4, ["v0", "v1", "v2", "v3"], (), (3,), 5.0,
                            "v0", 1),
    "n_equals_3": (3, ["a", "b", "c"], (), (), 3.0, "a", 1),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_cluster_scenario_decides_as_the_jax_qbft(name):
    n, inputs, dead, late, run_for, value, round_ = SCENARIOS[name]
    got = {}
    for label, mod in MODS.items():
        got[label] = asyncio.run(run_cluster(mod, n, inputs, dead=dead,
                                             late=late, run_for=run_for))
    (jdec, jrules), (tdec, trules) = got["jax"], got["port"]
    assert tdec == jdec
    if value is None:
        assert tdec == {}
    else:
        assert len(tdec) == n - len(dead)
        assert set(tdec.values()) == {(value, round_)}
    if name == "happy_path":
        assert trules == jrules
        assert all(r and r[-1][0] == "QUORUM_COMMITS"
                   for r in trules.values()), trules


# -- (ii) the hand-made justification cases ----------------------------------

@pytest.mark.parametrize("label", sorted(MODS))
def test_fake_round_change_and_decided_quorum(label):
    mod = MODS[label]
    d = mod.Definition(is_leader=lambda i, r, p: r % 4 == p,
                       round_timeout=lambda r: 1.0, nodes=4)
    fake = mod.Msg(mod.MsgType.ROUND_CHANGE, "i", source=2, round=3,
                   prepared_round=2, prepared_value="evil", justification=())
    ok = mod.Msg(mod.MsgType.ROUND_CHANGE, "i", source=2, round=3)
    commits = tuple(mod.Msg(mod.MsgType.COMMIT, "i", source=s, round=1,
                            value="v") for s in range(3))
    good = mod.Msg(mod.MsgType.DECIDED, "i", source=0, round=1, value="v",
                   justification=commits)
    bad = mod.Msg(mod.MsgType.DECIDED, "i", source=0, round=1, value="v",
                  justification=commits[:2])
    verdicts = [mod.is_justified(d, "i", m) for m in (fake, ok, good, bad)]
    assert verdicts == [False, True, True, False]


# -- (iii) random message sets through the pure functions --------------------

VALUES = st.sampled_from([None, "a", "b"])


def base_msg(n: int):
    return st.tuples(st.integers(1, 5), st.integers(0, n - 1),
                     st.integers(1, 4), VALUES, st.integers(0, 3), VALUES)


def msg_spec(n: int):
    """(type, source, round, value, pr, pv, justification specs)."""
    return st.tuples(base_msg(n),
                     st.lists(base_msg(n), max_size=5).map(tuple))


def build(mod, spec):
    (typ, src, rnd, val, pr, pv), just = spec
    return mod.Msg(mod.MsgType(typ), "inst", src, rnd, val, pr, pv,
                   tuple(mod.Msg(mod.MsgType(t), "inst", s, r, v, p, q)
                         for t, s, r, v, p, q in just))


def canon(mod, x):
    """Messages as plain tuples, enums as ints, the J1 sentinel named."""
    if x is mod._NULL:
        return "NULL"
    if isinstance(x, mod.Msg):
        return (int(x.type), x.instance, x.source, x.round, x.value,
                x.prepared_round, x.prepared_value,
                canon(mod, x.justification))
    if isinstance(x, (list, tuple)):
        return tuple(canon(mod, e) for e in x)
    if isinstance(x, dict):
        return {k: canon(mod, v) for k, v in x.items()}
    if hasattr(x, "name") and hasattr(x, "value"):
        return int(x)
    return x


def pure_results(mod, n: int, lead: int, round_: int, process: int,
                 specs, probe):
    """Every pure function of the module on one message set."""
    d = mod.Definition(is_leader=lambda i, r, p: (r + lead) % n == p,
                       round_timeout=lambda r: 1.0, nodes=n)
    msgs = [build(mod, s) for s in specs]
    msg = build(mod, probe)
    buffer: dict = {}
    for m in msgs:
        buffer.setdefault(m.source, []).append(m)
    flat = mod.flatten(buffer)
    out = {
        "quorum": (d.quorum, d.faulty),
        "flatten": flat,
        "classify": mod.classify(d, "inst", round_, process, buffer, msg),
        "is_justified": [mod.is_justified(d, "inst", m) for m in msgs + [msg]],
        "is_justified_round_change": [
            mod.is_justified_round_change(d, m) for m in msgs + [msg]],
        "is_justified_decided": [
            mod.is_justified_decided(d, m) for m in msgs + [msg]],
        "is_justified_pre_prepare": [
            mod.is_justified_pre_prepare(d, "inst", m) for m in msgs + [msg]],
        "contains_justified_qrc": [
            mod.contains_justified_qrc(d, list(msg.justification) + flat, r)
            for r in range(1, 5)],
        "get_single_justified_pr_pv": mod.get_single_justified_pr_pv(d, flat),
        "get_justified_qrc": [mod.get_justified_qrc(d, flat, r)
                              for r in range(1, 5)],
        "get_prepare_quorums": mod.get_prepare_quorums(d, flat),
        "filter_msgs": [mod.filter_msgs(flat, mod.MsgType(t), r)
                        for t in range(1, 6) for r in range(1, 5)],
        "filter_msgs_value": [mod.filter_msgs(flat, mod.MsgType(t), r, value=v)
                              for t in (2, 3) for r in (1, 2)
                              for v in (None, "a")],
    }
    frcs = []
    for r in range(0, 5):
        frc = mod.get_f_plus_1_round_changes(d, flat, r)
        frcs.append((frc, None if frc is None
                     else mod.next_min_round(d, frc, r)))
    out["f_plus_1_round_changes"] = frcs
    return canon(mod, out)


@settings(max_examples=300, deadline=None)
@given(st.sampled_from([3, 4, 5, 7]).flatmap(lambda n: st.tuples(
    st.just(n), st.integers(0, n - 1), st.integers(1, 4),
    st.integers(0, n - 1), st.lists(msg_spec(n), max_size=14),
    msg_spec(n))))
def test_pure_functions_equal_the_jax_qbft(case):
    n, lead, round_, process, specs, probe = case
    want = pure_results(jqbft, n, lead, round_, process, specs, probe)
    got = pure_results(tqbft, n, lead, round_, process, specs, probe)
    assert got == want


def test_pure_functions_see_every_rule():
    """The random cases are not all NOTHING: a hand-made set reaches each
    classification on both modules alike."""
    n = 4
    prep = [((2, s, 1, "a", 0, None), ()) for s in range(3)]
    com = [((3, s, 1, "a", 0, None), ()) for s in range(3)]
    rc = [((4, s, 2, None, 0, None), ()) for s in range(3)]
    cases = {
        "JUSTIFIED_PRE_PREPARE": ([], ((1, 1, 1, "a", 0, None), ())),
        "QUORUM_PREPARES": (prep, prep[0]),
        "QUORUM_COMMITS": (com, com[0]),
        "F_PLUS_1_ROUND_CHANGES": ([((4, s, 3, None, 0, None), ())
                                    for s in range(2)],
                                   ((4, 1, 3, None, 0, None), ())),
        "QUORUM_ROUND_CHANGES": (rc, rc[2]),
        "JUSTIFIED_DECIDED": ([], ((5, 0, 1, "a", 0, None),
                                   tuple(c[0] for c in com))),
    }
    for want, (specs, probe) in cases.items():
        # the leader of round 2 is process 2 when lead = 0
        results = [pure_results(mod, n, 0, 1 if want != "QUORUM_ROUND_CHANGES"
                                else 2, 2, specs, probe)
                   for mod in (jqbft, tqbft)]
        assert results[0] == results[1]
        assert tqbft.UponRule(results[1]["classify"][0]).name == want, want
