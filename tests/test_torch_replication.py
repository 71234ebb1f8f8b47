"""The port's replication membership layer against the JAX package's, on the
CPU: quorum math, group striping, the read plan, the membership table, the
repair queue, the discovery parser, the failover rules and the two cfgs'
environment parsing and validation. Every case feeds the same inputs to
both packages and asks for the same answer (or the same refusal)."""

import logging

import pytest

from distributed_faiss_tpu.parallel import replication as jrep
from distributed_faiss_tpu.parallel import rpc as jrpc
from distributed_faiss_tpu.utils.config import AntiEntropyCfg as JAntiEntropyCfg
from distributed_faiss_tpu.utils.config import ReplicationCfg as JReplicationCfg
from distributed_faiss_tpu.utils.state import IndexState as JState
from distributed_faiss_tpu.utils.state import NOT_TRAINED_REJECTION_FMT as J_NOT_TRAINED
from distributed_faiss_tpu.utils.state import STALE_READ_REJECTION_FMT as J_STALE
from distributed_faiss_tpu_torch.parallel import replication as trep
from distributed_faiss_tpu_torch.parallel import rpc as trpc
from distributed_faiss_tpu_torch.utils.config import AntiEntropyCfg, ReplicationCfg
from distributed_faiss_tpu_torch.utils.state import IndexState


def _outcome(fn, *args):
    """fn's value, or the type of what it raised."""
    try:
        return fn(*args)
    except Exception as e:  # the refusal itself is compared
        return type(e)


@pytest.mark.parametrize("replication", [0, 1, 2, 3, 4, 5])
def test_quorum_size_matches_jax(replication):
    for wq in range(-1, 7):
        assert (_outcome(trep.quorum_size, replication, wq)
                == _outcome(jrep.quorum_size, replication, wq)), wq


@pytest.mark.parametrize("replication", [0, 1, 2, 3, 4])
def test_assign_groups_matches_jax(replication, caplog):
    caplog.set_level(logging.WARNING)
    for n in range(0, 10):
        assert (_outcome(trep.assign_groups, n, replication)
                == _outcome(jrep.assign_groups, n, replication)), n


# (groups by stub position, preferred, suspects)
PLANS = [
    ([0], {}, ()),
    ([0, 1, 0, 1], {}, ()),
    ([0, 1, 0, 1], {0: 2}, ()),
    ([0, 1, 0, 1], {0: 2, 1: 7}, {1}),
    ([0, 0, 0, 1, 1, 1], {0: 1}, {1, 3, 4}),
    ([2, 0, 2, 0, 1], {}, {0, 1, 2, 3, 4}),
]


@pytest.mark.parametrize("groups,preferred,suspects", PLANS)
def test_plan_read_fanout_matches_jax(groups, preferred, suspects):
    got = trep.plan_read_fanout(trep.MembershipTable(groups), preferred, suspects)
    want = jrep.plan_read_fanout(jrep.MembershipTable(groups), preferred, suspects)
    assert got == want
    # one entry per group, each group's replicas exactly once
    assert sorted(g for g, _p, _o in got) == sorted(set(groups))
    for g, pick, ordering in got:
        assert ordering[0] == pick
        assert sorted(ordering) == [p for p, gg in enumerate(groups) if gg == g]


def test_membership_table_matches_jax():
    """The same register/remove sequence leaves both tables with the same
    groups, replicas and group of every position."""
    ops = [("register", 1, 0), ("register", 2, 5), ("remove", 0), ("register", 3, 1),
           ("register", 3, 1), ("remove", 9), ("register", 0, 5), ("remove", 2)]
    tables = [trep.MembershipTable([0, 1, 0, 1]), jrep.MembershipTable([0, 1, 0, 1])]
    for op in ops:
        for t in tables:
            getattr(t, op[0])(*op[1:])
        a, b = tables
        assert a.snapshot() == b.snapshot() and a.groups() == b.groups()
        assert [a.group_of(p) for p in range(5)] == [b.group_of(p) for p in range(5)]
        assert [a.replicas(g) for g in range(6)] == [b.replicas(g) for g in range(6)]


@pytest.mark.parametrize("maxlen", [1, 3, 256])
def test_repair_queue_matches_jax(maxlen, caplog):
    caplog.set_level(logging.WARNING)
    queues = [trep.RepairQueue(maxlen), jrep.RepairQueue(maxlen)]
    seen = []
    for q in queues:
        for i in range(5):
            q.record({"i": i})
        first = [e["i"] for e in q.drain()]
        q.record({"i": 9})
        q.mark_repaired(2)
        seen.append((first, len(q), q.stats()))
    assert seen[0] == seen[1]
    dropped = max(0, 5 - maxlen)
    assert seen[0][2] == {"recorded": 6, "repaired": 2, "dropped": dropped, "pending": 1}


DISCOVERY = [
    "",
    "3\nhosta,1000\n\nhostb,2000\nhosta,1000\ngarbage\n",
    "x\nh,1\nh,2,extra\nh,notaport\n",
    "2\n  h , 7 \nh,7\n",
]


@pytest.mark.parametrize("text", DISCOVERY)
def test_parse_discovery_lines_matches_jax(text):
    lines = text.splitlines(keepends=True)
    assert trep.parse_discovery_lines(lines) == jrep.parse_discovery_lines(lines)


def test_failover_rules_match_jax():
    """The drain refusal and the stale-read refusal fail over; the other
    application errors and a transport error do not; both packages' server
    texts are the same."""
    assert (J_NOT_TRAINED.format(state=JState.ADD)
            == trep.NOT_TRAINED_REJECTION_FMT.format(state=IndexState.ADD))
    texts = [J_NOT_TRAINED.format(state=JState.ADD), J_NOT_TRAINED.format(state=JState.TRAINING),
             J_STALE.format(version=[1, 2, 3], watermark=None), "Server has no index with id=x"]
    for text in texts:
        got = [f(trpc.ServerException("Traceback ...\nRuntimeError: " + text))
               for f in (trep.drain_failover_eligible, trep.stale_read_failover_eligible)]
        want = [f(jrpc.ServerException("Traceback ...\nRuntimeError: " + text))
                for f in (jrep.drain_failover_eligible, jrep.stale_read_failover_eligible)]
        assert got == want
    assert [trep.drain_failover_eligible(trpc.ServerException(t)) for t in texts] == [
        True, False, False, False]
    assert not trep.drain_failover_eligible(OSError(texts[0]))


ENVS = [
    {},
    {"DFT_REPLICATION": "3", "DFT_WRITE_QUORUM": "2", "DFT_REPAIR_QUEUE": "8",
     "DFT_REPAIR_INTERVAL": "0.5", "DFT_ANTIENTROPY": "0", "DFT_ANTIENTROPY_INTERVAL": "7.5",
     "DFT_SUSPECT_AFTER": "5", "DFT_COMPACT_LEASE_TTL": "30",
     "DFT_ANTIENTROPY_DELTA_MAX": "99", "DFT_ANTIENTROPY_TIMEOUT": "1.5",
     "DFT_LEDGER_PRUNE_AGE_S": "0"},
    {"DFT_ANTIENTROPY": "false", "DFT_REPLICATION": "1"},
]


@pytest.mark.parametrize("env", ENVS)
def test_cfgs_read_the_jax_environment(env):
    assert ReplicationCfg.from_env(env).__dict__ == JReplicationCfg.from_env(env).__dict__
    assert AntiEntropyCfg.from_env(env).__dict__ == JAntiEntropyCfg.from_env(env).__dict__


BAD = [
    {"DFT_REPLICATION": "0"}, {"DFT_WRITE_QUORUM": "-1"},
    {"DFT_REPLICATION": "2", "DFT_WRITE_QUORUM": "3"}, {"DFT_REPAIR_QUEUE": "0"},
    {"DFT_REPAIR_INTERVAL": "-1"}, {"DFT_ANTIENTROPY_INTERVAL": "0"},
    {"DFT_SUSPECT_AFTER": "0"}, {"DFT_COMPACT_LEASE_TTL": "0"},
    {"DFT_ANTIENTROPY_DELTA_MAX": "0"}, {"DFT_ANTIENTROPY_TIMEOUT": "0"},
    {"DFT_LEDGER_PRUNE_AGE_S": "-1"},
]


@pytest.mark.parametrize("env", BAD)
def test_cfgs_refuse_what_jax_refuses(env):
    def parsed(cls):
        out = _outcome(cls.from_env, env)
        return out if isinstance(out, type) else out.__dict__

    for ours, theirs in ((ReplicationCfg, JReplicationCfg), (AntiEntropyCfg, JAntiEntropyCfg)):
        assert parsed(ours) == parsed(theirs)
    assert any(_outcome(c.from_env, env) is ValueError for c in (ReplicationCfg, AntiEntropyCfg))
    with pytest.raises(TypeError):
        ReplicationCfg(bogus=1)
