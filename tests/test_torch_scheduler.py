"""The port's admission schedulers (``repro_torch.serving.scheduler``)
against the JAX package's, host-side only.

The same seeded pushes (priorities, schedule lengths, deadlines, guided
and unguided shapes, tenants and weights) and the same ``can_fit`` masks
go through the reference's and the port's FIFO, SJF, EDF and WFQ queues:
the pop orders are identical. Then the port's own analogues of
``tests/test_scheduler.py``: WFQ's weight share, no retroactive credit
and its starvation bound, backfill, ``make_scheduler`` /
``fresh_scheduler`` resolution and the non-positive weight error.
"""
import random

import pytest

from repro.serving.policy import RequestPolicy as JRequestPolicy
from repro.serving.scheduler import QueueItem as JQueueItem
from repro.serving.scheduler import make_scheduler as jmake_scheduler
from repro_torch.serving.policy import RequestPolicy
from repro_torch.serving.scheduler import (SCHEDULERS, EDFScheduler,
                                           FIFOScheduler, QueueItem,
                                           SJFScheduler, WFQScheduler,
                                           fresh_scheduler, make_scheduler)


def _spec(rng, seq):
    return dict(seq=seq, steps=rng.randint(1, 30),
                priority=rng.choice([0, 0, 1, 5]),
                deadline=None if rng.random() < 0.3
                else float(rng.randint(5, 90)),
                streams=rng.choice([1, 1, 2]),
                tenant=rng.choice(["gold", "silver", "bronze"]),
                weight=rng.choice([0.5, 1.0, 4.0]))


def _item(QI, Pol, spec):
    pol = Pol(priority=spec["priority"], deadline=spec["deadline"],
              guidance_scale=4.0 if spec["streams"] == 2 else None,
              tenant=spec["tenant"], weight=spec["weight"])
    return QI(seq=spec["seq"], request=None, policy=pol, steps=spec["steps"],
              ticket_id=spec["seq"])


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
@pytest.mark.parametrize("seed", range(6))
def test_pop_order_matches_reference(name, seed):
    """Interleaved pushes and pops, each pop under a seeded fit mask
    (singles only, pairs only, everything or nothing): the reference's and
    the port's queues pop the same items, in the same order."""
    rng = random.Random(1000 * seed + len(name))
    ref, got = jmake_scheduler(name), make_scheduler(name)
    assert got.name == ref.name == name
    seq = 0
    for _ in range(60):
        if rng.random() < 0.6:
            spec = _spec(rng, seq)
            seq += 1
            ref.push(_item(JQueueItem, JRequestPolicy, spec))
            got.push(_item(QueueItem, RequestPolicy, spec))
        else:
            fit = rng.choice([None, 1, 2, 0])
            can = None if fit is None else (
                lambda it, f=fit: f != 0 and it.streams == f)
            a, b = ref.pop(can), got.pop(can)
            assert (a and a.seq) == (b and b.seq)
        assert len(ref) == len(got)
    assert [i.seq for i in ref.drain()] == [i.seq for i in got.drain()]
    assert seq > 20


@pytest.mark.parametrize("cls", [FIFOScheduler, SJFScheduler, EDFScheduler,
                                 WFQScheduler])
def test_backfill_skips_nonfitting_without_losing_it(cls):
    s = cls()
    s.push(_item(QueueItem, RequestPolicy, dict(
        seq=0, steps=5, priority=0, deadline=1.0, streams=2,
        tenant="default", weight=1.0)))
    s.push(_item(QueueItem, RequestPolicy, dict(
        seq=1, steps=5, priority=0, deadline=2.0, streams=1,
        tenant="default", weight=1.0)))
    assert s.pop(lambda it: it.streams == 1).seq == 1
    assert len(s) == 1
    assert s.pop().seq == 0 and len(s) == 0


def _tenant_item(seq, steps, tenant, weight=1.0, priority=0):
    return QueueItem(seq=seq, request=None, steps=steps, ticket_id=seq,
                     policy=RequestPolicy(tenant=tenant, weight=weight,
                                          priority=priority))


@pytest.mark.parametrize("seed", range(4))
def test_wfq_share_tracks_weights_while_backlogged(seed):
    rng = random.Random(700 + seed)
    wa, wb = rng.choice([1.0, 2.0, 4.0]), rng.choice([1.0, 2.0, 4.0])
    steps = rng.randint(1, 8)
    s = WFQScheduler()
    seq = 0
    for tenant, w in (("a", wa), ("b", wb)):
        for _ in range(60):
            s.push(_tenant_item(seq, steps, tenant, w))
            seq += 1
    popped = [s.pop() for _ in range(40)]
    na = sum(it.policy.tenant == "a" for it in popped)
    assert abs(na - 40 * wa / (wa + wb)) <= 2


def test_wfq_backlogged_tenants_share_by_weight():
    s = WFQScheduler()
    for i in range(40):
        s.push(_tenant_item(i, 6, "gold", 3.0))
    for i in range(40, 80):
        s.push(_tenant_item(i, 6, "bronze", 1.0))
    served = {"gold": 0, "bronze": 0}
    for _ in range(40):
        it = s.pop()
        served[it.policy.tenant] += it.steps
    assert served == {"gold": 30 * 6, "bronze": 10 * 6}


def test_wfq_idle_tenant_gets_no_retroactive_credit():
    s = WFQScheduler()
    for i in range(10):
        s.push(_tenant_item(i, 4, "busy"))
    for _ in range(5):
        s.pop()
    s.push(_tenant_item(100, 4, "late"))
    s.push(_tenant_item(101, 4, "busy"))
    order = []
    while len(s):
        order.append(s.pop().seq)
    assert order.index(100) == 1 and order[-1] == 101


@pytest.mark.parametrize("seed", range(4))
def test_wfq_starvation_bound_under_bursty_competition(seed):
    """A light tenant's request is served within a bounded number of pops
    while a heavy, higher-priority tenant bursts before every pop."""
    rng = random.Random(600 + seed)
    s = WFQScheduler()
    seq = 0

    def burst(n):
        nonlocal seq
        for _ in range(n):
            s.push(_tenant_item(seq, rng.randint(1, 8), "adv", 8.0, 5))
            seq += 1

    burst(rng.randint(1, 10))
    victim = seq
    s.push(_tenant_item(seq, 5, "victim"))
    seq += 1
    pops = 0
    while True:
        burst(rng.randint(1, 3))
        pops += 1
        if s.pop().seq == victim:
            break
        assert pops < 100, "WFQ starved the light tenant"
    assert pops <= 50


def test_wfq_rejects_nonpositive_weight():
    s = WFQScheduler()
    for w in (0.0, -1.0):
        with pytest.raises(ValueError, match="weight"):
            s.push(_tenant_item(0, 4, "t", w))
    assert len(s) == 0


def test_make_and_fresh_scheduler_resolution():
    for name in SCHEDULERS:
        assert make_scheduler(name).name == name
    inst = EDFScheduler()
    assert make_scheduler(inst) is inst
    assert isinstance(make_scheduler(SJFScheduler), SJFScheduler)
    with pytest.raises(ValueError, match="unknown scheduler"):
        make_scheduler("lifo")
    with pytest.raises(TypeError):
        make_scheduler(42)
    queued = SJFScheduler()
    queued.push(_tenant_item(0, 3, "t"))
    fresh = fresh_scheduler(queued)
    assert isinstance(fresh, SJFScheduler) and fresh is not queued
    assert len(fresh) == 0 and len(queued) == 1
    assert fresh_scheduler("edf").name == "edf"
