"""The port's run queue (``repro_torch.core.runqueue``) against the
reference's, on the CPU.  Every scenario runs once on each package's
``RunQueue`` over its own executor and must give the same outcome.

Fairness is asserted on the concurrency the queue granted, never on a
wall-clock sleep (the reference's own fairness test waits 0.3 s and is
timing-sensitive, ROADMAP §3): the runs meet at a barrier before their
first stage, so both are active when they submit, and every stage body
reads, at its entry and under the queue's lock, its run's in-flight
count and the fair share, ``capacity // active runs``.
"""
import threading

import pytest

import repro.core.executor as jexecutor
import repro.core.graph as jgraph
import repro.core.runqueue as jrunqueue
import repro_torch.core.executor as executor
import repro_torch.core.graph as graph
import repro_torch.core.runqueue as runqueue

PACKAGES = {"reference": (jexecutor, jgraph, jrunqueue),
            "port": (executor, graph, runqueue)}
WAIT_S = 30  # bound on every blocking wait, never asserted on


def _held_graph(g, width, body):
    """``width`` independent stages, each running ``body(name)``."""
    out = g.StageGraph()

    class Held(g.Stage):
        def __init__(self, name):
            super().__init__(name)
            self.outputs = (name,)

        def run(self, ctx):
            return {self.name: body(self.name)}

    for j in range(width):
        out.add(Held(f"s{j}"))
    return out


def _run(g, view, graph_):
    ctx = g.StageContext(template=None, record=None)
    graph_.execute(ctx, executor=view)
    return dict(ctx.outputs)


def _fair_share_scenario(pkg, runs=2, width=3, workers=2):
    ex_mod, g, rq_mod = PACKAGES[pkg]
    seen = {i: [] for i in range(runs)}
    # the runs and this thread: no body starts before every ticket is known
    meet = threading.Barrier(runs + 1)
    with ex_mod.ThreadedExecutor(workers=workers) as shared:
        rq = rq_mod.RunQueue(shared, max_active=runs)
        tickets = {}

        def body_for(i):
            def body(name):
                with rq._cond:  # the view's own lock: a consistent reading
                    seen[i].append((tickets[i].in_flight, rq._share(),
                                    rq._active))
                return name
            return body

        def drive(view, i):
            meet.wait(WAIT_S)  # both runs active before any submit
            return _run(g, view, _held_graph(g, width, body_for(i)))

        for i in range(runs):
            tickets[i] = rq.submit(f"run{i}", lambda v, i=i: drive(v, i))
        meet.wait(WAIT_S)
        assert rq.drain(timeout=WAIT_S)
        results = {i: t.result(WAIT_S) for i, t in tickets.items()}
        stats = rq.stats()
        rq.shutdown()
    return seen, tickets, results, stats


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_fair_share_caps_each_runs_grant(pkg):
    seen, tickets, results, stats = _fair_share_scenario(pkg)
    for i, rows in seen.items():
        assert len(rows) == 3
        # every body ran within its run's share of capacity 2
        assert all(1 <= inflight <= share for inflight, share, _ in rows)
        # while both runs were active the share was one body each
        assert all(share == 1 for _, share, active in rows if active == 2)
        assert tickets[i].status == "done"
        assert 1 <= tickets[i].max_in_flight <= 2
        assert results[i] == {f"s{j}": f"s{j}" for j in range(3)}
    assert stats["by_status"] == {"done": 2} and stats["active"] == 0


def test_port_grants_as_the_reference_does():
    """Run by run, the same results, statuses and settled queue."""
    got, want = (_fair_share_scenario(p) for p in ("port", "reference"))
    assert got[2] == want[2]
    assert got[3]["by_status"] == want[3]["by_status"]
    assert [t.as_doc()["status"] for t in got[1].values()] \
        == [t.as_doc()["status"] for t in want[1].values()]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_drain_settles_every_accepted_run_then_refuses(pkg):
    ex_mod, g, rq_mod = PACKAGES[pkg]
    gate = threading.Event()
    started = threading.Event()

    def slow(name):
        started.set()
        assert gate.wait(WAIT_S)
        return name

    def boom(name):
        raise ValueError("boom from the body")

    with ex_mod.ThreadedExecutor(workers=2) as shared:
        rq = rq_mod.RunQueue(shared, max_active=2)
        held = rq.submit("held", lambda v: _run(g, v,
                                                _held_graph(g, 1, slow)))
        bad = rq.submit("bad", lambda v: _run(g, v, _held_graph(g, 1, boom)))
        assert started.wait(WAIT_S)
        assert not rq.drain(timeout=0)  # the held run has not settled
        gate.set()
        assert rq.drain(timeout=WAIT_S)
        assert held.status == "done" and bad.status == "failed"
        assert held.result(WAIT_S) == {"s0": "s0"}
        with pytest.raises(ValueError, match="boom"):
            bad.result(WAIT_S)
        with pytest.raises(rq_mod.RunQueueClosed):
            rq.submit("late", lambda v: None)
        assert rq.stats()["by_status"] == {"done": 1, "failed": 1}
        rq.shutdown()


def test_submit_workflow_passes_the_device(tmp_path):
    """``submit_workflow`` drives the port's ``run_workflow`` through the
    run's fair view, with ``device`` among its arguments."""
    from repro_torch.core import REGISTRY, ProvenanceStore

    with executor.ThreadedExecutor(workers=2) as shared:
        rq = runqueue.RunQueue(shared, max_active=2)
        tickets = [rq.submit_workflow(REGISTRY.get("train-qwen2-1.5b"),
                                      ProvenanceStore(str(tmp_path / f"r{i}")),
                                      stages=["data", "plan"], device="cpu",
                                      name=f"wf{i}")
                   for i in range(2)]
        assert rq.drain(timeout=WAIT_S)
        for t in tickets:
            res = t.result(WAIT_S)
            assert t.status == "done" and res.plan_choice is not None
            assert sorted(res.stage_results) == ["data", "plan"]
        rq.shutdown()
