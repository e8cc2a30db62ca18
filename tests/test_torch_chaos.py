"""Chaos campaigns of the port (`dask_sql_tpu_torch/resilience/chaos.py`)
on the CPU, held to the reference's harness (`dask_sql_tpu/resilience/
chaos.py`, `tests/unit/test_chaos.py`).

Short seeded campaigns (8 queries, 2 rounds, 2 workers, the base config's
short cooldowns and hangs) hold every invariant of `_check_invariants`;
the armed plan repeats for a seed; the sites and templates are the
reference's, PREDICT's among them, but for the one that waits for
ROADMAP.md Queue 1 item 10; ``analysis.lock_sanitizer`` on a Context arms the lock sanitizer and
points it at the Context's metrics; and the zombie-thread invariant holds
the campaign to the threads it could have started.
"""
import threading

import pytest
import torch

from dask_sql_tpu.resilience import chaos as ref_chaos
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.resilience import chaos, faults
from dask_sql_tpu_torch.runtime import locks


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_state():
    from dask_sql_tpu_torch.streaming import aggregate as stream_agg
    from dask_sql_tpu_torch.streaming import select as stream_sel

    faults.reset()
    stream_agg.reset_cache()
    stream_sel.reset_cache()
    yield
    faults.reset()
    stream_agg.reset_cache()
    stream_sel.reset_cache()


@pytest.fixture
def sanitizer():
    """The lock sanitizer armed for one test, and put back as it was."""
    was = locks.enabled()
    locks.set_enabled(True)
    yield
    locks.set_enabled(was)


def _assert_held(report, queries):
    assert report.submitted + report.shed == queries
    assert report.armed  # faults really were armed, not a quiet run
    assert report.ok, "invariant violations:\n" + "\n".join(
        report.violations)
    assert (report.completed + report.failed + report.cancelled
            + report.shed) == report.submitted
    assert report.device == "cpu" and report.card_before is None


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_campaign_holds_global_invariants(seed, sanitizer, tmp_path):
    report = chaos.run_campaign(seed=seed, queries=8, rounds=2, workers=2,
                                device="cpu",
                                state_dir=str(tmp_path / "state"))
    _assert_held(report, 8)
    assert report.rounds == 2


def test_campaign_is_seed_deterministic_in_armed_plan():
    """The same seed arms the same fault subsets in the same rounds."""
    a = chaos.run_campaign(seed=11, queries=8, rounds=2, workers=2,
                           device="cpu")
    b = chaos.run_campaign(seed=11, queries=8, rounds=2, workers=2,
                           device="cpu")
    assert a.ok and b.ok
    assert a.armed == b.armed
    for _, spec, _ in a.armed:
        for part in spec.split(","):
            assert part.split(":")[0] in chaos.ALL_SITES


def test_sites_and_templates_are_the_references_but_items_9_and_10():
    """The reference's sites and templates: item 9's ``predict`` site and
    PREDICT template and item 10's ``spmd`` site are in."""
    assert set(chaos.ALL_SITES) == set(ref_chaos.ALL_SITES)
    assert chaos.ALL_SITES == ref_chaos.ALL_SITES
    assert "predict" in chaos.ALL_SITES and "spmd" in chaos.ALL_SITES
    assert set(chaos.ALL_SITES) == set(faults.SITE_ERRORS) | set(
        faults.HANG_SITES)
    budget = 12345
    assert chaos._query_mix(budget) == ref_chaos._query_mix(budget)
    assert any("PREDICT" in t[0] for t in chaos._query_mix(budget))
    assert chaos._BASE_CONFIG == ref_chaos._BASE_CONFIG


def test_lock_sanitizer_is_armed_and_attached_by_its_key():
    was = locks.enabled()
    try:
        locks.set_enabled(False)
        plain = Context(device="cpu")
        assert not locks.enabled()
        assert locks._metrics is plain.metrics
        armed = Context(device="cpu",
                        config_options={"analysis.lock_sanitizer": True})
        assert locks.enabled()
        assert locks._metrics is armed.metrics
        # one way: a later default Context does not disarm it
        Context(device="cpu")
        assert locks.enabled()
    finally:
        locks.set_enabled(was)


def test_a_campaign_context_arms_the_sanitizer_from_its_options():
    was = locks.enabled()
    try:
        locks.set_enabled(False)
        report = chaos.run_campaign(
            seed=7, queries=4, rounds=1, workers=2, device="cpu",
            config_options={"analysis.lock_sanitizer": True})
        assert locks.enabled()
        _assert_held(report, 4)
    finally:
        locks.set_enabled(was)


def _idle_thread(name):
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name=name, daemon=True)
    t.start()
    return t, stop


def test_zombie_check_is_the_campaigns_threads_only():
    """A background thread alive before the campaign (another engine's in
    this process) is not the storm's zombie; one the campaign leaves is."""
    t, stop = _idle_thread("dsql-bg-compile")
    try:
        report = chaos.run_campaign(seed=5, queries=4, rounds=1, workers=2,
                                    device="cpu")
        _assert_held(report, 4)
        # a stray started after the campaign's snapshot is a violation
        from dask_sql_tpu_torch.serving.runtime import ServingRuntime

        report = chaos.ChaosReport(seed=0)
        ctx = Context(device="cpu")
        rt = ServingRuntime(workers=1, metrics=ctx.metrics)
        rt.shutdown(wait=True)
        before = frozenset(threading.enumerate())
        late, late_stop = _idle_thread("dsql-warmup")
        try:
            chaos._check_invariants(report, ctx, rt, [],
                                    threads_before=before)
        finally:
            late_stop.set()
            late.join(5)
        assert report.violations == [
            "zombie background threads after drain: ['dsql-warmup']"]
    finally:
        stop.set()
        t.join(5)
