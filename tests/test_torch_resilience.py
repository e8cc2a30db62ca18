"""The resilience layer of the port (`dask_sql_tpu_torch/resilience/`)
through `Context(device="cpu")`: the error taxonomy and the boundary of
`TorchFrame.execute`, fault injection, the circuit breaker and the
degradation ladder down to its CPU rung.

The reference's cases (`tests/unit/test_resilience.py`) run against the
port, reading counters from ``c.metrics``.  On fresh Contexts over the
same frame, the port moves the reference's ``resilience.degraded*``,
``resilience.rung.*`` and ``analysis.rung_skip*`` counters under
``compile:always``, ``oom:once`` and ``exec_oom:once`` (over
`bench.gen_lineitem(2_000)`, `FAULT_QUERY`) and for a GROUP BY the plan
verifier dooms, with equal answers (the reference in its float64-carry
segment-sum mode, floats within MATMUL_FLOAT_REL_ERR_BOUND); the port's Q1
under each fault is held against its clean run.
Port-only: the CPU rung over a lazy table and over DICT, FOR and RLE
columns, no CPU rung under a card Context, a kernel failure inside a rung
propagating with no step down, the card's OOM classified as degradable,
and a fresh verdict after an append.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import bench
import dask_sql_tpu
from dask_sql_tpu.resilience import faults as ref_faults
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.columnar.encodings import Encoding
from dask_sql_tpu_torch.columnar.pack import packed_host_arrays
from dask_sql_tpu_torch.config import Config
from dask_sql_tpu_torch.ops import segsum as segsum_ops
from dask_sql_tpu_torch.resilience import faults
from dask_sql_tpu_torch.resilience.errors import (
    CompileError,
    DeadlineError,
    ExecutionError,
    ParseError,
    QueryError,
    ResourceExhaustedError,
    ShutdownError,
    TransientExecutionError,
    classify,
)
from dask_sql_tpu_torch.resilience.faults import FaultInjector
from dask_sql_tpu_torch.resilience.ladder import (
    _fingerprint_of,
    plan_fingerprint,
    wrap_boundary,
)
from dask_sql_tpu_torch.resilience.retry import CircuitBreaker

REL = segsum_ops.MATMUL_FLOAT_REL_ERR_BOUND
Q1 = bench.QUERY
#: the aggregate the reference runs under each fault: Q1's filter on the
#: DICT date codes and a global aggregate, whose few eager operations keep
#: the reference's compiles (its eager walk compiles each operation, and
#: its CPU rung each again) to seconds
FAULT_QUERY = ("SELECT SUM(l_quantity) AS sum_qty, COUNT(*) AS n "
               "FROM lineitem WHERE l_shipdate <= DATE '1998-09-02'")
WIDE_QUERY = ("SELECT k1, k2, SUM(v) AS s FROM big GROUP BY k1, k2 "
              "ORDER BY k1, k2")
#: the smallest dictionaries whose radix product (with the NULL slot each)
#: passes the 1 << 22 gate: 2,049 x 2,049
WIDE_KEYS = 2_049


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are tiny: one thread runs them fastest on
    a machine whose cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_injectors():
    """No armed fault before or after a test, in either engine: a spent
    ``once`` budget is kept per (spec, seed) in the process."""
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()


def _ctx():
    c = Context(device="cpu")
    c.create_table("t", pd.DataFrame({"a": [1, 2, 3], "b": [1.5, 2.5, 3.5]}))
    return c


def _ladder(metrics) -> dict:
    return {k: v for k, v in dict(metrics).items() if v and k.startswith(
        ("resilience.degraded", "resilience.rung.", "analysis.rung_skip"))}


def _resilience(metrics) -> dict:
    return {k: v for k, v in dict(metrics).items()
            if v and k.startswith("resilience.")}


def assert_same_frame(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for name in got.columns:
        g, w = got[name].reset_index(drop=True), want[name].reset_index(drop=True)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g.to_numpy(), w.to_numpy(), rtol=REL,
                                       err_msg=name)
        else:
            pd.testing.assert_series_equal(g, w, check_exact=True,
                                           check_dtype=False)


# ---------------------------------------------------------------- taxonomy
def test_taxonomy_exceptions_module_aliases():
    """The reference's case, on the port's `exceptions.py`: the public
    names keep their historical bases and carry the taxonomy's codes, and
    each is the reference's class of the same name in kind."""
    import dask_sql_tpu.exceptions as ref_exceptions
    from dask_sql_tpu_torch import exceptions
    from dask_sql_tpu_torch.exceptions import (
        BindError,
        LexError,
        OptimizationException,
        ParsingException,
    )

    assert issubclass(ParsingException, ValueError)
    assert issubclass(BindError, ValueError)
    assert issubclass(LexError, ValueError)
    assert issubclass(OptimizationException, RuntimeError)
    assert issubclass(ParsingException, QueryError)
    assert ParsingException("x").code == "PARSE_ERROR"
    assert BindError("x").code == "BIND_ERROR"
    assert OptimizationException("x").code == "OPTIMIZATION_ERROR"
    assert exceptions.__all__ == ref_exceptions.__all__
    for name in exceptions.__all__:
        if name != "classify":
            port, ref = getattr(exceptions, name), getattr(ref_exceptions, name)
            assert port("x").code == ref("x").code, name


def test_taxonomy_flags_and_codes():
    assert CompileError("x").degradable and not CompileError("x").retryable
    assert ResourceExhaustedError("x").degradable
    assert TransientExecutionError("x").retryable
    assert not DeadlineError("x").retryable
    assert ShutdownError("x").retryable
    payload = ResourceExhaustedError("x").payload()
    assert payload["code"] == "RESOURCE_EXHAUSTED"
    assert payload["errorType"] == "INSUFFICIENT_RESOURCES"
    assert not CompileError("known-permanent", degradable=False).degradable


def test_parse_error_is_taxonomy_through_sql():
    with pytest.raises(ParseError) as ei:
        _ctx().sql("SELEC nope")
    assert ei.value.payload()["errorType"] == "USER_ERROR"


def test_classify_maps_oom_and_transients():
    assert isinstance(classify(RuntimeError("RESOURCE_EXHAUSTED: out of "
                                            "memory allocating 1GB")),
                      ResourceExhaustedError)
    assert isinstance(classify(MemoryError()), ResourceExhaustedError)
    assert isinstance(classify(ConnectionError("reset")),
                      TransientExecutionError)
    wrapped = classify(KeyError("ghost"))
    assert isinstance(wrapped, ExecutionError) and not wrapped.retryable
    assert classify(KeyError("ROOM_ID")).code == "EXECUTION_ERROR"
    assert isinstance(classify(RuntimeError("device OOM")),
                      ResourceExhaustedError)
    assert not classify(FileNotFoundError("gone.parquet")).retryable
    assert not classify(PermissionError("denied")).retryable
    e = CompileError("x")
    assert classify(e) is e


def test_classify_the_cards_failures():
    """torch's allocation failure steps down; a CUDA status, a kernel
    wrapper's error or a failed build does not, whatever its text says."""
    oom = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.11 GiB "
        "total capacity)")
    assert isinstance(classify(oom), ResourceExhaustedError)
    assert classify(oom).degradable
    for text in ("CUDA error: out of memory",
                 "CUDA error: an illegal memory access was encountered",
                 "segsum kernel cannot be planned: CUDA error 2",
                 "segsum kernel launch failed: CUDA error 700",
                 "nvcc failed on segsum.cu: out of memory"):
        err = classify(RuntimeError(text))
        assert type(err) is ExecutionError and not err.degradable, text
    assert type(classify(ValueError("segsum: column 0 is torch.int8; the "
                                    "kernel takes float32/float64/bool")
                         )) is ExecutionError


def test_executor_boundary_wraps_raw_failures():
    """A failure inside execution leaves `TorchFrame.execute` as a
    QueryError that is still a RuntimeError and keeps the text; the port's
    NotImplementedError for a later slice keeps its type."""
    c = _ctx()

    def boom(x):
        raise ValueError("kernel exploded")

    c.register_function(boom, "boom_udf", [("x", np.int64)], np.int64)
    with pytest.raises(QueryError) as ei:
        c.sql("SELECT boom_udf(a) AS v FROM t", return_futures=False)
    assert ei.value.code == "EXECUTION_ERROR"
    assert isinstance(ei.value, RuntimeError)
    assert "kernel exploded" in str(ei.value)
    # EXPLAIN ANALYZE answers through the boundary now; a later slice's
    # NotImplementedError still passes it as it is
    plan = c.sql("EXPLAIN ANALYZE SELECT a FROM t").compute()["PLAN"]
    assert any(line.lstrip().startswith("TableScan: ") for line in plan)
    with pytest.raises(NotImplementedError, match="item 8b"):
        wrap_boundary(lambda: (_ for _ in ()).throw(NotImplementedError(
            "SHOW QUERIES needs item 8b, not in the port yet")))
    with pytest.raises(ExecutionError):
        wrap_boundary(lambda: (_ for _ in ()).throw(
            NotImplementedError("cast X -> Y")))


# ------------------------------------------------------------------ faults
def test_fault_spec_parsing_and_budgets():
    inj = FaultInjector("compile:once,oom:2,execute:always,d2h:at2")
    assert inj.arm("compile") and not inj.arm("compile")
    assert inj.arm("oom") and inj.arm("oom") and not inj.arm("oom")
    assert all(inj.arm("execute") for _ in range(5))
    assert [inj.arm("d2h") for _ in range(3)] == [False, True, False]
    assert not inj.arm("exec_oom")  # unlisted site never fires


def test_fault_probability_deterministic():
    i1 = FaultInjector("compile:0.5", seed=7)
    i2 = FaultInjector("compile:0.5", seed=7)
    seq = [i1.arm("compile") for _ in range(32)]
    assert seq == [i2.arm("compile") for _ in range(32)]
    assert any(seq) and not all(seq)


def test_fault_sites_are_the_references():
    """The port's sites are the reference's, each raising the same class of
    taxonomy error; a reference site whose code the port lacks yet, or any
    other name, is refused."""
    assert set(faults.SITE_ERRORS) == {"compile", "predict", "spmd", "oom",
                                       "exec_oom", "execute", "d2h",
                                       "partition", "checkpoint"}
    assert set(faults.SITE_ERRORS) == set(ref_faults.SITE_ERRORS)
    assert faults.HANG_SITES == ref_faults.HANG_SITES == {"compile_hang"}
    for site, err in faults.SITE_ERRORS.items():
        ref_bases = {b.__name__ for b in ref_faults.SITE_ERRORS[site].__mro__}
        assert {b.__name__ for b in err.__mro__} == ref_bases, site
    FaultInjector(",".join(f"{s}:once" for s in
                           list(faults.SITE_ERRORS) + ["compile_hang"]))
    with pytest.raises(ValueError):
        FaultInjector("warpcore:once")


def test_fault_injector_keyed_on_spec_and_seed():
    config = Config()
    with config.set({"resilience.inject": "compile:once"}):
        inj1 = faults.get_injector(config)
        assert inj1.arm("compile")
        assert faults.get_injector(config) is inj1
    with config.set({"resilience.inject": "oom:once"}):
        assert faults.get_injector(config) is not inj1
    with config.set({"resilience.inject": "compile:once",
                     "resilience.inject.seed": 9}):
        inj3 = faults.get_injector(config)
        assert inj3 is not inj1 and inj3.arm("compile")
    with config.set({"resilience.inject": "compile:once"}):
        assert faults.get_injector(config) is inj1
        assert not inj1.arm("compile")  # still spent
    assert faults.get_injector(config) is None


def test_d2h_site_is_retryable_and_not_degradable():
    config = Config()
    bufs = [torch.arange(4), torch.ones(4, dtype=torch.float32)]
    with config.set({"resilience.inject": "d2h:once"}):
        with pytest.raises(TransientExecutionError) as ei:
            packed_host_arrays(bufs, config)
        assert ei.value.retryable and not ei.value.degradable
        host = packed_host_arrays(bufs, config)
    np.testing.assert_array_equal(host[0], np.arange(4))


def test_execute_site_raises_at_the_executor():
    c = _ctx()
    with pytest.raises(TransientExecutionError):
        c.sql("SELECT SUM(a) AS s FROM t", config_options={
            "resilience.inject": "execute:once"}).compute()
    assert _resilience(c.metrics.snapshot()["counters"]) == {}


# ----------------------------------------------------------------- breaker
def test_breaker_trips_and_cools_down():
    now = [0.0]
    b = CircuitBreaker(threshold=2, cooldown_s=10.0, clock=lambda: now[0])
    key = ("fp", "compiled")
    assert b.allow(key)
    assert not b.record_failure(key)
    assert b.allow(key)
    assert b.record_failure(key)  # trips now
    assert not b.allow(key)
    now[0] = 11.0
    assert b.allow(key)      # half-open trial admitted
    assert not b.allow(key)  # only one
    assert b.record_success(key)
    assert b.allow(key)


def test_breaker_unsettled_trial_does_not_stick_open():
    now = [0.0]
    b = CircuitBreaker(threshold=1, cooldown_s=10.0, clock=lambda: now[0])
    key = ("fp", "compiled")
    b.record_failure(key)
    now[0] = 11.0
    assert b.allow(key) and not b.allow(key)
    now[0] = 22.0
    assert b.allow(key)
    b.record_success(key)
    assert b.allow(key) and b.allow(key)


def test_breaker_success_resets_counter():
    b = CircuitBreaker(threshold=2, cooldown_s=10.0)
    key = ("fp", "r")
    b.record_failure(key)
    b.record_success(key)
    b.record_failure(key)
    assert b.allow(key)


def test_plan_fingerprint_stable():
    c = _ctx()
    p1 = c.sql("SELECT SUM(a) AS s FROM t")._plan
    p2 = c.sql("SELECT SUM(a) AS s FROM t")._plan
    p3 = c.sql("SELECT SUM(b) AS s FROM t")._plan
    assert plan_fingerprint(p1) == plan_fingerprint(p2)
    assert plan_fingerprint(p1) != plan_fingerprint(p3)


def test_breaker_key_is_the_family():
    """Q1 with another date literal is the same breaker entity."""
    from dask_sql_tpu_torch.physical.executor import Executor

    c = Context(device="cpu")
    c.create_table("lineitem", bench.gen_lineitem(500, seed=0))
    other = Q1.replace("1998-09-02", "1998-08-01")
    fps = [_fingerprint_of(Executor(c), c.sql(q)._plan) for q in (Q1, other)]
    assert fps[0] == fps[1]
    assert fps[0] != plan_fingerprint(c.sql(Q1)._plan)


# ------------------------------------------------- the ladder, injected
def test_forced_compile_failure_degrades_and_matches():
    sql = "SELECT SUM(a) AS s FROM t GROUP BY a > 1 ORDER BY s"
    clean = _ctx().sql(sql, return_futures=False)
    c = _ctx()
    hurt = c.sql(sql, return_futures=False,
                 config_options={"resilience.inject": "compile:always"})
    pd.testing.assert_frame_equal(hurt, clean)
    assert c.metrics.counter("resilience.degraded") >= 1


def test_forced_oom_degrades_and_matches():
    clean = _ctx().sql("SELECT SUM(a) AS s FROM t", return_futures=False)
    c = _ctx()
    hurt = c.sql("SELECT SUM(a) AS s FROM t", return_futures=False,
                 config_options={"resilience.inject": "oom:once"})
    pd.testing.assert_frame_equal(hurt, clean)
    assert c.metrics.counter("resilience.degraded") == 1


def test_forced_exec_oom_takes_cpu_rung():
    c = _ctx()
    out = c.sql("SELECT SUM(a) AS s FROM t", return_futures=False,
                config_options={"resilience.inject": "exec_oom:once",
                                "sql.compile": False})
    assert int(out["s"][0]) == 6
    assert c.metrics.counter("resilience.rung.cpu") == 1
    assert c.metrics.counter("resilience.degraded.interpreted") == 1


def test_cpu_fallback_off_propagates():
    with pytest.raises(ResourceExhaustedError):
        _ctx().sql("SELECT SUM(a) AS s FROM t", return_futures=False,
                   config_options={"resilience.inject": "exec_oom:once",
                                   "resilience.ladder.cpu_fallback": False})


def test_no_cpu_rung_under_a_card_context(monkeypatch):
    """On the card the eager walk's degradable failure leaves the query as
    a degradable ResourceExhaustedError: the CPU rung would run the plan
    past the card's kernels, so it serves CPU Contexts only."""
    c = _ctx()
    monkeypatch.setattr(c, "device", torch.device("cuda"))
    with pytest.raises(ResourceExhaustedError) as ei:
        c.sql("SELECT SUM(a) AS s FROM t", return_futures=False,
              config_options={"resilience.inject": "exec_oom:once",
                              "sql.compile": False})
    assert ei.value.degradable
    # the reclaim before the step down (resilience/pressure.py) found no
    # cached bytes to free: one attempt, no rung taken
    assert _resilience(c.metrics.snapshot()["counters"]) == {
        "resilience.pressure.reclaims": 1}


def test_ladder_disabled_propagates_failure():
    for spec in ("compile:always", "exec_oom:always"):
        with pytest.raises(ResourceExhaustedError if "oom" in spec
                           else CompileError):
            _ctx().sql("SELECT SUM(a) AS s FROM t", return_futures=False,
                       config_options={"resilience.inject": spec,
                                       "resilience.ladder.enabled": False})


def test_breaker_skips_failing_rung_on_next_submission():
    c = _ctx()
    c.breaker.threshold = 2
    q = "SELECT SUM(a) AS s FROM t"
    # each run executes (the reference's test turns its cache off too)
    opts = {"resilience.inject": "compile:always",
            "serving.cache.enabled": False}
    c.sql(q, return_futures=False, config_options=opts)
    c.sql(q, return_futures=False, config_options=opts)
    assert c.metrics.counter("resilience.breaker.trip") >= 1
    degraded_before = c.metrics.counter("resilience.degraded.compiled_select")
    out = c.sql(q, return_futures=False, config_options=opts)
    assert int(out["s"][0]) == 6
    assert c.metrics.counter("resilience.breaker.skip") >= 1
    assert c.metrics.counter("resilience.degraded.compiled_select") == \
        degraded_before


def test_breaker_trips_skips_the_family_and_closes():
    """Three failures trip every compiled rung of Q1's family; the fourth
    run and a run with another date literal skip them with no step down;
    after the cooldown a clean half-open trial closes the breaker and Q1 is
    back on the fused aggregate."""
    now = [0.0]
    c = Context(device="cpu")
    c.config.update({"serving.cache.enabled": False})  # every run executes
    c.breaker = CircuitBreaker(threshold=3, cooldown_s=5.0,
                               clock=lambda: now[0])
    c.create_table("lineitem", bench.gen_lineitem(1_000, seed=0))
    want = c.sql(Q1).compute()
    opts = {"resilience.inject": "compile:always"}
    for _ in range(3):
        c.sql(Q1, config_options=opts).compute()
    assert c.metrics.counter("resilience.breaker.trip") == 3
    assert c.metrics.counter("resilience.degraded") == 9
    got = c.sql(Q1, config_options=opts).compute()
    other = c.sql(Q1.replace("1998-09-02", "1998-08-01"),
                  config_options=opts).compute()
    assert c.metrics.counter("resilience.degraded") == 9
    assert c.metrics.counter("resilience.breaker.skip.compiled_aggregate") == 2
    assert c.metrics.counter("resilience.breaker.skip") == 6
    assert_same_frame(got, want)
    assert len(other) == len(want)
    now[0] = 6.0
    c.sql(Q1).compute()
    assert c.metrics.counter("resilience.rung.compiled_aggregate") == 2
    c.sql(Q1).compute()
    assert c.metrics.counter("resilience.rung.compiled_aggregate") == 3
    assert c.metrics.counter("resilience.breaker.skip.compiled_aggregate") == 2
    # the rungs that decline Q1 settle no trial: each waits out another
    # cooldown (retry.py), as in the reference
    assert c.metrics.counter("resilience.breaker.skip.compiled_select") == 3
    assert c.metrics.counter("resilience.degraded") == 9


def test_kernel_failure_in_a_rung_propagates(monkeypatch):
    """A non-degradable failure inside a rung is not the ladder's: it
    leaves `c.sql` as an ExecutionError and steps down nowhere."""
    c = Context(device="cpu")
    c.create_table("lineitem", bench.gen_lineitem(1_000, seed=0))

    def broken(gid, columns, domain):
        raise RuntimeError("segsum kernel launch failed: CUDA error 700")

    monkeypatch.setattr(segsum_ops, "segsum_typed", broken)
    with pytest.raises(ExecutionError, match="CUDA error 700"):
        c.sql(Q1).compute()
    assert _resilience(c.metrics.snapshot()["counters"]) == {}


# ------------------------------------------------------------ CPU rung
def _encoded_frame(n=4096):
    r = np.random.default_rng(3)
    return pd.DataFrame({
        "k": np.sort(r.integers(0, 6, n)),  # sorted runs: RLE
        "d": r.choice([0.5, 1.5, 2.5, 3.5], n),  # few values: DICT
        # many values over a narrow range: FOR
        "f": r.integers(10**9, 10**9 + 90_000, n) * 3,
        "v": r.normal(size=n),
    })


def test_cpu_rung_over_encoded_and_lazy_tables(tmp_path):
    """The CPU rung reads the tables as they are stored (DICT, FOR and RLE
    columns, a lazy parquet table scanned onto the host) and answers as
    the clean run does."""
    frame = _encoded_frame()
    path = tmp_path / "e.parquet"
    frame.to_parquet(path, row_group_size=1024)
    c = Context(device="cpu")
    c.create_table("enc", frame)
    c.create_table("lazy", str(path))
    encodings = {n: col.encoding for n, col in
                 c.schema["root"].tables["enc"].table.columns.items()}
    assert {encodings["k"], encodings["d"], encodings["f"]} == {
        Encoding.RLE, Encoding.DICT, Encoding.FOR}
    opts = {"resilience.inject": "exec_oom:always"}
    for rung_cpu, table in enumerate(("enc", "lazy"), 1):
        sql = (f"SELECT k, d, SUM(v) AS s, MAX(f) AS m, COUNT(*) AS n "
               f"FROM {table} WHERE f > 3000100000 GROUP BY k, d "
               f"ORDER BY k, d")
        got = c.sql(sql, config_options=opts).compute()
        assert c.metrics.counter("resilience.rung.cpu") == rung_cpu
        # the rung scanned the lazy table onto the host, and kept nothing
        assert c.schema["root"].tables["lazy"]._table is None
        pd.testing.assert_frame_equal(got, c.sql(sql).compute())


def test_an_appended_table_gets_a_fresh_verdict():
    """The radix verdict rides the plan: an append that grows the group
    domain past the gate gives a new plan and a skip, and re-registering
    small dictionaries gives the compiled rung back."""
    small = pd.DataFrame({"k1": [f"a{i % 50}" for i in range(2500)],
                          "k2": [f"b{i % 50}" for i in range(2500)],
                          "v": np.arange(2500, dtype=np.float64)})
    sql = "SELECT k1, k2, SUM(v) AS s FROM big GROUP BY k1, k2"
    c = Context(device="cpu")
    c.create_table("big", small)
    assert len(c.sql(sql).compute()) == 50
    assert c.metrics.counter("resilience.rung.compiled_aggregate") == 1
    grow = pd.DataFrame({"k1": [f"c{i}" for i in range(2500)],
                         "k2": [f"d{i}" for i in range(2500)],
                         "v": np.ones(2500)})
    c.append_rows("big", grow)
    assert len(c.sql(sql).compute()) == 2550
    assert c.metrics.counter("analysis.rung_skip.compiled_aggregate") == 1
    assert c.metrics.counter("analysis.findings.radix-overflow") == 1
    c.create_table("big", small)
    assert len(c.sql(sql).compute()) == 50
    assert c.metrics.counter("resilience.rung.compiled_aggregate") == 2
    assert c.metrics.counter("analysis.rung_skip.compiled_aggregate") == 1
    assert c.metrics.counter("resilience.degraded") == 0


# ------------------------------------ the reference, executing (4 runs)
def _wide_frame() -> pd.DataFrame:
    return pd.DataFrame({
        "k1": [f"a{i}" for i in range(WIDE_KEYS)],
        "k2": [f"b{i}" for i in range(WIDE_KEYS)],
        "v": np.arange(WIDE_KEYS, dtype=np.float64),
    })


@pytest.mark.parametrize("case", ["compile_always", "oom_once",
                                  "exec_oom_once", "radix_overflow"])
def test_ladder_counters_match_reference(case):
    """Fresh Contexts of both engines over one frame: the same ladder
    counters and equal answers."""
    if case == "radix_overflow":
        name, frame, sql, opts = "big", _wide_frame(), WIDE_QUERY, {}
    else:
        name, frame = "lineitem", bench.gen_lineitem(2_000, seed=0)
        sql = FAULT_QUERY
        opts = {"compile_always": {"resilience.inject": "compile:always"},
                "oom_once": {"resilience.inject": "oom:once"},
                "exec_oom_once": {"resilience.inject": "exec_oom:once",
                                  "sql.compile": False}}[case]
    rc = dask_sql_tpu.Context()
    rc.create_table(name, frame)
    want = rc.sql(sql, config_options={**opts,
                                       "sql.compile.segsum": "matmul"}
                  ).compute()
    pc = Context(device="cpu")
    pc.create_table(name, frame)
    got = pc.sql(sql, config_options=opts).compute()
    assert _ladder(pc.metrics.snapshot()["counters"]) == \
        _ladder(rc.metrics.snapshot()["counters"])
    assert _ladder(pc.metrics.snapshot()["counters"]), case
    assert_same_frame(got, want)
