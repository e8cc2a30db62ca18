"""The rest of the port's surface against the reference's, on the CPU:
`TorchFrame` ``persist``, ``head``, ``len`` and ``explain_str``; `Context`
``visualize`` (the PNG, and its text fallback with the renderer broken),
``run_server`` / ``stop_server``, ``ipython_magic`` (the ``%%sql`` magic
on a real IPython shell, with ``auto_include``) and ``fqn``; the Fugue
adapter (`integrations/fugue.py`) with a fake ``fugue`` module; and the
repairs of this slice: ``sql.compile.select`` off declines the compiled
select as in the reference, and no exception leaves an in-flight row open
(`TorchFrame.execute`, `Context.submit`).

Each case runs one seeded frame and one SQL through a port Context and a
reference Context; values must be equal (floats within 5e-6 relative).
"""
import importlib
import json
import sys
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch

import dask_sql_tpu
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.utils import TRANSFER_STATS

REL = 5e-6
Q = ("SELECT k, SUM(v) AS s, COUNT(*) AS n FROM t WHERE v > 0.2 "
     "GROUP BY k ORDER BY k")
SEL = "SELECT k, v * 2 AS w FROM t WHERE v > 0.5 ORDER BY w DESC LIMIT 7"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(n=2000, seed=3):
    rng = np.random.RandomState(seed)
    return pd.DataFrame({"k": rng.choice(["a", "b", "c", "d"], n),
                         "v": rng.rand(n),
                         "i": rng.randint(0, 50, n)})


@pytest.fixture(scope="module")
def contexts():
    """A port and a reference Context over the same frame, result cache
    off on both (each call executes)."""
    pc, rc = Context(device="cpu"), dask_sql_tpu.Context()
    pc.config.update({"serving.cache.enabled": False})
    for c in (pc, rc):
        c.create_table("t", _frame())
    return pc, rc


def _equal(got: pd.DataFrame, want: pd.DataFrame) -> None:
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for name in got.columns:
        g = got[name].reset_index(drop=True)
        w = want[name].reset_index(drop=True)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g.to_numpy(), w.to_numpy(), rtol=REL)
        else:
            assert g.tolist() == w.tolist(), name


# ------------------------------------------------------- frame methods
@pytest.mark.parametrize("sql", [Q, SEL])
def test_head_and_len_match_the_reference(contexts, sql):
    pc, rc = contexts
    TRANSFER_STATS["d2h"] = 0
    n = len(pc.sql(sql))
    # len() reads the executed Table's row count: no pull of its own
    len_pulls = TRANSFER_STATS["d2h"]
    assert n == len(rc.sql(sql))
    TRANSFER_STATS["d2h"] = 0
    got = pc.sql(sql).head(3)
    assert TRANSFER_STATS["d2h"] == len_pulls
    _equal(got, rc.sql(sql).head(3))
    assert len(got) == 3


def test_persist_executes_once_and_keeps_the_result(contexts):
    pc, rc = contexts
    frame = pc.sql(Q)
    assert frame.persist() is frame
    before = pc.metrics.counter("query.executed")
    _equal(frame.compute(), rc.sql(Q).persist().compute())
    assert len(frame) == len(rc.sql(Q))
    assert pc.metrics.counter("query.executed") == before


def test_explain_str_is_the_references_plan(contexts):
    pc, rc = contexts
    pc.config.update({"serving.materialize.enabled": False})
    try:
        with dask_sql_tpu.config.set(
                {"serving.materialize.enabled": False}):
            want = rc.sql(Q).explain_str()
        assert pc.sql(Q).explain_str() == want
        assert pc.sql(Q).explain_str() == pc.explain(Q)
    finally:
        pc.config.update({"serving.materialize.enabled": True})


def test_fqn_matches_the_reference(contexts):
    pc, rc = contexts
    for parts in (["t"], ["root", "t"], ["s", "x"], ("a", "b", "c")):
        assert pc.fqn(parts) == rc.fqn(parts)


# ----------------------------------------------------------- visualize
def test_visualize_writes_a_png(contexts, tmp_path):
    pc, rc = contexts
    for c, name in ((pc, "port.png"), (rc, "ref.png")):
        c.visualize(SEL, filename=str(tmp_path / name))
        with open(tmp_path / name, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_visualize_text_fallback_without_renderer(contexts, tmp_path,
                                                  monkeypatch):
    import dask_sql_tpu.context as ref_ctx
    import dask_sql_tpu_torch.context as port_ctx

    def boom(plan, filename):
        raise ImportError("no renderer")

    pc, rc = contexts
    pc.config.update({"serving.materialize.enabled": False})
    try:
        texts = []
        for mod, c, name in ((port_ctx, pc, "port.png"),
                             (ref_ctx, rc, "ref.png")):
            monkeypatch.setattr(mod.Context, "_render_plan_png",
                                staticmethod(boom))
            c.visualize(SEL, filename=str(tmp_path / name))
            assert not (tmp_path / name).exists()
            texts.append((tmp_path / f"{name}.txt").read_text())
        assert "TableScan" in texts[0] and texts[0] == texts[1]
        # a name that ends in .txt is kept
        pc.visualize(SEL, filename=str(tmp_path / "plan.txt"))
        assert (tmp_path / "plan.txt").read_text() == texts[0]
    finally:
        pc.config.update({"serving.materialize.enabled": True})


# ------------------------------------------------------------- server
def _post_q(port):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/statement",
                                 data=Q.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        payload = json.loads(resp.read())
    deadline = time.time() + 60
    while "nextUri" in payload and time.time() < deadline:
        time.sleep(0.02)
        with urllib.request.urlopen(payload["nextUri"], timeout=30) as resp:
            payload = json.loads(resp.read())
    return payload


def _closed(port) -> bool:
    try:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/info",
                               timeout=5).close()
    except urllib.error.HTTPError:
        return False  # an answer, whatever its status
    except (urllib.error.URLError, ConnectionError, OSError):
        return True
    return False


def test_stop_server_stops_the_ports_server(contexts):
    pc, rc = contexts
    assert pc.server is None
    srv = pc.run_server(host="127.0.0.1", port=0, blocking=False)
    assert pc.server is srv
    got = _post_q(srv.port)
    assert got["stats"]["state"] == "FINISHED"
    want = rc.sql(Q).compute()
    assert [r[0] for r in got["data"]] == want["k"].tolist()
    np.testing.assert_allclose([r[1] for r in got["data"]],
                               want["s"].to_numpy(), rtol=REL)
    pc.stop_server()
    assert pc.server is None and _closed(srv.port)
    pc.stop_server()  # nothing left to stop


def test_the_references_stop_server_stops_nothing(contexts):
    """A fault of the reference the port does not copy: its run_server
    never keeps the server, so stop_server leaves it serving."""
    _, rc = contexts
    srv = rc.run_server(host="127.0.0.1", port=0, blocking=False)
    try:
        assert rc.server is None
        rc.stop_server()
        assert not _closed(srv.port)
    finally:
        srv.shutdown()


# ------------------------------------------------------ the %%sql magic
@pytest.fixture(scope="module")
def shell():
    from IPython.core.interactiveshell import InteractiveShell

    return InteractiveShell.instance()


def _magic(shell, context, cell_body, **ns):
    # registered from a cell, where IPython's get_ipython exists
    shell.user_ns.update(ns, _ctx=context)
    out = shell.run_cell("_ctx.ipython_magic(auto_include=True)")
    assert out.success, out.error_in_exec
    out = shell.run_cell(f"%%sql\n{cell_body}\n")
    assert out.success, out.error_in_exec
    return out.result


def test_sql_magic_with_auto_include(contexts, shell):
    pc, rc = contexts
    people = pd.DataFrame({"name": ["x", "y", "z"], "age": [30, 41, 25]})
    sql = "SELECT name, age FROM people WHERE age > 26 ORDER BY age"
    want = _magic(shell, rc, sql, people=people)
    got = _magic(shell, pc, sql, people=people)
    _equal(got, want)
    assert got["name"].tolist() == ["x", "y"]
    assert "people" in pc.schema["root"].tables
    # the line form
    line = shell.run_cell("%sql SELECT COUNT(*) AS n FROM t").result
    assert int(line["n"][0]) == 2000


# -------------------------------------------------- the Fugue adapter
def _fake_fugue():
    registered = {}
    mod = types.ModuleType("fugue")

    class SqlEngine:
        def __init__(self, execution_engine=None):
            self.execution_engine = execution_engine

    class NativeExecutionEngine:
        def __init__(self, conf=None):
            self.conf = conf

    class PandasDataFrame:
        def __init__(self, df):
            self.native = df

        def as_pandas(self):
            return self.native

    mod.SqlEngine = SqlEngine
    mod.NativeExecutionEngine = NativeExecutionEngine
    mod.dataframe = types.SimpleNamespace(PandasDataFrame=PandasDataFrame)
    mod.register_execution_engine = \
        lambda name, fn, on_dup="overwrite": registered.__setitem__(name, fn)
    return mod, registered


def test_fugue_adapter_with_a_fake_fugue(monkeypatch):
    import dask_sql_tpu_torch.context as port_ctx

    fake, registered = _fake_fugue()
    monkeypatch.setitem(sys.modules, "fugue", fake)
    for name in ("dask_sql_tpu_torch.integrations.fugue",
                 "dask_sql_tpu.integrations.fugue"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    port = importlib.import_module("dask_sql_tpu_torch.integrations.fugue")
    ref = importlib.import_module("dask_sql_tpu.integrations.fugue")
    assert set(registered) == {"torch", "tpu"}
    engine = registered["torch"]({"x": 1})
    assert isinstance(engine, port.TorchSQLExecutionEngine)
    assert engine.conf == {"x": 1}
    sql_engine = engine.create_default_sql_engine()
    assert isinstance(sql_engine, port.TorchSQLEngine)
    assert sql_engine.is_distributed

    dfs = {"t": fake.dataframe.PandasDataFrame(_frame(300))}
    # select builds Context(): the card, which this machine lacks
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sql_engine.select(dfs, Q)
    monkeypatch.setattr(port_ctx, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    got = sql_engine.select(dfs, Q).native
    want = ref.TpuSQLEngine(None).select(dfs, Q).native
    _equal(got, want)


def test_fugue_adapter_without_fugue(monkeypatch):
    monkeypatch.setitem(sys.modules, "fugue", None)
    monkeypatch.delitem(sys.modules, "dask_sql_tpu_torch.integrations.fugue",
                        raising=False)
    port = importlib.import_module("dask_sql_tpu_torch.integrations.fugue")
    for call in (port.TorchSQLEngine, port.TorchSQLExecutionEngine,
                 port.register_engines):
        with pytest.raises(ImportError, match="fugue"):
            call()


# ------------------------------------------------------------- repairs
RUNG_KEYS = ("resilience.rung.", "resilience.degraded")


def _states(context):
    """The state of each query SHOW QUERIES lists."""
    rows = context.sql("SHOW QUERIES").compute()
    return rows[rows["Field"] == "state"]["Value"].tolist()


def _rungs(counters):
    return {k: v for k, v in counters.items() if k.startswith(RUNG_KEYS)}


def test_compile_select_off_declines_as_the_reference():
    """``SET sql.compile.select = false`` takes the interpreted walk in
    both engines: the same rows and the same rung counters."""
    pc, rc = Context(device="cpu"), dask_sql_tpu.Context()
    for c in (pc, rc):
        c.create_table("t", _frame())
    opts = {"sql.compile.select": False}
    got = pc.sql(SEL, config_options=opts).compute()
    with dask_sql_tpu.config.set(opts):
        want = rc.sql(SEL, config_options=opts).compute()
    _equal(got, want)
    port_rungs = _rungs(pc.metrics.snapshot()["counters"])
    assert port_rungs == _rungs(rc.metrics.snapshot()["counters"])
    assert "resilience.rung.compiled_select" not in port_rungs
    # on: both take the compiled select
    pc.sql(SEL).compute()
    rc.sql(SEL).compute()
    assert pc.metrics.counter("resilience.rung.compiled_select") == 1
    assert _rungs(pc.metrics.snapshot()["counters"]) == \
        _rungs(rc.metrics.snapshot()["counters"])


def test_a_failure_right_after_the_live_row_begins_finishes_it(monkeypatch):
    """The in-flight row of a direct query is terminal whatever raises
    after its begin (SHOW QUERIES shows no live entry left)."""
    pc = Context(device="cpu")
    pc.create_table("t", _frame(200))
    real = pc.live_queries.start

    def start(qid):
        raise RuntimeError("start failed")

    monkeypatch.setattr(pc.live_queries, "start", start)
    with pytest.raises(Exception, match="start failed"):
        pc.sql(Q).compute()
    monkeypatch.setattr(pc.live_queries, "start", real)
    assert pc.live_queries.live_entries() == []
    assert _states(pc) == ["failed"]


def test_a_failure_after_admission_still_finishes_the_row(monkeypatch):
    """`Context.submit`: the done callback is attached before anything
    else can raise, so an admitted query's row always ends terminal."""
    from dask_sql_tpu_torch.serving import ServingRuntime

    pc = Context(device="cpu")
    pc.create_table("t", _frame(200))
    pc.serving = rt = ServingRuntime(workers=1, metrics=pc.metrics)
    try:
        real_put = pc.traces.put

        def put(qid, trace):
            # fails in submit only: the worker's own statement stores its
            # trace as always
            if sys._getframe(1).f_code.co_name == "submit":
                raise RuntimeError("trace store failed")
            return real_put(qid, trace)

        monkeypatch.setattr(pc.traces, "put", put)
        with pytest.raises(RuntimeError, match="trace store failed"):
            pc.submit(Q)
        # the admitted query runs to its end, and its row with it
        deadline = time.time() + 30
        while pc.live_queries.live_entries() and time.time() < deadline:
            time.sleep(0.01)
        assert pc.live_queries.live_entries() == []
    finally:
        rt.shutdown(wait=True)
        pc.serving = None
    assert _states(pc) == ["done"]
