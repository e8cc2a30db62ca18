"""The port's front ends against the reference's
(`tests/integration/test_server.py`, `test_serving_server.py`,
`test_cmd.py`): the Presto-wire server (`dask_sql_tpu_torch/server/`) on
``127.0.0.1:0`` over a port CPU Context, and the REPL's meta commands and
query runner (`dask_sql_tpu_torch/cmd.py`).

The statements of the reference's server tests go to a port server and a
reference server over the same frames, and their ``columns`` and ``data``
must be equal (exact: the frames are small integers, strings and
decimals the two engines compute alike).  Then, on the port alone: polling,
JDBC metadata, concurrent queries, ``/v1/metrics``, the 429 past the queue
bound with ``Retry-After``, the deadline header, DELETE ``/v1/cancel``,
the batch class header, the result cache and SHOW METRICS over the wire,
the drain, and the entry points' default device (the card).
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch

import dask_sql_tpu
from dask_sql_tpu_torch import Context

FRAMES = {
    "df_simple": pd.DataFrame({"a": [1, 2, 3], "b": [1.1, 2.2, 3.3]}),
    "user_table_1": pd.DataFrame({"user_id": [2, 1, 2, 3],
                                  "b": [3, 3, 1, 3]}),
    "words": pd.DataFrame({"w": ["x", "yy", "x", "zzz"],
                           "n": np.arange(4, dtype=np.int64)}),
}

#: the reference server tests' statements, plus a GROUP BY and strings
PARITY_SQL = [
    "SELECT 1 + 1 AS x",
    "SELECT a FROM df_simple ORDER BY a",
    "SELECT 41 + 1 AS x",
    "SELECT a + 41 AS v FROM df_simple",
    "SELECT user_id, SUM(b) AS s, COUNT(*) AS c FROM user_table_1 "
    "GROUP BY user_id ORDER BY user_id",
    "SELECT w, COUNT(*) AS c, MAX(n) AS m FROM words GROUP BY w ORDER BY w",
    "SELECT a, b FROM df_simple WHERE b > 2.0 ORDER BY a",
] + [f"SELECT {i} * a AS v FROM df_simple ORDER BY v" for i in range(1, 4)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _context(engine="port"):
    c = Context(device="cpu") if engine == "port" else dask_sql_tpu.Context()
    for name, frame in FRAMES.items():
        c.create_table(name, frame)
    return c


def _server(engine="port", context=None, **kw):
    if engine == "port":
        from dask_sql_tpu_torch.server.app import run_server
    else:
        from dask_sql_tpu.server.app import run_server
    return run_server(context=context if context is not None
                      else _context(engine), host="127.0.0.1", port=0,
                      blocking=False, **kw)


@pytest.fixture(scope="module")
def servers():
    """A port server and a reference server over the same frames."""
    port, ref = _server("port"), _server("ref")
    yield port, ref
    port.shutdown()
    ref.shutdown()


@pytest.fixture
def server(servers):
    return servers[0]


def _post(port, sql, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/statement", data=sql.encode(),
        method="POST")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _follow(payload, timeout=60):
    deadline = time.time() + timeout
    while "nextUri" in payload and time.time() < deadline:
        time.sleep(0.02)
        with urllib.request.urlopen(payload["nextUri"], timeout=30) as resp:
            payload = json.loads(resp.read())
    return payload


def _run(port, sql, headers=None):
    return _follow(_post(port, sql, headers)[1])


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return json.loads(resp.read())


# ----------------------------------------------------------- parity
@pytest.mark.parametrize("sql", PARITY_SQL)
def test_statement_columns_and_data_match_reference(servers, sql):
    port, ref = servers
    got, want = _run(port.port, sql), _run(ref.port, sql)
    assert got["stats"]["state"] == want["stats"]["state"] == "FINISHED"
    assert got["columns"] == want["columns"]
    assert got["data"] == want["data"]


def test_server_select(server):
    payload = _run(server.port, "SELECT 1 + 1 AS x")
    assert payload["stats"]["state"] == "FINISHED"
    assert payload["columns"][0]["name"] == "x"
    assert payload["data"][0][0] == 2


def test_server_error_matches_reference(servers):
    got = _run(servers[0].port, "SELECT FROM WHERE")
    want = _run(servers[1].port, "SELECT FROM WHERE")
    assert "error" in got
    assert got["error"]["errorName"] == want["error"]["errorName"]
    assert got["error"]["errorType"] == want["error"]["errorType"]
    assert got["stats"]["state"] == "FAILED"


def test_server_empty(server):
    assert _get(server.port, "/v1/empty")["data"] == []
    st, payload, _ = _post(server.port, "   ")
    assert st == 200 and payload["data"] == []


def test_server_jdbc_metadata():
    from dask_sql_tpu_torch.server.presto_jdbc import SYSTEM_SCHEMA

    c = _context()
    srv = _server(context=c, jdbc_metadata=True)
    try:
        assert SYSTEM_SCHEMA in c.schema
        payload = _run(srv.port, "SELECT * FROM system.jdbc.tables")
        cols = [col["name"] for col in payload["columns"]]
        names = [row[cols.index("TABLE_NAME")] for row in payload["data"]]
        assert "df_simple" in names
    finally:
        srv.shutdown()


def test_server_concurrent_queries_update_metrics(server):
    import concurrent.futures

    port = server.port
    before = _get(port, "/v1/metrics")

    def run(i):
        payload = _run(port, f"SELECT {i} * a AS v FROM df_simple ORDER BY v")
        assert payload["stats"]["state"] == "FINISHED", payload
        return [row[0] for row in payload["data"]]

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(run, range(11, 19)))
    for i, vals in zip(range(11, 19), results):
        assert vals == [i * 1, i * 2, i * 3]
    m = _get(port, "/v1/metrics")
    for key in ("workers", "queueDepth", "running", "completed", "failed",
                "cancelled", "avgLatencyMillis", "avgQueuedMillis",
                "ledger", "resultCache"):
        assert key in m, key
    assert m["completed"] >= before["completed"] + 8
    assert m["queueDepth"] == 0 and m["running"] == 0
    reg = m["registry"]["counters"]
    assert reg["serving.admitted"] >= 8 and reg["serving.completed"] >= 8
    assert m["registry"]["histograms"]["serving.latency_ms"]["count"] >= 8
    assert m["serving"]["admission"]["waiting"] == {"interactive": 0,
                                                    "batch": 0}


def test_server_status_reports_real_times(server):
    stats = _run(server.port, "SELECT 2 + 2 AS x")["stats"]
    assert stats["state"] == "FINISHED"
    assert stats["elapsedTimeMillis"] >= stats["queuedTimeMillis"] >= 0


def test_repeated_query_hits_cache_via_server(server):
    sql = "SELECT a + 42 AS v FROM df_simple"
    r1, r2 = _run(server.port, sql), _run(server.port, sql)
    assert r1["data"] == r2["data"]
    assert int(_get(server.port, "/v1/metrics")["resultCache"]["hits"]) >= 1
    rows = {row[0]: row[1] for row in
            _run(server.port, "SHOW METRICS")["data"]}
    assert int(rows["query.cache.hit"]) >= 1
    assert any(k.startswith("serving.runtime.") for k in rows)


def test_batch_class_header(server):
    st, p, _ = _post(server.port, "SELECT 3 + 3 AS x",
                     headers={"X-Dsql-Class": "batch",
                              "X-Dsql-Tenant": "dash"})
    assert st == 200
    assert _follow(p)["data"][0][0] == 6
    reg = _get(server.port, "/v1/metrics")["registry"]["counters"]
    assert reg.get("serving.admitted.batch", 0) >= 1


def test_metrics_prometheus_and_queries(server):
    req = urllib.request.urlopen(
        f"http://127.0.0.1:{server.port}/v1/metrics?format=prometheus",
        timeout=30)
    with req as resp:
        text = resp.read().decode()
        assert resp.headers["Content-Type"].startswith("text/plain")
    assert "dsql_serving_ledger_materialized_bytes" in text
    live = _get(server.port, "/v1/queries")
    assert "queries" in live and "ledger" in live


# -------------------------------------------------- a saturated server
@pytest.fixture
def tiny_server():
    """1 worker, interactive queue bound 1: trivially saturated by a row
    function that sleeps."""
    c = Context(device="cpu")
    c.create_table("sleepy", pd.DataFrame({"a": np.arange(4, dtype=np.int64)}))

    def slow(row):
        time.sleep(0.15)
        return int(row["x"])

    c.register_function(slow, "slowid", [("x", np.int64)], np.int64,
                        row_udf=True)
    with c.config.set({"serving.workers": 1,
                       "serving.queue.interactive": 1,
                       "serving.retry_after_s": 2.0}):
        srv = _server(context=c)
    yield srv
    srv.shutdown()


def test_rejection_past_queue_bound(tiny_server):
    port = tiny_server.port
    sqls = [f"SELECT slowid(a) + {i} AS v FROM sleepy" for i in range(3)]
    st1, p1, _ = _post(port, sqls[0])  # occupies the single worker
    deadline = time.time() + 10
    while time.time() < deadline and _get(port, "/v1/metrics")["running"] < 1:
        time.sleep(0.02)
    st2, p2, _ = _post(port, sqls[1])  # fills the queue (bound 1)
    assert st1 == 200 and st2 == 200
    st3, p3, h3 = _post(port, sqls[2])
    assert st3 == 429
    assert p3["error"]["errorName"] == "QUERY_QUEUE_FULL"
    assert p3["error"]["errorType"] == "INSUFFICIENT_RESOURCES"
    assert p3["error"]["retryAfterSeconds"] > 0
    assert int(h3["Retry-After"]) >= 1
    assert _follow(p1)["stats"]["state"] == "FINISHED"
    assert _follow(p2)["stats"]["state"] == "FINISHED"
    m = _get(port, "/v1/metrics")
    assert m["rejected"] == 1 and m["completed"] == 2
    assert m["registry"]["counters"]["serving.rejected"] == 1


def test_deadline_header_cancels(tiny_server):
    st, p, _ = _post(tiny_server.port, "SELECT slowid(a) AS v FROM sleepy",
                     headers={"X-Dsql-Deadline-Ms": "1"})
    assert st == 200
    payload = _follow(p)
    assert payload["error"]["errorName"] in ("EXCEEDED_TIME_LIMIT",
                                             "DeadlineExceededError")


def test_cancel_endpoint_cooperative(tiny_server):
    port = tiny_server.port
    _, p, _ = _post(port, "SELECT slowid(a) * 7 AS v FROM sleepy")
    time.sleep(0.1)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/cancel/{p['id']}", method="DELETE")
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert json.loads(resp.read())["cancelled"] is True
    assert "error" in _follow(p)
    assert _get(port, "/v1/metrics")["cancelled"] == 1


def test_drain_then_shutdown():
    srv = _server()
    port = srv.port
    assert _run(port, "SELECT 5 AS x")["data"] == [[5]]
    st, p, _ = _post(port, "")  # an empty statement is answered inline
    assert st == 200
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/drain",
                                 data=b"", method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert json.loads(resp.read())["status"] == "draining"
    deadline = time.time() + 10
    while time.time() < deadline and not srv.draining.is_set():
        time.sleep(0.02)
    st, p, _ = _post(port, "SELECT 6 AS x")
    assert st == 503 and p["error"]["retryable"] is True
    srv.shutdown()
    assert srv.context.metrics.counter("fleet.drain") == 1


def test_entry_points_default_to_the_card(monkeypatch):
    """`run_server()` and the REPL build their Context on the CUDA card:
    with none present they raise rather than serve from the CPU."""
    from dask_sql_tpu_torch import cmd
    from dask_sql_tpu_torch.server import app

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        app.run_server(host="127.0.0.1", port=0, blocking=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        app.main(["--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cmd.main([])


# ------------------------------------------------------------- the REPL
@pytest.fixture
def c():
    return _context()


def test_meta_commands(c, capsys):
    from dask_sql_tpu_torch.cmd import _handle_meta

    assert _handle_meta(c, "\\l")
    assert "root" in capsys.readouterr().out
    assert _handle_meta(c, "\\dt")
    assert "df_simple" in capsys.readouterr().out
    assert _handle_meta(c, "\\conf sql.optimize")
    assert "sql.optimize" in capsys.readouterr().out
    assert _handle_meta(c, "\\dm") and _handle_meta(c, "\\df")
    assert not _handle_meta(c, "\\nonsense")


def test_meta_schema_switch(c, capsys):
    from dask_sql_tpu_torch.cmd import _handle_meta

    c.create_schema("side")
    assert _handle_meta(c, "\\dss side")
    assert c.schema_name == "side"
    _handle_meta(c, "\\dss root")
    assert _handle_meta(c, "\\dsc root")
    assert "df_simple" in capsys.readouterr().out


def test_run_query_prints_result_as_the_reference(c, capsys):
    from dask_sql_tpu.cmd import _run_query as ref_run_query
    from dask_sql_tpu_torch.cmd import _run_query

    sql = "SELECT user_id, SUM(b) AS s FROM user_table_1 GROUP BY user_id " \
          "ORDER BY user_id"
    _run_query(c, sql)
    got = capsys.readouterr().out
    ref_run_query(_context("ref"), sql)
    want = capsys.readouterr().out
    assert got.splitlines()[:-1] == want.splitlines()[:-1]
    assert "user_id" in got


def test_run_query_prints_error(c, capsys):
    from dask_sql_tpu_torch.cmd import _run_query

    _run_query(c, "SELECT * FROM not_a_table")
    assert "ERROR" in capsys.readouterr().err


def test_quit_raises(c):
    from dask_sql_tpu_torch.cmd import _handle_meta

    with pytest.raises(EOFError):
        _handle_meta(c, "\\q")
