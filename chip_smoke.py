"""Chip smoke test of the PyTorch port on one CUDA card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds every kernel of the port from ``dask_sql_tpu_torch/csrc`` (one
``nvcc`` per source, started together) and, beside them, the native C++
planner from ``native/*.cpp`` (``g++``, into ``dask_sql_tpu_torch/_build``),
holds each kernel against its plain PyTorch version on the card, checks
that the segment-sum kernel (at domains 12 and 2048, uniform and skewed,
staged or loaded from misaligned copies) and the float64 scatter of large
group domains give the same bits on every run, and that TPC-H q15 on
``generate(scale_rows=200_000)`` (2,000 suppliers: both of its revenue
sums, computed apart, on the kernel) keeps its row with the same bits in
every run, and drives these paths through
``Context(device="cuda")``, each checked against a float64 pandas/numpy
oracle: TPC-H Q1 at SF1 (6,000,000 synthetic ``lineitem`` rows, loaded with
the column encodings the reference picks: DICT ``l_quantity`` and
``l_shipdate``; the date filter on the codes, one kernel launch, one
transfer), the same Q1 over PLAIN columns (``columnar.encoding = "off"``)
timed beside it, ``bench.py``'s root top-k SELECT over those 6,000,000 rows
and a select filtered on a DICT column (the compiled select: two transfers,
phase times), TPC-H Q3 over ``tests/tpch.py
generate(scale_rows=1_000_000)`` (the scale of ``bench.py``'s Q3 line, on
its encoded columns; the compiled join->aggregate pipeline, one transfer
and a plan-cache hit per warm run), every other TPC-H query (q2, q4-q22)
on all eight tables of those frames (the eager aggregate, the compiled
rungs, the outer, semi, anti and mark joins, subqueries and SUBSTRING:
each query's rungs, transfers and kernel launches, checked against the
port on the CPU and, for q14 and q19, a float64 oracle; no rung may step
down), a star join of 6,000,000 fact rows
through that pipeline into the segment-sum kernel, and (phase ``tpcds``)
all 99 TPC-DS queries on ``tests/tpcds.py generate(scale_rows=1_000_000)``
(24 tables, 1,000,000 ``store_sales`` rows; the set operations, window
functions and string-valued expressions), each cold and warm, against
the port on the CPU on the same frames, on its rungs, with per query the
warm ms, transfers, kernel launches and the set-operation and window
nodes that ran.  The ``surface`` phase appends to Q1's 6,000,000 rows
by INSERT INTO (a copy of the rows under a quantity, and one row of a new
return flag) and runs Q1 again, cold and warm, against the float64 oracle
of the appended frame (a new plan and pipeline, one kernel launch, one
transfer), and on the TPC-H frames runs a DDL script in multi-statement
calls (CREATE SCHEMA, USE, CREATE TABLE AS, CREATE VIEW, SHOW, DESCRIBE,
ANALYZE TABLE, ALTER TABLE, DROP) and queries of the function registry, a
registered tensor function and a registered aggregation; every statement
is held against the port on the CPU, on the same rungs and encoding
counts.  The ``files`` phase writes Q1's 6,000,000 rows as 6 parquet files
in row groups of 500,000 (a temporary directory): registered lazily (the
footers only: no card memory), Q1 streams in batches through partial and
final aggregate states, the kernel launching on each batch, against the
float64 oracle, with the card's peak memory during the query printed
beside the 192,000,000 bytes of the rows loaded PLAIN and the table still
on disk after; the same files loaded with ``persist=True`` (the encodings,
card bytes, Q1 on the fused aggregate with one launch and one transfer);
``bench.py``'s root select over the lazy table (pyarrow's filter, the
rows read); and Q3 with ``lineitem`` as 4 parquet files streamed through
its joins, ``customer`` from a CSV file by CREATE TABLE WITH (location =
...), against its float64 oracle.  The ``resilience`` phase runs Q1's
6,000,000 encoded rows down the degradation ladder: under
``compile:always`` every compiled rung steps down once and the eager
aggregate answers on the card (its kernel calls held against the plain
version; its warm ms beside the fused Q1's); the circuit breaker trips on
the third failure, skips the family's rungs (another date literal too)
and closes on a clean half-open trial after its cooldown; ``oom:once``
steps the fused aggregate down; a memory fraction of what is reserved
plus 8 MiB makes the card raise a real ``torch.cuda.OutOfMemoryError``
in the fused program and in the eager walk, and the query leaves as a
degradable ``ResourceExhaustedError`` (the CPU rung serves CPU Contexts
only; then Q1 is back on the fused aggregate); ``exec_oom:once`` with
``sql.compile`` off leaves the same way; a GROUP BY of two
2,500-value string keys over 1,000,000 rows skips the compiled rungs by
the plan verifier's proof and answers on the sorted scatter against a
pandas oracle (timed beside ``analysis.verify = off``); and EXPLAIN LINT
and EXPLAIN ESTIMATE of Q1, the root select (and its twin of the same
family whose every row survives) and Q3 with their ms, each query's
resident input plus result bytes and the resident bytes plus the card's
peak rise inside the estimate's ``peak_bytes`` (for Q1 and the every-row
select ``hi`` at most twice that sum), and Q1's cold
planning with the verifier and the estimator on and off.  The
``observability`` phase runs EXPLAIN ANALYZE of Q1 on the card (the node
tree's labels and rows against the port's on the CPU, one synchronize of
the card a node from ``tracing.py``, the kernel's launch held against its
plain version) and under ``compile:always`` (the ``degraded:`` markers,
the eager aggregate's launches), warm Q1 with lifecycle tracing on and
off in turns (no synchronize from ``tracing.py`` untraced), SHOW METRICS
(one pipeline build however many warm runs) and SHOW PROFILES (a hit a
run).  After each phase (``card_memory``) the card's allocated bytes
must be back within 64 MiB of their value before it once its Contexts
are deleted; the remainder is printed with the tensors that hold it.
The ``streamed`` phase runs Q1 under an admission budget of a quarter
of its provable floor: it streams in 4-8 partitions (``streaming/``), one
segment-sum launch each (held against the plain version on those calls),
within 5e-6 of the float64 oracle, with counts exact and the same bits in
every run; then with ``partition:at2`` (one repartition, every row once),
under a watched launch, and the root select without its ORDER BY and
LIMIT streamed in the single run's row order.  The ``pressure`` phase
checks the bands at a set device budget, a RED reclaim of card-resident
cached results (by ``torch.cuda.memory_allocated``), a real
``torch.cuda.OutOfMemoryError`` that a reclaim rescues on the same rung,
and the CRITICAL band (Q1 streamed, TPC-H q22 shed).  The ``coldstart``
phase saves and loads Q1's table and the TPC-H tables (the card's bytes
equal after the load), waits for the warm-up (the first Q1 builds no
pipeline), degrades a hung build under the watchdog, rebuilds a grown
table's pipeline in the background, and runs a second Python process that
finds the kernel and planner libraries in a compile cache.  The
``reuse`` phase (``materialize/``) folds three appends of 10,000 rows
into an aggregate over TPC-H lineitem at 1,000,000 rows (one launch a
fold, none at an answer, each answer against the float64 oracle), serves
tighter date windows of Q1's table by re-filtering cached rows on the
card, pins the stem ``l_quantity < 10`` under three downstream shapes
(its bytes the ledger's, each shape on the interpreted walk after the
pin) and reclaims the cache and then the stem at RED.  The ``server``
phase starts the Presto-wire server on the card (Q1 and eight members
of its family over HTTP, a 429, a cancel, ``/v1/metrics``) and pipes a
CREATE TABLE WITH (location = ...) and Q1 into the REPL on the card.
The ``surface_rest`` phase drives Q1's frame through ``head(5)``,
``len()`` (one transfer and one launch each), ``persist()`` and
``explain_str()``, `Context.visualize` (a PNG, or its ``.txt`` without
matplotlib), ``fqn``, `Context.run_server` on the card (one POST of Q1)
and ``stop_server`` (its port closed), and the ``%%sql`` magic where
IPython imports.  The ``chaos`` phase runs one seeded chaos campaign
(``resilience/chaos.py``) on a card Context with the lock sanitizer armed:
every invariant holds, the card's bytes among them, and the storm's kernel
calls are held against the plain version.  The ``selflint`` phase runs
``python -m dask_sql_tpu_torch.analysis --self`` (exit 0, no finding).
The ``ml`` phase (before ``selflint``) trains the engine's own models
(LinearRegression, LogisticRegression, KMeans) by CREATE MODEL over all
6,000,000 rows of Q1's table on the card, runs each one's PREDICT over a
filtered select on the fused ``compiled_predict`` rung (two transfers,
no step down; the rows against pandas, the predictions within 5e-6 of a
float64 oracle of the fitted weights, labels and cluster ids exact but
on float32 boundary rows, counted), a second literal and a same-shape
retrain with no pipeline build, the host tier, the ledger's model bytes
and SHOW MODELS, a RED reclaim, the ``predict:once`` step down and DROP
MODEL, then applies two drawn 100-tree ensembles (GBDT- and
forest-shaped) to the 6,000,000 x 3 feature matrix, held against the
same program on the CPU and a numpy walk on a sample of the rows, with
the card's peak rise beside the port's charge.
The ``spmd`` phase (after ``ml``) shards tables on the card: a sharded
table's mesh is a list of shards, several of which may name one device,
so ``make_mesh(4, devices=["cuda:0"])`` rehearses a four-card mesh on the
one card (everything but the copies between cards; a multi-card run
waits for a machine with more than one card).  It registers Q1's rows
with ``create_table(..., distributed=True)`` on the card's default mesh
(one shard a card: the sharded rungs decline, Q1 answers on the fused
aggregate), then on four shards: Q1 on ``spmd_aggregate`` (one kernel
launch a shard, each held against the plain version; the float64 oracle;
the same bits in 3 runs; a second date literal with no build; warm ms
beside the unsharded Q1's; the card bytes of the sharded table equal to
the unsharded one's), ``bench.py``'s root select without its ORDER BY and
LIMIT on ``spmd_select`` (rows and order the unsharded port's) and with
them (the walk's top-k), ``spmd:once`` (Q1 steps down to the fused
aggregate, the breaker charged on its sharded rung only), then Q3 with
``lineitem`` sharded on ``spmd_join_aggregate`` and the collectives
engine (a GROUP BY on a computed float key, a hash-shuffle join with
``sql.join.broadcast = False``, an ORDER BY ... LIMIT through the range-
partition sort) over the TPC-H frames, each against the port on the CPU
over four CPU shards, counters included.
Every phase but ``resilience`` and ``coldstart`` fails if a rung steps
down, answers on the CPU or moves a breaker (``observability`` allows only
its ``compile:always`` run's steps).
For each loaded frame
it prints the encoded columns and the card memory they take, encoded and,
for Q1's table, loaded PLAIN, and checks every encoded column's decoded
buffer against the host's PLAIN values exactly.  It times each query
cold and warm, Q1's planning cold with the native planner and with the
Python one (it fails when the native planner did not plan) and from the
plan cache, Q1 with three new date literals (one plan family: the first
builds the fused pipeline, the next two count ``families.hit``, one
transfer each, each against its float64 oracle), and the kernel,
its plain version and the PyTorch library call that computes the same
function, at the typed shape Q1 gives the kernel and at the ``[k, n]``
stacked shape of earlier work; the kernel is also held against its plain
version on the very calls the star join, q4, q9, q14 and q22 and the
TPC-DS queries above a Union (q5, q77) and window queries that aggregate
make.  The kernel is timed on the card alone (``ms``, behind a spin kernel),
with the host issuing each call in the loop (``unspun_ms``, the way the plain
version and the library call are timed), and on the host (``host_us`` to
issue one call).  Each phase prints one line.  The second-to-last lines
are the kernels' JSON record and the card's name and power limit; the last
line is the JSON result.  Any failed phase ends the script with a nonzero
exit code and no result line.  Without a CUDA card, or without the
``dask_sql_tpu_torch`` package beside it, it fails.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

N_ROWS = 6_000_000  # ~SF1 lineitem row count
QUERY = """
SELECT
    l_returnflag,
    l_linestatus,
    SUM(l_quantity) AS sum_qty,
    SUM(l_extendedprice) AS sum_base_price,
    SUM(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
    SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
    AVG(l_quantity) AS avg_qty,
    AVG(l_extendedprice) AS avg_price,
    AVG(l_discount) AS avg_disc,
    COUNT(*) AS count_order
FROM lineitem
WHERE l_shipdate <= DATE '1998-09-02'
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
"""
KEYS = ["l_returnflag", "l_linestatus"]
REL_BOUND = 5e-6  # MATMUL_FLOAT_REL_ERR_BOUND of the port's segment sum
Q3_ROWS = 1_000_000  # tests/tpch.py scale_rows of bench.py's Q3 line
Q3_KEYS = ["l_orderkey", "o_orderdate", "o_shippriority"]
Q3_REL = 1e-9  # float64 sums throughout
STAR_ROWS = 6_000_000
STAR_QUERY = ("SELECT d1_cat, SUM(f_val) AS s, COUNT(*) AS n "
              "FROM fact JOIN dim1 ON f_dim1 = d1_key "
              "JOIN dim2 ON f_dim2 = d2_key "
              "WHERE d2_region = 'r2' AND f_qty > 3 "
              "GROUP BY d1_cat ORDER BY d1_cat")
WARM_RUNS = 5
#: warm Q1 runs with lifecycle tracing on and off, in turns (`observability`)
TRACING_PAIRS = 25
REPEATS = 10  # runs of one segment sum that must give the same bits
#: every other TPC-H query, run on the Q3 frames (all eight tables) by the
#: `tpch_more` phase: the eager aggregate, the compiled rungs, the outer,
#: semi, anti and mark joins, subqueries and SUBSTRING
TPCH_MORE = (2, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
             20, 21, 22)
#: the rungs each answers on at these frames, and how often a query takes
#: each (the eager aggregate counts none), as the port on the CPU answers
#: them.  q17's join pipeline declines here: its filtered part keys are too
#: sparse in 1..100,000 for a lookup table, so its outer sum answers on the
#: eager rung
TPCH_RUNGS = {2: {"compiled_join_aggregate": 1},
              6: {"compiled_aggregate": 1},
              11: {"compiled_join_aggregate": 2},
              14: {"compiled_join_aggregate": 1},
              15: {"compiled_aggregate": 2},
              17: {"compiled_aggregate": 1},
              18: {"compiled_aggregate": 1},
              19: {"compiled_join_aggregate": 1}}
#: queries whose segment sums must reach the kernel in every run (a group
#: domain of at most 2048 in an aggregate over tables on the card; q15's
#: small one reduces the host group table of its revenue view)
TPCH_KERNEL = (4, 6, 11, 13, 14, 17, 19, 22)
#: queries whose kernel calls are held against the plain version
TPCH_CALLS = (4, 9, 14, 22)
#: Q1's date literals of the `families` phase: one family, three members
FAMILY_DATES = ("1998-08-01", "1997-06-30", "1995-03-15")
TPCH_REL = 1e-9  # float64 sums on the card and on the CPU
SELECT_QUERY = ("SELECT l_returnflag, l_extendedprice * (1 - l_discount) AS rev "
                "FROM lineitem WHERE l_discount > 0.09 "
                "ORDER BY rev DESC LIMIT 100")  # bench.py's root select line
#: the same plan family with every row surviving its filter: the select's
#: largest survivor bucket, the case its estimate's hi bounds
SELECT_ALL_QUERY = SELECT_QUERY.replace("> 0.09", "> -1.0")
#: TPC-DS on the card: `tests/tpcds.py generate(scale_rows=...)`, all 24
#: tables (1,000,000 store_sales rows), every query cold once and warm
#: TPCDS_WARM_RUNS times (fewer than WARM_RUNS, for the time limit)
TPCDS_ROWS = 1_000_000
TPCDS_WARM_RUNS = 3
#: host-bound TPC-DS queries (seconds of host dictionary merges a run) that
#: run warm once, for the time limit
TPCDS_HOST_BOUND = (4, 11, 74)
#: TPC-DS queries whose kernel calls are held against the plain version:
#: aggregates above a Union (ROLLUP), and window queries that aggregate
TPCDS_UNION_CALLS = (5, 77)
TPCDS_WINDOW_CALLS = (12, 20, 98, 36, 86)
#: the plan nodes of this slice counted per TPC-DS query
SLICE_NODES = ("Union", "Distinct", "Intersect", "Except", "Window")
#: q15 on the kernel route: at this scale its 2,000 suppliers put both of
#: its revenue sums on the segment-sum kernel
Q15_KERNEL_ROWS = 200_000
DICT_SELECT_QUERY = ("SELECT l_shipdate, l_quantity, l_extendedprice "
                     "FROM lineitem WHERE l_quantity < 10 "
                     "ORDER BY l_extendedprice DESC LIMIT 100")
#: the `surface` phase's appends to Q1's table: a copy of the rows under a
#: quantity (about a tenth more), then one row of a new return flag, typed
#: as the table's columns
#: the `files` phase: Q1's rows as parquet files, Q3's lineitem too
FILES_PARTS = 6
FILES_ROW_GROUP = 500_000
FILES_Q3_PARTS = 4
FILES_Q3_BATCH_ROWS = 250_000
PLAIN_ROW_BYTES = 32  # Q1's seven columns PLAIN: 4 x float32, 2 codes, a date
SURFACE_INSERTS = (
    "INSERT INTO lineitem SELECT * FROM lineitem WHERE l_quantity < 6",
    "INSERT INTO lineitem VALUES ('X', 'F', CAST(10.0 AS REAL), "
    "CAST(1000.0 AS REAL), CAST(0.05 AS REAL), CAST(0.02 AS REAL), "
    "TIMESTAMP '1998-01-01 00:00:00')")
#: the `surface` phase's statements over the TPC-H frames of `tpch_more`,
#: as multi-statement calls where one result is enough, in order (a later
#: call reads what an earlier one made)
SURFACE_DDL = (
    "CREATE SCHEMA surface; USE SCHEMA surface; "
    "CREATE TABLE revenue AS (SELECT l_returnflag, l_linestatus, "
    "SUM(l_extendedprice * (1 - l_discount)) AS revenue, COUNT(*) AS n "
    "FROM root.lineitem GROUP BY l_returnflag, l_linestatus); "
    "CREATE VIEW big_orders AS (SELECT o_orderkey, o_orderpriority, "
    "c_mktsegment, o_totalprice FROM root.orders JOIN root.customer "
    "ON o_custkey = c_custkey WHERE o_totalprice > 100000); "
    "SELECT c_mktsegment, COUNT(*) AS n, SUM(o_totalprice) AS total "
    "FROM big_orders GROUP BY c_mktsegment ORDER BY c_mktsegment",
    "SHOW TABLES",
    "SHOW COLUMNS FROM revenue",
    "DESCRIBE big_orders",
    "ANALYZE TABLE root.lineitem COMPUTE STATISTICS FOR ALL COLUMNS",
    "ALTER TABLE revenue RENAME TO revenue2; "
    "SELECT * FROM revenue2 ORDER BY l_returnflag, l_linestatus",
    "DROP VIEW big_orders; DROP TABLE revenue2; USE SCHEMA root; "
    "DROP SCHEMA surface; SHOW SCHEMAS")
#: the function registry, a registered tensor function and a registered
#: aggregation over the same frames: each query cold and WARM_RUNS warm
SURFACE_FUNCTIONS = {
    "left_position_power": (
        "SELECT LEFT(c_phone, 2) AS cc, COUNT(*) AS n, "
        "SUM(POWER(c_acctbal, 2)) AS p2 FROM customer "
        "WHERE POSITION('7' IN LOWER(c_name)) > 0 "
        "GROUP BY LEFT(c_phone, 2) ORDER BY cc"),
    "trim_lpad_split_replace": (
        "SELECT SPLIT_PART(p_name, ' ', 1) AS color, COUNT(*) AS n, "
        "MAX(LPAD(TRIM(p_type), 30, '.')) AS t, "
        "MIN(REPLACE(p_container, ' ', '_')) AS ct, "
        "MAX(SUBSTRING(p_name FROM p_size % 5 + 1 FOR 3)) AS sub "
        "FROM part GROUP BY SPLIT_PART(p_name, ' ', 1) ORDER BY color"),
    "truncate_greatest_log": (
        "SELECT l_returnflag, SUM(TRUNCATE(l_extendedprice, -2)) AS tp, "
        "MAX(GREATEST(l_extendedprice, l_tax * 1000000)) AS g, "
        "SUM(LOG(10, l_extendedprice)) AS lg FROM lineitem "
        "GROUP BY l_returnflag ORDER BY l_returnflag"),
    "date_trunc_diff_last_day": (
        "SELECT DATE_TRUNC('month', l_shipdate) AS m, COUNT(*) AS n, "
        "SUM(TIMESTAMPDIFF(DAY, l_shipdate, l_receiptdate)) AS d, "
        "MAX(LAST_DAY(l_shipdate)) AS ld FROM lineitem "
        "WHERE l_shipdate >= DATE '1997-01-01' "
        "GROUP BY DATE_TRUNC('month', l_shipdate) ORDER BY m"),
    "number_cast_group": (
        "SELECT CAST(o_shippriority AS VARCHAR) || '-' || o_orderpriority AS k, "
        "COUNT(*) AS n, SUM(o_totalprice) AS t FROM orders "
        "GROUP BY CAST(o_shippriority AS VARCHAR) || '-' || o_orderpriority "
        "ORDER BY k"),
    "udf_filter_sum": (
        "SELECT l_returnflag, SUM(disc_price(l_extendedprice, l_discount)) "
        "AS rev, COUNT(*) AS n FROM lineitem "
        "WHERE disc_price(l_extendedprice, l_discount) > 50000 "
        "GROUP BY l_returnflag ORDER BY l_returnflag"),
    "udf_projection": (
        "SELECT l_orderkey, l_linenumber, "
        "disc_price(l_extendedprice, l_discount) AS dp FROM lineitem "
        "WHERE l_orderkey < 2000 ORDER BY l_orderkey, l_linenumber"),
    "udaf_median": (
        "SELECT l_returnflag, med(l_extendedprice) AS m FROM lineitem "
        "GROUP BY l_returnflag ORDER BY l_returnflag"),
}

#: device memory rate by card name (NVIDIA data sheets), bytes/s
_MEMORY_RATE = [("H200", 4.8e12), ("NVL", 3.9e12), ("PCIe", 2.0e12),
                ("H100", 3.35e12)]
#: float64 rate outside the tensor cores, H100 SXM data sheet, FLOP/s
FP64_RATE = 34e12


def gen_lineitem(n: int, seed: int = 0):
    """Synthetic TPC-H lineitem, the same generator and seed as `bench.py`."""
    import pandas as pd

    rng = np.random.RandomState(seed)
    start = np.datetime64("1992-01-01")
    return pd.DataFrame(
        {
            "l_returnflag": rng.choice(["A", "N", "R"], n),
            "l_linestatus": rng.choice(["F", "O"], n),
            "l_quantity": rng.randint(1, 51, n).astype(np.float32),
            "l_extendedprice": (rng.rand(n).astype(np.float32) * 100000.0),
            "l_discount": (rng.rand(n).astype(np.float32) * 0.1),
            "l_tax": (rng.rand(n).astype(np.float32) * 0.08),
            "l_shipdate": start + rng.randint(0, 2526, n).astype("timedelta64[D]"),
        }
    )


def q1_oracle(df, date: str = "1998-09-02"):
    """Q1 in float64 numpy/pandas, from the same frame."""
    sel = df[df.l_shipdate <= np.datetime64(date)]
    price = sel.l_extendedprice.to_numpy(np.float64)
    disc = sel.l_discount.to_numpy(np.float64)
    tax = sel.l_tax.to_numpy(np.float64)
    work = sel[KEYS].assign(
        qty=sel.l_quantity.to_numpy(np.float64), price=price, disc=disc,
        disc_price=price * (1 - disc), charge=price * (1 - disc) * (1 + tax))
    out = work.groupby(KEYS).agg(
        sum_qty=("qty", "sum"), sum_base_price=("price", "sum"),
        sum_disc_price=("disc_price", "sum"), sum_charge=("charge", "sum"),
        avg_qty=("qty", "mean"), avg_price=("price", "mean"),
        avg_disc=("disc", "mean"), count_order=("qty", "count"))
    return out.reset_index().sort_values(KEYS).reset_index(drop=True)


def q3_oracle(tables):
    """TPC-H Q3 in float64 pandas, from the same frames: merge, filter,
    group, sort."""
    cust = tables["customer"]
    cust = cust[cust.c_mktsegment == "BUILDING"]
    orders = tables["orders"]
    orders = orders[orders.o_orderdate < np.datetime64("1995-03-15")]
    li = tables["lineitem"]
    li = li[li.l_shipdate > np.datetime64("1995-03-15")]
    m = li.merge(orders, left_on="l_orderkey", right_on="o_orderkey")
    m = m.merge(cust, left_on="o_custkey", right_on="c_custkey")
    m = m.assign(revenue=m.l_extendedprice.to_numpy(np.float64)
                 * (1 - m.l_discount.to_numpy(np.float64)))
    out = m.groupby(Q3_KEYS, as_index=False).revenue.sum()
    out = out.sort_values(["revenue", "o_orderdate"], ascending=[False, True],
                          kind="mergesort").head(10)
    return out[["l_orderkey", "revenue", "o_orderdate",
                "o_shippriority"]].reset_index(drop=True)


def select_oracle(df):
    """bench.py's root select in float64 pandas: the top 100 by revenue,
    ties in input order."""
    disc = df.l_discount.to_numpy()
    sel = df[disc > np.float32(0.09)]
    rev = sel.l_extendedprice.to_numpy(np.float64) * (
        1 - sel.l_discount.to_numpy(np.float64))
    order = np.argsort(-rev, kind="stable")[:100]
    return sel.l_returnflag.to_numpy()[order], rev[order]


def dict_select_oracle(df):
    """The DICT-filtered select in pandas: the top 100 by price."""
    sel = df[df.l_quantity.to_numpy() < np.float32(10)]
    price = sel.l_extendedprice.to_numpy()
    order = np.argsort(-price.astype(np.float64), kind="stable")[:100]
    return sel.iloc[order].reset_index(drop=True)


def gen_star(n: int, seed: int = 3):
    """The star schema of tests/integration/test_compiled_join.py, with n
    fact rows."""
    import pandas as pd

    rng = np.random.RandomState(seed)
    fact = pd.DataFrame({
        "f_dim1": rng.randint(0, 100, n),
        "f_dim2": rng.randint(1000, 1050, n),
        "f_val": rng.rand(n) * 100,
        "f_qty": rng.randint(1, 10, n),
    })
    dim1 = pd.DataFrame({
        "d1_key": np.arange(100),
        "d1_cat": [f"cat{i % 7}" for i in range(100)],
        "d1_flag": (np.arange(100) % 3 == 0),
    })
    dim2 = pd.DataFrame({
        "d2_key": np.arange(1000, 1050),
        "d2_region": [f"r{i % 5}" for i in range(50)],
    })
    return {"fact": fact, "dim1": dim1, "dim2": dim2}


def star_oracle(tables):
    m = tables["fact"].merge(tables["dim1"], left_on="f_dim1", right_on="d1_key")
    m = m.merge(tables["dim2"], left_on="f_dim2", right_on="d2_key")
    m = m[(m.d2_region == "r2") & (m.f_qty > 3)]
    out = m.groupby("d1_cat").agg(s=("f_val", "sum"), n=("f_val", "count"))
    return out.reset_index().sort_values("d1_cat").reset_index(drop=True)


def q14_oracle(tables) -> float:
    """TPC-H q14's promo revenue share in float64 pandas."""
    li = tables["lineitem"]
    li = li[(li.l_shipdate >= np.datetime64("1995-09-01"))
            & (li.l_shipdate < np.datetime64("1995-10-01"))]
    m = li.merge(tables["part"], left_on="l_partkey", right_on="p_partkey")
    rev = m.l_extendedprice.to_numpy(np.float64) * (
        1 - m.l_discount.to_numpy(np.float64))
    promo = np.where(m.p_type.str.startswith("PROMO").to_numpy(), rev, 0.0)
    return float(100.0 * promo.sum() / rev.sum())


def q19_oracle(tables) -> float:
    """TPC-H q19's discounted revenue in float64 pandas."""
    m = tables["lineitem"].merge(tables["part"], left_on="l_partkey",
                                 right_on="p_partkey")
    common = m.l_shipmode.isin(["AIR", "REG AIR"]) & (
        m.l_shipinstruct == "DELIVER IN PERSON")

    def arm(brand, size, containers, qlo, qhi, smax):
        return ((m.p_brand == brand)
                & m.p_container.isin([f"{size} {c}" for c in containers])
                & (m.l_quantity >= qlo) & (m.l_quantity <= qhi)
                & (m.p_size >= 1) & (m.p_size <= smax))

    sel = common & (arm("Brand#12", "SM", ("CASE", "BOX", "PACK", "PKG"), 1, 11, 5)
                    | arm("Brand#23", "MED", ("BAG", "BOX", "PKG", "PACK"), 10, 20, 10)
                    | arm("Brand#34", "LG", ("CASE", "BOX", "PACK", "PKG"), 20, 30, 15))
    mm = m[sel]
    return float((mm.l_extendedprice.to_numpy(np.float64)
                  * (1 - mm.l_discount.to_numpy(np.float64))).sum())


TPCH_ORACLES = {14: q14_oracle, 19: q19_oracle}


def same_answer(got, want, label) -> float:
    """`got` against `want` column by column: everything but floats
    exactly, floats within TPCH_REL; returns the largest relative error."""
    agree, rel = answers_agree(got, want)
    if not agree:
        fail(f"{label} result differs: {got.shape} {list(got.columns)} "
             f"against {want.shape} {list(want.columns)}, largest relative "
             f"float error {rel}")
    return rel


def answers_agree(got, want):
    """(agree, largest relative float error): the same columns and rows
    in the same order, everything but floats exactly (dtypes too), floats
    within TPCH_REL and NULL where `want` is."""
    if list(got.columns) != list(want.columns) or len(got) != len(want):
        return False, 0.0
    rel = 0.0
    for name in want.columns:
        g, w = got[name], want[name]
        if w.dtype.kind == "f":
            gv, wv = g.to_numpy(np.float64), w.to_numpy(np.float64)
            if not np.array_equal(np.isnan(gv), np.isnan(wv)):
                return False, rel
            ok = ~np.isnan(wv)
            if ok.any():
                rel = max(rel, float(np.max(np.abs(gv[ok] - wv[ok])
                                            / np.maximum(np.abs(wv[ok]),
                                                         1e-300))))
        elif g.tolist() != w.tolist() or g.dtype != w.dtype:
            return False, rel
    return rel <= TPCH_REL, rel


def rung_counts(c):
    return {k: v for k, v in c.metrics.snapshot()["counters"].items()
            if k.startswith("resilience.")}


def check_not_degraded(c, label) -> None:
    """No rung stepped down, none answered on the CPU and no breaker
    moved: each would hide the card's path."""
    bad = {k: v for k, v in c.metrics.snapshot()["counters"].items()
           if k.startswith(("resilience.degraded", "resilience.rung.cpu",
                            "resilience.breaker.")) and v}
    if bad:
        fail(f"{label}: a rung stepped down {bad}")


def max_rel(got, want) -> float:
    g = np.asarray(got, dtype=np.float64)
    w = np.asarray(want, dtype=np.float64)
    if not np.all(np.isfinite(g)):
        fail("a result is not finite")
    return float(np.max(np.abs(g - w) / np.abs(w))) if len(w) else 0.0


def measuring_context(device: str = "cuda"):
    """A port Context with the result cache off: every phase but `serving`
    times, counts and checks execution, so a repeated query must run
    again rather than come back from the cache."""
    from dask_sql_tpu_torch import Context

    c = Context(device=device)
    c.config.update({"serving.cache.enabled": False})
    return c


def load_tables(frames, options=None, distributed=(), device="cuda"):
    """(Context on `device` with `frames` registered, the tables named in
    `distributed` sharded over the default mesh, card memory the tables
    took in bytes (0 on the CPU), seconds)."""
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
    before = torch.cuda.memory_allocated() if on_card else 0
    t0 = time.perf_counter()
    c = measuring_context(device)
    c.config.update(options or {})
    for name, frame in frames.items():
        c.create_table(name, frame, distributed=name in distributed)
    if on_card:
        torch.cuda.synchronize()
    took = (torch.cuda.memory_allocated() if on_card else 0) - before
    return c, took, time.perf_counter() - t0


def check_encodings(c, frames, label, hbm_bytes, plain_hbm_bytes=None):
    """The `encodings` phase: each table's encoded columns, and each one's
    decoded buffer on the card against the host's PLAIN values, exactly."""
    from dask_sql_tpu_torch.columnar.encodings import Encoding
    from dask_sql_tpu_torch.columnar.table import Table

    encoded = {}
    for name, frame in frames.items():
        table = c.schema["root"].tables[name].table
        cols = {}
        for cname, col in table.columns.items():
            if col.encoding is Encoding.PLAIN:
                continue
            host = Table.from_pandas(frame[[cname]], "cpu",
                                     encode=False).columns[cname]
            dec = col.decode()
            valid = host.valid_mask().numpy()
            got_valid = dec.valid_mask().cpu().numpy()
            got = dec.data.cpu().numpy()
            if got.dtype != host.data.numpy().dtype \
                    or not np.array_equal(got_valid, valid) \
                    or not np.array_equal(got[valid], host.data.numpy()[valid]):
                fail(f"{name}.{cname}: the decoded {col.encoding} column "
                     "differs from the PLAIN values")
            cols[cname] = f"{col.encoding.value} {str(col.data.dtype)[6:]}"
        encoded[name] = cols
    hists = c.metrics.snapshot()["histograms"]
    phase("encodings", frame=label, columns=encoded,
          encoded_columns=c.metrics.counter(
              "columnar.encoding.encoded_columns"),
          hbm_bytes=hbm_bytes, plain_hbm_bytes=plain_hbm_bytes,
          encoded_bytes=hists.get("columnar.encoding.encoded_bytes",
                                  {}).get("sum", 0),
          decoded_bytes=hists.get("columnar.encoding.decoded_bytes",
                                  {}).get("sum", 0),
          decoded_equal_plain=True)


def check_counters(c, label, **want) -> None:
    """``columnar.encoding.<name>`` counters of `c` against `want`."""
    got = {k: c.metrics.counter(f"columnar.encoding.{k}") for k in want}
    if got != want:
        fail(f"{label}: encoding counters {got}, expected {want}")


def check_q1(got, want, label) -> float:
    """Q1's result against its oracle; returns the largest relative error."""
    if list(got.columns) != list(want.columns) or len(got) != len(want):
        fail(f"{label} result shape {got.shape} / columns {list(got.columns)}")
    for key in KEYS:
        if got[key].tolist() != want[key].tolist():
            fail(f"{label} group keys differ in {key}")
    if got["count_order"].tolist() != want["count_order"].tolist():
        fail(f"{label} counts differ from the oracle")
    rel = 0.0
    for name in want.columns[2:-1]:
        g = got[name].to_numpy(np.float64)
        w = want[name].to_numpy(np.float64)
        if not np.all(np.isfinite(g)):
            fail(f"{label} {name} is not finite")
        rel = max(rel, float(np.max(np.abs(g - w) / np.abs(w))))
    if not rel <= REL_BOUND:
        fail(f"{label} relative error {rel} > {REL_BOUND}")
    return rel


def run_select(c, sql, transfers, check, label):
    """A root select: a cold run, then WARM_RUNS warm runs with their phase
    times, each on the compiled select rung with two transfers (one when
    nothing survives) and checked by `check(result)`.  Returns
    (cold ms, warm ms list, per-phase median ms)."""
    from dask_sql_tpu_torch import families
    from dask_sql_tpu_torch.physical import compiled_select

    def one(times=None):
        rung = c.metrics.counter("resilience.rung.compiled_select")
        transfers["d2h"] = 0
        t0 = time.perf_counter()
        got = c.sql(sql).compute()
        ms = (time.perf_counter() - t0) * 1e3
        if c.metrics.counter("resilience.rung.compiled_select") != rung + 1:
            fail(f"{label} did not answer on the compiled select rung")
        if transfers["d2h"] != 2:
            fail(f"{label} made {transfers['d2h']} transfers, expected 2")
        check(got)
        return ms

    cold_ms = one()
    runs = [one() for _ in range(WARM_RUNS)]
    # the phases of the same pipeline on the same table, the card
    # synchronized between them
    pipe = next(reversed(compiled_select._cache.values()))
    table = c.schema["root"].tables["lineitem"].table
    # the query's family parameters, lifted as the select rung lifts them
    scan, upper, proj = compiled_select._extract(c.sql(sql)._plan)[:3]
    pz = families.pipeline_parameterizer(c.config)
    for e in list(upper) + list(scan.filters) + list(proj.exprs):
        pz.rewrite(e)
    laps = []
    for _ in range(WARM_RUNS):
        times = {}
        pipe.run(table.select(pipe.scan_names), pz.params, times)
        laps.append(times)
    phases = {k: float(np.median([t[k] for t in laps])) for k in laps[0]}
    return cold_ms, runs, phases


def reset_launches(segsum) -> None:
    for key in segsum.LAUNCHES:
        segsum.LAUNCHES[key] = 0


def warm_runs(c, sql, transfers, check):
    """WARM_RUNS timed runs of `sql`, each from the plan cache with one
    device-to-host transfer; `check(result)` on each.  Returns ms."""
    runs = []
    for _ in range(WARM_RUNS):
        hits = c.metrics.counter("query.plan_cache.hit")
        transfers["d2h"] = 0
        t0 = time.perf_counter()
        got = c.sql(sql).compute()
        runs.append((time.perf_counter() - t0) * 1e3)
        if c.metrics.counter("query.plan_cache.hit") != hits + 1:
            fail(f"a warm run missed the plan cache: {sql[:40]!r}")
        if transfers["d2h"] != 1:
            fail(f"a warm run made {transfers['d2h']} transfers, expected 1")
        check(got)
    return runs


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def memory_rate(name: str) -> float:
    for key, rate in _MEMORY_RATE:
        if key in name:
            return rate
    fail(f"no memory rate known for card {name!r}")


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() by CUDA events around `iters` calls, after
    warm-up.  Where issuing a call takes the host longer than the card
    takes to run it, the events time the host."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_ms(fn, iters: int):
    """(ms, host_us) of fn() after warm-up, each a mean over `iters` calls:
    the card's milliseconds by CUDA events, with a spin kernel queued ahead
    of them so that the host has issued every call before the card reaches
    the first, and the host's microseconds to issue one call, by its own
    clock over those calls."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(50_000_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_us


def segsum_inputs(n: int, domain: int, k: int, n_counts: int, seed: int,
                  stray_ids: bool = False):
    """gid [n] int32 and a [k, n] float32 column stack on the card: the
    first `n_counts` columns 0/1 masks (exact counts), the rest floats of
    spread magnitudes (hi/lo pairs of float64 sums)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    gid = torch.randint(0, domain, (n,), generator=g, device="cuda",
                        dtype=torch.int32)
    if stray_ids and n:
        # ids outside [0, domain) must add nothing
        gid[::97] = -1
        gid[1::89] = domain
    cols = torch.rand((k, n), generator=g, device="cuda")
    cols[:n_counts] = (cols[:n_counts] < 0.9).float()
    scale = torch.logspace(0, 5, max(k - n_counts, 1), device="cuda")
    cols[n_counts:] *= scale[: k - n_counts, None]
    return gid, cols.contiguous()


def typed_inputs(n: int, domain: int, seed: int, stray_ids: bool = False):
    """gid [n] int32 and the typed columns of Q1's call on the card: six
    bool count masks, then three float32 and two float64 sums each under
    one of those masks, with NaN in the rows the mask hides."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    gid = torch.randint(0, domain, (n,), generator=g, device="cuda",
                        dtype=torch.int32)
    if stray_ids and n:
        gid[::97] = -1
        gid[1::89] = domain
    masks = [torch.rand(n, generator=g, device="cuda") < p
             for p in (0.99, 0.98, 0.97, 0.9, 0.7, 0.5)]
    sums = [torch.rand(n, generator=g, device="cuda", dtype=dt) * scale
            for dt, scale in ((torch.float32, 50.0), (torch.float32, 1e5),
                              (torch.float32, 0.1), (torch.float64, 1e5),
                              (torch.float64, 1e9))]
    columns = [(m, None) for m in masks]
    for x, m in zip(sums, masks[1:]):
        x[~m] = float("nan")
        columns.append((x, m))
    return gid, columns


def misaligned(x: torch.Tensor) -> torch.Tensor:
    """A copy of x whose data starts one element past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:]
    view.copy_(x)
    return view


def typed_bytes(gid, columns, domain) -> int:
    """Bytes the typed call must move: each distinct buffer read once, the
    output written once."""
    bufs = {gid.data_ptr(): gid.nbytes}
    for data, mask in columns:
        bufs[data.data_ptr()] = data.nbytes
        if mask is not None:
            bufs[mask.data_ptr()] = mask.nbytes
    return sum(bufs.values()) + domain * len(columns) * 8


def typed_adds(gid, columns, domain) -> int:
    """Float64 additions the typed call's data needs: one per row whose id
    lies in the domain and whose column adds (mask, and bool value, true)."""
    live = (gid >= 0) & (gid < domain)
    total = 0
    for data, mask in columns:
        on = live if mask is None else live & mask
        if data.dtype == torch.bool:
            on = on & data
        total += int(on.sum())
    return total


def typed_errors(segsum, gid, columns, domain, label):
    """(largest absolute, largest relative) error of the kernel's typed
    call against its plain version on the same inputs; fails on a shape,
    a count or a relative error past REL_BOUND."""
    got = segsum.segsum_typed(gid, columns, domain)
    want = segsum.segsum_typed_plain(gid, columns, domain)
    torch.cuda.synchronize()
    k = len(columns)
    if got.shape != (domain, k) or got.dtype != torch.float64:
        fail(f"segsum {label}: shape {tuple(got.shape)} {got.dtype}")
    counts = [j for j, (d, _) in enumerate(columns) if d.dtype == torch.bool]
    if not torch.equal(got[:, counts], want[:, counts]):
        fail(f"segsum {label}: counts differ from the plain version")
    err = (got - want).abs()
    rel = float((err / want.abs().clamp_min(1e-30)).max()) if err.numel() else 0.0
    if not rel <= REL_BOUND:
        fail(f"segsum {label}: relative error {rel} > {REL_BOUND}")
    return (float(err.max()) if err.numel() else 0.0), rel


def check_calls(segsum, calls, label) -> float:
    """The kernel against its plain version on each captured call, one
    line for them all; returns the largest absolute error."""
    errs = [typed_errors(segsum, g_, c_, d_, f"{label}_call{i}")
            for i, (g_, c_, d_) in enumerate(calls)]
    phase("segsum_check", case=label, calls=len(calls),
          rows=sum(int(g_.shape[0]) for g_, _, _ in calls),
          domains=sorted({d_ for _, _, d_ in calls}),
          max_abs_err=max((e for e, _ in errs), default=0.0),
          max_rel_err=max((r for _, r in errs), default=0.0))
    return max((e for e, _ in errs), default=0.0)


def check_typed(segsum, gid, columns, domain, label):
    max_abs, rel = typed_errors(segsum, gid, columns, domain, label)
    k = len(columns)
    kc, warps, blocks = segsum.launch_geometry(gid, columns, domain)
    phase("segsum_check", case=label, n=int(gid.shape[0]), domain=domain, k=k,
          warps=warps, blocks=blocks, chunks=-(-k // kc),
          max_abs_err=max_abs, max_rel_err=rel)
    return max_abs


def check_kernel(segsum, gid, cols, domain, n_counts, label):
    got = segsum.segsum_columns(gid, cols, domain)
    want = segsum.segsum_plain(gid, cols.t(), domain)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != torch.float64:
        fail(f"segsum {label}: shape {tuple(got.shape)} {got.dtype}")
    if not torch.equal(got[:, :n_counts], want[:, :n_counts]):
        fail(f"segsum {label}: counts differ from the plain version")
    err = (got - want).abs()
    rel = float((err / want.abs().clamp_min(1e-30)).max()) if err.numel() else 0.0
    if not rel <= REL_BOUND:
        fail(f"segsum {label}: relative error {rel} > {REL_BOUND}")
    max_abs = float(err.max()) if err.numel() else 0.0
    phase("segsum_check", case=label, n=int(gid.shape[0]), domain=domain,
          k=int(cols.shape[0]), max_abs_err=max_abs, max_rel_err=rel)
    return max_abs


def repeatability(segsum, card) -> None:
    """Segment sums must give the same bits on every run: q15 keeps the
    supplier whose revenue equals the largest revenue, two sums computed
    apart, so a sum that moves in its last bits loses the row.  Each check
    runs REPEATS times and fails on any bit that differs from its first
    run: the kernel on Q1's typed columns at domains 12 and 2048, uniform
    and skewed (90% of rows at id 0), and over copies of the same columns
    that start off a 16-byte boundary (global loads instead of the staged
    ring: the same bits); `SortedSegments` (the sort included) at q15's
    call shape above the kernel's cutoff (one float64 column over 10,000
    suppliers) and skewed.  ``index_add_``, timed beside the sorted
    scatter, is reported, not checked."""
    def moved(fn):
        first = fn()
        return sum(not torch.equal(fn(), first) for _ in range(REPEATS))

    g = torch.Generator(device="cuda").manual_seed(6)
    for label, n, domain, skew in (("q15_shape", 1_000_000, 10_000, 0.0),
                                   ("skewed", 1_000_000, 250_000, 0.9)):
        gid = torch.randint(0, domain, (n,), generator=g, device="cuda",
                            dtype=torch.int32)
        gid[torch.rand(n, generator=g, device="cuda") < skew] = 0
        x = torch.rand(n, generator=g, device="cuda", dtype=torch.float64) * 1e5
        sorted_sum = lambda: segsum.SortedSegments(gid, domain).sum(x)  # noqa: E731
        index_add = lambda: torch.zeros(  # noqa: E731
            domain, dtype=torch.float64, device="cuda").index_add_(0, gid, x)
        sorted_moved = moved(sorted_sum)
        if sorted_moved:
            fail(f"SortedSegments {label} changed its bits in {sorted_moved} "
                 f"of {REPEATS} runs")
        phase("repeatability", card=card, case=label, n=n, domain=domain,
              skew=skew, repeats=REPEATS, sorted_runs_moved=sorted_moved,
              sorted_ms=cuda_ms(sorted_sum, 5),
              index_add_runs_moved=moved(index_add),
              index_add_ms=cuda_ms(index_add, 5),
              max_abs_diff=float((sorted_sum() - index_add()).abs().max()))
    for domain, skew in ((12, 0.0), (2048, 0.0), (12, 0.9), (2048, 0.9)):
        n = 1_000_003
        gid, cols = typed_inputs(n, domain, seed=8)
        gid[torch.rand(n, generator=g, device="cuda") < skew] = 0
        kernel = lambda: segsum.segsum_typed(gid, cols, domain)  # noqa: E731
        runs_moved = moved(kernel)
        mgid = misaligned(gid)
        mcols = [(misaligned(d), None if m is None else misaligned(m))
                 for d, m in cols]
        aligned_equal = torch.equal(segsum.segsum_typed(mgid, mcols, domain),
                                    kernel())
        if runs_moved or not aligned_equal:
            fail(f"the segsum kernel at domain {domain}, skew {skew}: bits "
                 f"moved in {runs_moved} of {REPEATS} runs, misaligned "
                 f"copies equal: {aligned_equal}")
        phase("repeatability", card=card, case=f"kernel_domain_{domain}",
              n=n, domain=domain, skew=skew, k=len(cols), repeats=REPEATS,
              kernel_runs_moved=runs_moved,
              misaligned_copies_equal=aligned_equal)


def q15_on_the_kernel(card, segsum, transfers):
    """TPC-H q15 where both of its revenue sums take the kernel: its row
    (the supplier whose revenue equals MAX(total_revenue)) in each of
    REPEATS runs, the same bits every run, the kernel launched in each."""
    from tests.tpch import QUERIES, generate

    frames = generate(scale_rows=Q15_KERNEL_ROWS, seed=7)
    suppliers = len(frames["supplier"])
    if suppliers > segsum.KERNEL_DOMAIN_CUTOFF:
        fail(f"q15's {suppliers} suppliers pass the kernel's cutoff")
    c, _, _ = load_tables(frames)
    cpu = cpu_context(frames)
    want = cpu.sql(QUERIES[15]).compute()
    reset_launches(segsum)
    first, runs = None, []
    for _ in range(REPEATS):
        transfers["d2h"] = 0
        t0 = time.perf_counter()
        got = c.sql(QUERIES[15]).compute()
        runs.append((time.perf_counter() - t0) * 1e3)
        if len(got) != 1:
            fail(f"q15 on the kernel route returned {len(got)} rows")
        if first is None:
            first = got
            rel = same_answer(got, want, "q15 on the kernel route")
        elif not got.equals(first):
            fail("q15 on the kernel route changed its answer between runs")
    launches = segsum.LAUNCHES["segsum"]
    if launches < REPEATS:
        fail(f"q15 launched the segsum kernel {launches} times in "
             f"{REPEATS} runs")
    check_not_degraded(c, "q15_kernel")
    phase("q15_kernel", card=card, scale_rows=Q15_KERNEL_ROWS,
          suppliers=suppliers, runs=REPEATS, rows=1, same_bits=True,
          launches=launches, ms=float(np.median(runs)), max_rel_err=rel)
    return launches


def cpu_context(frames):
    """The port on the CPU with `frames` registered: the card's yardstick."""
    cpu = measuring_context("cpu")
    for name, frame in frames.items():
        cpu.create_table(name, frame)
    return cpu


def like_table_ms(c, table: str, column: str, pattern: str):
    """(median ms, entries) of building a LIKE lookup table over the host
    dictionary of `table.column` (one regex match per distinct value), as
    an evaluator does once per build."""
    from dask_sql_tpu_torch.columnar.dtypes import SqlType
    from dask_sql_tpu_torch.physical.compiled import _TraceEval
    from dask_sql_tpu_torch.planner.expressions import ColumnRef, Literal

    t = c.schema["root"].tables[table].table
    idx = t.column_names.index(column)
    args = (ColumnRef(idx, column, SqlType.VARCHAR),
            Literal(pattern, SqlType.VARCHAR))
    runs = []
    for _ in range(WARM_RUNS):
        t0 = time.perf_counter()
        _TraceEval(t)._pattern_lut("like", ("col", idx),
                                   t.columns[column].dictionary, args)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(runs)), len(t.columns[column].dictionary)


def tpch_more(all_tables, card, segsum, transfers):
    """The `tpch_more` phase: each query cold once and WARM_RUNS times warm
    on the card, its rungs, transfers and segment-sum launches (the counts
    set to 0 just before the query's runs and read just after), checked
    against the port on the CPU and, for q14 and q19, a float64 oracle.
    Returns ({"launches": {query: n}, "max_abs_err": x}, the card's
    Context, the CPU's): the kernel is also held against its plain version
    on a call q4, q9, q22 (eager) and q14 (join pipeline) make."""
    from tests.tpch import QUERIES

    t0 = time.perf_counter()
    ct, hbm, load_s = load_tables(all_tables)
    cpu = cpu_context(all_tables)
    phase("tpch_more_load", card=card, tables=len(all_tables),
          hbm_bytes=hbm, load_s=load_s,
          setup_s=time.perf_counter() - t0,
          lineitem_rows=len(all_tables["lineitem"]))
    launches = {}
    for q in TPCH_MORE:
        sql = QUERIES[q]
        cpu_before = rung_counts(cpu)
        t0 = time.perf_counter()
        want = cpu.sql(sql).compute()
        cpu_ms = (time.perf_counter() - t0) * 1e3
        cpu_rungs = {k: v - cpu_before.get(k, 0)
                     for k, v in rung_counts(cpu).items()
                     if v != cpu_before.get(k, 0)}
        oracle = TPCH_ORACLES.get(q)
        oracle_want = oracle(all_tables) if oracle else None
        rel = [0.0]

        def check(got):
            rel[0] = max(rel[0], same_answer(got, want, f"q{q}"))
            if oracle_want is not None:
                r = max_rel(got.iloc[:, 0], [oracle_want])
                if not r <= TPCH_REL:
                    fail(f"q{q} relative error {r} against the oracle")
                rel[0] = max(rel[0], r)

        before = rung_counts(ct)
        reset_launches(segsum)
        transfers["d2h"] = 0
        t0 = time.perf_counter()
        got = ct.sql(sql).compute()
        cold_ms = (time.perf_counter() - t0) * 1e3
        cold_d2h = transfers["d2h"]
        check(got)
        runs = []
        for _ in range(WARM_RUNS):
            transfers["d2h"] = 0
            t0 = time.perf_counter()
            got = ct.sql(sql).compute()
            runs.append((time.perf_counter() - t0) * 1e3)
            check(got)
        launches[q] = segsum.LAUNCHES["segsum"]
        rungs = {k: v - before.get(k, 0) for k, v in rung_counts(ct).items()
                 if v != before.get(k, 0)}
        expected = {f"resilience.rung.{r}": n * (1 + WARM_RUNS)
                    for r, n in TPCH_RUNGS.get(q, {}).items()}
        if rungs != expected:
            fail(f"q{q} answered on rungs {rungs}, expected {expected}")
        if {k: v * (1 + WARM_RUNS) for k, v in cpu_rungs.items()} != expected:
            fail(f"q{q} on the CPU answered on rungs {cpu_rungs}")
        if q in TPCH_KERNEL and launches[q] < 1 + WARM_RUNS:
            fail(f"q{q} launched the segsum kernel {launches[q]} times in "
                 f"{1 + WARM_RUNS} runs")
        check_not_degraded(ct, f"q{q}")
        phase("tpch_more", card=card, query=f"q{q}", rows=len(got),
              cold_ms=cold_ms, ms=float(np.median(runs)), runs_ms=runs,
              cpu_ms=cpu_ms, rungs=rungs, cold_d2h=cold_d2h,
              d2h=transfers["d2h"], launches=launches[q],
              launches_per_query=launches[q] / (1 + WARM_RUNS),
              max_rel_err=rel[0], oracle=oracle is not None)
    # the kernel against its plain version on calls the queries make
    captured = {}
    typed = segsum.segsum_typed

    def capture(gid, columns, domain):
        captured.setdefault(q, []).append((gid, list(columns), domain))
        return typed(gid, columns, domain)

    segsum.segsum_typed = capture
    try:
        for q in TPCH_CALLS:
            ct.sql(QUERIES[q]).compute()
    finally:
        segsum.segsum_typed = typed
    err = 0.0
    for q, calls in captured.items():
        for i, (gid, cols, domain) in enumerate(calls):
            err = max(err, check_typed(segsum, gid, cols, domain,
                                       f"tpch_q{q}_call{i}"))
    like_ms, entries = like_table_ms(ct, "part", "p_name", "%green%")
    phase("like_table", card=card, column="part.p_name", pattern="%green%",
          entries=entries, ms=like_ms)
    check_not_degraded(ct, "tpch_more")
    return {"launches": launches, "max_abs_err": err}, ct, cpu


def counted(c):
    """The counters the port on the card and on the CPU must move alike:
    the rungs and the encoding counts."""
    return {k: v for k, v in c.metrics.snapshot()["counters"].items()
            if k.startswith(("resilience.", "columnar.encoding."))}


def moved(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def check_same_moves(card_moved, cpu_moved, runs, label) -> None:
    """`runs` runs on the card must move the counters as one run on the
    CPU does, `runs` times (and no rung may step down)."""
    want = {k: v * runs for k, v in cpu_moved.items()}
    if card_moved != want:
        fail(f"{label}: the card moved {card_moved}, the CPU {want}")
    if any(k.startswith("resilience.degraded") for k in card_moved):
        fail(f"{label}: a rung stepped down {card_moved}")


def capture_calls(segsum, run):
    """The segment-sum kernel's calls that `run()` makes."""
    captured = []
    typed = segsum.segsum_typed

    def capture(gid, columns, domain):
        captured.append((gid, list(columns), domain))
        return typed(gid, columns, domain)

    segsum.segsum_typed = capture
    try:
        run()
    finally:
        segsum.segsum_typed = typed
    return captured


def table_bytes(c, name) -> int:
    """Card bytes of a registered table's columns as stored."""
    table = c.schema["root"].tables[name].table
    return int(sum(col.device_nbytes() for col in table.columns.values()))


def surface_q1(c, df, card, segsum, transfers):
    """The `surface` phase on Q1's table (6,000,000 rows, encoded as the
    reference encodes them): the two INSERT INTOs of SURFACE_INSERTS append
    in place (the second adds a return flag, so the group domain grows past
    [4, 3]), then Q1 runs cold and warm.  Each statement on the card moves
    the rungs and encoding counts the port on the CPU moves for it; Q1 after
    the appends misses the plan cache, builds a new pipeline, launches the
    kernel once a run with one transfer, and equals its float64 oracle over
    the appended frame.  Returns the kernel's launches and largest error
    against its plain version on this part's calls."""
    import pandas as pd

    from dask_sql_tpu_torch.physical import compiled as compiled_agg

    t0 = time.perf_counter()
    cpu = cpu_context({"lineitem": df})
    cpu.sql(QUERY).compute()
    cpu_setup_s = time.perf_counter() - t0
    added = df[df.l_quantity.to_numpy() < np.float32(6)]
    new = pd.DataFrame({
        "l_returnflag": ["X"], "l_linestatus": ["F"],
        "l_quantity": np.float32([10.0]), "l_extendedprice": np.float32([1000.0]),
        "l_discount": np.float32([0.05]), "l_tax": np.float32([0.02]),
        "l_shipdate": np.array(["1998-01-01"], dtype=df.l_shipdate.dtype)})
    want = q1_oracle(pd.concat([df, added, new], ignore_index=True))
    torch.cuda.synchronize()
    before_hbm = torch.cuda.memory_allocated()
    before_table = table_bytes(c, "lineitem")
    dc = c.schema["root"].tables["lineitem"]
    uid = dc.uid
    statements = []
    for sql, n_rows in zip(SURFACE_INSERTS, (len(added), 1)):
        card_before, cpu_before = counted(c), counted(cpu)
        transfers["d2h"] = 0
        t0 = time.perf_counter()
        got = c.sql(sql).compute()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        d2h = transfers["d2h"]
        cpu_got = cpu.sql(sql).compute()
        if got["Inserted"].tolist() != [str(n_rows)] \
                or cpu_got["Inserted"].tolist() != [str(n_rows)]:
            fail(f"{sql[:40]!r} inserted {got['Inserted'].tolist()} on the "
                 f"card, {cpu_got['Inserted'].tolist()} on the CPU, expected "
                 f"{n_rows}")
        card_moved = moved(card_before, counted(c))
        check_same_moves(card_moved, moved(cpu_before, counted(cpu)), 1,
                         sql[:40])
        statements.append({"sql": sql[:60], "rows": n_rows, "ms": ms,
                           "d2h": d2h, "moved": card_moved})
    if dc.uid != uid or c.table_epoch("root", "lineitem") < 2:
        fail("INSERT INTO replaced the table instead of appending in place")
    torch.cuda.synchronize()
    after_hbm = torch.cuda.memory_allocated()
    after_table = table_bytes(c, "lineitem")

    misses = c.metrics.counter("query.plan_cache.miss")
    pipelines = {id(p_) for p_ in compiled_agg._cache.values()}
    card_before, cpu_before = counted(c), counted(cpu)
    reset_launches(segsum)
    transfers["d2h"] = 0
    t0 = time.perf_counter()
    got = c.sql(QUERY).compute()
    cold_ms = (time.perf_counter() - t0) * 1e3
    if transfers["d2h"] != 1 or segsum.LAUNCHES["segsum"] != 1:
        fail(f"Q1 after the appends: {transfers['d2h']} transfers, "
             f"{segsum.LAUNCHES['segsum']} kernel launches, expected 1 and 1")
    if c.metrics.counter("query.plan_cache.miss") != misses + 1:
        fail("Q1 after the appends reused a cached plan")
    if id(next(reversed(compiled_agg._cache.values()))) in pipelines:
        fail("Q1 after the appends reused a cached pipeline")
    rel = check_q1(got, want, "Q1 after the appends")
    if "X" not in got["l_returnflag"].tolist():
        fail("Q1 after the appends lost the new return flag")
    cpu_rel = check_q1(cpu.sql(QUERY).compute(), want,
                       "Q1 after the appends on the CPU")
    card_moved = moved(card_before, counted(c))
    check_same_moves(card_moved, moved(cpu_before, counted(cpu)), 1,
                     "Q1 after the appends")
    if card_moved.get("resilience.rung.compiled_aggregate") != 1:
        fail(f"Q1 after the appends answered on {card_moved}")
    runs = warm_runs(c, QUERY, transfers,
                     lambda g: check_q1(g, want, "Q1 after the appends, warm"))
    launches = segsum.LAUNCHES["segsum"]
    if launches != 1 + WARM_RUNS:
        fail(f"Q1 after the appends launched the kernel {launches} times "
             f"in {1 + WARM_RUNS} runs")
    calls = capture_calls(segsum, lambda: c.sql(QUERY).compute())
    if not calls:
        fail("Q1 after the appends made no segment-sum call")
    err = max((check_typed(segsum, g_, c_, d_, f"surface_q1_call{i}")
               for i, (g_, c_, d_) in enumerate(calls)), default=0.0)
    check_not_degraded(c, "surface_q1")
    phase("surface", part="q1_after_insert", card=card, rows=len(df),
          appended=len(added) + 1, statements=statements,
          cold_ms=cold_ms, ms=float(np.median(runs)), runs_ms=runs,
          d2h=1, launches=launches, groups=len(got), max_rel_err=rel,
          cpu_max_rel_err=cpu_rel, cpu_setup_s=cpu_setup_s,
          domain=calls[0][2] if calls else None, moved=card_moved,
          table_bytes_before=before_table, table_bytes_after=after_table,
          hbm_bytes_before=before_hbm, hbm_bytes_after=after_hbm,
          encodings_after={n: col.encoding.value for n, col in
                           dc.table.columns.items()},
          kernel_max_abs_err=err)
    return {"launches": launches, "max_abs_err": err}


#: the `resilience` phase: the breaker's cooldown (seconds), the card
#: memory above what is reserved that a forced OOM leaves, and the rows
#: and keys of the verifier's radix-overflow table (two string keys of
#: 2,500 values: 2,501 x 2,501 radix slots > 1 << 22)
BREAKER_COOLDOWN_S = 2.0
OOM_HEADROOM_BYTES = 8 << 20
WIDE_ROWS = 1_000_000
WIDE_KEYS = 2_500
WIDE_QUERY = "SELECT k1, k2, SUM(v) AS s FROM big GROUP BY k1, k2"


def fill_free_blocks(smallest: int = OOM_HEADROOM_BYTES):
    """Tensors that take the free blocks of at least `smallest` bytes the
    caching allocator can still serve under the memory fraction: then no
    buffer larger than the headroom fits."""
    filler, size = [], 1 << 30
    while size >= smallest:
        try:
            filler.append(torch.empty(size, dtype=torch.uint8, device="cuda"))
        except torch.cuda.OutOfMemoryError:
            size //= 2
    return filler


def ladder_moves(c, before) -> dict:
    """The ladder's counters `c` moved since `before`."""
    counters = c.metrics.snapshot()["counters"]
    return {k: v for k, v in moved(before, counters).items()
            if k.startswith(("resilience.", "analysis.rung_skip",
                             "analysis.findings."))}


def expect_moves(c, before, want, label) -> dict:
    got = ladder_moves(c, before)
    if got != want:
        fail(f"resilience {label}: the ladder moved {got}, expected {want}")
    return got


def resident_bytes(c) -> int:
    """Bytes of every registered table as the estimator counts them
    (encoded, with the host dictionaries)."""
    from dask_sql_tpu_torch.columnar.encodings import encoded_nbytes

    return sum(encoded_nbytes(col) for dc in c.schema["root"].tables.values()
               for col in dc.table.columns.values())


def explain_and_bounds(c, sql, label, card, tight: bool) -> dict:
    """EXPLAIN LINT and EXPLAIN ESTIMATE of `sql` on the card with their
    ms, then the query run: its resident input bytes plus result bytes
    must lie in the estimate's ``peak_bytes`` [lo, hi], and the resident
    bytes plus the card's measured peak rise during the run must lie in
    [lo, hi] too: ``hi`` bounds the port's fused programs
    (`analysis/fused.py`).  With `tight`, ``hi`` must also be at most
    twice that measured sum, so that the check cannot hold by
    construction."""
    from dask_sql_tpu_torch.columnar.encodings import encoded_nbytes

    out = {}
    for kind in ("LINT", "ESTIMATE"):
        t0 = time.perf_counter()
        rows = list(c.sql(f"EXPLAIN {kind} {sql}").compute()[kind])
        out[kind.lower() + "_ms"] = (time.perf_counter() - t0) * 1e3
        out[kind.lower()] = rows
    est = c.sql(sql)._plan._dsql_estimate
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    frame = c.sql(sql)
    result = frame.execute()
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    measured = resident_bytes(c) + sum(
        encoded_nbytes(col) for col in result.columns.values())
    lo, hi = est.peak_bytes.lo, est.peak_bytes.hi
    if hi is None or not lo <= measured <= hi:
        fail(f"explain {label}: resident + result {measured} "
             f"bytes outside the estimate [{lo}, {hi}]")
    peak = resident_bytes(c) + rise
    if not lo <= peak <= hi:
        fail(f"explain {label}: resident + the card's peak rise {peak} "
             f"bytes outside the estimate [{lo}, {hi}]")
    if tight and hi > 2 * peak:
        fail(f"explain {label}: the estimate's hi {hi} is more than twice "
             f"the resident bytes plus the card's peak rise {peak}")
    phase("resilience", part="explain", card=card, query=label,
          lint_ms=out["lint_ms"], estimate_ms=out["estimate_ms"],
          lint=out["lint"], estimate=out["estimate"][:2],
          peak_bytes=[lo, hi], resident_plus_result=measured,
          card_peak_rise=rise, card_allocated_before=before,
          resident_plus_peak_rise=peak, hi_over_peak=hi / peak,
          tight=tight)
    return out


#: card bytes a phase may leave allocated once its Contexts are deleted
FREED_SLACK = 64 << 20


def card_holders(limit: int = 8, budget: int = 500_000) -> list:
    """The largest CUDA tensors alive, each with the path by which it is
    reached from a local of a running frame of this thread or a global of
    the port's modules and this script: what holds card memory.  A
    breadth-first walk down `gc.get_referents` from those roots."""
    import types
    from collections import deque

    import warnings

    with warnings.catch_warnings():  # isinstance on deprecated aliases
        warnings.simplefilter("ignore")
        tensors = [o for o in gc.get_objects()
                   if isinstance(o, torch.Tensor) and o.is_cuda]
    tensors.sort(key=lambda t: t.untyped_storage().nbytes(), reverse=True)
    del tensors[limit:]
    targets = {id(t): i for i, t in enumerate(tensors)}
    found = {}
    parent = {}
    queue = deque()
    skip = {id(tensors), id(targets), id(found), id(parent), id(queue)}
    frame = sys._getframe(1)
    while frame is not None:
        for name, value in frame.f_locals.items():
            queue.append((value, f"{frame.f_code.co_name}:{name}"))
        frame = frame.f_back
    for mod_name, mod in list(sys.modules.items()):
        if mod_name.startswith("dask_sql_tpu_torch") or mod_name in (
                "__main__", "chip_smoke"):
            for name, value in vars(mod).items():
                if not isinstance(value, (types.ModuleType, type,
                                          types.FunctionType)):
                    queue.append((value, f"{mod_name}.{name}"))
    for value, label in list(queue):
        parent.setdefault(id(value), (None, label))
    while queue and len(parent) < budget and len(found) < len(tensors):
        obj, _ = queue.popleft()
        if id(obj) in targets and id(obj) not in found:
            found[id(obj)] = True
        if isinstance(obj, (torch.Tensor, np.ndarray, str, bytes)):
            continue
        for ref in gc.get_referents(obj):
            if id(ref) in parent or id(ref) in skip:
                continue
            parent[id(ref)] = (id(obj), type(obj).__name__)
            queue.append((ref, None))
    out = []
    for t in tensors:
        path, key = [], id(t)
        while key in parent and len(path) < 40:
            up, label = parent[key]
            path.append(label)
            if up is None:
                break
            key = up
        out.append({"bytes": t.untyped_storage().nbytes(),
                    "shape": list(t.shape), "dtype": str(t.dtype),
                    "held_by": list(reversed(path)) if id(t) in found
                    else None})
    del tensors, queue, parent
    return out


def card_allocated() -> int:
    """The card's allocated bytes once the collector has run, less the
    cuBLAS workspaces (one a thread that ran a matmul, kept by PyTorch's
    allocator for the process: the library's, not a Context's)."""
    gc.collect()
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return torch.cuda.memory_allocated()


def check_card_freed(before: int, label: str) -> None:
    """Once a phase's Contexts are deleted, the card's allocated bytes are
    back within FREED_SLACK of `before`; prints the remainder and, above a
    MiB, the tensors that hold it."""
    now = card_allocated()
    rest = now - before
    holders = card_holders() if rest > (1 << 20) else []
    phase("card_memory", after=label, before=before, allocated=now,
          remainder=rest, holders=holders)
    if rest > FREED_SLACK:
        fail(f"{label}: {rest} card bytes outlive the phase's Contexts "
             f"(held by {holders[:3]})")


def resilience(df, want, card, segsum, transfers):
    """The `resilience` phase on Q1's 6,000,000 encoded rows: injected
    compile failures (the eager aggregate answers on the card, its kernel
    calls held against the plain version), the breaker tripping, skipping
    the family and closing after its cooldown, ``oom:once``, a real
    ``torch.cuda.OutOfMemoryError`` under a memory fraction and
    ``exec_oom:once`` (each leaves as a degradable ResourceExhaustedError:
    the CPU rung serves CPU Contexts only), a verifier skip on a
    1,000,000-row radix-overflow table, and EXPLAIN LINT / ESTIMATE with the estimate's
    bounds.  Returns the kernel's launches on each path and the largest
    error of its checked calls."""
    import pandas as pd

    from dask_sql_tpu_torch.resilience import faults
    from dask_sql_tpu_torch.resilience.retry import CircuitBreaker

    gc.collect()
    allocated_at_start = torch.cuda.memory_allocated()
    c, table_card_bytes, _ = load_tables({"lineitem": df})
    launches = {}
    # the compiled Q1, for the times beside the interpreted one
    check_q1(c.sql(QUERY).compute(), want, "resilience Q1")
    compiled_runs = warm_runs(c, QUERY, transfers,
                              lambda g: check_q1(g, want, "Q1"))

    # (a) every compiled rung fails to "compile": the eager aggregate
    # answers, one step down a rung
    faults.reset()
    always = {"resilience.inject": "compile:always"}
    before = c.metrics.snapshot()["counters"]
    reset_launches(segsum)
    calls = capture_calls(segsum, lambda: check_q1(
        c.sql(QUERY, config_options=always).compute(), want,
        "Q1 under compile:always"))
    launches["resilience_compile_always"] = segsum.LAUNCHES["segsum"]
    expect_moves(c, before, {
        "resilience.degraded": 3, "resilience.degraded.compiled_select": 1,
        "resilience.degraded.compiled_join_aggregate": 1,
        "resilience.degraded.compiled_aggregate": 1}, "compile:always")
    if not calls or launches["resilience_compile_always"] < 1:
        fail("the eager Q1 did not reach the kernel")
    err = check_calls(segsum, calls, "resilience_compile_always")
    del calls
    # timed with the breaker off, so that every run steps down alike
    interp_runs = []
    for _ in range(WARM_RUNS):
        t0 = time.perf_counter()
        check_q1(c.sql(QUERY, config_options={
            **always, "resilience.breaker.enabled": False}).compute(),
            want, "Q1 under compile:always")
        interp_runs.append((time.perf_counter() - t0) * 1e3)
    phase("resilience", part="compile_always", card=card, rows=len(df),
          table_card_bytes=table_card_bytes,
          card_allocated_at_start=allocated_at_start,
          card_allocated=torch.cuda.memory_allocated(),
          launches=launches["resilience_compile_always"],
          interpreted_ms=float(np.median(interp_runs)),
          interpreted_runs_ms=interp_runs,
          compiled_ms=float(np.median(compiled_runs)),
          compiled_runs_ms=compiled_runs, kernel_max_abs_err=err)

    # (b) the breaker: three failures trip each compiled rung of the
    # family, the fourth run and another date literal skip them, and after
    # the cooldown a clean half-open trial closes it
    c.config.update({"resilience.breaker.threshold": 3,
                     "resilience.breaker.cooldown_s": BREAKER_COOLDOWN_S})
    c.breaker = CircuitBreaker.from_config(c.config)
    faults.reset()
    before = c.metrics.snapshot()["counters"]
    reset_launches(segsum)
    for i in range(3):
        check_q1(c.sql(QUERY, config_options=always).compute(), want,
                 f"breaker run {i + 1}")
        trips = c.metrics.counter("resilience.breaker.trip") - before.get(
            "resilience.breaker.trip", 0)
        if trips != (3 if i == 2 else 0):
            fail(f"breaker run {i + 1}: {trips} trips")
    step = c.metrics.snapshot()["counters"]
    check_q1(c.sql(QUERY, config_options=always).compute(), want,
             "breaker run 4")
    date = FAMILY_DATES[0]
    check_q1(c.sql(QUERY.replace("DATE '1998-09-02'", f"DATE '{date}'"),
                   config_options=always).compute(),
             q1_oracle(df, date), f"breaker run 5 ({date})")
    expect_moves(c, step, {
        "resilience.breaker.skip": 6,
        "resilience.breaker.skip.compiled_select": 2,
        "resilience.breaker.skip.compiled_join_aggregate": 2,
        "resilience.breaker.skip.compiled_aggregate": 2}, "breaker open")
    time.sleep(BREAKER_COOLDOWN_S + 0.1)
    step = c.metrics.snapshot()["counters"]
    check_q1(c.sql(QUERY).compute(), want, "breaker half-open trial")
    # the half-open trials: the select and join rungs decline Q1 and settle
    # nothing, the fused aggregate answers and closes its breaker
    expect_moves(c, step, {"resilience.rung.compiled_aggregate": 1},
                 "half-open trial")
    fp = next(k[0] for k in c.breaker._state)
    if c.breaker.is_open((fp, "compiled_aggregate")):
        fail("the half-open trial did not close the breaker")
    step = c.metrics.snapshot()["counters"]
    check_q1(c.sql(QUERY).compute(), want, "after the breaker closed")
    expect_moves(c, step, {"resilience.rung.compiled_aggregate": 1,
                           "resilience.breaker.skip": 2,
                           "resilience.breaker.skip.compiled_select": 1,
                           "resilience.breaker.skip.compiled_join_aggregate":
                               1}, "closed")
    launches["resilience_breaker"] = segsum.LAUNCHES["segsum"]
    phase("resilience", part="breaker", card=card,
          card_allocated=torch.cuda.memory_allocated(),
          moved=ladder_moves(c, before), cooldown_s=BREAKER_COOLDOWN_S,
          launches=launches["resilience_breaker"])

    # (c) oom:once inside the fused aggregate
    c.breaker = CircuitBreaker.from_config(c.config)
    faults.reset()
    before = c.metrics.snapshot()["counters"]
    reset_launches(segsum)
    check_q1(c.sql(QUERY, config_options={"resilience.inject": "oom:once"}
                   ).compute(), want, "Q1 under oom:once")
    launches["resilience_oom_once"] = segsum.LAUNCHES["segsum"]
    # the reclaim before the step down finds no cached bytes (the result
    # cache is off): one attempt, nothing freed
    expect_moves(c, before, {"resilience.degraded": 1,
                             "resilience.degraded.compiled_aggregate": 1,
                             "resilience.pressure.reclaims": 1},
                 "oom:once")
    phase("resilience", part="oom_once", card=card,
          card_allocated=torch.cuda.memory_allocated(),
          launches=launches["resilience_oom_once"])

    # (d) a real OOM: the card limited to what is reserved and a few MB,
    # and the free blocks the caching allocator keeps inside what is
    # reserved taken by a filler, so that the fused program's first large
    # buffer cannot be served.  The fused aggregate steps down, the eager
    # walk fails the same way, and with no rung below it on the card the
    # query leaves as a degradable ResourceExhaustedError
    from dask_sql_tpu_torch.resilience.errors import ResourceExhaustedError

    c.breaker = CircuitBreaker.from_config(c.config)
    before = c.metrics.snapshot()["counters"]
    reset_launches(segsum)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    total = torch.cuda.get_device_properties(0).total_memory
    fraction = (reserved + OOM_HEADROOM_BYTES) / total
    torch.cuda.set_per_process_memory_fraction(fraction)
    raised = None
    t0 = time.perf_counter()
    try:
        filler = fill_free_blocks()
        t0 = time.perf_counter()
        c.sql(QUERY).compute()
    except ResourceExhaustedError as exc:
        raised = (type(exc).__name__, exc.degradable,
                  type(exc.__cause__).__name__,
                  isinstance(exc.__cause__, torch.cuda.OutOfMemoryError))
        del exc
    finally:
        fail_ms = (time.perf_counter() - t0) * 1e3
        filler = None
        torch.cuda.set_per_process_memory_fraction(1.0)
    gc.collect()
    launches["resilience_real_oom"] = segsum.LAUNCHES["segsum"]
    oom_moves = expect_moves(c, before, {
        "resilience.degraded": 1,
        "resilience.degraded.compiled_aggregate": 1,
        # a reclaim attempt at the fused rung and at the eager walk
        "resilience.pressure.reclaims": 2}, "a real OOM")
    if raised is None or not (raised[1] and raised[3]):
        fail(f"the memory fraction gave {raised}, not a degradable "
             f"ResourceExhaustedError from torch.cuda.OutOfMemoryError")
    step = c.metrics.snapshot()["counters"]
    check_q1(c.sql(QUERY).compute(), want, "Q1 after the OOM")
    expect_moves(c, step, {"resilience.rung.compiled_aggregate": 1},
                 "after the OOM")
    phase("resilience", part="real_oom", card=card, reserved_bytes=reserved,
          card_allocated=torch.cuda.memory_allocated(),
          fraction=fraction, moved=oom_moves, raised=raised,
          failed_after_ms=fail_ms, launches=launches["resilience_real_oom"])

    # (e) exec_oom:once with the compiled rungs off: the eager walk fails
    # and, on the card, the failure leaves the query as it is
    faults.reset()
    before = c.metrics.snapshot()["counters"]
    reset_launches(segsum)
    raised = None
    try:
        c.sql(QUERY, config_options={"resilience.inject": "exec_oom:once",
                                     "sql.compile": False}).compute()
    except ResourceExhaustedError as exc:
        raised = (type(exc).__name__, exc.degradable)
    launches["resilience_exec_oom"] = segsum.LAUNCHES["segsum"]
    expect_moves(c, before, {"resilience.pressure.reclaims": 1},
                 "exec_oom:once")
    if raised is None or not raised[1]:
        fail(f"exec_oom:once on the card gave {raised}, not a degradable "
             f"ResourceExhaustedError")
    phase("resilience", part="exec_oom", card=card, raised=raised,
          card_allocated=torch.cuda.memory_allocated(),
          launches=launches["resilience_exec_oom"])

    # (g) EXPLAIN LINT / ESTIMATE of Q1 and the root select, their bounds,
    # and Q1's cold planning with the verifier and the estimator on and off
    explain_and_bounds(c, QUERY, "q1", card, tight=True)
    # the select's survivor bucket depends on its filter's selectivity,
    # which the estimate cannot see: hi bounds the case where every row
    # survives, and is held tight against that case, a member of the same
    # plan family (the same estimate)
    explain_and_bounds(c, SELECT_QUERY, "select", card, tight=False)
    explain_and_bounds(c, SELECT_ALL_QUERY, "select_all_rows", card,
                       tight=True)
    cold = {}
    for label, options in (("on", None), ("off", {"analysis.verify": "off",
                                                  "analysis.estimate": "off"})):
        runs_ = []
        for _ in range(WARM_RUNS):
            c._plan_cache.clear()
            c._family_estimates.clear()
            t0 = time.perf_counter()
            c.sql(QUERY, config_options=options)
            runs_.append((time.perf_counter() - t0) * 1e3)
        cold[label] = runs_
    phase("resilience", part="plan_stages", card=card, query="q1",
          cold_ms_on=float(np.median(cold["on"])),
          cold_ms_off=float(np.median(cold["off"])),
          cold_runs_ms_on=cold["on"], cold_runs_ms_off=cold["off"])
    del c

    # (f) the verifier's radix-overflow skip: the compiled rungs are not
    # attempted, the sorted scatter answers; under analysis.verify = off
    # the fused aggregate is attempted and declines at run time
    i = np.arange(WIDE_ROWS)
    wide = pd.DataFrame({
        "k1": np.char.add("a", (i % WIDE_KEYS).astype(str)).astype(object),
        "k2": np.char.add("b", (i % WIDE_KEYS).astype(str)).astype(object),
        "v": np.random.default_rng(5).random(WIDE_ROWS)})
    wide_want = wide.groupby(["k1", "k2"], as_index=False)["v"].sum() \
        .rename(columns={"v": "s"}).sort_values(["k1", "k2"]) \
        .reset_index(drop=True)
    cw = measuring_context()
    cw.create_table("big", wide)
    del wide

    def check_wide(got):
        got = got.sort_values(["k1", "k2"]).reset_index(drop=True)
        if got[["k1", "k2"]].values.tolist() != \
                wide_want[["k1", "k2"]].values.tolist():
            fail("the radix-overflow groups differ from the oracle")
        rel = max_rel(got["s"], wide_want["s"])
        if not rel <= TPCH_REL:
            fail(f"the radix-overflow sums: relative error {rel}")
        return rel

    wide_runs = {}
    for label, options in (("on", None), ("off", {"analysis.verify": "off"})):
        before = cw.metrics.snapshot()["counters"]
        reset_launches(segsum)
        rel = check_wide(cw.sql(WIDE_QUERY, config_options=options).compute())
        if label == "on":
            launches["resilience_verifier_skip"] = segsum.LAUNCHES["segsum"]
            expect_moves(cw, before, {
                "analysis.rung_skip": 2,
                "analysis.rung_skip.compiled_aggregate": 1,
                "analysis.rung_skip.compiled_join_aggregate": 1,
                "analysis.findings.radix-overflow": 1}, "verifier skip")
        elif cw.metrics.counter("compiled_aggregate.declined") != \
                before.get("compiled_aggregate.declined", 0) + 1:
            fail("with analysis.verify off the fused aggregate did not "
                 "decline the radix overflow")
        runs_ = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            rel = max(rel, check_wide(cw.sql(
                WIDE_QUERY, config_options=options).compute()))
            runs_.append((time.perf_counter() - t0) * 1e3)
        wide_runs[label] = (float(np.median(runs_)), runs_, rel)
    check_not_degraded(cw, "verifier skip")
    phase("resilience", part="verifier_skip", card=card, rows=WIDE_ROWS,
          groups=len(wide_want), launches=launches["resilience_verifier_skip"],
          ms=wide_runs["on"][0], runs_ms=wide_runs["on"][1],
          verify_off_ms=wide_runs["off"][0],
          verify_off_runs_ms=wide_runs["off"][1],
          max_rel_err=max(wide_runs["on"][2], wide_runs["off"][2]))
    del cw
    return {"launches": launches, "max_abs_err": err}


#: the `streamed` phase's root select: bench.py's select without its ORDER
#: BY and LIMIT, which `stream_decision` declines as the reference does
STREAM_SELECT_QUERY = ("SELECT l_returnflag, l_extendedprice * (1 - l_discount)"
                       " AS rev FROM lineitem WHERE l_discount > 0.09")
#: the `streamed` phase's budget: this share of Q1's provable floor
STREAM_BUDGET_SHARE = 4
#: the `pressure` phase: rows of its second Q1 table (the real OOM) and
#: the card-resident results that fill the result cache before it
PRESSURE_Q1_ROWS = 1_000_000
PRESSURE_CACHE_QUERIES = tuple(
    f"SELECT l_extendedprice, l_discount, l_tax FROM lineitem "
    f"WHERE l_quantity < {q}" for q in (11, 21, 31))
#: the `coldstart` phase's background recompile: Q1 over this many rows,
#: then over twice as many under the same name
BG_ROWS = 1_000_000
#: the `coldstart` phase's hung-build query: a family no warm-up built
HANG_QUERY = ("SELECT l_returnflag, SUM(l_quantity) AS q, COUNT(*) AS n "
              "FROM lineitem GROUP BY l_returnflag ORDER BY l_returnflag")
#: the second process of the `coldstart` phase: a Context whose compile
#: cache names the directory given as argv[1] runs a small aggregate, and
#: prints what its metrics and the cache counted
COMPILE_CACHE_CHILD = r"""
import json, sys
import numpy as np, pandas as pd, torch
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.ops import segsum
from dask_sql_tpu_torch.serving import compile_cache
c = Context()
c.config.update({"serving.compile_cache.path": sys.argv[1],
                 "serving.cache.enabled": False})
c.create_table("t", pd.DataFrame({"g": np.arange(100_000) % 7,
                                  "x": np.arange(100_000, dtype=np.float64)}))
out = c.sql("SELECT g, SUM(x) AS s FROM t GROUP BY g ORDER BY g").compute()
want = [float(sum(range(g, 100_000, 7))) for g in range(7)]
print(json.dumps({"hit": c.metrics.counter("resilience.compile_cache.hit"),
                  "miss": c.metrics.counter("resilience.compile_cache.miss"),
                  "stats": compile_cache.stats(), "launches": segsum.LAUNCHES,
                  "right": out["s"].tolist() == want}))
"""


def counters(c) -> dict:
    return dict(c.metrics.snapshot()["counters"])


def streamed(df, want, card, segsum):
    """The `streamed` phase on Q1's 6,000,000 encoded rows: Q1 under an
    admission budget of a quarter of its provable floor runs in
    partitions on `streaming/aggregate.py` (one segment-sum launch each,
    the kernel held against its plain version on those calls, the answer
    against the float64 oracle, the same bits in every run), with
    ``partition:at2`` (one repartition, every row once), a watched launch
    under ``serving.stream.launch_timeout_ms``, and the root select
    without its ORDER BY and LIMIT streamed in the in-memory run's row
    order."""
    from dask_sql_tpu_torch.resilience import faults, watchdog

    from dask_sql_tpu_torch.streaming import stream_decision

    c, _, _ = load_tables({"lineitem": df})
    plan = c.sql(QUERY).plan
    est = plan._dsql_estimate
    budget = est.peak_bytes.lo // STREAM_BUDGET_SHARE
    opts = {"serving.admission.max_estimated_bytes": budget}
    decision = stream_decision(plan, est, c, c.config, budget)[1]
    mem_runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        check_q1(c.sql(QUERY).compute(), want, "in-memory Q1")
        mem_runs.append((time.perf_counter() - t0) * 1e3)
    # the estimate after profile feedback still bounds the card: resident
    # bytes plus the peak rise of one more in-memory run inside [lo, hi]
    frame = c.sql(QUERY)
    fed = c._plan_estimate(frame.plan)
    gc.collect()
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    frame.execute()
    torch.cuda.synchronize()
    peak = resident_bytes(c) + torch.cuda.max_memory_allocated() - alloc
    del frame
    if not fed.feedback or not fed.peak_bytes.lo <= peak <= fed.peak_bytes.hi:
        fail(f"Q1's estimate after feedback [{fed.peak_bytes.lo}, "
             f"{fed.peak_bytes.hi}] (feedback {fed.feedback}) against "
             f"resident plus peak rise {peak}")
    phase("streamed", part="feedback_bound", card=card,
          static_hi=est.peak_bytes.hi, feedback_hi=fed.peak_bytes.hi,
          lo=fed.peak_bytes.lo, resident_plus_peak_rise=peak,
          feedback_hi_over_peak=fed.peak_bytes.hi / peak,
          cost_rung_skips=c.metrics.counter(
              "serving.scheduler.cost_rung_skip"))
    before = counters(c)
    reset_launches(segsum)
    t0 = time.perf_counter()
    got = c.sql(QUERY, config_options=opts).compute()
    cold_ms = (time.perf_counter() - t0) * 1e3
    launches = segsum.LAUNCHES["segsum"]
    moves = moved(before, counters(c))
    parts = moves.get("serving.stream.partitions", 0)
    if moves.get("resilience.rung.streamed_aggregate") != 1 \
            or moves.get("serving.stream.rows") != N_ROWS \
            or not 4 <= parts <= 8 or launches != parts \
            or moves.get("serving.shed_estimated_bytes"):
        fail(f"streamed Q1 moved {moves} with {launches} kernel launches")
    rel = check_q1(got, want, "streamed Q1")
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = c.sql(QUERY, config_options=opts).compute()
        runs.append((time.perf_counter() - t0) * 1e3)
        if not again.equals(got):
            fail("two streamed Q1 runs gave different bits")
    calls = capture_calls(segsum, lambda: c.sql(
        QUERY, config_options=opts).compute())
    if len(calls) != parts:
        fail(f"streamed Q1 made {len(calls)} segment-sum calls in {parts} "
             f"partitions")
    err = check_calls(segsum, calls, "streamed_q1")
    if parts != decision.partitions:
        fail(f"streamed Q1 ran {parts} partitions, decided {decision}")
    phase("streamed", part="q1", card=card, rows=N_ROWS,
          peak_bytes_lo=est.peak_bytes.lo, budget=budget, partitions=parts,
          chunk_rows=decision.chunk_rows,
          chunk_bytes_lo=decision.chunk_bytes_lo, launches=launches,
          max_rel_err=rel, cold_ms=cold_ms, ms=float(np.median(runs)),
          runs_ms=runs, in_memory_ms=float(np.median(mem_runs)),
          same_bits_runs=len(runs) + 1, kernel_max_abs_err=err)

    # an injected OOM in the second partition: one repartition, resumed
    faults.reset()
    before = counters(c)
    reset_launches(segsum)
    got = c.sql(QUERY, config_options={
        **opts, "resilience.inject": "partition:at2"}).compute()
    at2_launches = segsum.LAUNCHES["segsum"]
    faults.reset()
    moves = moved(before, counters(c))
    if moves.get("serving.stream.repartitions") != 1 \
            or moves.get("resilience.partition.oom") != 1 \
            or moves.get("serving.stream.rows") != N_ROWS \
            or moves.get("resilience.degraded"):
        fail(f"streamed Q1 under partition:at2 moved {moves}")
    at2_rel = check_q1(got, want, "streamed Q1 after a repartition")
    phase("streamed", part="partition_at2", card=card,
          partitions=moves["serving.stream.partitions"],
          launches=at2_launches, rows=moves["serving.stream.rows"],
          max_rel_err=at2_rel)

    # a watched launch: each partition waits for its own CUDA event
    before = counters(c)
    t0 = time.perf_counter()
    got = c.sql(QUERY, config_options={
        **opts, "serving.stream.launch_timeout_ms": 60_000.0}).compute()
    watched_ms = (time.perf_counter() - t0) * 1e3
    moves = moved(before, counters(c))
    if moves.get("resilience.rung.streamed_aggregate") != 1 \
            or moves.get("resilience.watchdog.timeout"):
        fail(f"the watched streamed Q1 moved {moves}")
    check_q1(got, want, "watched streamed Q1")
    if watchdog.join_abandoned(5.0):
        fail("a watched launch's helper thread outlived it")

    # the root select, streamed, in the in-memory run's row order
    sel_est = c.sql(STREAM_SELECT_QUERY).plan._dsql_estimate
    sel_budget = sel_est.peak_bytes.lo // STREAM_BUDGET_SHARE
    t0 = time.perf_counter()
    whole = c.sql(STREAM_SELECT_QUERY).compute()
    whole_ms = (time.perf_counter() - t0) * 1e3
    before = counters(c)
    t0 = time.perf_counter()
    got = c.sql(STREAM_SELECT_QUERY, config_options={
        "serving.admission.max_estimated_bytes": sel_budget}).compute()
    sel_ms = (time.perf_counter() - t0) * 1e3
    moves = moved(before, counters(c))
    survivors = int((df.l_discount.to_numpy() > np.float32(0.09)).sum())
    if moves.get("resilience.rung.streamed_select") != 1 \
            or len(got) != survivors or not got.equals(whole):
        fail(f"the streamed select moved {moves}, gave {len(got)} rows of "
             f"{survivors}, same as the single run: {got.equals(whole)}")
    phase("streamed", part="select", card=card, survivors=survivors,
          partitions=moves["serving.stream.partitions"], budget=sel_budget,
          ms=sel_ms, in_memory_ms=whole_ms, watched_q1_ms=watched_ms,
          cost_rung_skips=c.metrics.counter(
              "serving.scheduler.cost_rung_skip"))
    check_not_degraded(c, "streamed")
    del c
    return {"launches": {"streamed_q1": launches,
                         "streamed_q1_partition_at2": at2_launches},
            "max_abs_err": err}


def pressure(df, want, tpch, card, segsum):
    """The `pressure` phase on Q1's rows: the bands at a set device budget;
    a RED reclaim that frees the card-resident cached results (by
    ``torch.cuda.memory_allocated``); a real ``torch.cuda.OutOfMemoryError``
    in Q1's fused aggregate over 1,000,000 rows, made with a memory
    fraction and `fill_free_blocks`, that a reclaim rescues on the same
    rung; and the CRITICAL band: Q1 streamed, TPC-H q22 (two scans, no
    streamed rung) shed with a `PressureShedError`."""
    from dask_sql_tpu_torch.resilience.pressure import PressureShedError
    from tests.tpch import QUERIES

    c, _, _ = load_tables({"lineitem": df,
                           "lineitem_1m": df.head(PRESSURE_Q1_ROWS),
                           "customer": tpch["customer"],
                           "orders": tpch["orders"]})
    c.config.update({"serving.cache.enabled": True})

    def fill_cache():
        for sql in PRESSURE_CACHE_QUERIES:  # the eager walk keeps them
            c.sql(sql, config_options={"sql.compile": False}).compute()
        return c.ledger.snapshot()["resultCacheBytes"]

    cache_bytes = fill_cache()
    snap = c.ledger.snapshot()
    used = (snap["reservedBytes"] + snap["resultCacheBytes"]
            + snap["tableBytes"])
    bands = {}
    for label, budget in (("yellow", int(used / 0.85)),
                          ("green", used * 10), ("critical", used // 2)):
        with c.config.set({"serving.scheduler.device_budget_bytes": budget}):
            bands[label] = c.pressure.band()
    if bands != {"yellow": "yellow", "green": "green",
                 "critical": "critical"}:
        fail(f"pressure bands {bands}")

    # RED: evaluate() reclaims back to the YELLOW floor
    alloc0 = card_allocated()
    with c.config.set({"serving.scheduler.device_budget_bytes":
                       int(used / 0.92)}):
        band = c.pressure.evaluate()
    alloc1 = card_allocated()
    freed = c.metrics.counter("resilience.pressure.reclaimed_bytes")
    if band not in ("green", "yellow") or freed <= 0 \
            or alloc0 - alloc1 < freed:
        fail(f"RED reclaim: band {band}, {freed} bytes reclaimed, "
             f"memory_allocated fell by {alloc0 - alloc1}")
    phase("pressure", part="bands_and_red", card=card, used_bytes=used,
          bands=bands, cache_bytes=cache_bytes, reclaimed_bytes=freed,
          allocated_before=alloc0, allocated_after=alloc1,
          band_after=band)

    # a real OOM in Q1's fused aggregate, rescued on the same rung
    from dask_sql_tpu_torch.resilience.retry import CircuitBreaker

    sql_1m = QUERY.replace("FROM lineitem", "FROM lineitem_1m")
    want_1m = q1_oracle(df.head(PRESSURE_Q1_ROWS))
    c.breaker = CircuitBreaker.from_config(c.config)
    check_q1(c.sql(sql_1m).compute(), want_1m, "Q1 on 1M rows")
    refill = fill_cache()
    before = counters(c)
    reset_launches(segsum)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    total = torch.cuda.get_device_properties(0).total_memory
    fraction = (reserved + OOM_HEADROOM_BYTES) / total
    torch.cuda.set_per_process_memory_fraction(fraction)
    filler = None
    try:
        filler = fill_free_blocks()
        t0 = time.perf_counter()
        got = c.sql(sql_1m, config_options={
            "serving.cache.enabled": False}).compute()
        rescue_ms = (time.perf_counter() - t0) * 1e3
    finally:
        filler = None
        torch.cuda.set_per_process_memory_fraction(1.0)
    oom_launches = segsum.LAUNCHES["segsum"]
    moves = moved(before, counters(c))
    if moves.get("resilience.pressure.rung_retry_ok") != 1 \
            or moves.get("resilience.degraded") \
            or moves.get("resilience.rung.compiled_aggregate") != 1:
        fail(f"the real OOM moved {moves}")
    rel = check_q1(got, want_1m, "Q1 after the reclaim")
    phase("pressure", part="real_oom_rescued", card=card,
          rows=PRESSURE_Q1_ROWS, reserved_bytes=reserved, fraction=fraction,
          cache_bytes=refill, moved={k: v for k, v in moves.items()
                                     if k.startswith("resilience.")},
          launches=oom_launches, ms=rescue_ms, max_rel_err=rel)

    # CRITICAL: Q1 streamed under the device budget, q22 shed
    critical = {"serving.scheduler.device_budget_bytes":
                table_bytes(c, "lineitem") // 3}
    before = counters(c)
    reset_launches(segsum)
    got = c.sql(QUERY, config_options={
        **critical, "serving.cache.enabled": False}).compute()
    crit_launches = segsum.LAUNCHES["segsum"]
    check_q1(got, want, "Q1 under CRITICAL")
    shed = None
    try:
        c.sql(QUERIES[22], config_options=critical).compute()
    except PressureShedError as exc:
        shed = (exc.code, exc.retryable, exc.retry_after_s)
    moves = moved(before, counters(c))
    if moves.get("resilience.pressure.critical_streamed") != 1 \
            or moves.get("resilience.rung.streamed_aggregate") != 1 \
            or moves.get("resilience.pressure.critical_shed") != 1 \
            or shed is None or shed[0] != "PRESSURE_SHED":
        fail(f"CRITICAL moved {moves}, shed {shed}")
    phase("pressure", part="critical", card=card,
          budget=critical["serving.scheduler.device_budget_bytes"],
          partitions=moves["serving.stream.partitions"],
          launches=crit_launches, q22_shed=shed)
    check_not_degraded(c, "pressure")
    del c
    return {"launches": {"pressure_real_oom_q1_1m": oom_launches,
                         "pressure_critical_q1": crit_launches}}


def coldstart(df, want, tpch, card, segsum):
    """The `coldstart` phase: save and load of Q1's 6,000,000 rows and
    the TPC-H tables at 1,000,000 rows (the card's bytes after the load
    equal to before the save), the warm-up after `load_state` (the first
    Q1 after ``ready`` builds no pipeline), ``compile_hang:once`` under
    ``resilience.compile_timeout_ms`` (the rung degrades, the answer is
    right, no helper thread outlives the phase), a background recompile of
    a grown table, and a compile-cache hit for the segment-sum library in
    a second Python process."""
    import shutil
    import tempfile

    from dask_sql_tpu_torch import _build
    from dask_sql_tpu_torch.resilience import faults, watchdog
    from dask_sql_tpu_torch.serving import compile_cache
    from tests.tpch import QUERIES

    # the compile cache: this process builds the segment-sum library into
    # it (nvcc) and keeps there the native planner it built at its start;
    # a second process, run beside the rest of the phase, finds both
    work = tempfile.mkdtemp(prefix="dsql_coldstart_")
    cache = os.path.join(work, "compile-cache")
    native = _build.native_library_path()
    compile_cache.enable(cache)
    try:
        t0 = time.perf_counter()
        built = _build.build(["segsum"])
        build_s = time.perf_counter() - t0
        shutil.copy2(native, _build.native_library_path())
    finally:
        compile_cache.disable()
    t_child = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-c", COMPILE_CACHE_CHILD, cache],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        frames = {"lineitem": df,
                  **{f"tpch_{n}": t for n, t in tpch.items()}}
        c, _, _ = load_tables(frames)
        check_q1(c.sql(QUERY).compute(), want, "Q1 before the save")
        c.sql(QUERIES[6].replace("lineitem", "tpch_lineitem")).compute()
        before_bytes = {n: table_bytes(c, n) for n in frames}
        loc = os.path.join(work, "snap")
        t0 = time.perf_counter()
        c.save_state(loc)
        save_s = time.perf_counter() - t0
        del c
        gc.collect()
        c2 = measuring_context()
        t0 = time.perf_counter()
        c2.load_state(loc)
        load_s = time.perf_counter() - t0
        after_bytes = {n: table_bytes(c2, n) for n in frames}
        if after_bytes != before_bytes:
            fail(f"card bytes after the load {after_bytes} differ from "
                 f"before the save {before_bytes}")
        warm = c2.warmup
        if warm is None:
            fail("load_state started no warm-up")
        t0 = time.perf_counter()
        warm.join(120)
        warm_s = time.perf_counter() - t0
        if not warm.ready or warm.warmed < 2 or warm.failed:
            fail(f"the warm-up ended {warm.status()}")
        reset_launches(segsum)
        t0 = time.perf_counter()
        got = c2.sql(QUERY).compute()
        first_ms = (time.perf_counter() - t0) * 1e3
        builds = [s.name for s in c2.last_trace.spans
                  if s.name.startswith("compile:")]
        warm_launches = segsum.LAUNCHES["segsum"]
        if builds or warm_launches != 1:
            fail(f"the first Q1 after the warm-up built {builds}, launched "
                 f"{segsum.LAUNCHES}")
        rel = check_q1(got, want, "Q1 after the load")
        phase("coldstart", part="save_load_warm", card=card,
              tables=len(frames), card_bytes=sum(after_bytes.values()),
              save_s=save_s, load_s=load_s, warmup_s=warm_s,
              warmed=warm.warmed, first_q1_ms=first_ms, max_rel_err=rel)

        # a hung pipeline build under the watchdog
        before = counters(c2)
        faults.reset()
        t0 = time.perf_counter()
        got = c2.sql(HANG_QUERY, config_options={
            "resilience.inject": "compile_hang:once",
            "resilience.inject.hang_s": 30.0,
            "resilience.compile_timeout_ms": 200}).compute()
        hang_ms = (time.perf_counter() - t0) * 1e3
        faults.reset()
        moves = moved(before, counters(c2))
        g = df.groupby("l_returnflag")
        if got["l_returnflag"].tolist() != sorted(df.l_returnflag.unique()) \
                or got["n"].tolist() != g.size().tolist() \
                or max_rel(got["q"], g.l_quantity.sum().to_numpy(
                    np.float64)) > REL_BOUND:
            fail("the query under a hung build answered wrong")
        if moves.get("resilience.watchdog.timeout") != 1 \
                or moves.get("resilience.degraded.compiled_aggregate") != 1:
            fail(f"the hung build moved {moves}")
        alive = watchdog.join_abandoned(10.0)
        helpers = [t.name for t in threading.enumerate()
                   if t.name.startswith("dsql-compile-watchdog")]
        if alive or helpers:
            fail(f"helper threads outlived the hung build: {helpers}")
        phase("coldstart", part="compile_hang", card=card, ms=hang_ms,
              moved={k: v for k, v in moves.items()
                     if k.startswith("resilience.")})

        # a background recompile: the table grows, the family rebuilds
        # off the query's path and is found by the next query
        c2.config.update({"serving.bg_compile.enabled": True})
        small, grown = df.head(BG_ROWS), df.head(2 * BG_ROWS)
        grown_want = q1_oracle(grown)
        c2.create_table("bg", small)
        sql_bg = QUERY.replace("FROM lineitem", "FROM bg")
        check_q1(c2.sql(sql_bg).compute(), q1_oracle(small), "bg Q1")
        c2.create_table("bg", grown)
        before = counters(c2)
        check_q1(c2.sql(sql_bg).compute(), grown_want,
                 "bg Q1 while it rebuilds")
        if not c2.background_compiler().wait_idle(60):
            fail("the background recompile did not finish")
        check_q1(c2.sql(sql_bg).compute(), grown_want, "bg Q1 rebuilt")
        moves = moved(before, counters(c2))
        if moves.get("serving.bg_compile.deferred") != 1 \
                or moves.get("serving.bg_compile.completed") != 1 \
                or moves.get("resilience.rung.compiled_aggregate") != 1 \
                or moves.get("resilience.degraded"):
            fail(f"the background recompile moved {moves}")
        c2.background_compiler().cancel()
        c2.background_compiler().join(10)
        phase("coldstart", part="background_recompile", card=card,
              moved={k: v for k, v in moves.items()
                     if k.startswith(("serving.bg", "resilience.rung"))})
        del c2

        out, err = child.communicate(timeout=300)
        child_s = time.perf_counter() - t_child
        if child.returncode != 0:
            fail(f"the compile-cache process failed: {err[-2000:]}")
        seen = json.loads(out.strip().splitlines()[-1])
        if not seen["right"] or seen["hit"] != 2 or seen["miss"] \
                or seen["launches"]["segsum"] != 1 or "segsum" not in built:
            fail(f"the compile cache: built {built}, the second process "
                 f"saw {seen}")
        phase("coldstart", part="compile_cache", card=card,
              build_s=build_s, second_process_s=child_s, second=seen)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(work, ignore_errors=True)
    return {"launches": {"coldstart_q1_after_warmup": warm_launches}}


def spy_synchronize():
    """Wraps `torch.cuda.synchronize`: returns the list of the calling
    modules' file names, and the function that puts it back."""
    calls = []
    sync = torch.cuda.synchronize

    def spy(device=None):
        calls.append(sys._getframe(1).f_code.co_filename)
        return sync(device)

    torch.cuda.synchronize = spy

    def restore():
        torch.cuda.synchronize = sync

    return calls, restore


def tree_rows(plan_rows) -> list:
    """EXPLAIN ANALYZE's node lines with their ms taken out."""
    import re

    return [re.sub(r"\[[0-9.]+ ms, ", "[", r) for r in plan_rows
            if r.endswith(" rows]") or r.lstrip().startswith("!! ")]


def node_ms(plan_rows) -> list:
    import re

    return [float(m.group(1)) for r in plan_rows
            for m in [re.search(r"\[([0-9.]+) ms, ", r)] if m]


def observability(df, want, card, segsum, transfers):
    """The `observability` phase on Q1's 6,000,000 encoded rows: EXPLAIN
    ANALYZE of Q1 (the node tree's labels and rows equal to the port's on
    the CPU for the same plan, the root with Q1's rows, the kernel's launch
    held against the plain version, one synchronize of the card a node
    from `tracing.py`, the node ms beside the warm Q1's wall ms); EXPLAIN
    ANALYZE under ``compile:always`` (the ``degraded:`` markers, the eager
    aggregate's launches held against the plain version); warm Q1 with
    lifecycle tracing on and off in turns (the median of WARM_RUNS each,
    and no synchronize from `tracing.py` in an untraced run); SHOW METRICS
    (one pipeline build of the fused aggregate however many warm runs,
    ``query.execute_ms`` counting every query) and SHOW PROFILES (Q1's
    family with a hit a run).  Returns the launches and the largest error
    of the checked calls."""
    launches = {}
    c, _, _ = load_tables({"lineitem": df})
    runs = 0  # queries executed on `c`
    check_q1(c.sql(QUERY).compute(), want, "observability Q1")
    runs += 1

    # EXPLAIN ANALYZE of Q1: the kernel's launch counted on the run that
    # is read, its call captured there and held against the plain version
    reset_launches(segsum)
    plan = []
    syncs, restore = spy_synchronize()
    try:
        calls = capture_calls(segsum, lambda: plan.append(
            list(c.sql("EXPLAIN ANALYZE " + QUERY).compute()["PLAN"])))
    finally:
        restore()
    runs += 1
    launches["observability_explain_analyze_q1"] = segsum.LAUNCHES["segsum"]
    plan = plan[0]
    err = check_calls(segsum, calls, "observability_explain_analyze_q1")
    nodes = [r for r in tree_rows(plan) if not r.lstrip().startswith("!! ")]
    traced_syncs = sum(1 for f in syncs if f.endswith("tracing.py"))
    if launches["observability_explain_analyze_q1"] != 1:
        fail(f"EXPLAIN ANALYZE of Q1 launched the kernel "
             f"{launches['observability_explain_analyze_q1']} times")
    if traced_syncs != len(nodes):
        fail(f"EXPLAIN ANALYZE of Q1: {traced_syncs} synchronizes from "
             f"tracing.py for {len(nodes)} nodes")
    cpu = cpu_context({"lineitem": df})
    cpu_plan = list(cpu.sql("EXPLAIN ANALYZE " + QUERY).compute()["PLAN"])
    if tree_rows(plan) != tree_rows(cpu_plan):
        fail(f"EXPLAIN ANALYZE of Q1: the card's tree {tree_rows(plan)} is "
             f"not the CPU's {tree_rows(cpu_plan)}")
    if not nodes[0].endswith(f"[{len(want)} rows]"):
        fail(f"EXPLAIN ANALYZE of Q1: the root {nodes[0]!r} does not show "
             f"Q1's {len(want)} rows")
    del cpu

    # EXPLAIN ANALYZE under compile:always: the eager aggregate, its
    # kernel calls held against the plain version
    from dask_sql_tpu_torch.resilience import faults

    faults.reset()
    before = c.metrics.snapshot()["counters"]
    reset_launches(segsum)
    eager_plan = []
    calls = capture_calls(segsum, lambda: eager_plan.append(list(c.sql(
        "EXPLAIN ANALYZE " + QUERY, config_options={
            "resilience.inject": "compile:always"}).compute()["PLAN"])))
    faults.reset()
    runs += 1
    eager_plan = eager_plan[0]
    launches["observability_compile_always"] = segsum.LAUNCHES["segsum"]
    err = max(err, check_calls(segsum, calls, "observability_compile_always"))
    markers = [r.strip() for r in eager_plan
               if r.strip().startswith("!! degraded")]
    if not markers or launches["observability_compile_always"] != 9:
        fail(f"EXPLAIN ANALYZE under compile:always: markers {markers}, "
             f"{launches['observability_compile_always']} launches, "
             "expected degraded markers and 9")
    del calls
    stepped = {"resilience.degraded": 3,
               **{f"resilience.degraded.{r}": 1 for r in (
                   "compiled_select", "compiled_join_aggregate",
                   "compiled_aggregate")}}
    expect_moves(c, before, stepped, "observability compile:always")

    # warm Q1 with lifecycle tracing on and off, in turns; an untraced
    # run makes no synchronize from tracing.py
    off = {"observability.trace.enabled": False}
    check_q1(c.sql(QUERY, config_options=off).compute(), want, "untraced")
    runs += 1
    on_ms, off_ms = [], []
    syncs, restore = spy_synchronize()
    try:
        # WARM_RUNS pairs, then more: the host clock's spread on a shared
        # host is about the spans' cost
        for _ in range(TRACING_PAIRS):
            for options, ms in ((None, on_ms), (off, off_ms)):
                t0 = time.perf_counter()
                c.sql(QUERY, config_options=options).compute()
                ms.append((time.perf_counter() - t0) * 1e3)
                runs += 1
    finally:
        restore()
    if any(f.endswith("tracing.py") for f in syncs):
        fail(f"an untraced warm Q1 synchronized the card from tracing.py "
             f"{sum(1 for f in syncs if f.endswith('tracing.py'))} times")

    # SHOW METRICS and SHOW PROFILES (Q1's family fingerprint from the
    # last traced run: a statement's trace carries none)
    fp = c.last_trace.fingerprint
    metrics = c.sql("SHOW METRICS", return_futures=False)
    values = dict(zip(metrics["Metric"], metrics["Value"]))
    builds = values.get("resilience.compile_ms.compiled_aggregate.count")
    executed = values.get("query.execute_ms.count")
    if builds != "1" or executed != str(runs):
        fail(f"SHOW METRICS: {builds} builds of the fused aggregate (1 "
             f"expected), query.execute_ms count {executed} ({runs} runs)")
    profiles = c.sql("SHOW PROFILES", return_futures=False)
    hits = {f: v for f, m, v in zip(profiles["Fingerprint"],
                                    profiles["Metric"], profiles["Value"])
            if m == "hits"}
    q1_runs = runs - 2  # the two EXPLAIN ANALYZE runs are their own plans
    if hits.get(fp) != str(q1_runs):
        fail(f"SHOW PROFILES: Q1's family {fp} has hits {hits.get(fp)}, "
             f"{q1_runs} runs")
    # no other step down, no CPU rung, no breaker trip in the phase
    counters = c.metrics.snapshot()["counters"]
    bad = {k: v for k, v in counters.items()
           if k.startswith(("resilience.degraded", "resilience.rung.cpu",
                            "resilience.breaker."))
           and v != stepped.get(k)}
    if bad:
        fail(f"observability: the ladder moved {bad} past compile:always")
    phase("observability", card=card, rows=N_ROWS,
          explain_analyze=nodes, node_ms=node_ms(plan),
          warm_q1_ms=float(np.median(on_ms[:WARM_RUNS])),
          tracing_on_ms=float(np.median(on_ms[:WARM_RUNS])),
          tracing_off_ms=float(np.median(off_ms[:WARM_RUNS])),
          tracing_on_runs_ms=on_ms[:WARM_RUNS],
          tracing_off_runs_ms=off_ms[:WARM_RUNS],
          tracing_pairs=TRACING_PAIRS,
          tracing_on_ms_all_pairs=float(np.median(on_ms)),
          tracing_off_ms_all_pairs=float(np.median(off_ms)),
          tracing_on_minus_off_ms_all_pairs=float(np.median(
              np.subtract(on_ms, off_ms))),
          tracing_syncs_explain_analyze=traced_syncs,
          compile_always_markers=markers,
          launches=launches, compiled_aggregate_builds=int(builds),
          query_execute_ms_count=int(executed), q1_profile_hits=q1_runs,
          show_metrics_rows=len(metrics), show_profiles_rows=len(profiles),
          max_abs_err=err)
    del c
    return {"launches": launches, "max_abs_err": err}


def spy_batches():
    """Wraps the streamed aggregate's batch reader: returns the list that
    collects each batch's rows, and the function that puts it back."""
    from dask_sql_tpu_torch.physical import streaming

    seen = []
    inner = streaming._iter_batches

    def spy(dc, columns, pa_filters, batch_rows):
        for batch in inner(dc, columns, pa_filters, batch_rows):
            seen.append(batch.num_rows)
            yield batch
            del batch  # hold no batch while the next one loads

    streaming._iter_batches = spy

    def restore():
        streaming._iter_batches = inner

    return seen, restore


def write_parquet(df, directory, parts: int, row_group: int) -> None:
    """`df` as `parts` parquet files of equal rows under `directory`."""
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(directory)
    at = pa.Table.from_pandas(df, preserve_index=False)
    step = -(-at.num_rows // parts)
    for i in range(parts):
        pq.write_table(at.slice(step * i, step),
                       os.path.join(directory, f"part-{i}.parquet"),
                       row_group_size=row_group)


def files_q1(df, want, encoded_hbm, card, segsum, transfers):
    """The `files` phase on Q1's 6,000,000 rows, written as FILES_PARTS
    parquet files in row groups of FILES_ROW_GROUP: (a) registered lazily,
    which reads the footers and allocates no card memory; (b) Q1 streamed
    at the default ``sql.streaming.batch_rows``, in batches that end at
    row groups, each batch's partials and the final combine on the kernel
    (at least one launch a batch), against the float64 oracle, with the
    card's peak memory above the query's baseline below the rows loaded
    PLAIN and the table still on disk after; (c) the same files loaded
    with ``persist=True``: the encodings, the card bytes against the pandas
    load's `encoded_hbm`, and Q1 on the fused aggregate with one launch and
    one transfer; (d) `bench.py`'s root select over the lazy table: the
    compiled select declines and the eager scan reads only the rows that
    pyarrow's filter keeps.  Returns the kernel's launches on (b) and (c)
    and the largest error against its plain version on their calls."""
    import os
    import tempfile

    from dask_sql_tpu_torch.datacontainer import LazyParquetContainer

    out = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        write_parquet(df, os.path.join(d, "lineitem"), FILES_PARTS,
                      FILES_ROW_GROUP)
        write_s = time.perf_counter() - t0
        location = os.path.join(d, "lineitem", "*.parquet")

        # (a) lazy registration: footers only
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        c = measuring_context()
        c.create_table("lineitem", location)
        register_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        register_bytes = torch.cuda.memory_allocated() - before
        dc = c.schema["root"].tables["lineitem"]
        footer_rows = c.schema["root"].statistics["lineitem"].row_count
        if not isinstance(dc, LazyParquetContainer) or dc._table is not None:
            fail("the parquet location did not register lazily")
        if register_bytes != 0 or footer_rows != len(df):
            fail(f"lazy registration allocated {register_bytes} card bytes, "
                 f"footers count {footer_rows} rows")
        phase("files", part="lazy_registration", card=card, rows=len(df),
              files=FILES_PARTS, row_group=FILES_ROW_GROUP, write_s=write_s,
              register_ms=register_ms, card_bytes=register_bytes,
              footer_rows=footer_rows)

        # (b) Q1 streamed at the default batch size
        seen, restore = spy_batches()
        try:
            reset_launches(segsum)
            transfers["d2h"] = 0
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            got = c.sql(QUERY).compute()
            cold_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            batches, rows_read = len(seen), sum(seen)
            launches = segsum.LAUNCHES["segsum"]
            rel = check_q1(got, want, "Q1 streamed from parquet")
            runs = []
            for _ in range(WARM_RUNS):
                t0 = time.perf_counter()
                check_q1(c.sql(QUERY).compute(), want,
                         "Q1 streamed from parquet, warm")
                runs.append((time.perf_counter() - t0) * 1e3)
        finally:
            restore()
        if batches < 3 or launches < batches:
            fail(f"Q1 streamed in {batches} batches with {launches} kernel "
                 "launches: expected at least 3 batches, a launch a batch")
        if peak >= N_ROWS * PLAIN_ROW_BYTES:
            fail(f"Q1 streamed peaked at {peak} card bytes, not below the "
                 f"{N_ROWS * PLAIN_ROW_BYTES} of the rows loaded PLAIN")
        if dc._table is not None:
            fail("the streamed Q1 loaded the lazy table")
        calls = capture_calls(segsum, lambda: c.sql(QUERY).compute())
        err = check_calls(segsum, calls, "files_q1_streamed")
        check_not_degraded(c, "files_q1_streamed")
        counters = c.metrics.snapshot()["counters"]
        if any(k.startswith("resilience.rung") for k in counters):
            fail(f"Q1 streamed moved a rung: {counters}")
        phase("files", part="q1_streamed", card=card, batches=batches,
              rows_read=rows_read, batch_rows=seen[:3],
              launches=launches, d2h=transfers["d2h"], cold_ms=cold_ms,
              ms=float(np.median(runs)), runs_ms=runs, peak_card_bytes=peak,
              plain_card_bytes=N_ROWS * PLAIN_ROW_BYTES, max_rel_err=rel,
              kernel_calls=len(calls), kernel_max_abs_err=err,
              table_loaded=dc._table is not None)
        out["files_q1_streamed"] = launches
        del calls

        # (c) the same files loaded with persist=True
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        cp = measuring_context()
        cp.create_table("lineitem", location, persist=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        persisted_bytes = torch.cuda.memory_allocated() - before
        table = cp.schema["root"].tables["lineitem"].table
        reset_launches(segsum)
        transfers["d2h"] = 0
        got = cp.sql(QUERY).compute()
        p_launches, p_d2h = segsum.LAUNCHES["segsum"], transfers["d2h"]
        p_rel = check_q1(got, want, "Q1 on the persisted parquet")
        if p_launches != 1 or p_d2h != 1 \
                or cp.metrics.counter(
                    "resilience.rung.compiled_aggregate") != 1:
            fail(f"Q1 on the persisted parquet: {p_launches} launches, "
                 f"{p_d2h} transfers, {cp.metrics.snapshot()["counters"]}")
        p_runs = warm_runs(cp, QUERY, transfers,
                           lambda g: check_q1(g, want, "persisted, warm"))
        calls = capture_calls(segsum, lambda: cp.sql(QUERY).compute())
        p_err = check_calls(segsum, calls, "files_q1_persisted")
        check_not_degraded(cp, "files_q1_persisted")
        phase("files", part="q1_persisted", card=card, load_s=load_s,
              encoded_columns=cp.metrics.counter(
                  "columnar.encoding.encoded_columns"),
              encodings={n: col.encoding.value
                         for n, col in table.columns.items()},
              card_bytes=persisted_bytes, pandas_load_card_bytes=encoded_hbm,
              launches=p_launches, d2h=p_d2h, ms=float(np.median(p_runs)),
              runs_ms=p_runs, max_rel_err=p_rel, kernel_max_abs_err=p_err)
        out["files_q1_persisted"] = p_launches
        del cp, table, calls

        # (d) bench.py's root select over the lazy table
        flags_want, rev_want = select_oracle(df)
        read = []
        scan = LazyParquetContainer.scan

        def counted_scan(self, columns=None, filters=None):
            table = scan(self, columns, filters)
            read.append(table.num_rows)
            return table

        LazyParquetContainer.scan = counted_scan
        try:
            sel_runs = []
            for i in range(1 + WARM_RUNS):
                rung = c.metrics.counter("resilience.rung.compiled_select")
                transfers["d2h"] = 0
                t0 = time.perf_counter()
                got = c.sql(SELECT_QUERY).compute()
                sel_runs.append((time.perf_counter() - t0) * 1e3)
                if c.metrics.counter(
                        "resilience.rung.compiled_select") != rung:
                    fail("the select over the lazy table took the compiled "
                         "select")
                if got["l_returnflag"].tolist() != flags_want.tolist():
                    fail("the lazy select's rows or order differ from the "
                         "oracle")
                sel_rel = max_rel(got["rev"], rev_want)
                if not sel_rel <= REL_BOUND:
                    fail(f"the lazy select's relative error {sel_rel}")
        finally:
            LazyParquetContainer.scan = scan
        if dc._table is not None:
            fail("the lazy select loaded the table")
        phase("files", part="select_lazy", card=card, rows_read=read[0],
              survivors=int((df.l_discount.to_numpy() > np.float32(0.09)).sum()),
              cold_ms=sel_runs[0], ms=float(np.median(sel_runs[1:])),
              runs_ms=sel_runs[1:], d2h=transfers["d2h"],
              max_rel_err=sel_rel)
        check_not_degraded(c, "files_select")
        out["max_abs_err"] = max(err, p_err)
    return out


def files_q3(tables, card, segsum, transfers):
    """The `files` phase on Q3's frames: `lineitem` as FILES_Q3_PARTS
    parquet files, lazy, streamed through Q3's joins in batches of
    FILES_Q3_BATCH_ROWS; `customer` from a CSV file by CREATE TABLE WITH
    (location, format = 'csv', persist = True); `orders` in memory.  Held
    against the float64 oracle; prints the batches, the rows read and the
    times.  Returns the kernel's launches and its largest error against
    its plain version on the query's calls."""
    import os
    import tempfile

    from tests.tpch import QUERIES

    q3_want = q3_oracle(tables)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        write_parquet(tables["lineitem"], os.path.join(d, "lineitem"),
                      FILES_Q3_PARTS, FILES_ROW_GROUP)
        csv = os.path.join(d, "customer.csv")
        tables["customer"].to_csv(csv, index=False)
        write_s = time.perf_counter() - t0
        c = measuring_context()
        c.create_table("lineitem", os.path.join(d, "lineitem"))
        t0 = time.perf_counter()
        c.sql(f"CREATE TABLE customer WITH (location = '{csv}', "
              "format = 'csv', persist = True)")
        csv_s = time.perf_counter() - t0
        c.create_table("orders", tables["orders"])
        options = {"sql.streaming.batch_rows": FILES_Q3_BATCH_ROWS}
        rels = []

        def check(got):
            if len(got) != len(q3_want):
                fail(f"Q3 from parquet gave {len(got)} rows")
            for key in Q3_KEYS:
                if got[key].tolist() != q3_want[key].tolist():
                    fail(f"Q3 from parquet: {key} differs from the oracle")
            rel = max_rel(got["revenue"], q3_want["revenue"])
            if not rel <= Q3_REL:
                fail(f"Q3 from parquet: relative error {rel} > {Q3_REL}")
            rels.append(rel)

        seen, restore = spy_batches()
        try:
            reset_launches(segsum)
            t0 = time.perf_counter()
            check(c.sql(QUERIES[3], config_options=options).compute())
            cold_ms = (time.perf_counter() - t0) * 1e3
            batches, rows_read = len(seen), sum(seen)
            launches = segsum.LAUNCHES["segsum"]
            runs = []
            for _ in range(WARM_RUNS):
                t0 = time.perf_counter()
                check(c.sql(QUERIES[3], config_options=options).compute())
                runs.append((time.perf_counter() - t0) * 1e3)
        finally:
            restore()
        if batches < 2:
            fail(f"Q3 from parquet streamed in {batches} batches")
        if c.schema["root"].tables["lineitem"]._table is not None:
            fail("the streamed Q3 loaded the lazy table")
        calls = capture_calls(segsum, lambda: c.sql(
            QUERIES[3], config_options=options).compute())
        err = check_calls(segsum, calls, "files_q3_streamed")
        check_not_degraded(c, "files_q3_streamed")
        phase("files", part="q3_streamed", card=card,
              lineitem_rows=len(tables["lineitem"]), files=FILES_Q3_PARTS,
              batch_rows=FILES_Q3_BATCH_ROWS, batches=batches,
              rows_read=rows_read, write_s=write_s, csv_load_s=csv_s,
              cold_ms=cold_ms, ms=float(np.median(runs)), runs_ms=runs,
              launches=launches, kernel_calls=len(calls),
              max_rel_err=max(rels), kernel_max_abs_err=err)
    return {"launches": launches, "max_abs_err": err}


def run_on_both(ct, cpu, sql, segsum, transfers, warm: bool, oracle=None):
    """`sql` on the card and on the CPU: the card's answer (cold, and each
    warm run) against the CPU's (`answers_agree`) and against `oracle`
    where given, the counters each moved alike, no rung stepped down.
    Returns the line for the phase."""
    card_before, cpu_before = counted(ct), counted(cpu)
    t0 = time.perf_counter()
    want = cpu.sql(sql, return_futures=False)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    reset_launches(segsum)
    runs, d2h, rel = [], [], 0.0
    for _ in range(1 + (WARM_RUNS if warm else 0)):
        transfers["d2h"] = 0
        t0 = time.perf_counter()
        got = ct.sql(sql, return_futures=False)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
        d2h.append(transfers["d2h"])
        if (got is None) != (want is None):
            fail(f"{sql[:50]!r}: a result on one side only")
        if got is not None:
            agree, r = answers_agree(got, want)
            if not agree:
                fail(f"{sql[:50]!r} on the card differs from the port on the "
                     f"CPU (largest relative error {r})")
            rel = max(rel, r)
            if oracle is not None:
                rel = max(rel, oracle(got))
    card_moved = moved(card_before, counted(ct))
    check_same_moves(card_moved, moved(cpu_before, counted(cpu)), len(runs),
                     sql[:50])
    return {"rows": None if want is None else len(want), "cold_ms": runs[0],
            "ms": float(np.median(runs[1:])) if warm else None,
            "runs_ms": runs[1:], "cpu_ms": cpu_ms, "d2h": d2h[-1],
            "launches": segsum.LAUNCHES["segsum"], "moved": card_moved,
            "max_rel_err": rel}


def surface_sql(ct, cpu, frames, card, segsum, transfers):
    """The `surface` phase on the TPC-H frames of `tpch_more` (all eight
    tables, on the card and on the CPU): the DDL script of SURFACE_DDL,
    then the function registry, a registered tensor function and a
    registered aggregation (SURFACE_FUNCTIONS), the last two also against
    float64 pandas.  Returns {"launches": {path: n}, "max_abs_err": x}:
    the kernel is held against its plain version on the calls the
    script's CREATE TABLE AS and the function queries make."""
    li = frames["lineitem"]
    price = li.l_extendedprice.to_numpy(np.float64)
    dp = price * (1 - li.l_discount.to_numpy(np.float64))
    keep = dp > 50000
    rev = (li[keep].assign(dp=dp[keep]).groupby("l_returnflag").dp.sum()
           .sort_index())
    med = li.groupby("l_returnflag").l_extendedprice.median().sort_index()

    def against(series, column):
        def check(got):
            if got["l_returnflag"].tolist() != series.index.tolist():
                fail(f"{column}: groups differ from the float64 oracle")
            r = max_rel(got[column], series.to_numpy())
            if not r <= TPCH_REL:
                fail(f"{column}: relative error {r} against the oracle")
            return r
        return check

    oracles = {"udf_filter_sum": against(rev, "rev"),
               "udaf_median": against(med, "m")}
    for ctx in (ct, cpu):
        ctx.register_function(lambda p, d: p * (1 - d), "disc_price",
                              [("p", np.float64), ("d", np.float64)],
                              np.float64)
        ctx.register_aggregation(lambda g: g.median(), "med",
                                 [("x", np.float64)], np.float64)
    launches, err, lines = {}, 0.0, []
    ddl_launches = 0
    for i, sql in enumerate(SURFACE_DDL):
        line = run_on_both(ct, cpu, sql, segsum, transfers, warm=False)
        ddl_launches += line["launches"]
        phase("surface", part="ddl", card=card, statement=i, sql=sql[:70],
              **line)
    if ct.sql("SHOW SCHEMAS").compute()["Schema"].tolist() != ["root"]:
        fail("the DDL script left a schema behind")
    if ddl_launches < 1:
        fail("the DDL script's aggregates never launched the kernel")
    launches["surface_ddl"] = ddl_launches
    calls = capture_calls(segsum, lambda: ct.sql(
        "SELECT l_returnflag, l_linestatus, SUM(l_extendedprice * "
        "(1 - l_discount)) AS revenue, COUNT(*) AS n FROM lineitem "
        "GROUP BY l_returnflag, l_linestatus").compute())
    for i, (g_, c_, d_) in enumerate(calls):
        err = max(err, check_typed(segsum, g_, c_, d_, f"surface_ddl_call{i}"))
    fn_launches = 0
    for name, sql in SURFACE_FUNCTIONS.items():
        line = run_on_both(ct, cpu, sql, segsum, transfers, warm=True,
                           oracle=oracles.get(name))
        fn_launches += line["launches"]
        phase("surface", part="functions", card=card, query=name, **line,
              oracle=name in oracles)
        calls = capture_calls(segsum, lambda: ct.sql(sql).compute())
        for i, (g_, c_, d_) in enumerate(calls):
            err = max(err, check_typed(segsum, g_, c_, d_,
                                       f"surface_{name}_call{i}"))
    if fn_launches < 1:
        fail("the function queries never launched the kernel")
    launches["surface_functions"] = fn_launches
    check_not_degraded(ct, "surface")
    return {"launches": launches, "max_abs_err": err}


def rows_sorted(df):
    """`df` with its rows in one canonical order: sorted by every column,
    floats by their first 9 significant digits (so that sums equal within
    the bound sort alike), NULLs last."""
    keys = {}
    for i, name in enumerate(df.columns):
        col = df[name]
        if col.dtype.kind == "f":
            col = col.map(lambda v: v if np.isnan(v) else float(f"{v:.9e}"))
        keys[f"k{i}"] = col.astype(str) if col.dtype == object else col
    import pandas as pd

    order = pd.DataFrame(keys).sort_values(list(keys), na_position="last",
                                           kind="stable").index
    return df.loc[order].reset_index(drop=True)


#: the query CANCEL QUERY stops on the card must have run this long
CANCEL_AFTER_S = 1.0


def cancel_on_the_card(c, sql, card):
    """The `serving` phase's cancel, on the `tpcds` phase's Context: CANCEL
    QUERY on `sql` (TPC-DS q4, whose plan nodes run one after another for
    seconds) once it has run CANCEL_AFTER_S.  The query stops at its next
    checkpoint, cancelled (the node running then finishes its queued
    launches first); its scheduler reservation goes back once, its card
    bytes are freed, and ``query.cancel`` is on the flight recorder."""
    from dask_sql_tpu_torch.observability import flight
    from dask_sql_tpu_torch.serving import QueryCancelledError, ServingRuntime

    c.sql(sql)  # planned: its cost hint carries the estimate's floor
    rt = ServingRuntime(workers=1, metrics=c.metrics,
                        scheduler_budget_bytes=1 << 40)
    c.serving = rt
    before = card_allocated()
    torch.cuda.reset_peak_memory_stats()
    stop_ms = None
    try:
        qid, fut = c.submit(sql)
        entry = c.live_queries.get(qid)
        deadline = time.perf_counter() + 60
        while time.perf_counter() < deadline and not fut.done() and not (
                entry.state == "running"
                and entry.elapsed_ms() >= CANCEL_AFTER_S * 1e3):
            time.sleep(0.01)
        if fut.done():
            fail(f"the query to cancel answered in {entry.elapsed_ms()} ms")
        reserved = c.ledger.reserved_bytes()
        ran_ms = entry.elapsed_ms()
        answer = c.sql(f"CANCEL QUERY '{qid}'").compute()
        t_cancel = time.perf_counter()
        try:
            fut.result(600)
            fail("the cancelled query answered")
        except QueryCancelledError:
            stop_ms = (time.perf_counter() - t_cancel) * 1e3
    finally:
        rt.shutdown(wait=True)
        c.serving = None
    peak = torch.cuda.max_memory_allocated()
    left = rt.scheduler.reserved_bytes
    # the future holds the error, and its traceback the executor's
    # intermediate tables, until the caller lets it go
    state = c.live_queries.get(qid).state
    del fut, entry, rt
    events = [e for e in flight.RECORDER.events(name="query.cancel")
              if e.get("qid") == qid]
    out = {"ran_ms": ran_ms, "stopped_after_ms": stop_ms,
           "reserved_bytes": reserved, "reserved_after": left,
           "card_before": before, "card_peak": peak,
           "cancelled": c.metrics.counter("serving.cancelled"),
           "state": state, "answer": answer["Cancelled"].tolist()}
    phase("serving", part="cancel", card=card, query="tpcds_q4", **out)
    if answer["Cancelled"].tolist() != ["true"] or state != "cancelled" \
            or [e["ok"] for e in events] != [True]:
        fail(f"CANCEL QUERY: {out}, events {events}")
    if reserved <= 0 or left != 0:
        fail(f"the cancelled query reserved {reserved} bytes, {left} left")
    check_card_freed(before, "serving_cancel")
    return out


def tpcds(card, segsum, transfers):
    """The `tpcds` phase: every TPC-DS query on `tests/tpcds.py
    generate(scale_rows=TPCDS_ROWS)` loaded on the card with the
    reference's encodings, cold once and TPCDS_WARM_RUNS times warm (once
    for the host-bound TPCDS_HOST_BOUND), each
    answer held against the port on the CPU on the same frames (in order,
    floats within TPCH_REL; where ties at an ORDER BY put rows in another
    order, the LIMIT-stripped query's rows as a multiset), on the CPU run's
    rungs, with `resilience.degraded` at 0.  Per query: warm ms, counted
    transfers, kernel launches and the slice's plan nodes that ran.  The
    kernel is held against its plain version on the calls of queries above
    a Union and of window queries that aggregate."""
    from collections import Counter

    from dask_sql_tpu_torch.physical.executor import Executor
    from dask_sql_tpu_torch.physical.rel.logical import window as window_rel
    from tests.ds_oracle import strip_top_limit
    from tests.tpcds import generate
    from tests.tpcds_queries import QUERIES

    t0 = time.perf_counter()
    frames = generate(scale_rows=TPCDS_ROWS, seed=42)
    gen_s = time.perf_counter() - t0
    ct, hbm, load_s = load_tables(frames)
    cpu = cpu_context(frames)
    phase("tpcds_load", card=card, tables=len(frames),
          rows={n: len(f) for n, f in frames.items() if len(f) >= 100_000},
          host_bytes=int(sum(f.memory_usage(deep=True).sum()
                             for f in frames.values())),
          hbm_bytes=hbm, gen_s=gen_s, load_s=load_s,
          setup_s=time.perf_counter() - t0)
    ran = Counter()
    for kind in SLICE_NODES:
        plugin = Executor._plugins[kind]

        def counted(rel, executor, kind=kind, convert=plugin.convert):
            ran[kind] += 1
            return convert(rel, executor)

        plugin.convert = counted
    launches, cpu_s = {}, 0.0
    try:
        for q in sorted(QUERIES):
            sql = QUERIES[q]
            cpu_before = rung_counts(cpu)
            t0 = time.perf_counter()
            want = cpu.sql(sql).compute()
            cpu_ms = (time.perf_counter() - t0) * 1e3
            cpu_s += cpu_ms / 1e3
            cpu_rungs = {k: v - cpu_before.get(k, 0)
                         for k, v in rung_counts(cpu).items()
                         if v != cpu_before.get(k, 0)}
            before = rung_counts(ct)
            reset_launches(segsum)
            ran.clear()
            runs, rel, compared = [], 0.0, "in_order"
            runs_per_query = 1 + (1 if q in TPCDS_HOST_BOUND
                                  else TPCDS_WARM_RUNS)
            for i in range(runs_per_query):
                transfers["d2h"] = 0
                t0 = time.perf_counter()
                got = ct.sql(sql).compute()
                runs.append((time.perf_counter() - t0) * 1e3)
                agree, r = answers_agree(got, want)
                if not agree and compared == "in_order":
                    # ties at an ORDER BY may sort alike-valued rows apart
                    stripped = strip_top_limit(sql)
                    agree, r = answers_agree(
                        rows_sorted(ct.sql(stripped).compute()),
                        rows_sorted(cpu.sql(stripped).compute()))
                    agree = agree and len(got) == len(want)
                    compared = "multiset"
                if not agree:
                    fail(f"TPC-DS q{q} on the card differs from the port on "
                         f"the CPU (largest relative error {r})")
                rel = max(rel, r)
            launches[q] = segsum.LAUNCHES["segsum"]
            rungs = {k: v - before.get(k, 0) for k, v in rung_counts(ct).items()
                     if v != before.get(k, 0)}
            expected = {k: v * runs_per_query for k, v in cpu_rungs.items()}
            if rungs != expected:
                fail(f"TPC-DS q{q} answered on rungs {rungs}, the CPU on "
                     f"{expected}")
            check_not_degraded(ct, f"tpcds q{q}")
            phase("tpcds", card=card, query=f"q{q}", rows=len(got),
                  cold_ms=runs[0], ms=float(np.median(runs[1:])),
                  runs_ms=runs[1:], cpu_ms=cpu_ms, d2h=transfers["d2h"],
                  launches=launches[q] // runs_per_query, rungs=rungs,
                  nodes={k: v // runs_per_query for k, v in ran.items()},
                  compared=compared, max_rel_err=rel)
    finally:
        for kind in SLICE_NODES:
            del Executor._plugins[kind].convert
    # the kernel against its plain version on calls the queries make
    captured = {}
    typed = segsum.segsum_typed

    def capture(gid, columns, domain):
        captured.setdefault(q, []).append((gid, list(columns), domain))
        return typed(gid, columns, domain)

    segsum.segsum_typed = capture
    try:
        for q in TPCDS_UNION_CALLS + TPCDS_WINDOW_CALLS:
            ct.sql(QUERIES[q]).compute()
    finally:
        segsum.segsum_typed = typed
    for group in (TPCDS_UNION_CALLS, TPCDS_WINDOW_CALLS):
        if not any(captured.get(q) for q in group):
            fail(f"no TPC-DS query of {group} called the segsum kernel")
    err = 0.0
    for q, calls in captured.items():
        for i, (gid, cols, domain) in enumerate(calls):
            err = max(err, check_typed(segsum, gid, cols, domain,
                                       f"tpcds_q{q}_call{i}"))
    check_not_degraded(ct, "tpcds")
    phase("tpcds_summary", card=card, queries=len(launches),
          kernel_queries=sorted(q for q, n in launches.items() if n),
          checked_calls={f"q{q}": len(v) for q, v in captured.items()},
          sparse_table_bytes=window_rel.SPARSE_TABLE_BYTES["max"],
          cpu_s=cpu_s, kernel_max_abs_err=err)
    cancel_on_the_card(ct, QUERIES[4], card)
    return {"launches": launches, "max_abs_err": err}


#: the `serving` phase: a burst of this many members of Q1's family, on
#: this many serving workers (each member a date literal of its own)
SERVING_MEMBERS = 32
SERVING_WORKERS = 8
#: how long a batch leader waits for same-family followers while other
#: queries are in flight (the reference's default is 2 ms; a burst of 32
#: submits reaches the executor over a few ms)
SERVING_WINDOW_MS = 20.0
#: the stacked family call held against its plain version at these sizes
SERVING_STACKS = (2, 8, 32)
#: ``serving.deadline_s`` of the shedding part: TPC-H q22 over Q3's frames
#: takes about 300 ms on the card, through several plan nodes
SERVING_DEADLINE_S = 0.05


def serving_dates(n: int):
    """`n` distinct Q1 date literals, 60 days apart from 1998-09-02 back."""
    base = np.datetime64("1998-09-02")
    return [str(base - np.timedelta64(60 * i, "D")) for i in range(n)]


def q1_family_oracle(df, dates):
    """`q1_oracle` of each date, in float64, from one pass: the sums of
    each group and ship date, then their prefix up to each date."""
    import pandas as pd

    price = df.l_extendedprice.to_numpy(np.float64)
    disc = df.l_discount.to_numpy(np.float64)
    tax = df.l_tax.to_numpy(np.float64)
    work = pd.DataFrame({
        KEYS[0]: df[KEYS[0]].to_numpy(), KEYS[1]: df[KEYS[1]].to_numpy(),
        "day": df.l_shipdate.to_numpy(),
        "qty": df.l_quantity.to_numpy(np.float64), "price": price,
        "disc": disc, "disc_price": price * (1 - disc),
        "charge": price * (1 - disc) * (1 + tax), "n": 1})
    by_day = work.groupby(KEYS + ["day"]).sum().reset_index()
    out = {}
    for date in dates:
        g = by_day[by_day.day <= np.datetime64(date)].groupby(KEYS).sum(
            numeric_only=True)
        out[date] = pd.DataFrame({
            "sum_qty": g.qty, "sum_base_price": g.price,
            "sum_disc_price": g.disc_price, "sum_charge": g.charge,
            "avg_qty": g.qty / g.n, "avg_price": g.price / g.n,
            "avg_disc": g.disc / g.n, "count_order": g.n,
        }).reset_index().sort_values(KEYS).reset_index(drop=True)
    return out


def q1_of(date: str) -> str:
    return QUERY.replace("DATE '1998-09-02'", f"DATE '{date}'")


def burst(c, sqls, segsum, **options):
    """Every query of `sqls` submitted at once to a fresh `ServingRuntime`
    on `c` built from its config with `options` (each planned first, so
    its cost hint holds the estimate).  Returns (answers in order, ms from
    submit to answer of each, wall seconds, the runtime's counters, the
    kernel launches by wrapper)."""
    from dask_sql_tpu_torch.serving import ServingRuntime

    for q in sqls:
        c.sql(q)
    with c.config.set(options):
        rt = ServingRuntime.from_config(c.config, c.metrics)
    c.serving = rt
    before = dict(c.metrics.snapshot()["counters"])
    reset_launches(segsum)
    done, lat = {}, {}
    try:
        t0 = time.perf_counter()
        futs = []
        for i, q in enumerate(sqls):
            t_sub = time.perf_counter()
            _, fut = c.submit(q)

            def stamp(f, i=i, t_sub=t_sub):
                lat[i] = (time.perf_counter() - t_sub) * 1e3
                done[i] = time.perf_counter()

            fut.add_done_callback(stamp)
            futs.append(fut)
        answers = [f.result(600) for f in futs]
        wall_s = max(done.values()) - t0
    finally:
        rt.shutdown(wait=True)
        c.serving = None
    if any(t.is_alive() for t in rt._threads):
        fail("a serving worker outlived shutdown(wait=True)")
    launches = dict(segsum.LAUNCHES)
    after = c.metrics.snapshot()["counters"]
    moved = {k: v - before.get(k, 0) for k, v in after.items()
             if k.startswith(("serving.", "families.", "query.cache."))
             and v != before.get(k, 0)}
    return answers, [lat[i] for i in range(len(sqls))], wall_s, moved, \
        launches


def q1_pipeline_params(c, sqls):
    """(the Q1 family's fused pipeline, its table, each query's parameter
    values), as the compiled aggregate rung lifts them."""
    from dask_sql_tpu_torch.physical import compiled
    from dask_sql_tpu_torch.physical.executor import Executor
    from dask_sql_tpu_torch.planner import plan as p

    params = []
    for q in sqls:
        agg = next(n for n in p.walk_plan(c.sql(q)._plan)
                   if isinstance(n, p.Aggregate))
        pipe, table, values, _ = compiled._scan_chain_pipeline(
            agg, compiled._extract_chain(agg), Executor(c))
        params.append(values)
    return pipe, table, params


def stacked_check(segsum, pipe, table, params, card, rate):
    """The stacked family call of a batch of len(params) members, as
    `run_batched` makes it over the 6M rows, against its plain version and
    each member's own `segsum_typed` call (the same bits), with its ms,
    the plain ms, the library call's ms and its bound."""
    captured = []
    stacked = segsum.segsum_stacked

    def capture(gid, members, domain):
        captured.append((gid, [list(m) for m in members], domain))
        return stacked(gid, members, domain)

    segsum.segsum_stacked = capture
    try:
        pipe.run_batched(table, params)
    finally:
        segsum.segsum_stacked = stacked
    gid, members, domain = captured[0]
    b = len(members)
    got = segsum.segsum_stacked(gid, members, domain)
    want = segsum.segsum_stacked_plain(gid, members, domain)
    torch.cuda.synchronize()
    err, rel = 0.0, 0.0
    for j, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, segsum.segsum_typed(gid, members[j], domain)):
            fail(f"stacked call B={b}: member {j} differs from its own "
                 "segsum_typed call")
        counts = [i for i, (d, _) in enumerate(members[j])
                  if d.dtype == torch.bool]
        if not torch.equal(g[:, counts], w[:, counts]):
            fail(f"stacked call B={b}: counts differ from the plain version")
        e = (g - w).abs()
        err = max(err, float(e.max()))
        rel = max(rel, float((e / w.abs().clamp_min(1e-30)).max()))
    if not rel <= REL_BOUND:
        fail(f"stacked call B={b}: relative error {rel} > {REL_BOUND}")
    cols = [col for m in members for col in m]
    k = len(members[0])
    iters = 10 if b <= 8 else 3
    ms, host_us = card_ms(lambda: segsum.segsum_stacked(gid, members,
                                                        domain), iters)
    solo_ms = cuda_ms(lambda: [segsum.segsum_typed(gid, m, domain)
                               for m in members], iters)
    plain_ms = cuda_ms(lambda: segsum.segsum_stacked_plain(
        gid, members, domain), 2)
    n_bytes = typed_bytes(gid, cols, domain)
    bytes_ms = n_bytes / rate * 1e3
    ops_ms = typed_adds(gid, cols, domain) / FP64_RATE * 1e3
    need = int(gid.shape[0]) * len(cols) * 8
    library_ms = None
    if torch.cuda.mem_get_info()[0] > 2 * need:
        src64 = torch.stack([d.to(torch.float64) if m is None else
                             torch.where(m, d.to(torch.float64), 0.0)
                             for d, m in cols], dim=1)
        library_ms = cuda_ms(lambda: torch.zeros(
            domain, len(cols), dtype=torch.float64,
            device=gid.device).index_add_(0, gid, src64), 2)
        del src64
    per_call = max(1, segsum.STACK_SCRATCH_BYTES
                   // (segsum.launch_geometry(gid, members[0], domain)[2]
                       * domain * k * 8))
    out = {"members": b, "k": len(cols), "k_member": k, "domain": domain,
           "calls": -(-b // per_call), "max_abs_err": err,
           "max_rel_err": rel, "same_bits_as_solo": True, "ms": ms,
           "host_us": host_us, "solo_calls_ms": solo_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": n_bytes}
    phase("serving", part="stacked_call", card=card, **out)
    del captured, got, want, cols, members
    return out


def check_same_bits(got, solo, label) -> None:
    import pandas as pd

    try:
        pd.testing.assert_frame_equal(got, solo, check_exact=True)
    except AssertionError as e:
        fail(f"{label}: a batched member differs from its run alone: {e}")


def serving(df, c3, check_q3, queries, card, segsum):
    """The `serving` phase, the path of a query through the serving tier on
    Q1's 6,000,000 encoded rows and Q3's frames (`c3`): a burst of
    SERVING_MEMBERS members of Q1's family on SERVING_WORKERS workers (each
    answer against its float64 oracle, bit-equal to its run alone, fewer
    segment-sum launches than members), the same burst with the batcher
    off, interactive Q1 members popped before a batch Q3 and root select,
    packing under a byte budget of twice Q1's provable floor (the reserved
    bytes never past it, 0 after the drain), a queue-full shed and a
    deadline at a checkpoint, the result cache (a hit launches nothing; an
    INSERT INTO drops it and the repeat sees the new row), SHOW QUERIES,
    and the stacked family call against its plain version at
    SERVING_STACKS.  `queries` are `tests/tpch.py`'s: Q3 runs as batch
    work, q22 (several plan nodes over `c3`'s customer and orders) past a
    deadline.  Returns the kernels' numbers of the phase."""
    from dask_sql_tpu_torch.serving import (
        DeadlineExceededError,
        QueueFullError,
        ServingRuntime,
    )

    t_phase = time.perf_counter()
    q3_sql = queries[3]
    c, _, _ = load_tables({"lineitem": df})
    dates = serving_dates(SERVING_MEMBERS)
    sqls = [q1_of(d) for d in dates]
    oracles = q1_family_oracle(df, dates)
    rate = memory_rate(torch.cuda.get_device_name(0))

    # (a) the burst: 32 interactive members of Q1's family at once
    opts = {"serving.workers": SERVING_WORKERS,
            "serving.batch.window_ms": SERVING_WINDOW_MS}
    answers, lat, wall_s, moved, launches = burst(c, sqls, segsum, **opts)
    total = launches["segsum"] + launches["segsum_stacked"]
    if total >= SERVING_MEMBERS or not launches["segsum_stacked"]:
        fail(f"the burst made {launches} segment-sum launches for "
             f"{SERVING_MEMBERS} members")
    rel = max(check_q1(got, oracles[d], f"burst Q1 {d}")
              for got, d in zip(answers, dates))
    sizes = c.metrics.snapshot()["histograms"].get("serving.batch.size", {})
    for got, q, d in zip(answers, sqls, dates):
        check_same_bits(got, c.sql(q).compute(), f"burst Q1 {d}")
    check_not_degraded(c, "serving burst")
    burst_out = {"members": SERVING_MEMBERS, "workers": SERVING_WORKERS,
                 "window_ms": SERVING_WINDOW_MS, "launches": launches,
                 "counters": moved, "batch_sizes": sizes,
                 "queries_per_s": SERVING_MEMBERS / wall_s,
                 "p50_ms": float(np.percentile(lat, 50)),
                 "p99_ms": float(np.percentile(lat, 99)),
                 "max_rel_err": rel, "same_bits_as_solo": True}
    phase("serving", part="burst", card=card, **burst_out)

    # (b) the same burst with the batcher off, for comparison
    answers, lat1, wall1, moved1, launches1 = burst(
        c, sqls, segsum, **opts, **{"serving.batch.max_queries": 1})
    for got, d in zip(answers, dates):
        check_q1(got, oracles[d], f"unbatched Q1 {d}")
    phase("serving", part="burst_unbatched", card=card,
          members=SERVING_MEMBERS, launches=launches1, counters=moved1,
          queries_per_s=SERVING_MEMBERS / wall1,
          p50_ms=float(np.percentile(lat1, 50)),
          p99_ms=float(np.percentile(lat1, 99)))
    del answers

    # (c) the stacked family call against its plain version, on the
    # members' columns over the 6,000,000 rows
    pipe, table, params = q1_pipeline_params(
        c, [q1_of(d) for d in serving_dates(max(SERVING_STACKS))])
    stacks = {b: stacked_check(segsum, pipe, table, params[:b], card, rate)
              for b in SERVING_STACKS}
    del pipe, table, params

    # (d) mixed classes on one worker: batch work queued first, then
    # interactive members; the interactive ones pop first
    flags_want, rev_want = select_oracle(df)
    rt = ServingRuntime(workers=1, metrics=c.metrics)
    c.serving = c3.serving = rt
    gate = threading.Event()
    try:
        rt.submit(lambda t: gate.wait(60))
        work = [("batch", c3, q3_sql), ("batch", c, SELECT_QUERY)] + [
            ("interactive", c, q) for q in sqls[:4]]
        subs = [(cls, ctx.submit(q, priority_class=cls), q)
                for cls, ctx, q in work]
        gate.set()
        results = [(cls, fut.result(600), q) for cls, (_, fut), q in subs]
        started = [(ctx.live_queries.get(qid).ticket.started_at, cls)
                   for (cls, ctx, _), (_, (qid, _), _)
                   in zip(work, subs)]
    finally:
        gate.set()
        rt.shutdown(wait=True)
        c.serving = c3.serving = None
    order = [cls for _, cls in sorted(started)]
    if order != ["interactive"] * 4 + ["batch"] * 2:
        fail(f"the classes popped in the order {order}")
    for cls, got, q in results:
        if q == q3_sql:
            check_q3(got)
        elif q == SELECT_QUERY:
            if got["l_returnflag"].tolist() != flags_want.tolist() or \
                    max_rel(got["rev"], rev_want) > REL_BOUND:
                fail("the batch root select differs from its oracle")
        else:
            check_q1(got, oracles[dates[sqls.index(q)]], "mixed Q1")
    phase("serving", part="mixed_classes", card=card, pop_order=order)

    # (e) packing against a byte budget of twice Q1's provable floor
    lo = c.cost_hint(sqls[0]).bytes_lo
    budget = 2 * lo
    peak, stop = [0], threading.Event()

    def sample():
        while not stop.is_set():
            peak[0] = max(peak[0], c.ledger.reserved_bytes())
            time.sleep(0.0005)

    sampler = threading.Thread(target=sample)
    drift0 = c.metrics.snapshot()["histograms"].get(
        "serving.scheduler.reserve_drift", {}).get("count", 0)
    sampler.start()
    try:
        answers, _, _, moved_p, _ = burst(
            c, sqls[:16], segsum, **opts,
            **{"serving.scheduler.device_budget_bytes": budget})
    finally:
        stop.set()
        sampler.join(10)
    if sampler.is_alive():
        fail("the reservation sampler did not stop")
    for got, d in zip(answers, dates):
        check_q1(got, oracles[d], f"packed Q1 {d}")
    if peak[0] > budget or c.ledger.reserved_bytes() != 0:
        fail(f"reserved bytes {peak[0]} past the budget {budget}, or "
             f"{c.ledger.reserved_bytes()} left after the drain")
    drift = c.metrics.snapshot()["histograms"].get(
        "serving.scheduler.reserve_drift", {})
    if drift.get("count", 0) - drift0 != 16:
        fail(f"the reserve drift was observed {drift} times for 16 queries")
    phase("serving", part="packing", card=card, bytes_lo=lo,
          budget_bytes=budget, peak_reserved_bytes=peak[0],
          reserved_after_drain=c.ledger.reserved_bytes(), counters=moved_p,
          reserve_drift=drift)
    del answers

    # (f) shedding: past the interactive queue, and past the deadline
    with c.config.set({"serving.workers": 1,
                       "serving.queue.interactive": 1}):
        rt = ServingRuntime.from_config(c.config, c.metrics)
    c.serving = rt
    gate, started = threading.Event(), threading.Event()
    try:
        rt.submit(lambda t: (started.set(), gate.wait(60))[1])
        if not started.wait(60):
            fail("the blocking query never started")
        _, queued = c.submit(sqls[0])
        try:
            c.submit(sqls[1])
            fail("a submit past serving.queue.interactive was admitted")
        except QueueFullError as e:
            shed = {"class": e.priority_class, "bound": e.bound,
                    "retry_after_s": e.retry_after_s}
        gate.set()
        queued.result(600)
    finally:
        gate.set()
        rt.shutdown(wait=True)
        c.serving = None
    with c3.config.set({"serving.deadline_s": SERVING_DEADLINE_S}):
        rt = ServingRuntime.from_config(c3.config, c3.metrics)
    c3.serving = rt
    try:
        _, fut = c3.submit(queries[22])
        try:
            fut.result(600)
            fail("a query past serving.deadline_s answered")
        except DeadlineExceededError as e:
            deadline_msg = str(e)
    finally:
        rt.shutdown(wait=True)
        c3.serving = None
    if "exceeded its deadline" not in deadline_msg:
        fail(f"the deadline did not stop the query at a checkpoint: "
             f"{deadline_msg}")
    phase("serving", part="shedding", card=card, queue_full=shed,
          deadline_s=SERVING_DEADLINE_S, deadline=deadline_msg,
          timeouts=c3.metrics.counter("serving.timeouts"))

    # (g) the result cache on: a repeat is a hit that launches nothing; an
    # INSERT INTO drops it, and the repeat sees the new row
    c.config.update({"serving.cache.enabled": True})
    rt = ServingRuntime.from_config(c.config, c.metrics)
    c.serving = rt
    try:
        first = c.submit(sqls[0])[1].result(600)
        hits = c.metrics.counter("query.cache.hit")
        reset_launches(segsum)
        t0 = time.perf_counter()
        again = c.submit(sqls[0])[1].result(600)
        hit_ms = (time.perf_counter() - t0) * 1e3
        hit_launches = dict(segsum.LAUNCHES)
        if c.metrics.counter("query.cache.hit") != hits + 1 or \
                sum(hit_launches.values()) != 0:
            fail(f"the repeat was no cache hit: launches {hit_launches}")
        check_same_bits(again, first, "the cached Q1")
        cache_bytes = c.ledger.snapshot()["resultCacheBytes"]
        c.sql(SURFACE_INSERTS[1])
        if c.metrics.counter("query.cache.invalidated") != 1:
            fail("INSERT INTO did not drop the cached result")
        reset_launches(segsum)
        after = c.submit(sqls[0])[1].result(600)
        after_launches = dict(segsum.LAUNCHES)
    finally:
        rt.shutdown(wait=True)
        c.serving = None
    if after_launches["segsum"] != 1 or len(after) != len(first) + 1:
        fail(f"after INSERT INTO the repeat launched {after_launches} and "
             f"gave {len(after)} rows")
    new = after[after.l_returnflag == "X"]
    if new["count_order"].tolist() != [1] or new["sum_qty"].tolist() != [10.0]:
        fail(f"the repeat does not see the inserted row: {new}")
    check_q1(after[after.l_returnflag != "X"].reset_index(drop=True),
             oracles[dates[0]], "Q1 after the insert")
    phase("serving", part="cache", card=card, hit_launches=hit_launches,
          hit_ms=hit_ms,
          result_cache_bytes=cache_bytes,
          invalidated=c.metrics.counter("query.cache.invalidated"),
          after_insert_launches=after_launches, after_insert_rows=len(after))

    # (h) what is left: the finished queries in SHOW QUERIES
    rows = c.sql("SHOW QUERIES").compute()
    fields = set(rows["Field"])
    if not {"rung", "family", "batch"} <= fields:
        fail(f"SHOW QUERIES lacks rung, family or batch: {sorted(fields)}")
    live = len(set(rows["Qid"])) - 1
    roles = rows[rows.Field == "batch"]["Value"].value_counts().to_dict()
    phase("serving", part="show_queries", card=card, queries=live,
          batch_roles=roles,
          rungs=rows[rows.Field == "rung"]["Value"].value_counts().to_dict())
    check_not_degraded(c, "serving")

    del c, rows
    phase("serving", part="seconds", card=card,
          seconds=time.perf_counter() - t_phase)
    return {"launches": launches["segsum_stacked"], "burst": burst_out,
            "stacks": stacks}


#: the `reuse` phase: the incremental aggregate over TPC-H lineitem loaded
#: PLAIN (an integer group key of domain 7: the kernel), its appends, the
#: stem of Q1's table under three downstream shapes, and a date window
REUSE_AGG_QUERY = ("SELECT l_linenumber, COUNT(*) AS n, SUM(l_quantity) AS q,"
                   " SUM(l_extendedprice) AS p, MIN(l_extendedprice) AS lo,"
                   " MAX(l_quantity) AS hi FROM lineitem GROUP BY l_linenumber")
REUSE_APPEND_ROWS = 10_000
REUSE_APPEND_SEEDS = (11, 12, 13)
REUSE_STEM = "FROM lineitem WHERE l_quantity < 10"
REUSE_STEM_SHAPES = {
    "grouped_sum": ("SELECT l_returnflag, l_linestatus, SUM(l_extendedprice)"
                    f" AS s, COUNT(*) AS n {REUSE_STEM} GROUP BY l_returnflag,"
                    " l_linestatus ORDER BY l_returnflag, l_linestatus"),
    "global_avg": f"SELECT AVG(l_discount) AS d {REUSE_STEM}",
    "top_100": (f"SELECT l_shipdate, l_extendedprice {REUSE_STEM} ORDER BY "
                "l_extendedprice DESC, l_shipdate LIMIT 100"),
}
#: ``serving.materialize.max_bytes`` of the stem's Context (the default is
#: 128 MiB)
REUSE_PIN_BUDGET = 256 << 20
REUSE_WINDOWS = (("1995-01-01", "1996-01-01"), ("1995-03-01", "1995-10-01"),
                 ("1995-06-01", "1995-07-01"))
REUSE_WINDOW_QUERY = ("SELECT l_shipdate, l_quantity, l_extendedprice FROM "
                      "lineitem WHERE l_shipdate >= DATE '{}' AND "
                      "l_shipdate < DATE '{}'")


def reuse_agg_oracle(frame):
    """REUSE_AGG_QUERY in float64 pandas, sorted by the key."""
    work = frame.assign(q=frame.l_quantity.astype(np.float64),
                        p=frame.l_extendedprice.astype(np.float64))
    return work.groupby("l_linenumber", as_index=False).agg(
        n=("q", "count"), q=("q", "sum"), p=("p", "sum"), lo=("p", "min"),
        hi=("q", "max")).sort_values("l_linenumber").reset_index(drop=True)


def check_reuse_agg(got, want, label) -> float:
    """Keys, counts, MIN and MAX exact; the sums within REL_BOUND of the
    float64 oracle.  Returns the largest relative error."""
    got = got.sort_values("l_linenumber").reset_index(drop=True)
    for name in ("l_linenumber", "n", "lo", "hi"):
        if got[name].tolist() != want[name].tolist():
            fail(f"{label}: {name} differs from the oracle")
    rel = max(max_rel(got[name], want[name]) for name in ("q", "p"))
    if not rel <= REL_BOUND:
        fail(f"{label}: relative error {rel} > {REL_BOUND}")
    return rel


def stem_oracles(df):
    """REUSE_STEM_SHAPES in float64 pandas over Q1's frame."""
    sel = df[df.l_quantity < np.float32(10)]
    grouped = sel.assign(s=sel.l_extendedprice.astype(np.float64)).groupby(
        KEYS, as_index=False).agg(s=("s", "sum"), n=("s", "count"))
    top = sel.sort_values(["l_extendedprice", "l_shipdate"],
                          ascending=[False, True]).head(100)
    return {"grouped_sum": grouped.sort_values(KEYS).reset_index(drop=True),
            "global_avg": float(sel.l_discount.astype(np.float64).mean()),
            "top_100": top[["l_shipdate", "l_extendedprice"]].reset_index(
                drop=True)}


def check_stem_shape(name, got, want) -> float:
    if name == "grouped_sum":
        for key in KEYS + ["n"]:
            if got[key].tolist() != want[key].tolist():
                fail(f"stem {name}: {key} differs from the oracle")
        rel = max_rel(got["s"], want["s"])
    elif name == "global_avg":
        rel = abs(float(got["d"][0]) - want) / abs(want)
    else:
        if got["l_extendedprice"].tolist() != \
                want["l_extendedprice"].tolist() or \
                got["l_shipdate"].tolist() != want["l_shipdate"].tolist():
            fail(f"stem {name}: rows differ from the oracle")
        rel = 0.0
    if not rel <= REL_BOUND:
        fail(f"stem {name}: relative error {rel} > {REL_BOUND}")
    return rel


def synced_ms(fn):
    """(fn()'s value, its ms with the card's work finished)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def rows_as_set(frame):
    return frame.sort_values(list(frame.columns)).reset_index(drop=True)


def reuse(df, want, tpch, card, segsum, transfers):
    """The `reuse` phase (materialize/) on Contexts on the card with the
    result cache on.  (a) incremental: TPC-H lineitem (1,000,000 rows,
    encodings off) under REUSE_AGG_QUERY, then three appends of 10,000
    rows of the same generator under other seeds, re-queried after each:
    one bootstrap launch and one launch a fold, none at an answer (one
    transfer), each answer against the float64 oracle over all rows, each
    fold's and answer's ms beside the query's on a fresh cache-off Context
    over the grown table.  (c) subsumption on Q1's encoded 6,000,000 rows:
    a date window, then two tighter ones served from the cached rows with
    no launch, equal (as sets) to a fresh run's.  (b) the stem
    ``l_quantity < 10`` under three downstream shapes: pinned at the second
    shape's run, its bytes the ledger's ``materializedBytes``; each shape's
    rung and ms before the pin (a cache-off Context) and after it (the
    interpreted walk over the pinned rows); then a RED reclaim that frees
    the result cache, then the pinned stem.  A card Context re-filters only
    cached rows on the card (the eager walk's); the compiled select's rows
    lie on the host, so its tighter windows run afresh.  Returns the kernel's launches
    by path and its largest error against the plain version on the calls
    these paths make."""
    import pandas as pd

    from dask_sql_tpu_torch.observability import flight
    from tests.tpch import generate

    t_phase = time.perf_counter()
    out = {"launches": {}, "max_abs_err": 0.0}
    errs = []
    # (a) incremental folds
    base = tpch["lineitem"]
    c, _, _ = load_tables({"lineitem": base}, {"columnar.encoding": "off"})
    c.config.update({"serving.cache.enabled": True})
    reset_launches(segsum)
    check_reuse_agg(c.sql(REUSE_AGG_QUERY).compute(), reuse_agg_oracle(base),
                    "incremental first run")
    first_launches = segsum.LAUNCHES["segsum"]
    inc = c.materialize.incremental
    on_append = inc.on_append
    fold_ms = []

    def timed_on_append(*args):
        got, ms = synced_ms(lambda: on_append(*args))
        fold_ms.append(ms)
        return got

    inc.on_append = timed_on_append
    frames = [base]
    steps = []
    try:
        for i, seed in enumerate(REUSE_APPEND_SEEDS):
            delta = generate(scale_rows=REUSE_APPEND_ROWS, seed=seed)[
                "lineitem"].head(REUSE_APPEND_ROWS)
            frames.append(delta)
            reset_launches(segsum)
            calls = capture_calls(segsum, lambda: c.append_rows("lineitem",
                                                                delta))
            fold_launches = segsum.LAUNCHES["segsum"]
            want_rows = 1 if i else 2  # the bootstrap, then the fold
            if fold_launches != want_rows or len(calls) != want_rows:
                fail(f"append {i}: {fold_launches} launches, "
                     f"{len(calls)} calls, expected {want_rows}")
            errs.append(check_calls(segsum, calls, f"reuse_fold_{i}"))
            reset_launches(segsum)
            transfers["d2h"] = 0
            hits = c.metrics.counter("serving.reuse.incremental.hits")
            got, answer_ms = synced_ms(
                lambda: c.sql(REUSE_AGG_QUERY).compute())
            if sum(segsum.LAUNCHES.values()) or transfers["d2h"] != 1 or \
                    c.metrics.counter("serving.reuse.incremental.hits") \
                    != hits + 1:
                fail(f"answer {i}: launches {dict(segsum.LAUNCHES)}, "
                     f"{transfers['d2h']} transfers, not from the state")
            grown = pd.concat(frames, ignore_index=True)
            rel = check_reuse_agg(got, reuse_agg_oracle(grown),
                                  f"incremental answer {i}")
            fresh, _, _ = load_tables({"lineitem": grown},
                                      {"columnar.encoding": "off"})
            fresh.sql(REUSE_AGG_QUERY).compute()
            full_ms = float(np.median([synced_ms(lambda: fresh.sql(
                REUSE_AGG_QUERY).compute())[1] for _ in range(WARM_RUNS)]))
            del fresh
            steps.append({"append": i, "rows": int(len(grown)),
                          "fold_ms": fold_ms[-1], "fold_launches":
                          fold_launches, "answer_ms": answer_ms,
                          "answer_launches": 0, "full_query_ms": full_ms,
                          "max_rel_err": rel})
    finally:
        inc.on_append = on_append
    moves = {k: c.metrics.counter(k) for k in (
        "serving.reuse.incremental.folds", "serving.reuse.incremental.hits",
        "serving.reuse.incremental.declined")}
    if moves != {"serving.reuse.incremental.folds": 3,
                 "serving.reuse.incremental.hits": 3,
                 "serving.reuse.incremental.declined": 0}:
        fail(f"incremental counters {moves}")
    out["launches"]["reuse_incremental_first_run"] = first_launches
    out["launches"]["reuse_incremental_bootstrap_and_folds"] = sum(
        st["fold_launches"] for st in steps)
    out["launches"]["reuse_incremental_answers"] = 0
    phase("reuse", part="incremental", card=card, rows=int(len(base)),
          append_rows=REUSE_APPEND_ROWS, steps=steps, counters=moves)
    check_not_degraded(c, "reuse_incremental")
    del c, frames, delta, grown, got, calls

    # (c) subsumption, then (b) the stem, on Q1's encoded rows.  Both
    # engines' estimators floor a full-width stem over this table at its
    # resident bytes (144,020,453), above the default 128 MiB budget for
    # pinned stems: the budget is raised to let it pin
    c, _, _ = load_tables({"lineitem": df})
    c.config.update({"serving.cache.enabled": True,
                     "serving.materialize.max_bytes": REUSE_PIN_BUDGET})
    cold, _, _ = load_tables({"lineitem": df})
    windows = []
    # the eager walk's rows stay on the card, and a tighter window is
    # re-filtered there; the compiled select's rows lie on the host (its
    # one transfer), so a card Context declines them and runs the tighter
    # window afresh on the card (its windows a day later: another stem,
    # so nothing pins here)
    for mode, options, shift, where, serves in (
            ("eager_walk", {"sql.compile": False}, 0, "cuda", True),
            ("compiled_select", {}, 1, "cpu", False)):
        for i, (lo, hi) in enumerate(REUSE_WINDOWS):
            lo = str(np.datetime64(lo) + np.timedelta64(shift, "D"))
            sql = REUSE_WINDOW_QUERY.format(lo, hi)
            reset_launches(segsum)
            transfers["d2h"] = 0
            hits = c.metrics.counter("serving.reuse.subsumption.hits")
            declined = c.metrics.counter(
                "serving.reuse.subsumption.declined")
            frame = c.sql(sql, config_options=options)
            got, ms = synced_ms(frame.compute)
            device = next(iter(frame.execute().columns.values())).device
            served = c.metrics.counter("serving.reuse.subsumption.hits") \
                - hits
            declined = c.metrics.counter(
                "serving.reuse.subsumption.declined") - declined
            launches = sum(segsum.LAUNCHES.values())
            want_served = 1 if i and serves else 0
            want_declined = 1 if i and not serves else 0
            if served != want_served or declined != want_declined \
                    or launches or device.type != where:
                fail(f"{mode} window {lo}..{hi}: served {served}, declined "
                     f"{declined}, launches {launches}, rows on {device}")
            fresh, fresh_ms = synced_ms(lambda: cold.sql(sql).compute())
            if not rows_as_set(got).equals(rows_as_set(fresh)):
                fail(f"{mode} window {lo}..{hi}: rows differ from a fresh "
                     "run")
            windows.append({"mode": mode, "window": [lo, hi],
                            "rows": int(len(got)), "served": bool(served),
                            "declined": bool(declined),
                            "rows_on": str(device), "launches": launches,
                            "d2h": transfers["d2h"], "ms": ms,
                            "fresh_ms": fresh_ms})
    del frame
    out["launches"]["reuse_subsumption"] = sum(
        w["launches"] for w in windows if w["served"])
    phase("reuse", part="subsumption", card=card, windows=windows)

    oracles = stem_oracles(df)
    shapes = {}
    for name, sql in REUSE_STEM_SHAPES.items():
        before = counters(cold)
        cold.sql(sql).compute()
        runs = []
        for _ in range(WARM_RUNS):
            got, ms = synced_ms(lambda: cold.sql(sql).compute())
            runs.append(ms)
        check_stem_shape(name, got, oracles[name])
        rungs = {k: v for k, v in moved(before, counters(cold)).items()
                 if k.startswith("resilience.rung.")}
        shapes[name] = {"before": {"rungs": rungs,
                                   "ms": float(np.median(runs))}}
    for name in ("grouped_sum", "global_avg"):
        check_stem_shape(name, c.sql(REUSE_STEM_SHAPES[name]).compute(),
                         oracles[name])
    if c.metrics.counter("serving.materialize.stored") != 1:
        fail("two shapes over the stem did not pin it: "
             f"{c.metrics.counter('serving.materialize.stored')}")
    pinned = c.materialize.pinned_bytes()
    ledger = c.ledger.snapshot()["materializedBytes"]
    if not pinned or pinned != ledger:
        fail(f"pinned bytes {pinned} against the ledger's {ledger}")
    stem_rows = c.materialize.rows()[0][3]
    if stem_rows != int((df.l_quantity < np.float32(10)).sum()):
        fail(f"the pinned stem holds {stem_rows} rows")
    after_calls = []
    for name, sql in REUSE_STEM_SHAPES.items():
        runs = []
        for _ in range(WARM_RUNS):
            c._result_cache.invalidate_all()
            before = counters(c)
            reset_launches(segsum)
            if not runs:
                calls = capture_calls(segsum, lambda: c.sql(sql).compute())
                after_calls += calls
                c._result_cache.invalidate_all()
                before = counters(c)
                reset_launches(segsum)
            got, ms = synced_ms(lambda: c.sql(sql).compute())
            runs.append(ms)
        moves = moved(before, counters(c))
        check_stem_shape(name, got, oracles[name])
        rungs = {k: v for k, v in moves.items()
                 if k.startswith("resilience.rung.")}
        if rungs or moves.get("serving.materialize.hits") != 1:
            fail(f"stem {name} after the pin moved {moves}")
        shapes[name]["after"] = {"rungs": rungs, "walk": "interpreted",
                                 "ms": float(np.median(runs)),
                                 "launches": segsum.LAUNCHES["segsum"]}
        out["launches"][f"reuse_stem_{name}_after_pin"] = \
            segsum.LAUNCHES["segsum"]
    if after_calls:
        errs.append(check_calls(segsum, after_calls, "reuse_stem_walk"))
    # the captured calls hold the pinned table's columns
    del calls, after_calls
    phase("reuse", part="stem", card=card, rows=N_ROWS, stem_rows=stem_rows,
          pinned_bytes=pinned, ledger_materialized_bytes=ledger,
          shapes=shapes)

    # a RED reclaim: its deficit exceeds the cached results, so it frees
    # the cache tier and then the pinned stem
    snap = c.ledger.snapshot()
    used = (snap["reservedBytes"] + snap["resultCacheBytes"]
            + snap["tableBytes"] + snap["materializedBytes"])
    budget = int(used / 0.92)
    cache_bytes = snap["resultCacheBytes"]
    alloc0 = card_allocated()
    flight.RECORDER.clear()
    with c.config.set({"serving.scheduler.device_budget_bytes": budget}):
        band = c.pressure.band()
        after_band = c.pressure.evaluate()
    alloc1 = card_allocated()
    ev = flight.RECORDER.events(name="pressure.reclaim")
    if band != "red" or not ev or ev[-1]["cache_bytes"] != cache_bytes \
            or ev[-1]["stem_bytes"] != pinned \
            or c.materialize.pinned_bytes() \
            or alloc0 - alloc1 < pinned:
        fail(f"RED reclaim: band {band}, events {ev}, "
             f"memory_allocated fell by {alloc0 - alloc1}")
    phase("reuse", part="red_reclaim", card=card, budget=budget,
          band=band, band_after=after_band, cache_bytes=cache_bytes,
          stem_bytes=ev[-1]["stem_bytes"], allocated_before=alloc0,
          allocated_after=alloc1)
    check_not_degraded(c, "reuse")
    check_not_degraded(cold, "reuse_cold")
    del c, cold, got, fresh
    out["max_abs_err"] = max(errs, default=0.0)
    phase("reuse", part="seconds", card=card,
          seconds=time.perf_counter() - t_phase)
    return out


#: the `server` phase: workers and the interactive queue's bound of its
#: server, and the row function's sleep a row of its slow statements
SERVER_WORKERS = 2
SERVER_QUEUE = 2
SERVER_SLEEP_S = 0.25
SERVER_FAMILY = 9  # Q1 and eight more members of its family


def http_post(port, sql, headers=None):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/statement",
                                 data=sql.encode(), method="POST")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def http_get(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as resp:
        return json.loads(resp.read())


def http_follow(payload, timeout=300):
    import urllib.request

    deadline = time.time() + timeout
    while "nextUri" in payload:
        if time.time() > deadline:
            fail(f"a statement did not finish in {timeout} s")
        time.sleep(0.01)
        with urllib.request.urlopen(payload["nextUri"], timeout=120) as resp:
            payload = json.loads(resp.read())
    return payload


def wire_frame(payload):
    import pandas as pd

    return pd.DataFrame(payload["data"],
                        columns=[col["name"] for col in payload["columns"]])


def printed_frame(text, columns):
    """The rows of a pandas frame as ``print`` shows it (wrapped into
    column blocks or not, middle columns elided as ``...`` or not; prompts
    and terminal escapes stripped): {column: [printed value, ...]} in
    index order, for the columns it shows."""
    import re

    values = {name: {} for name in columns}
    current = None
    for line in text.splitlines():
        line = re.sub(r"\x1b\[[0-9;?]*[A-Za-z]", "", line)
        line = line.split("(torch-sql) > ")[-1]
        toks = line.replace("\\", " ").split()
        if not toks:
            current = None
            continue
        if all(t in values or t == "..." for t in toks) \
                and any(t in values for t in toks):
            current = toks
            continue
        if current and toks[0].isdigit() and len(toks) == len(current) + 1:
            for name, tok in zip(current, toks[1:]):
                if name in values:
                    values[name][int(toks[0])] = tok
    return {name: [v[i] for i in sorted(v)] for name, v in values.items()
            if v}


def printed_close(token: str, value: float) -> bool:
    """A printed float within REL_BOUND of `value` plus half a unit of its
    last printed digit."""
    mant, _, exp = token.lower().partition("e")
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    half = 0.5 * 10.0 ** (int(exp or 0) - decimals)
    return abs(float(token) - value) <= REL_BOUND * abs(value) + half


def server(df, want, card, segsum):
    """The `server` phase: the Presto-wire server (server/app.py) and the
    REPL (cmd.py) on the card.  `run_server()` without a Context builds one
    on the card; then a server over a card Context with Q1's 6,000,000
    rows (SERVER_WORKERS workers, interactive queue bound SERVER_QUEUE)
    answers Q1 and eight more members of its family over HTTP (one launch
    each, against `q1_oracle`), sheds a statement past the queue bound
    with a 429 and ``Retry-After``, cancels a running statement by DELETE
    ``/v1/cancel``, and prints ``/v1/metrics``; it shuts down and the card
    keeps no byte of it.  Last, ``python -m dask_sql_tpu_torch.cmd`` is fed
    a CREATE TABLE WITH (location = ...) of Q1's rows written as parquet
    files (the `files` phase's layout) and Q1 on stdin: it exits 0 and
    prints the oracle's rows."""
    import tempfile

    import pandas as pd

    from dask_sql_tpu_torch import Context
    from dask_sql_tpu_torch.server.app import run_server

    t_phase = time.perf_counter()
    srv = run_server(host="127.0.0.1", port=0, blocking=False)
    try:
        device = str(srv.context.device)
        one = http_follow(http_post(srv.port, "SELECT 1 + 1 AS x")[1])
    finally:
        srv.shutdown()
    if not device.startswith("cuda") or one.get("data") != [[2]]:
        fail(f"run_server() served on {device}: {one}")
    del srv

    c = Context()
    c.config.update({"serving.workers": SERVER_WORKERS,
                     "serving.queue.interactive": SERVER_QUEUE,
                     "serving.retry_after_s": 2.0})
    c.create_table("lineitem", df)
    c.create_table("sleepy", pd.DataFrame({"a": np.arange(4,
                                                          dtype=np.int64)}))

    def slow(row):
        time.sleep(SERVER_SLEEP_S)
        return int(row["x"])

    c.register_function(slow, "slowid", [("x", np.int64)], np.int64,
                        row_udf=True)
    srv = run_server(context=c, host="127.0.0.1", port=0, blocking=False)
    port = srv.port
    try:
        dates = serving_dates(SERVER_FAMILY)
        oracles = q1_family_oracle(df, dates)
        family = []
        reset_launches(segsum)
        for date in dates:
            sql = QUERY.replace("1998-09-02", date)
            st, p, _ = http_post(port, sql)
            payload, ms = synced_ms(lambda: http_follow(p))
            if st != 200 or payload["stats"]["state"] != "FINISHED":
                fail(f"Q1 on {date} over HTTP: {st} {payload.get('error')}")
            rel = check_q1(wire_frame(payload), oracles[date],
                           f"Q1 on {date} over HTTP")
            family.append({"date": date, "ms": ms, "max_rel_err": rel})
        family_launches = dict(segsum.LAUNCHES)
        if sum(family_launches.values()) != SERVER_FAMILY:
            fail(f"the family over HTTP launched {family_launches}")
        phase("server", part="q1_family", card=card, members=SERVER_FAMILY,
              launches=family_launches, runs=family)

        # the queue bound: two running, two queued, the fifth shed
        slow_sql = [f"SELECT slowid(a) + {i} AS v FROM sleepy"
                    for i in range(5)]
        posted = [http_post(port, slow_sql[0]), http_post(port, slow_sql[1])]
        deadline = time.time() + 30
        while time.time() < deadline and \
                http_get(port, "/v1/metrics")["running"] < SERVER_WORKERS:
            time.sleep(0.01)
        posted += [http_post(port, sql) for sql in slow_sql[2:4]]
        shed = http_post(port, slow_sql[4])
        if [st for st, _, _ in posted] != [200] * 4 or shed[0] != 429 \
                or shed[1]["error"]["errorName"] != "QUERY_QUEUE_FULL" \
                or int(shed[2].get("Retry-After", 0)) < 1:
            fail(f"the queue bound: {[st for st, _, _ in posted]}, "
                 f"then {shed[0]} {shed[1].get('error')}")
        # a running statement cancelled
        import urllib.request

        qid = posted[0][1]["id"]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/cancel/{qid}", method="DELETE")
        with urllib.request.urlopen(req, timeout=60) as resp:
            cancelled = json.loads(resp.read())["cancelled"]
        finals = [http_follow(p) for _, p, _ in posted]
        if cancelled is not True or "error" not in finals[0] or any(
                f["stats"]["state"] != "FINISHED" for f in finals[1:]):
            fail(f"cancel {cancelled}: {[f['stats']['state'] for f in finals]}")
        metrics = http_get(port, "/v1/metrics")
        if metrics["rejected"] != 1 or metrics["cancelled"] != 1:
            fail(f"/v1/metrics after the shed and the cancel: {metrics}")
        phase("server", part="shed_and_cancel", card=card,
              shed_status=shed[0], retry_after=shed[2].get("Retry-After"),
              cancelled=finals[0]["error"]["errorName"])
        phase("server", part="metrics", card=card, metrics={
            k: metrics[k] for k in ("workers", "queueDepth", "running",
                                    "completed", "failed", "cancelled",
                                    "rejected", "avgLatencyMillis",
                                    "avgQueuedMillis")},
            ledger=metrics["ledger"],
            counters={k: v for k, v in metrics["registry"][
                "counters"].items() if k.startswith(("serving.", "query."))})
    finally:
        srv.shutdown()
    check_not_degraded(c, "server")
    del srv, c

    # the REPL on the card: CREATE TABLE WITH (location = ...) and Q1
    with tempfile.TemporaryDirectory() as d:
        write_parquet(df, os.path.join(d, "lineitem"), FILES_PARTS,
                      FILES_ROW_GROUP)
        location = os.path.join(d, "lineitem", "*.parquet")
        script = (f"CREATE TABLE lineitem WITH (location = '{location}', "
                  "format = 'parquet', persist = true)\n"
                  + " ".join(QUERY.split()) + "\n\\q\n")
        t0 = time.perf_counter()
        repl = subprocess.run(
            [sys.executable, "-m", "dask_sql_tpu_torch.cmd"], input=script,
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        repl_s = time.perf_counter() - t0
    # the rows as the REPL prints them: the keys and counts exact, every
    # float column it shows within its printed digits
    printed = printed_frame(repl.stdout, list(want.columns))
    shown = [name for name in want.columns[2:-1] if name in printed]
    ok = repl.returncode == 0 and "ERROR" not in repl.stderr \
        and len(printed.get("count_order", ())) == len(want) and shown
    if ok:
        ok = printed["l_returnflag"] == want["l_returnflag"].tolist() \
            and printed["l_linestatus"] == want["l_linestatus"].tolist() \
            and [int(v) for v in printed["count_order"]] \
            == want["count_order"].tolist() \
            and all(len(printed[name]) == len(want) and all(
                printed_close(tok, float(w))
                for tok, w in zip(printed[name], want[name]))
                for name in shown)
    if not ok:
        fail(f"the REPL: exit {repl.returncode}, stdout "
             f"{repl.stdout[-2000:]!r}, stderr {repl.stderr[-2000:]!r}")
    phase("server", part="repl", card=card, seconds=repl_s,
          rows=len(printed["count_order"]), columns_shown=shown)
    phase("server", part="seconds", card=card,
          seconds=time.perf_counter() - t_phase)
    return {"launches": family_launches}


CHAOS_SEED = 16
CHAOS_QUERIES = 96
CHAOS_ROUNDS = 4
CHAOS_WORKERS = 8


def port_closed(port: int) -> bool:
    """True when nothing answers on the port any more."""
    import urllib.error
    import urllib.request

    try:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/info",
                               timeout=10).close()
    except urllib.error.HTTPError:
        return False  # an answer, whatever its status
    except (urllib.error.URLError, ConnectionError, OSError):
        return True
    return False


def surface_rest(df, want, card, segsum, transfers):
    """The `surface_rest` phase on Q1's 6,000,000 encoded rows (result
    cache off): ``head(5)`` and ``len()`` each take Q1's one transfer and
    one launch and equal the oracle, ``persist()`` executes once and a
    later ``compute()`` adds neither, ``explain_str()`` is the plan
    ``explain`` prints, `visualize` writes its PNG (or, without
    matplotlib, its ``.txt``), `fqn`; `Context.run_server` on the card
    answers one POST of Q1, and `stop_server` closes its port; the
    ``%%sql`` magic answers Q1 where IPython imports (its absence is
    printed: the magic is `Context.sql`, which this phase drives anyway).
    Each path's kernel calls are held against the plain version."""
    import tempfile

    t_phase = time.perf_counter()
    c, _, _ = load_tables({"lineitem": df})
    launches, calls = {}, []

    def run(label, fn, d2h=1):
        reset_launches(segsum)
        transfers["d2h"] = 0
        t0 = time.perf_counter()
        out = []
        calls.extend(capture_calls(segsum, lambda: out.append(fn())))
        ms = (time.perf_counter() - t0) * 1e3
        launches[f"surface_rest_{label}"] = segsum.LAUNCHES["segsum"]
        if segsum.LAUNCHES["segsum"] != 1 or transfers["d2h"] != d2h:
            fail(f"{label}: {dict(segsum.LAUNCHES)} launches, "
                 f"{transfers['d2h']} transfers, expected 1 and {d2h}")
        return out[0], ms

    head, head_ms = run("head", lambda: c.sql(QUERY).head(5))
    head_rel = check_q1(head, want.head(5), "head(5)")
    n, len_ms = run("len", lambda: len(c.sql(QUERY)))
    if n != len(want):
        fail(f"len() of Q1 is {n}, the oracle has {len(want)} rows")
    frame, persist_ms = run("persist", lambda: c.sql(QUERY).persist())
    reset_launches(segsum)
    transfers["d2h"] = 0
    persist_rel = check_q1(frame.compute(), want, "persist().compute()")
    if segsum.LAUNCHES["segsum"] or transfers["d2h"] > 1:
        fail(f"compute() after persist() launched {dict(segsum.LAUNCHES)}, "
             f"{transfers['d2h']} transfers")
    plan_text = frame.explain_str()
    if plan_text != c.explain(QUERY) or "Aggregate" not in plan_text:
        fail(f"explain_str() of Q1: {plan_text[:200]!r}")
    if c.fqn(["lineitem"]) != ("root", "lineitem") \
            or c.fqn(["s", "t"]) != ("s", "t"):
        fail(f"fqn: {c.fqn(['lineitem'])} {c.fqn(['s', 't'])}")
    with tempfile.TemporaryDirectory() as d:
        png = os.path.join(d, "q1.png")
        t0 = time.perf_counter()
        c.visualize(QUERY, filename=png)
        vis_ms = (time.perf_counter() - t0) * 1e3
        written = png if os.path.exists(png) else png + ".txt"
        if not os.path.exists(written):
            fail("visualize wrote neither the PNG nor the .txt")
        with open(written, "rb") as f:
            head_bytes = f.read(8)
        vis_bytes = os.path.getsize(written)
        if written == png and head_bytes != b"\x89PNG\r\n\x1a\n":
            fail("visualize wrote a .png that is no PNG")
    phase("surface_rest", part="frame", card=card, rows=N_ROWS,
          head_ms=head_ms, len_ms=len_ms, persist_ms=persist_ms,
          head_max_rel_err=head_rel, persist_max_rel_err=persist_rel,
          d2h={"head": 1, "len": 1, "persist": 1}, launches=dict(launches),
          explain_lines=len(plan_text.splitlines()),
          visualize=os.path.basename(written), visualize_bytes=vis_bytes,
          visualize_ms=vis_ms, fqn=list(c.fqn(["lineitem"])))

    # the Presto server of this Context on the card, kept and stopped; its
    # boot warms Q1's profiled family first (serving/warmup.py)
    srv = c.run_server(host="127.0.0.1", port=0, blocking=False)
    port = srv.port
    try:
        if c.server is not srv or str(srv.context.device) != "cuda:0":
            fail(f"run_server kept {c.server} on {srv.context.device}")
        if c.warmup is not None:
            c.warmup.join(120)
            phase("surface_rest", part="server_warmup", card=card,
                  status=c.warmup.status())
        payload, post_ms = run("server", lambda: synced_ms(
            lambda: http_follow(http_post(port, QUERY)[1])))[0]
        if payload["stats"]["state"] != "FINISHED":
            fail(f"Q1 over HTTP: {payload.get('error')}")
        server_rel = check_q1(wire_frame(payload), want, "Q1 over HTTP")
    finally:
        c.stop_server()
    if c.server is not None or not port_closed(port):
        fail(f"stop_server left port {port} open")
    phase("surface_rest", part="server", card=card, device="cuda:0",
          port_closed=True, ms=post_ms, max_rel_err=server_rel,
          launches=launches["surface_rest_server"])

    # the %%sql magic, where IPython imports
    try:
        from IPython.core.interactiveshell import InteractiveShell
    except ImportError:
        phase("surface_rest", part="sql_magic", card=card,
              ipython="not installed: the magic was not driven (it is "
                      "Context.sql, driven above)")
    else:
        shell = InteractiveShell.instance()
        shell.user_ns["_ctx"] = c
        if not shell.run_cell("_ctx.ipython_magic()").success:
            fail("ipython_magic() failed to register %%sql")

        def magic():
            out = shell.run_cell("%%sql\n" + QUERY)
            if not out.success:
                fail(f"%%sql Q1: {out.error_in_exec}")
            return out.result

        got, magic_ms = run("sql_magic", magic)
        magic_rel = check_q1(got, want, "%%sql Q1")
        shell.user_ns.pop("_ctx", None)
        phase("surface_rest", part="sql_magic", card=card, ms=magic_ms,
              max_rel_err=magic_rel,
              launches=launches["surface_rest_sql_magic"])
        del shell, got
    check_not_degraded(c, "surface_rest")
    err = check_calls(segsum, calls, "surface_rest")
    phase("surface_rest", part="seconds", card=card,
          seconds=time.perf_counter() - t_phase)
    del c, frame, head, calls, srv
    return {"launches": launches, "max_abs_err": err}


def chaos(card, segsum):
    """The `chaos` phase: one seeded campaign
    (`resilience/chaos.py` `run_campaign`, CHAOS_QUERIES queries over
    CHAOS_ROUNDS rounds on CHAOS_WORKERS workers, checkpoint writes in a
    temporary directory, the lock sanitizer armed) on a card Context.  Its
    report must hold every invariant, the card's bytes back within
    FREED_SLACK once its Context is gone among them; the armed sites, the
    outcomes and the wall time are printed, and the kernel's calls of the
    storm (the grouped sums of ``t_small`` on the fused aggregate and of
    ``t_big`` on the streamed one), copied to the host as they are made,
    are held against the plain version after it."""
    import tempfile

    from dask_sql_tpu_torch.resilience import chaos as chaos_mod

    host_calls, host_stacked = [], []
    typed, stacked = segsum.segsum_typed, segsum.segsum_stacked
    lock = threading.Lock()

    def to_host(columns):
        return [(d.cpu(), None if m is None else m.cpu()) for d, m in columns]

    def to_card(columns):
        return [(d.cuda(), None if m is None else m.cuda())
                for d, m in columns]

    # host copies of the storm's calls: the campaign's card-bytes
    # invariant must not see tensors kept for the check
    def capture(gid, columns, domain):
        with lock:
            host_calls.append((gid.cpu(), to_host(columns), domain))
        return typed(gid, columns, domain)

    def capture_stacked(gid, members, domain):
        with lock:
            host_stacked.append((gid.cpu(), [to_host(m) for m in members],
                                 domain))
        return stacked(gid, members, domain)

    reset_launches(segsum)
    segsum.segsum_typed, segsum.segsum_stacked = capture, capture_stacked
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as d:
            report = chaos_mod.run_campaign(
                seed=CHAOS_SEED, queries=CHAOS_QUERIES, rounds=CHAOS_ROUNDS,
                workers=CHAOS_WORKERS, state_dir=os.path.join(d, "state"),
                config_options={"analysis.lock_sanitizer": True})
    finally:
        segsum.segsum_typed, segsum.segsum_stacked = typed, stacked
    wall_s = time.perf_counter() - t0
    launches = dict(segsum.LAUNCHES)
    if not report.ok:
        fail("chaos invariant violations: " + "; ".join(report.violations))
    if not report.device.startswith("cuda") or report.card_before is None:
        fail(f"the campaign ran on {report.device}")
    if not launches["segsum"] + launches["segsum_stacked"] \
            or len(host_calls) + len(host_stacked) == 0:
        fail(f"the storm launched the kernel {launches}, "
             f"{len(host_calls)} + {len(host_stacked)} calls seen")
    calls = [(g.cuda(), to_card(cols), dom) for g, cols, dom in host_calls]
    err = check_calls(segsum, calls, "chaos") if calls else 0.0
    for i, (g, members, dom) in enumerate(host_stacked):
        g, members = g.cuda(), [to_card(m) for m in members]
        got = segsum.segsum_stacked(g, members, dom)
        ref = segsum.segsum_stacked_plain(g, members, dom)
        for j, (a, b) in enumerate(zip(got, ref)):
            e = (a - b).abs()
            rel = float((e / b.abs().clamp_min(1e-30)).max()) \
                if e.numel() else 0.0
            if not rel <= REL_BOUND:
                fail(f"chaos stacked call {i} member {j}: relative error "
                     f"{rel} > {REL_BOUND}")
            err = max(err, float(e.max()) if e.numel() else 0.0)
    phase("chaos", card=card, seed=report.seed, ok=report.ok,
          summary=report.summary(), armed=report.armed,
          outcomes={"submitted": report.submitted,
                    "completed": report.completed, "failed": report.failed,
                    "cancelled": report.cancelled, "shed": report.shed},
          card_before=report.card_before, card_after=report.card_after,
          launches=launches, calls_checked=len(calls),
          stacked_calls_checked=len(host_stacked), max_abs_err=err,
          wall_s=wall_s)
    del calls, host_calls, host_stacked
    return {"launches": {"chaos_storm": launches["segsum"],
                         "chaos_storm_stacked": launches["segsum_stacked"]},
            "max_abs_err": err}


def selflint(card):
    """The `selflint` phase: ``python -m dask_sql_tpu_torch.analysis --self
    --format json`` in a subprocess exits 0 with no finding; the file
    count and the wall time are printed."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "dask_sql_tpu_torch.analysis", "--self",
         "--format", "json"], capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    seconds = time.perf_counter() - t0
    try:
        payload = json.loads(out.stdout)
    except ValueError:
        payload = {}
    if out.returncode != 0 or payload.get("findings") != []:
        fail(f"the self-lint exited {out.returncode}: "
             f"{out.stdout[-2000:]!r} {out.stderr[-2000:]!r}")
    phase("selflint", card=card, exit_code=out.returncode,
          files=payload["files"], findings=0, seconds=seconds)


#: the `ml` phase: the engine's own models trained over Q1's table, their
#: PREDICT on the fused rung, and tree programs drawn at full width
ML_MODELS = {
    # name: (model_class, target expression or None, features, options)
    "revenue": ("LinearRegression", "l_extendedprice",
                ("l_quantity", "l_discount", "l_tax"), ""),
    "returned": ("LogisticRegression",
                 "CASE WHEN l_returnflag = 'R' THEN 1 ELSE 0 END",
                 ("l_quantity", "l_discount", "l_tax"), ""),
    "segments": ("KMeans", None,
                 ("l_quantity", "l_extendedprice", "l_discount"),
                 ", n_clusters = 8"),
}
ML_DISCOUNT = 0.02
ML_VARIANT_DISCOUNT = 0.03
ML_REL = 5e-6  # predictions against the float64 oracle
ML_RETRAIN_L2 = 1000.0
#: the drawn ensembles: sklearn's GradientBoostingRegressor defaults (100
#: trees of depth 3, learning rate 0.1) and a 100-tree forest of depth 10
#: over 3 classes (its node bucket 2,048)
ML_ENSEMBLES = {"gbdt": (100, 3), "forest": (100, 10)}
ML_GBDT_LR = 0.1
ML_GBDT_BASELINE = 0.5
ML_CLASSES = 3
#: the rows of the card's tree results held against the CPU run of the
#: same program and the numpy walk (a seeded sample: the CPU walk of all
#: 6,000,000 rows would take minutes)
ML_TREE_SAMPLE = 262_144
ML_TREE_RUNS = 3


def ml_predict_sql(name: str, discount: float = ML_DISCOUNT) -> str:
    return (f"SELECT * FROM PREDICT(MODEL {name}, SELECT "
            f"{', '.join(ML_MODELS[name][2])} FROM lineitem "
            f"WHERE l_discount > {discount})")


def ml_create_sql(name: str, extra: str = "") -> str:
    model_class, target, features, options = ML_MODELS[name]
    cols = ", ".join(features)
    if target is None:
        return (f"CREATE OR REPLACE MODEL {name} WITH (model_class = "
                f"'{model_class}'{options}{extra}) AS (SELECT {cols} "
                f"FROM lineitem)")
    return (f"CREATE OR REPLACE MODEL {name} WITH (model_class = "
            f"'{model_class}', target_column = 'target'{options}{extra}) AS "
            f"(SELECT {cols}, {target} AS target FROM lineitem)")


def ml_survivors(df, discount: float):
    """The rows the PREDICT input keeps, as pandas keeps them (the float32
    column against the literal rounded to float32)."""
    return df[df.l_discount.to_numpy() > np.float32(discount)]


#: the share of a score's magnitude that float32 rounding may move it by
#: (the features rounded to float32, a 3-term product, the bias: each a
#: few ulps of 6e-8), within which a label or cluster id may flip
ML_BOUNDARY = 1e-6


def ml_oracle(model, X64: np.ndarray):
    """(float64 oracle predictions, boolean boundary rows or None for a
    regression) of a fitted engine model from its own weights: the
    boundary rows are those whose label or cluster id a float32 rounding
    of the scores could flip."""
    if getattr(model, "cluster_centers_", None) is not None:
        c = model.cluster_centers_.double().cpu().numpy()
        d = (c * c).sum(1)[None, :] - 2.0 * (X64 @ c.T)
        part = np.partition(d, 1, axis=1)
        scale = (c * c).sum(1).max() \
            + 2.0 * (np.abs(X64) @ np.abs(c).T).max(1)
        return d.argmin(1).astype(np.float64), \
            part[:, 1] - part[:, 0] <= ML_BOUNDARY * scale
    w = model._w.double().cpu().numpy()
    raw = X64 @ w[:-1] + w[-1]
    if getattr(model, "classes_", None) is None:
        return raw, None
    classes = np.asarray(model.classes_, dtype=np.float64)
    scale = np.abs(X64) @ np.abs(w[:-1]) + abs(w[-1])
    return classes[(raw > 0).astype(np.int64)], \
        np.abs(raw) <= ML_BOUNDARY * scale


def ml_check(name, model, got, sub, label) -> dict:
    """The PREDICT's rows against the pandas-filtered rows, and its
    predictions against the float64 oracle of the model's weights: within
    ML_REL relative for a regression, labels and cluster ids exact but on
    boundary rows, whose count is returned."""
    features = list(ML_MODELS[name][2])
    if list(got.columns) != features + ["target"] or len(got) != len(sub):
        fail(f"{label}: {got.shape} / {list(got.columns)}, expected "
             f"{len(sub)} rows")
    for col in features:
        if not np.array_equal(got[col].to_numpy(np.float64),
                              sub[col].to_numpy(np.float64)):
            fail(f"{label}: column {col} differs from the pandas rows")
    X64 = sub[features].to_numpy(np.float64)
    want, boundary = ml_oracle(model, X64)
    pred = got["target"].to_numpy(np.float64)
    if not np.all(np.isfinite(pred)):
        fail(f"{label}: a prediction is not finite")
    if boundary is None:
        rel = float(np.max(np.abs(pred - want) / np.abs(want))) \
            if len(want) else 0.0
        if not rel <= ML_REL:
            fail(f"{label}: relative error {rel} > {ML_REL}")
        return {"max_rel_err": rel, "boundary_rows": 0, "mismatches": 0}
    wrong = pred != want
    if (wrong & ~boundary).any():
        fail(f"{label}: {int((wrong & ~boundary).sum())} labels differ "
             f"off the boundary")
    return {"boundary_rows": int(boundary.sum()),
            "mismatches": int(wrong.sum())}


def ml_sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def ml_builds(c) -> int:
    return c.metrics.snapshot()["histograms"].get(
        "resilience.compile_ms.compiled_predict", {}).get("count", 0)


def draw_ensemble(kind: str, n_trees: int, X: np.ndarray, seed: int,
                  depth: int):
    """`n_trees` trees as records with sklearn ``Tree``'s attributes
    (``node_count``, ``children_left``, ``children_right``, ``feature``,
    ``threshold``, ``value``, ``max_depth``), drawn from `seed`: splits on
    a random feature at a random quantile of a sample of `X`.  ``gbdt``
    trees are full (regression leaves); ``forest`` trees stop a branch
    with probability 0.15 a level (class-count leaves over ML_CLASSES)."""
    import types

    rng = np.random.default_rng(seed)
    sample = np.sort(X[rng.choice(len(X), min(len(X), 4096),
                                  replace=False)], axis=0)
    out = []
    for _ in range(n_trees):
        left, right, feat, thr, val = [], [], [], [], []

        def grow(level):
            i = len(left)
            for lst, v in ((left, -1), (right, -1), (feat, -2),
                           (thr, -2.0)):
                lst.append(v)
            if kind == "gbdt":
                val.append([[rng.standard_normal()]])
            else:
                val.append([list(rng.integers(1, 50, ML_CLASSES)
                                 .astype(np.float64))])
            stop = level == depth or (kind == "forest" and level > 1
                                      and rng.random() < 0.15)
            if stop:
                return i, level
            f = int(rng.integers(0, X.shape[1]))
            feat[i] = f
            thr[i] = float(sample[int(rng.uniform(0.05, 0.95)
                                      * len(sample)), f])
            left[i], dl = grow(level + 1)
            right[i], dr = grow(level + 1)
            return i, max(dl, dr)

        _, max_depth = grow(0)
        out.append(types.SimpleNamespace(
            node_count=len(left),
            children_left=np.asarray(left, dtype=np.int64),
            children_right=np.asarray(right, dtype=np.int64),
            feature=np.asarray(feat, dtype=np.int64),
            threshold=np.asarray(thr, dtype=np.float64),
            value=np.asarray(val, dtype=np.float64), max_depth=max_depth))
    return out


def lower_ensemble(kind: str, trees, n_features: int):
    """The drawn trees through the port's own lowering helpers: a GBDT
    regressor (learning rate folded into the weights, a constant
    baseline) or a forest classifier; the depth hint is the drawing's."""
    from dask_sql_tpu_torch.inference import programs

    depth = max(int(t.max_depth) for t in trees)
    if kind == "gbdt":
        return programs._lower_tree_regression(
            trees, np.full(len(trees), ML_GBDT_LR), ML_GBDT_BASELINE,
            n_features, "gbdt_regressor", depth)
    return programs._lower_tree_classifier(
        trees, np.arange(ML_CLASSES, dtype=np.float64), n_features,
        "forest_classifier", ML_ENSEMBLES["forest"][1])


def numpy_tree_walk(kind: str, trees, X: np.ndarray, program) -> np.ndarray:
    """The ensemble's predictions by a plain numpy walk of the records,
    one tree at a time (splits on float32-rounded features, as sklearn):
    the GBDT's baseline plus its learning-rate-weighted leaves, or the
    forest's class of the highest mean leaf probability."""
    Xd = X.astype(np.float32).astype(np.float64)
    rows = np.arange(len(X))
    total = np.zeros(len(X)) if kind == "gbdt" \
        else np.zeros((len(X), ML_CLASSES))
    for t in trees:
        node = np.zeros(len(X), dtype=np.int64)
        for _ in range(int(t.max_depth)):
            inner = t.children_left[node] >= 0
            go = Xd[rows, np.maximum(t.feature[node], 0)] \
                <= t.threshold[node]
            nxt = np.where(go, t.children_left[node],
                           t.children_right[node])
            node = np.where(inner, nxt, node)
        if kind == "gbdt":
            total += ML_GBDT_LR * t.value[node, 0, 0]
        else:
            counts = t.value[node, 0, :]
            total += counts / counts.sum(axis=1, keepdims=True)
    if kind == "gbdt":
        return total + ML_GBDT_BASELINE
    return np.asarray(program.params[-1])[np.argmax(total / len(trees),
                                                    axis=1)]


def ml_programs(lowered, X_host: np.ndarray, card, device) -> None:
    """The trained models' programs alone over the whole feature matrix
    on the card (the linear, logistic and kmeans programs, committed
    params): the median ms of ML_TREE_RUNS runs, the card synchronized
    around each.  (The segments model reads its own three features, here
    the matrix's columns stand in: the program's work is the same.)"""
    X = torch.as_tensor(X_host, device=device)
    out = {}
    for name, program in lowered.items():
        params = tuple(torch.as_tensor(p, device=device)
                       for p in program.params)
        program.apply(params, X)
        runs = []
        for _ in range(ML_TREE_RUNS):
            ml_sync(device)
            t0 = time.perf_counter()
            program.apply(params, X)
            ml_sync(device)
            runs.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"kind": program.kind, "ms": float(np.median(runs)),
                     "runs_ms": runs}
    phase("ml", part="programs", card=card, rows=len(X_host),
          features=X_host.shape[1], programs=out)
    del X


def ml_trees(X_host: np.ndarray, card, device) -> dict:
    """Step 6 of the `ml` phase: both drawn ensembles applied to the
    feature matrix on the card, against the same program on the CPU and
    the numpy walk on a seeded sample of the rows (sums within 1e-12,
    labels exact); the ms and the card's peak rise beside the port's
    charge, `predict_scratch_bytes` times the row bucket."""
    from dask_sql_tpu_torch.inference import predict_scratch_bytes

    out = {}
    n = len(X_host)
    bucket = 1 << (n - 1).bit_length()
    rng = np.random.default_rng(17)
    idx = np.sort(rng.choice(n, min(n, ML_TREE_SAMPLE), replace=False))
    X = torch.as_tensor(X_host, device=device)
    for seed, (kind, (n_trees, depth)) in enumerate(ML_ENSEMBLES.items()):
        t0 = time.perf_counter()
        trees = draw_ensemble(kind, n_trees, X_host, seed=seed, depth=depth)
        program = lower_ensemble(kind, trees, X_host.shape[1])
        lower_s = time.perf_counter() - t0
        if program is None:
            fail(f"ml trees: the {kind} ensemble declined to lower")
        params = tuple(torch.as_tensor(p, device=device)
                       for p in program.params)
        ml_sync(device)
        if torch.device(device).type == "cuda":
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = program.apply(params, X)
        ml_sync(device)
        first_ms = (time.perf_counter() - t0) * 1e3
        rise = None
        if torch.device(device).type == "cuda":
            rise = torch.cuda.max_memory_allocated() - before
        charge = predict_scratch_bytes(program, X_host.shape[1]) * bucket
        if rise is not None and rise > charge:
            fail(f"ml trees {kind}: the card's peak rise {rise} exceeds the "
                 f"port's charge {charge}")
        runs = []
        for _ in range(ML_TREE_RUNS):
            ml_sync(device)
            t0 = time.perf_counter()
            again = program.apply(params, X)
            ml_sync(device)
            runs.append((time.perf_counter() - t0) * 1e3)
            del again
        # the card's result on the host, for the checks
        got = got.cpu().numpy()
        Xs = X_host[idx]
        cpu = program.apply(tuple(torch.as_tensor(p) for p in
                                  program.params),
                            torch.as_tensor(Xs)).numpy()
        walk = numpy_tree_walk(kind, trees, Xs, program)
        if kind == "gbdt":
            err_cpu = float(np.max(np.abs(got[idx] - cpu)))
            err_walk = float(np.max(np.abs(got[idx] - walk)))
            if not max(err_cpu, err_walk) <= 1e-12:
                fail(f"ml trees gbdt: card vs CPU {err_cpu}, vs the numpy "
                     f"walk {err_walk}")
            agree = {"max_abs_err_cpu": err_cpu,
                     "max_abs_err_walk": err_walk}
        else:
            diff_cpu = int((got[idx] != cpu).sum())
            diff_walk = int((got[idx] != walk).sum())
            if diff_cpu or diff_walk:
                fail(f"ml trees forest: {diff_cpu} labels differ from the "
                     f"CPU run, {diff_walk} from the numpy walk")
            agree = {"labels_differ_cpu": 0, "labels_differ_walk": 0,
                     "classes_seen": sorted(set(got[idx].tolist()))}
        out[kind] = {"ms": float(np.median(runs)), "first_ms": first_ms}
        phase("ml", part=f"trees_{kind}", card=card, rows=n, trees=n_trees,
              depth=program.meta["depth"], node_bucket=program.meta["nodes"],
              param_bytes=program.param_bytes, lower_s=lower_s,
              first_ms=first_ms, ms=float(np.median(runs)), runs_ms=runs,
              rows_per_s=n / (float(np.median(runs)) / 1e3),
              peak_rise_bytes=rise,
              scratch_bytes_per_row=predict_scratch_bytes(
                  program, X_host.shape[1]),
              charge_bytes=charge, bucket=bucket,
              checked_rows=len(idx), **agree)
        del got, params
    del X
    return out


def ml_phase(df, card, segsum, transfers, device="cuda"):
    """The `ml` phase (ROADMAP.md Queue 1 item 9) on Q1's table, loaded as
    the reference loads it: the three engine models of ML_MODELS trained
    over every row on the card; each one's PREDICT on the
    ``compiled_predict`` rung (two transfers, no step down) against the
    pandas rows and the float64 oracle of its weights, first and warm;
    a second literal and a same-shape retrain with no pipeline build; the
    host tier; the model tier of the ledger, SHOW MODELS, a RED reclaim,
    DROP MODEL and the ``predict:once`` step down; the drawn tree
    ensembles at full width (`ml_trees`)."""
    from dask_sql_tpu_torch.inference import programs

    c = measuring_context(device)
    c.create_table("lineitem", df)
    reset_launches(segsum)
    fits = {}
    for name in ML_MODELS:
        ml_sync(device)
        t0 = time.perf_counter()
        c.sql(ml_create_sql(name))
        ml_sync(device)
        fits[name] = (time.perf_counter() - t0) * 1e3
        model, _ = c.get_model("root", name)
        if model._device != c.device:
            fail(f"ml: {name} fit on {model._device}")
    phase("ml", part="fit", card=card, rows=len(df), fit_ms=fits,
          models={n: ML_MODELS[n][0] for n in ML_MODELS})

    sub = ml_survivors(df, ML_DISCOUNT)
    results, timings = {}, {}
    for name in ML_MODELS:
        sql = ml_predict_sql(name)
        model, _ = c.get_model("root", name)
        compiled_before = c.metrics.counter("inference.predict.compiled")
        est = c.sql(sql)._plan._dsql_estimate
        transfers["d2h"] = 0
        ml_sync(device)
        before = rise = None
        if torch.device(device).type == "cuda":
            before = card_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = c.sql(sql).compute()
        first_ms = (time.perf_counter() - t0) * 1e3
        lo, hi = est.peak_bytes.lo, est.peak_bytes.hi
        if before is not None:
            rise = torch.cuda.max_memory_allocated() - before
            peak = resident_bytes(c) + rise
            if hi is None or not lo <= peak <= hi:
                fail(f"ml {name}: resident + the card's peak rise {peak} "
                     f"bytes outside the estimate [{lo}, {hi}]")
        if transfers["d2h"] != 2:
            fail(f"ml {name}: {transfers['d2h']} transfers, expected 2")
        if c.metrics.counter("inference.predict.compiled") \
                != compiled_before + 1:
            fail(f"ml {name}: PREDICT did not answer on compiled_predict")
        check_not_degraded(c, f"ml {name}")
        results[name] = ml_check(name, model, got, sub, f"ml {name}")
        runs = []
        for _ in range(WARM_RUNS):
            transfers["d2h"] = 0
            t0 = time.perf_counter()
            again = c.sql(sql).compute()
            runs.append((time.perf_counter() - t0) * 1e3)
            if transfers["d2h"] != 2:
                fail(f"ml {name}: a warm run made {transfers['d2h']} "
                     f"transfers")
        ml_check(name, model, again, sub, f"ml {name} warm")
        program, _ = programs.try_lower(model)
        timings[name] = float(np.median(runs))
        phase("ml", part="predict", card=card, model=name,
              kind=program.kind, rows=len(df), survivors=len(sub),
              bucket=1 << (len(sub) - 1).bit_length(), first_ms=first_ms,
              ms=timings[name], runs_ms=runs, d2h=2,
              param_bytes=program.param_bytes, peak_bytes=[lo, hi],
              card_peak_rise=rise, **results[name])
    check_not_degraded(c, "ml predict")
    builds = ml_builds(c)
    # where a warm PREDICT's time goes: the pipeline's phases, the card
    # synchronized between them (revenue's pipeline on the same table)
    from dask_sql_tpu_torch import families, inference
    from dask_sql_tpu_torch.physical import compiled_predict

    got_pred = compiled_predict._extract_predict(
        c.sql(ml_predict_sql("revenue"))._plan)
    scan, upper, proj = got_pred[2][:3]
    pz = families.pipeline_parameterizer(c.config)
    for e in list(upper) + list(scan.filters) + list(proj.exprs):
        pz.rewrite(e)
    model = c.get_model("root", "revenue")[0]
    program, _ = inference.program_for(c, "root", "revenue", model,
                                       commit=True)
    pipe = next(v for k, v in reversed(compiled_predict._cache.items())
                if k[5] == "revenue")
    table = c.schema["root"].tables["lineitem"].table
    laps = []
    for _ in range(WARM_RUNS):
        times = {}
        pipe.run(table.select(pipe.scan_names),
                 tuple(pz.params) + tuple(program.params), times)
        laps.append(times)
    phase("ml", part="predict_phases", card=card, model="revenue",
          phases_ms={k: float(np.median([t[k] for t in laps]))
                     for k in laps[0]},
          packed_rows=2 * (len(ML_MODELS["revenue"][2]) + 1),
          packed_bytes=2 * (len(ML_MODELS["revenue"][2]) + 1) * 8
          * (1 << (len(sub) - 1).bit_length()))
    del pipe, table, program, model

    # 3. reuse of the pipeline: a second literal, then a same-shape retrain
    hits = c.metrics.counter("families.hit")
    variant = c.sql(ml_predict_sql("revenue", ML_VARIANT_DISCOUNT)).compute()
    ml_check("revenue", c.get_model("root", "revenue")[0], variant,
             ml_survivors(df, ML_VARIANT_DISCOUNT), "ml variant")
    if c.metrics.counter("families.hit") != hits + 1 \
            or ml_builds(c) != builds:
        fail(f"ml variant: families.hit {c.metrics.counter('families.hit')}"
             f" (was {hits}), builds {ml_builds(c)} (was {builds})")
    swaps = c.metrics.counter("inference.model.swap")
    old_w = c.get_model("root", "revenue")[0]._w.cpu().numpy()
    t0 = time.perf_counter()
    c.sql(ml_create_sql("revenue", f", l2 = {ML_RETRAIN_L2}"))
    retrain_ms = (time.perf_counter() - t0) * 1e3
    retrained = c.get_model("root", "revenue")[0]
    got = c.sql(ml_predict_sql("revenue")).compute()
    swapped = ml_check("revenue", retrained, got, sub, "ml swap")
    if c.metrics.counter("inference.model.swap") != swaps + 1 \
            or ml_builds(c) != builds:
        fail(f"ml swap: inference.model.swap "
             f"{c.metrics.counter('inference.model.swap')} (was {swaps}), "
             f"builds {ml_builds(c)} (was {builds})")
    if np.array_equal(retrained._w.cpu().numpy(), old_w):
        fail("ml swap: the retrain left the weights as they were")
    phase("ml", part="reuse", card=card, variant_rows=len(variant),
          families_hit=1, swaps=1, builds=builds, retrain_ms=retrain_ms,
          swapped=swapped)

    # 4. the host tier: the same rows, within ML_REL of the fused answer
    fused = c.sql(ml_predict_sql("revenue")).compute()
    host_before = c.metrics.counter("inference.predict.host")
    host_runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        host = c.sql(ml_predict_sql("revenue"),
                     config_options={"sql.compile.predict": False}).compute()
        host_runs.append((time.perf_counter() - t0) * 1e3)
    if c.metrics.counter("inference.predict.host") != host_before + 3:
        fail("ml host tier: inference.predict.host did not count")
    host_check = ml_check("revenue", retrained, host, sub, "ml host")
    rel = float(np.max(np.abs(host["target"].to_numpy()
                              - fused["target"].to_numpy())
                       / np.abs(fused["target"].to_numpy())))
    if not rel <= ML_REL:
        fail(f"ml host tier: {rel} relative to the fused rung")
    phase("ml", part="host_tier", card=card, ms=float(np.median(host_runs)),
          runs_ms=host_runs, fused_ms=timings["revenue"],
          rel_to_fused=rel, **host_check)

    # 5. the model tier: the ledger, SHOW MODELS, a RED reclaim, the fault
    # site, DROP MODEL
    committed = {n: programs.try_lower(c.get_model("root", n)[0])[0]
                 .param_bytes for n in ML_MODELS}
    snap = c.ledger.snapshot()
    shown = c.sql("SHOW MODELS").compute()
    shown_bytes = dict(zip(shown["Model"], shown["ParamBytes"].astype(int)))
    if snap["modelBytes"] != sum(committed.values()) \
            or shown_bytes != committed:
        fail(f"ml ledger: modelBytes {snap['modelBytes']}, SHOW MODELS "
             f"{shown_bytes}, committed {committed}")
    used = (snap["reservedBytes"] + snap["resultCacheBytes"]
            + snap["tableBytes"] + snap["modelBytes"])
    with c.config.set({"serving.scheduler.device_budget_bytes": used,
                       "resilience.pressure.model_idle_s": 0.0}):
        band = c.pressure.band()
        c.pressure.evaluate()
    reclaimed = c.ledger.snapshot()["modelBytes"]
    if band not in ("red", "critical") or reclaimed != 0:
        fail(f"ml RED reclaim: band {band}, modelBytes {reclaimed} after")
    degraded = c.metrics.counter("resilience.degraded.compiled_predict")
    host_before = c.metrics.counter("inference.predict.host")
    stepped = c.sql(ml_predict_sql("revenue"),
                    config_options={"resilience.inject": "predict:once"}
                    ).compute()
    if c.metrics.counter("resilience.degraded.compiled_predict") \
            != degraded + 1 \
            or c.metrics.counter("inference.predict.host") != host_before + 1:
        fail("ml predict:once: no step down to the host tier")
    ml_check("revenue", retrained, stepped, sub, "ml predict:once")
    c.sql(ml_predict_sql("revenue")).compute()  # commits again
    recommitted = c.ledger.snapshot()["modelBytes"]
    lowered = {n: programs.try_lower(c.get_model("root", n)[0])[0]
               for n in ML_MODELS}
    for name in ML_MODELS:
        c.sql(f"DROP MODEL {name}")
    dropped = c.ledger.snapshot()["modelBytes"]
    if recommitted != committed["revenue"] or dropped != 0:
        fail(f"ml DROP: modelBytes {recommitted} recommitted, {dropped} "
             f"after the drops")
    phase("ml", part="model_tier", card=card, model_bytes=snap["modelBytes"],
          show_models=committed, red_band=band, after_reclaim=reclaimed,
          predict_once_degraded=1, recommitted=recommitted,
          after_drop=dropped)

    # 6. the drawn ensembles on the card over the 6M x 3 feature matrix
    X_host = np.array(df[list(ML_MODELS["revenue"][2])].to_numpy(np.float64))
    del c, got, again, variant, fused, host, stepped
    ml_programs(lowered, X_host, card, device)
    trees = ml_trees(X_host, card, device)
    launches = dict(segsum.LAUNCHES)
    return {"launches": {"ml": launches["segsum"]},
            "fit_ms": fits, "predict_ms": timings, "trees": trees}


#: the `spmd` phase: shards of the rehearsal mesh on the one card, the
#: second literal of Q1's family, and the collectives engine's queries
#: over TPC-H lineitem (sharded) with orders, each with the counters the
#: reference's engine moves for its shape
SPMD_SHARDS = 4
SPMD_DATE = "1997-06-30"
SPMD_RUNS = 3  # runs of Q1 on the shards that must give the same bits
SPMD_ENGINE = {
    "dist_aggregate": (
        "SELECT l_discount * 100 AS d, COUNT(*) AS n, SUM(l_quantity) AS q "
        "FROM lineitem GROUP BY l_discount * 100", {},
        {"parallel.dist.agg_kernel": 1, "resilience.rung.dist_aggregate": 1}),
    "shuffle_join": (
        "SELECT l_orderkey, l_quantity, o_orderdate FROM lineitem JOIN "
        "orders ON l_orderkey = o_orderkey WHERE l_quantity < 5",
        {"sql.join.broadcast": False}, {"parallel.dist.join_kernel": 1}),
    "dist_sort": (
        "SELECT * FROM (SELECT l_orderkey, l_extendedprice FROM lineitem "
        "ORDER BY l_extendedprice DESC, l_orderkey) t LIMIT 20", {},
        {"parallel.dist.sort_kernel": 1, "resilience.rung.dist_sort": 1}),
}


def rung_moves(c, run):
    """(result of `run()`, the ``resilience.``/``parallel.`` counters it
    moved on `c`, the pressure controller's aside)."""
    keep = ("resilience.", "parallel.")
    before = {k: v for k, v in c.metrics.snapshot()["counters"].items()
              if k.startswith(keep)}
    out = run()
    after = {k: v for k, v in c.metrics.snapshot()["counters"].items()
             if k.startswith(keep) and "pressure" not in k}
    return out, moved(before, after)


def frames_same_bits(a, b) -> bool:
    return list(a.columns) == list(b.columns) and len(a) == len(b) and all(
        np.array_equal(a[n].to_numpy(), b[n].to_numpy()) for n in a.columns)


def spmd_phase(df, want, all_tables, card, segsum, transfers,
               device="cuda"):
    """The `spmd` phase: sharded tables on the card.  The card's own mesh
    (one shard a card: the sharded rungs decline below two shards, as the
    reference's do, and Q1 answers on the fused aggregate); Q1's
    6,000,000 rows on a mesh of SPMD_SHARDS shards on the card (the
    ``spmd_aggregate`` rung, one kernel launch a shard, each held against
    the plain version; the float64 oracle; the same bits in SPMD_RUNS
    runs; a second literal with no build; warm ms beside the unsharded
    Q1's; the card bytes of the sharded table equal to the unsharded
    one's), `bench.py`'s root select without its ORDER BY and LIMIT on
    ``spmd_select`` (rows and order equal to the unsharded port's, two
    transfers) and with them (the rung declines ORDER BY: the walk's
    top-k over the global rows), ``spmd:once`` stepping Q1 down to the
    fused aggregate with the breaker charged on (family, spmd_aggregate)
    only, Q3 with ``lineitem`` sharded on ``spmd_join_aggregate`` against
    its oracle, and the collectives engine (SPMD_ENGINE) against the port
    on the CPU over a mesh of as many CPU shards, counters included.
    ``device="cpu"`` rehearses the phase on the host (no launches)."""
    from dask_sql_tpu_torch.parallel import mesh as pm
    from dask_sql_tpu_torch.parallel.dist_plan import table_is_sharded
    from tests.tpch import QUERIES

    t_phase = time.perf_counter()
    out = {"launches": {}, "max_abs_err": 0.0}
    # (a) the card's own mesh: one shard a card
    on_card = device == "cuda"
    pm.reset_default_mesh(device)
    own = pm.default_mesh(device)
    if own.size != (torch.cuda.device_count() if on_card else 1):
        fail(f"the default mesh {own!r} is not one shard a card")
    c1, _, _ = load_tables({"lineitem": df}, distributed=("lineitem",),
                           device=device)
    t1 = c1.schema["root"].tables["lineitem"].table
    if t1.sharding is None or table_is_sharded(t1):
        fail("a one-shard mesh's table must be sharded and not count as such")
    got, mv = rung_moves(c1, lambda: c1.sql(QUERY).compute())
    check_q1(got, want, "Q1 on the card's own mesh")
    if mv != {"resilience.rung.compiled_aggregate": 1}:
        fail(f"Q1 on the card's own mesh moved {mv}")
    phase("spmd", part="own_mesh", card=card, mesh=repr(own),
          shards=own.size, rungs=mv)
    del c1, t1, got
    gc.collect()  # its pipelines go with it, before the next loads count

    # (b) Q1 on SPMD_SHARDS shards of the card, beside the unsharded table
    mesh = pm.make_mesh(SPMD_SHARDS, devices=[
        torch.device("cuda", 0) if on_card else torch.device("cpu")])
    pm.set_default_mesh(mesh)
    try:
        c4, hbm4, _ = load_tables({"lineitem": df},
                                  distributed=("lineitem",), device=device)
        gc.collect()
        cu, hbm1, _ = load_tables({"lineitem": df}, device=device)
        t4 = c4.schema["root"].tables["lineitem"].table
        if t4.sharding.mesh != mesh:
            fail(f"the sharded table is on {t4.sharding.mesh!r}")
        # the blocks are views of the loaded columns, so the sharded table
        # holds the unsharded one's bytes (the loads' allocation deltas,
        # printed beside them, move by a few hundred KB between loads of
        # the same frame either way)
        views = all(
            b.columns[n].data.data_ptr() == col.data.data_ptr()
            + t4.sharding.offsets[i] * col.data.element_size()
            for n, col in t4.columns.items()
            for i, b in enumerate(t4.sharding.blocks(t4)))
        bytes4 = table_bytes(c4, "lineitem")
        bytes1 = table_bytes(cu, "lineitem")
        if not views or bytes4 != bytes1:
            fail(f"the sharded table holds {bytes4} card bytes, the "
                 f"unsharded {bytes1} (blocks are views: {views})")
        reset_launches(segsum)
        transfers["d2h"] = 0
        res = []
        calls = capture_calls(segsum, lambda: res.append(rung_moves(
            c4, lambda: c4.sql(QUERY).compute())))
        launches = dict(segsum.LAUNCHES)
        d2h = transfers["d2h"]
        got, mv = res[0]
        if mv != {"resilience.rung.spmd_aggregate": 1,
                  "parallel.spmd.launches": 1,
                  "parallel.spmd.rows": N_ROWS}:
            fail(f"Q1 on {SPMD_SHARDS} shards moved {mv}")
        if launches["segsum"] != (SPMD_SHARDS if on_card else 0) \
                or len(calls) != SPMD_SHARDS:
            fail(f"Q1 on {SPMD_SHARDS} shards: {launches} launches, "
                 f"{len(calls)} calls")
        if d2h != 1:
            fail(f"Q1 on {SPMD_SHARDS} shards made {d2h} transfers")
        rows = sorted(int(g_.shape[0]) for g_, _, _ in calls)
        if rows != sorted(t4.sharding.sizes):
            fail(f"the kernel's calls took {rows} rows, the blocks "
                 f"{t4.sharding.sizes}")
        err = check_calls(segsum, calls, "spmd_q1_shards") if on_card \
            else 0.0
        shard_times = {}
        if on_card:
            # one shard's call: timed alone, beside its plain version and
            # its bound (the launches above are the query's)
            g_, c_, d_ = calls[0]
            shard_ms, shard_host_us = card_ms(
                lambda: segsum.segsum_typed(g_, c_, d_), 20)
            shard_bytes = typed_bytes(g_, c_, d_)
            shard_times = {
                "shard_call_ms": shard_ms, "shard_call_host_us": shard_host_us,
                "shard_call_plain_ms": cuda_ms(
                    lambda: segsum.segsum_typed_plain(g_, c_, d_), 5),
                "shard_call_bound_ms": max(
                    shard_bytes / memory_rate(torch.cuda.get_device_name(0)),
                    typed_adds(g_, c_, d_) / FP64_RATE) * 1e3,
                "shard_call_bytes": shard_bytes}
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["launches"]["spmd_q1_shards"] = launches["segsum"]
        rel = check_q1(got, want, f"Q1 on {SPMD_SHARDS} shards")
        for i in range(SPMD_RUNS - 1):
            if not frames_same_bits(c4.sql(QUERY).compute(), got):
                fail(f"Q1 on {SPMD_SHARDS} shards: run {i + 2} moved bits")
        hist = "resilience.compile_ms.spmd_aggregate"

        def builds():
            return c4.metrics.snapshot()["histograms"].get(
                hist, {}).get("count", 0)

        b0, hits = builds(), c4.metrics.counter("families.hit")
        sql2 = QUERY.replace("DATE '1998-09-02'", f"DATE '{SPMD_DATE}'")
        rel2 = check_q1(c4.sql(sql2).compute(), q1_oracle(df, SPMD_DATE),
                        f"Q1 on {SPMD_DATE}, {SPMD_SHARDS} shards")
        if builds() != b0 or c4.metrics.counter("families.hit") != hits + 1:
            fail(f"the second literal built {builds() - b0} pipelines")
        check_q1(cu.sql(QUERY).compute(), want, "Q1 unsharded")  # warm it
        sharded_ms, single_ms = [], []
        for _ in range(WARM_RUNS):
            for ctx, runs_ in ((c4, sharded_ms), (cu, single_ms)):
                t0 = time.perf_counter()
                ctx.sql(QUERY).compute()
                runs_.append((time.perf_counter() - t0) * 1e3)
        phase("spmd", part="q1_shards", card=card, mesh=repr(mesh),
              rows=N_ROWS, blocks=t4.sharding.sizes, rungs=mv,
              launches=launches, d2h=d2h, max_rel_err=max(rel, rel2),
              kernel_max_abs_err=err, **shard_times,
              same_bits_runs=SPMD_RUNS,
              second_literal_builds=builds() - b0,
              ms=float(np.median(sharded_ms)), runs_ms=sharded_ms,
              unsharded_ms=float(np.median(single_ms)),
              unsharded_runs_ms=single_ms, table_bytes=bytes4,
              unsharded_table_bytes=bytes1, load_allocated=hbm4,
              unsharded_load_allocated=hbm1, blocks_are_views=views)

        # (c) bench.py's root select: without ORDER BY on spmd_select
        # (rows and order the unsharded port's), with it on the walk's
        # top-k over the global rows (the rung keeps ORDER BY off),
        # against the oracle
        transfers["d2h"] = 0
        t0 = time.perf_counter()
        got, mv = rung_moves(c4, lambda: c4.sql(STREAM_SELECT_QUERY)
                             .compute())
        ms = (time.perf_counter() - t0) * 1e3
        sel_d2h = transfers["d2h"]
        if not frames_same_bits(got, cu.sql(STREAM_SELECT_QUERY).compute()):
            fail(f"the select on {SPMD_SHARDS} shards: rows or order differ "
                 "from the unsharded port's")
        if mv != {"resilience.rung.spmd_select": 1,
                  "parallel.spmd.launches": 1, "parallel.spmd.rows": N_ROWS} \
                or sel_d2h != 2:
            fail(f"the select on {SPMD_SHARDS} shards moved {mv}, "
                 f"{sel_d2h} transfers")
        phase("spmd", part="select_no_order", card=card, rows=len(got),
              rungs=mv, d2h=sel_d2h, cold_ms=ms)
        flags_want, rev_want = select_oracle(df)
        got, mv = rung_moves(c4, lambda: c4.sql(SELECT_QUERY).compute())
        if got["l_returnflag"].tolist() != flags_want.tolist():
            fail("the top-k select on the shards differs from the oracle")
        top_rel = max_rel(got["rev"], rev_want)
        if not top_rel <= REL_BOUND or "resilience.rung.spmd_select" in mv:
            fail(f"the top-k select on the shards: {top_rel}, moved {mv}")
        phase("spmd", part="select_topk", card=card, rows=len(got),
              rungs=mv, max_rel_err=top_rel)
        check_not_degraded(c4, "spmd")

        # (d) spmd:once: Q1 steps down, the breaker charged on its rung
        got, mv = rung_moves(c4, lambda: c4.sql(QUERY, config_options={
            "resilience.inject": "spmd:once"}).compute())
        check_q1(got, want, "Q1 under spmd:once")
        if mv != {"resilience.degraded": 1,
                  "resilience.degraded.spmd_aggregate": 1,
                  "resilience.rung.compiled_aggregate": 1}:
            fail(f"spmd:once moved {mv}")
        charged = {k[1]: v[0] for k, v in c4.breaker._state.items()}
        if charged != {"spmd_aggregate": 1}:
            fail(f"spmd:once charged the breaker {charged}")
        phase("spmd", part="spmd_once", card=card, rungs=mv,
              breaker=charged)
        del c4, cu, t4, got, calls, res

        # (e) Q3 with lineitem sharded, and the collectives engine over
        # the same frames against the port on the CPU's shards
        tables = {n: all_tables[n] for n in ("customer", "orders",
                                             "lineitem")}
        ct, _, _ = load_tables(tables, distributed=("lineitem",),
                               device=device)
        reset_launches(segsum)
        got, mv = rung_moves(ct, lambda: ct.sql(QUERIES[3]).compute())
        q3_want = q3_oracle(tables)
        if mv != {"resilience.rung.spmd_join_aggregate": 1,
                  "parallel.spmd.launches": 1,
                  "parallel.spmd.rows": len(tables["lineitem"])}:
            fail(f"Q3 on {SPMD_SHARDS} shards moved {mv}")
        for key in Q3_KEYS:
            if got[key].tolist() != q3_want[key].tolist():
                fail(f"Q3 on {SPMD_SHARDS} shards: {key} differs")
        q3_rel = max_rel(got["revenue"], q3_want["revenue"])
        if not q3_rel <= Q3_REL:
            fail(f"Q3 on {SPMD_SHARDS} shards: relative error {q3_rel}")
        out["launches"]["spmd_q3_shards"] = segsum.LAUNCHES["segsum"]
        phase("spmd", part="q3_shards", card=card, rungs=mv,
              launches=dict(segsum.LAUNCHES), max_rel_err=q3_rel)
        pm.set_default_mesh(pm.make_mesh(SPMD_SHARDS, devices=["cpu"]))
        cpu, _, _ = load_tables(tables, distributed=("lineitem",),
                                device="cpu")
        for label, (sql, options, expect) in SPMD_ENGINE.items():
            t0 = time.perf_counter()
            got, mv = rung_moves(ct, lambda: ct.sql(
                sql, config_options=options).compute())
            ms = (time.perf_counter() - t0) * 1e3
            want_c, mv_c = rung_moves(cpu, lambda: cpu.sql(
                sql, config_options=options).compute())
            mv.pop("parallel.dist.gather", None)
            mv_c.pop("parallel.dist.gather", None)
            if mv != expect or mv_c != expect:
                fail(f"{label}: the card moved {mv}, the CPU {mv_c}, "
                     f"expected {expect}")
            if "ORDER BY" not in sql:
                got = got.sort_values(list(got.columns)).reset_index(
                    drop=True)
                want_c = want_c.sort_values(list(want_c.columns)) \
                    .reset_index(drop=True)
            rel = same_answer(got, want_c, f"{label} on {SPMD_SHARDS} shards")
            phase("spmd", part=label, card=card, rows=len(got), rungs=mv,
                  cold_ms=ms, max_rel_err=rel)
        check_not_degraded(ct, "spmd_engine")
        del ct, cpu, tables, got, want_c
    finally:
        pm.reset_default_mesh(device)
        pm.reset_default_mesh("cpu")
    gc.collect()
    phase("spmd", part="done", card=card,
          seconds=time.perf_counter() - t_phase)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs on the card only")
    from dask_sql_tpu_torch import _build
    from dask_sql_tpu_torch.ops import segsum
    from dask_sql_tpu_torch.utils import TRANSFER_STATS

    # 1. card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    phase("card", nvidia_smi=card, kind=kind, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build: every kernel source at once, and the native planner beside
    # them
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(_build.native_library)
        built = _build.build()
        native_path = native.result()
    phase("build", seconds=time.perf_counter() - t0, compiled=built,
          native_planner=native_path.name)

    # 3. each kernel against its plain version, at the main path's shapes
    q1_domain, q1_k, q1_counts = 12, 13, 6
    gid, cols = segsum_inputs(N_ROWS, q1_domain, q1_k, q1_counts, seed=1)
    q1_err = check_kernel(segsum, gid, cols, q1_domain, q1_counts, "q1_shape")
    for label, n, domain, k, counts, stray in (
            ("domain_1", 100_003, 1, 3, 1, False),
            ("domain_2048_two_chunks", 1_000_000, 2048, 20, 2, False),
            ("ragged_block_stray_ids", 1_000_003, 12, 13, 6, True),
            ("empty", 0, 12, 13, 6, False)):
        g_, c_ = segsum_inputs(n, domain, k, counts, seed=2, stray_ids=stray)
        check_kernel(segsum, g_, c_, domain, counts, label)
    del g_, c_
    # the typed columns the reducer hands the kernel, read where they lie
    tgid, tcols = typed_inputs(N_ROWS, q1_domain, seed=3)
    typed_err = check_typed(segsum, tgid, tcols, q1_domain, "typed_q1_shape")
    for label, n, domain, stray in (
            ("typed_misaligned_views", 1_000_001, 12, True),
            ("typed_domain_2048", 1_000_000, 2048, False),
            # chunks of 6 columns: one of counts, one of float sums
            ("typed_domain_4096_mixed_chunks", 1_000_000, 4096, False),
            ("typed_ragged_stray_ids", 1_000_003, 12, True),
            ("typed_40_columns", 100_003, 12, True),
            # one partial a block, the ids split among its warps
            ("typed_max_domain_split", 1_000_000, segsum.KERNEL_MAX_DOMAIN,
             False),
            ("typed_empty", 0, 12, False)):
        g_, c_ = typed_inputs(n, domain, seed=4, stray_ids=stray)
        if label == "typed_misaligned_views":
            g_ = misaligned(g_)
            c_ = [(misaligned(d), None if m is None else misaligned(m))
                  for d, m in c_]
        if label == "typed_40_columns":
            c_ = (c_ * 4)[:40]
        check_typed(segsum, g_, c_, domain, label)
    del g_, c_
    # the kernel's plan takes the domain the router may send it, no more
    g_, c_ = typed_inputs(4, 1, seed=5)
    segsum.launch_geometry(g_, c_, segsum.KERNEL_MAX_DOMAIN)
    try:
        segsum.launch_geometry(g_, c_, segsum.KERNEL_MAX_DOMAIN + 1)
        fail("segsum plans a domain above KERNEL_MAX_DOMAIN")
    except ValueError:
        pass
    phase("segsum_check", case="max_domain", domain=segsum.KERNEL_MAX_DOMAIN)
    del g_, c_
    repeatability(segsum, card)

    # 4. Q1 at SF1 through the port's entry points, on the card, over the
    # columns the reference loads (each path runs with the launch counts
    # set to 0 just before it)
    t0 = time.perf_counter()
    df = gen_lineitem(N_ROWS)
    want = q1_oracle(df)
    gen_s = time.perf_counter() - t0
    # card memory before each phase: its Contexts must give it back
    mem0 = card_allocated()
    c, q1_hbm, load_s = load_tables({"lineitem": df})
    setup_s = gen_s + load_s
    reset_launches(segsum)
    TRANSFER_STATS["d2h"] = 0
    t0 = time.perf_counter()
    got = c.sql(QUERY).compute()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(segsum.LAUNCHES)
    d2h = TRANSFER_STATS["d2h"]
    if launches["segsum"] != 1:
        fail(f"Q1 launched the segsum kernel {launches} times, expected once")
    if d2h != 1:
        fail(f"Q1 made {d2h} device-to-host transfers, expected 1")
    q1_rel = check_q1(got, want, "Q1")
    # the reference's counts on these frames: the date filter on the codes,
    # the 6 group rows decoded on the host, 2 encoded columns
    check_counters(c, "Q1", encoded_columns=2, codespace_pred=1, late_rows=6)
    phase("q1_sf1", rows=N_ROWS, groups=len(got), setup_s=setup_s,
          load_s=load_s, first_ms=first_ms, launches=launches, d2h=d2h,
          max_rel_err=q1_rel, codespace_pred=1, late_rows=6)

    # 5. times, beside the card's name and power limit
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        c.sql(QUERY).compute()
        runs.append((time.perf_counter() - t0) * 1e3)
    q1_ms = float(np.median(runs))
    phase("q1_time", card=card, ms=q1_ms, runs_ms=runs,
          rows_per_s=N_ROWS / (q1_ms / 1e3))

    # 6. Q1's planning: cold with the native planner (parse, bind, the rule
    # loop and join reordering in C++), cold with the Python planner, and
    # from the plan cache
    python_plan = {"sql.native.binder": "off"}
    binders = ("planner.native.plan", "planner.native.bind",
               "planner.python.bind")
    cold_plan, python_cold_plan, warm_plan = [], [], []
    ran = {}
    for options, runs_ in ((None, cold_plan), (python_plan, python_cold_plan)):
        before = {k: c.metrics.counter(k) for k in binders}
        for _ in range(WARM_RUNS):
            c._plan_cache.clear()
            t0 = time.perf_counter()
            c.sql(QUERY, config_options=options)
            runs_.append((time.perf_counter() - t0) * 1e3)
            if options is None:
                t0 = time.perf_counter()
                c.sql(QUERY)
                warm_plan.append((time.perf_counter() - t0) * 1e3)
        ran["python" if options else "native"] = {
            k: c.metrics.counter(k) - before[k] for k in binders
            if c.metrics.counter(k) != before[k]}
    if ran["native"] != {"planner.native.plan": WARM_RUNS}:
        fail(f"the native planner did not plan Q1: {ran['native']}")
    if ran["python"] != {"planner.python.bind": WARM_RUNS}:
        fail(f"sql.native.binder = off did not plan in Python: {ran['python']}")
    if c.metrics.counter("planner.optimize.fallback"):
        fail("the optimizer fell back to an unoptimized plan")
    phase("plan", card=card, query="q1", cold_ms=float(np.median(cold_plan)),
          python_cold_ms=float(np.median(python_cold_plan)),
          warm_ms=float(np.median(warm_plan)), cold_runs_ms=cold_plan,
          python_cold_runs_ms=python_cold_plan, warm_runs_ms=warm_plan,
          binders=ran)

    # 6b. plan families: Q1 with three new date literals.  The first builds
    # the fused pipeline of the family, the next two reuse it
    # (``families.hit``), each with one transfer and its own answer
    from dask_sql_tpu_torch.physical import compiled as compiled_agg

    compiled_agg._cache.clear()
    family_runs = []
    for i, date in enumerate(FAMILY_DATES):
        sql = QUERY.replace("DATE '1998-09-02'", f"DATE '{date}'")
        fam_want = q1_oracle(df, date)
        hits = c.metrics.counter("families.hit")
        TRANSFER_STATS["d2h"] = 0
        t0 = time.perf_counter()
        got = c.sql(sql).compute()
        ms = (time.perf_counter() - t0) * 1e3
        if TRANSFER_STATS["d2h"] != 1:
            fail(f"Q1 on {date} made {TRANSFER_STATS['d2h']} transfers")
        if c.metrics.counter("families.hit") - hits != (1 if i else 0):
            fail(f"Q1 on {date}: families.hit moved "
                 f"{c.metrics.counter('families.hit') - hits}, "
                 f"expected {1 if i else 0}")
        rel = check_q1(got, fam_want, f"Q1 on {date}")
        warm = warm_runs(c, sql, TRANSFER_STATS,
                         lambda g, w=fam_want, d=date: check_q1(g, w, d))
        family_runs.append({"date": date, "first_ms": ms,
                            "warm_ms": float(np.median(warm)),
                            "pipeline": "hit" if i else "built",
                            "max_rel_err": rel})
    if len(compiled_agg._cache) != 1:
        fail(f"the family built {len(compiled_agg._cache)} pipelines")
    phase("families", card=card, query="q1", runs=family_runs,
          parameterized=c.metrics.counter("families.parameterized"),
          hits=c.metrics.counter("families.hit"))

    # 7. the same Q1 over PLAIN columns, timed beside the encoded one in
    # turns (encoded, plain, ...)
    cp, plain_hbm, plain_load_s = load_tables(
        {"lineitem": df}, {"columnar.encoding": "off"})
    if cp.schema["root"].tables["lineitem"].table.has_encoded_columns():
        fail("columnar.encoding = off loaded an encoded column")
    reset_launches(segsum)
    TRANSFER_STATS["d2h"] = 0
    plain_rel = check_q1(cp.sql(QUERY).compute(), want, "Q1 on PLAIN columns")
    plain_launches = dict(segsum.LAUNCHES)
    if plain_launches["segsum"] != 1 or TRANSFER_STATS["d2h"] != 1:
        fail(f"Q1 on PLAIN columns: {plain_launches} launches, "
             f"{TRANSFER_STATS['d2h']} transfers")
    enc_runs, plain_runs = [], []
    for _ in range(WARM_RUNS):
        for ctx, runs_ in ((c, enc_runs), (cp, plain_runs)):
            t0 = time.perf_counter()
            ctx.sql(QUERY).compute()
            runs_.append((time.perf_counter() - t0) * 1e3)
    phase("q1_plain", card=card, rows=N_ROWS, load_s=plain_load_s,
          launches=plain_launches, max_rel_err=plain_rel,
          ms=float(np.median(plain_runs)), runs_ms=plain_runs,
          encoded_ms=float(np.median(enc_runs)), encoded_runs_ms=enc_runs)
    check_encodings(c, {"lineitem": df}, "q1_lineitem", q1_hbm, plain_hbm)
    check_not_degraded(c, "q1")
    check_not_degraded(cp, "q1_plain")
    # the loop's `ctx` names the PLAIN Context too: both go
    del cp, ctx

    # 8. bench.py's root top-k select over the same 6M encoded rows, and a
    # select filtered on a DICT column
    flags_want, rev_want = select_oracle(df)
    sel_rel = [0.0]

    def check_select(got):
        if list(got.columns) != ["l_returnflag", "rev"] or len(got) != 100:
            fail(f"select result shape {got.shape} / {list(got.columns)}")
        if got["l_returnflag"].tolist() != flags_want.tolist():
            fail("select rows or their order differ from the oracle")
        sel_rel[0] = max(sel_rel[0], max_rel(got["rev"], rev_want))
        if not sel_rel[0] <= REL_BOUND:
            fail(f"select relative error {sel_rel[0]} > {REL_BOUND}")

    reset_launches(segsum)
    sel_cold, sel_runs, sel_phases = run_select(
        c, SELECT_QUERY, TRANSFER_STATS, check_select, "select")
    survivors = int((df.l_discount.to_numpy() > np.float32(0.09)).sum())
    phase("select", card=card, rows=N_ROWS, survivors=survivors,
          bucket=1 << (survivors - 1).bit_length(), cold_ms=sel_cold,
          ms=float(np.median(sel_runs)), runs_ms=sel_runs,
          rows_per_s=N_ROWS / (float(np.median(sel_runs)) / 1e3),
          phases_ms=sel_phases, d2h=2, launches=dict(segsum.LAUNCHES),
          max_rel_err=sel_rel[0])

    dict_want = dict_select_oracle(df)
    pred_before = c.metrics.counter("columnar.encoding.codespace_pred")

    def check_dict_select(got):
        if len(got) != 100:
            fail(f"DICT select gave {len(got)} rows")
        for name in ("l_shipdate", "l_quantity"):
            if got[name].tolist() != dict_want[name].tolist():
                fail(f"DICT select {name} differs from the oracle")
        if got["l_extendedprice"].tolist() != dict_want["l_extendedprice"].tolist():
            fail("DICT select prices differ from the oracle")

    late_before = c.metrics.counter("columnar.encoding.late_rows")
    dsel_cold, dsel_runs, dsel_phases = run_select(
        c, DICT_SELECT_QUERY, TRANSFER_STATS, check_dict_select, "DICT select")
    if c.metrics.counter("columnar.encoding.codespace_pred") \
            != pred_before + 1:
        fail("the DICT select's filter did not run on the codes")
    late = c.metrics.counter("columnar.encoding.late_rows") - late_before
    if late != 100 * (1 + WARM_RUNS):
        fail(f"the DICT select decoded {late} rows late")
    dsurv = int((df.l_quantity.to_numpy() < np.float32(10)).sum())
    phase("select_dict", card=card, rows=N_ROWS, survivors=dsurv,
          bucket=1 << (dsurv - 1).bit_length(), cold_ms=dsel_cold,
          ms=float(np.median(dsel_runs)), runs_ms=dsel_runs,
          phases_ms=dsel_phases, d2h=2, codespace_pred=1,
          late_rows_per_query=100)
    check_not_degraded(c, "select")

    # 8b. the `surface` phase on Q1's table: INSERT INTO appends in place,
    # and Q1 after them on a new plan and pipeline
    surface_q1_launches = surface_q1(c, df, card, segsum, TRANSFER_STATS)
    del c, got
    check_card_freed(mem0, "q1_select_surface")
    # 8c. the `files` phase on the same rows written as parquet files:
    # lazy, streamed, persisted, and the root select over them
    mem0 = card_allocated()
    files_q1_out = files_q1(df, want, q1_hbm, card, segsum, TRANSFER_STATS)
    check_card_freed(mem0, "files_q1")
    # 8d. the `resilience` phase on the same rows: the ladder's rungs under
    # injected and real failures, the breaker, a verifier skip, EXPLAIN
    mem0 = card_allocated()
    resilience_out = resilience(df, want, card, segsum, TRANSFER_STATS)
    check_card_freed(mem0, "resilience")
    # 8e. the `observability` phase on the same rows: EXPLAIN ANALYZE, the
    # cost of the lifecycle spans, SHOW METRICS and SHOW PROFILES
    mem0 = card_allocated()
    observability_out = observability(df, want, card, segsum,
                                      TRANSFER_STATS)
    check_card_freed(mem0, "observability")
    # 8f. the `streamed` phase on the same rows: Q1 and the root select in
    # partitions under an admission budget
    mem0 = card_allocated()
    streamed_out = streamed(df, want, card, segsum)
    check_card_freed(mem0, "streamed")

    # 9. TPC-H Q3 through the compiled join->aggregate pipeline, over the
    # encoded columns
    from dask_sql_tpu_torch.physical import compiled_join
    from tests.tpch import QUERIES, generate

    t0 = time.perf_counter()
    all_tables = generate(scale_rows=Q3_ROWS, seed=7)
    gen3_s = time.perf_counter() - t0
    # 8g. the `pressure` and `coldstart` phases on Q1's rows and these
    # frames: bands, reclaim, a rescued OOM, CRITICAL; checkpoints, the
    # warm-up, a hung build, a background recompile, the compile cache
    mem0 = card_allocated()
    pressure_out = pressure(df, want, all_tables, card, segsum)
    check_card_freed(mem0, "pressure")
    mem0 = card_allocated()
    coldstart_out = coldstart(df, want, all_tables, card, segsum)
    check_card_freed(mem0, "coldstart")
    # 8h. the `reuse` and `server` phases: semantic reuse (incremental
    # folds, subsumption, a pinned stem) and the front ends on the card
    mem0 = card_allocated()
    reuse_out = reuse(df, want, all_tables, card, segsum, TRANSFER_STATS)
    check_card_freed(mem0, "reuse")
    mem0 = card_allocated()
    server_out = server(df, want, card, segsum)
    check_card_freed(mem0, "server")
    # 8i. the `surface_rest`, `chaos` and `selflint` phases: the frame and
    # Context methods on Q1's rows, a chaos campaign on the card, and the
    # port's self-lint
    mem0 = card_allocated()
    surface_rest_out = surface_rest(df, want, card, segsum, TRANSFER_STATS)
    check_card_freed(mem0, "surface_rest")
    mem0 = card_allocated()
    chaos_out = chaos(card, segsum)
    check_card_freed(mem0, "chaos")
    # 8j. the `ml` phase: CREATE MODEL over Q1's rows, PREDICT on the
    # fused rung, the host tier, the model tier, the drawn ensembles
    mem0 = card_allocated()
    t0 = time.perf_counter()
    ml_out = ml_phase(df, card, segsum, TRANSFER_STATS)
    ml_s = time.perf_counter() - t0
    ml_after = card_allocated()
    phase("ml", part="card_memory", card=card, seconds=ml_s,
          allocated_before=mem0, allocated_after=ml_after,
          equal=ml_after == mem0)
    check_card_freed(mem0, "ml")
    # 8k. the `spmd` phase: sharded tables on shards of the card, the
    # sharded rungs and the collectives engine
    mem0 = card_allocated()
    spmd_out = spmd_phase(df, want, all_tables, card, segsum, TRANSFER_STATS)
    check_card_freed(mem0, "spmd")
    selflint(card)
    t0 = time.perf_counter() - gen3_s
    tables = {n: all_tables[n] for n in ("customer", "orders", "lineitem")}
    mem0 = card_allocated()
    c3, q3_hbm, q3_load_s = load_tables(tables)
    q3_setup_s = time.perf_counter() - t0
    check_encodings(c3, tables, "q3_tables", q3_hbm)
    q3_want = q3_oracle(tables)
    q3_rel = [0.0]

    def check_q3(got):
        if list(got.columns) != list(q3_want.columns) or len(got) != 10:
            fail(f"Q3 result shape {got.shape} / columns {list(got.columns)}")
        for key in Q3_KEYS:
            if got[key].tolist() != q3_want[key].tolist():
                fail(f"Q3 {key} differs from the oracle")
        rel = max_rel(got["revenue"], q3_want["revenue"])
        if not rel <= Q3_REL:
            fail(f"Q3 revenue relative error {rel} > {Q3_REL}")
        q3_rel[0] = max(q3_rel[0], rel)

    reset_launches(segsum)
    TRANSFER_STATS["d2h"] = 0
    t0 = time.perf_counter()
    got = c3.sql(QUERIES[3]).compute()
    q3_cold_ms = (time.perf_counter() - t0) * 1e3
    q3_cold_d2h = TRANSFER_STATS["d2h"]
    check_q3(got)
    # the probe side's shipdate filter runs on its DICT codes (the
    # reference counts 1 on these frames: l_orderkey is FOR at this scale)
    if c3.metrics.counter("columnar.encoding.codespace_pred") != 1:
        fail(f"Q3 code-space predicates "
             f"{c3.metrics.counter('columnar.encoding.codespace_pred')}, "
             "expected 1")
    q3_late = c3.metrics.counter("columnar.encoding.late_rows")
    q3_runs = warm_runs(c3, QUERIES[3], TRANSFER_STATS, check_q3)
    q3_launches = dict(segsum.LAUNCHES)
    if c3.metrics.counter("compiled_join.run") != 1 + WARM_RUNS:
        fail(f"Q3 ran the join pipeline "
             f"{c3.metrics.counter('compiled_join.run')} "
             f"times in {1 + WARM_RUNS} runs")
    if c3.metrics.counter("planner.optimize.fallback"):
        fail("the optimizer fell back to an unoptimized plan for Q3")
    pipe = next(reversed(compiled_join._cache.values()))
    q3_ms = float(np.median(q3_runs))
    phase("q3", card=card, scale_rows=Q3_ROWS, setup_s=q3_setup_s,
          cold_ms=q3_cold_ms, cold_d2h=q3_cold_d2h, ms=q3_ms,
          runs_ms=q3_runs, rows_per_s=Q3_ROWS / (q3_ms / 1e3),
          join_pipeline_runs=c3.metrics.counter("compiled_join.run"),
          gid="pointer" if pipe.gid_join is not None else "radix",
          group_domain=pipe.domain, segsum_mode=pipe.segsum_mode,
          launches=q3_launches, max_rel_err=q3_rel[0],
          codespace_pred=c3.metrics.counter(
              "columnar.encoding.codespace_pred"),
          late_rows_per_query=q3_late,
          scan_decodes=c3.metrics.counter("columnar.encoding.decode"))
    check_not_degraded(c3, "q3")
    # the `resilience` phase's EXPLAIN LINT / ESTIMATE and bounds for Q3
    # the join's output has no finite bound in the reference's model,
    # which hi keeps at least: loose
    explain_and_bounds(c3, QUERIES[3], "q3", card, tight=False)
    check_not_degraded(c3, "q3")
    # 9b. the `serving` phase: Q1's rows and Q3's frames through the
    # serving tier (its Contexts and workers gone after it)
    mem_serving = card_allocated()
    serving_out = serving(df, c3, check_q3, QUERIES, card, segsum)
    check_card_freed(mem_serving, "serving")
    del c3, tables, got, pipe, df
    check_card_freed(mem0, "q3")

    # 10. TPC-H q5-q19 on the same frames, all eight tables: the eager
    # aggregate (q5, q7, q8, q9, q10, q12) and the compiled rungs (q14,
    # q17, q19), each held against the port on the CPU (plain kernels) and
    # q14 and q19 against float64 pandas too
    mem0 = card_allocated()
    tpch_launches, ct, cpu = tpch_more(all_tables, card, segsum,
                                       TRANSFER_STATS)
    # 10b. the `surface` phase on those frames: the DDL script, the
    # function registry, a registered function and aggregation
    surface_launches = surface_sql(ct, cpu, all_tables, card, segsum,
                                   TRANSFER_STATS)
    # how often the ladder's cost-based skip chose a lower rung on the card
    # over these queries, by rung, beside the CPU's count on the same runs
    phase("cost_skip", card=card, card_skips={
        k: v for k, v in counters(ct).items()
        if k.startswith("serving.scheduler.cost_rung_skip")},
        cpu_skips={k: v for k, v in counters(cpu).items()
                   if k.startswith("serving.scheduler.cost_rung_skip")},
        builds={k: v["count"] for k, v in ct.metrics.snapshot()[
            "histograms"].items() if k.startswith("resilience.compile_ms.")})
    del ct, cpu
    check_card_freed(mem0, "tpch_more_surface_sql")
    # 10c. the `files` phase on Q3's frames: lineitem streamed from parquet
    # through the joins, customer from a CSV file
    mem0 = card_allocated()
    files_q3_out = files_q3({n: all_tables[n] for n in
                             ("customer", "orders", "lineitem")},
                            card, segsum, TRANSFER_STATS)
    del all_tables
    check_card_freed(mem0, "files_q3")
    mem0 = card_allocated()
    q15_launches = q15_on_the_kernel(card, segsum, TRANSFER_STATS)
    check_card_freed(mem0, "q15_kernel")

    # 10. a star join through the pipeline into the segment-sum kernel
    t0 = time.perf_counter()
    star = gen_star(STAR_ROWS)
    mem0 = card_allocated()
    cs = measuring_context()
    for name, frame in star.items():
        cs.create_table(name, frame)
    torch.cuda.synchronize()
    star_setup_s = time.perf_counter() - t0
    star_want = star_oracle(star)
    star_rel = [0.0]

    def check_star(got):
        if got["d1_cat"].tolist() != star_want["d1_cat"].tolist():
            fail("star join groups differ from the oracle")
        if got["n"].tolist() != star_want["n"].tolist():
            fail("star join counts differ from the oracle")
        rel = max_rel(got["s"], star_want["s"])
        if not rel <= REL_BOUND:
            fail(f"star join relative error {rel} > {REL_BOUND}")
        star_rel[0] = max(star_rel[0], rel)

    reset_launches(segsum)
    t0 = time.perf_counter()
    check_star(cs.sql(STAR_QUERY).compute())
    star_cold_ms = (time.perf_counter() - t0) * 1e3
    star_runs = warm_runs(cs, STAR_QUERY, TRANSFER_STATS, check_star)
    star_launches = dict(segsum.LAUNCHES)
    if star_launches["segsum"] < 1 + WARM_RUNS:
        fail(f"the star join launched the segsum kernel {star_launches} "
             f"times in {1 + WARM_RUNS} runs")
    if cs.metrics.counter("compiled_join.run") != 1 + WARM_RUNS:
        fail("the star join did not run through the join pipeline")
    # the kernel against its plain version on the call the star join makes
    captured = []
    typed = segsum.segsum_typed

    def capture(gid, columns, domain):
        captured.append((gid, list(columns), domain))
        return typed(gid, columns, domain)

    segsum.segsum_typed = capture
    try:
        cs.sql(STAR_QUERY).compute()
    finally:
        segsum.segsum_typed = typed
    star_gid, star_cols, star_domain = captured[0]
    star_err = check_typed(segsum, star_gid, star_cols, star_domain,
                           "join_star_call")
    star_ms = float(np.median(star_runs))
    phase("join_star", card=card, rows=STAR_ROWS, setup_s=star_setup_s,
          cold_ms=star_cold_ms, ms=star_ms, runs_ms=star_runs,
          rows_per_s=STAR_ROWS / (star_ms / 1e3), launches=star_launches,
          group_domain=star_domain, k=len(star_cols),
          max_rel_err=star_rel[0], kernel_max_abs_err=star_err)
    check_not_degraded(cs, "join_star")
    del cs, star, captured, star_gid, star_cols
    check_card_freed(mem0, "join_star")

    # 11. TPC-DS: the set operations, window functions and the rest of
    # the evaluator on all 24 tables
    mem0 = card_allocated()
    tpcds_launches = tpcds(card, segsum, TRANSFER_STATS)
    check_card_freed(mem0, "tpcds")

    rate = memory_rate(kind)
    # the typed call Q1 makes: 11 columns read in place
    tk = len(tcols)
    typed = lambda: segsum.segsum_typed(tgid, tcols, q1_domain)  # noqa: E731
    t_ms, t_host_us = card_ms(typed, 20)
    t_unspun_ms = cuda_ms(typed, 20)
    t_plain_ms = cuda_ms(
        lambda: segsum.segsum_typed_plain(tgid, tcols, q1_domain), 5)
    tsrc64 = torch.stack([d.to(torch.float64) if m is None else
                          torch.where(m, d.to(torch.float64), 0.0)
                          for d, m in tcols], dim=1)
    t_library_ms = cuda_ms(lambda: torch.zeros(
        q1_domain, tk, dtype=torch.float64, device="cuda").index_add_(
            0, tgid, tsrc64), 5)
    del tsrc64
    t_bytes = typed_bytes(tgid, tcols, q1_domain)
    t_bytes_ms = t_bytes / rate * 1e3
    t_ops_ms = typed_adds(tgid, tcols, q1_domain) / FP64_RATE * 1e3
    t_bound_ms = max(t_bytes_ms, t_ops_ms)
    kc, warps, blocks = segsum.launch_geometry(tgid, tcols, q1_domain)
    phase("segsum_time", shape="typed_q1", card=card, n=N_ROWS,
          domain=q1_domain, k=tk, warps=warps, blocks=blocks, ms=t_ms,
          host_us=t_host_us, unspun_ms=t_unspun_ms, plain_ms=t_plain_ms,
          library_ms=t_library_ms, bound_us=t_bound_ms * 1e3, bytes=t_bytes,
          share_of_bound=t_bound_ms / t_ms)

    # the [k, n] float32 stack of earlier work: 13 columns
    stacked = lambda: segsum.segsum_columns(gid, cols, q1_domain)  # noqa: E731
    kernel_ms, host_us = card_ms(stacked, 20)
    unspun_ms = cuda_ms(stacked, 20)
    plain_ms = cuda_ms(lambda: segsum.segsum_plain(gid, cols.t(), q1_domain), 5)
    src64 = cols.t().to(torch.float64).contiguous()
    library_ms = cuda_ms(lambda: torch.zeros(q1_domain, q1_k, dtype=torch.float64,
                                             device="cuda").index_add_(0, gid, src64), 5)
    n_bytes = N_ROWS * (4 + 4 * q1_k) + q1_domain * q1_k * 8
    bytes_ms = n_bytes / rate * 1e3
    ops_ms = N_ROWS * q1_k / FP64_RATE * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    kc, warps, blocks = segsum.launch_geometry(
        gid, [(c, None) for c in cols.unbind(0)], q1_domain)
    phase("segsum_time", shape="stacked_q1", card=card, n=N_ROWS,
          domain=q1_domain, k=q1_k, warps=warps, blocks=blocks,
          ms=kernel_ms, host_us=host_us, unspun_ms=unspun_ms,
          plain_ms=plain_ms, library_ms=library_ms, bound_us=bound_ms * 1e3,
          bytes=n_bytes, share_of_bound=bound_ms / kernel_ms)

    print(json.dumps({"kernels": [{
        "name": "segsum",
        "route": "cuda",
        "source": "dask_sql_tpu_torch/csrc/segsum.cu",
        "replaces": "dask_sql_tpu/ops/pallas_kernels.py:99",
        "launches": launches["segsum"],
        "launches_by_path": {"q1_sf1": launches["segsum"],
                             "q1_plain": plain_launches["segsum"],
                             "q3": q3_launches["segsum"],
                             "join_star": star_launches["segsum"],
                             **{f"tpch_q{q}": n for q, n in
                                tpch_launches["launches"].items()},
                             "tpch_q15_kernel_route": q15_launches,
                             **{f"tpcds_q{q}": n for q, n in
                                tpcds_launches["launches"].items()},
                             "surface_q1_after_insert":
                                 surface_q1_launches["launches"],
                             **surface_launches["launches"],
                             "files_q1_streamed":
                                 files_q1_out["files_q1_streamed"],
                             "files_q1_persisted":
                                 files_q1_out["files_q1_persisted"],
                             "files_q3_streamed": files_q3_out["launches"],
                             **resilience_out["launches"],
                             **observability_out["launches"],
                             **streamed_out["launches"],
                             **pressure_out["launches"],
                             **coldstart_out["launches"],
                             **reuse_out["launches"],
                             "server_q1_family":
                                 server_out["launches"]["segsum"],
                             **surface_rest_out["launches"],
                             **chaos_out["launches"],
                             **ml_out["launches"],
                             **spmd_out["launches"]},
        "max_abs_err": max(typed_err, star_err, tpch_launches["max_abs_err"],
                           tpcds_launches["max_abs_err"],
                           surface_q1_launches["max_abs_err"],
                           surface_launches["max_abs_err"],
                           files_q1_out["max_abs_err"],
                           files_q3_out["max_abs_err"],
                           resilience_out["max_abs_err"],
                           observability_out["max_abs_err"],
                           streamed_out["max_abs_err"],
                           reuse_out["max_abs_err"],
                           surface_rest_out["max_abs_err"],
                           chaos_out["max_abs_err"],
                           spmd_out["max_abs_err"]),
        "ms": t_ms,
        "plain_ms": t_plain_ms,
        "bound_ms": t_bound_ms,
        "bound_by": "bytes" if t_bytes_ms >= t_ops_ms else "operations",
        "library_ms": t_library_ms,
        "host_us": t_host_us,
        "unspun_ms": t_unspun_ms,
        "stacked_ms": kernel_ms,
        "stacked_host_us": host_us,
        "stacked_unspun_ms": unspun_ms,
        "stacked_plain_ms": plain_ms,
        "stacked_bound_ms": bound_ms,
        "stacked_library_ms": library_ms,
        "stacked_max_abs_err": q1_err,
    }, {
        # the family batcher's stacked launch: the same kernel, one call
        # over every member's columns with one member's plan
        "name": "segsum_stacked",
        "route": "cuda",
        "source": "dask_sql_tpu_torch/csrc/segsum.cu",
        "wrapper": "dask_sql_tpu_torch/ops/segsum.py segsum_stacked",
        "replaces": "dask_sql_tpu/ops/pallas_kernels.py:99",
        "batched_path": "dask_sql_tpu/physical/compiled.py:1190",
        "launches": serving_out["launches"],
        "max_abs_err": max(st["max_abs_err"]
                           for st in serving_out["stacks"].values()),
        "ms": serving_out["stacks"][8]["ms"],
        "plain_ms": serving_out["stacks"][8]["plain_ms"],
        "bound_ms": serving_out["stacks"][8]["bound_ms"],
        "bound_by": serving_out["stacks"][8]["bound_by"],
        "library_ms": serving_out["stacks"][8]["library_ms"],
        "members": 8,
        "by_members": {str(b): {k: st[k] for k in (
            "k", "calls", "ms", "solo_calls_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "max_abs_err")}
            for b, st in serving_out["stacks"].items()},
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
