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
nodes that ran.  For each loaded frame
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

import json
import subprocess
import sys
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
#: TPC-DS on the card: `tests/tpcds.py generate(scale_rows=...)`, all 24
#: tables (1,000,000 store_sales rows), every query cold once and warm
#: TPCDS_WARM_RUNS times (fewer than WARM_RUNS, for the time limit)
TPCDS_ROWS = 1_000_000
TPCDS_WARM_RUNS = 3
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
    return {k: v for k, v in c.metrics.items()
            if k.startswith("resilience.")}


def check_not_degraded(c, label) -> None:
    """No rung stepped down: a degradation would hide the card's path."""
    bad = {k: v for k, v in c.metrics.items()
           if k.startswith("resilience.degraded") and v}
    if bad:
        fail(f"{label}: a rung stepped down {bad}")


def max_rel(got, want) -> float:
    g = np.asarray(got, dtype=np.float64)
    w = np.asarray(want, dtype=np.float64)
    if not np.all(np.isfinite(g)):
        fail("a result is not finite")
    return float(np.max(np.abs(g - w) / np.abs(w))) if len(w) else 0.0


def load_tables(frames, options=None):
    """(Context on the card with `frames` registered, card memory the
    tables took in bytes, seconds)."""
    from dask_sql_tpu_torch import Context

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    c = Context(device="cuda")
    c.config.update(options or {})
    for name, frame in frames.items():
        c.create_table(name, frame)
    torch.cuda.synchronize()
    return c, torch.cuda.memory_allocated() - before, time.perf_counter() - t0


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
    observed = c.metrics.observed
    phase("encodings", frame=label, columns=encoded,
          encoded_columns=c.metrics["columnar.encoding.encoded_columns"],
          hbm_bytes=hbm_bytes, plain_hbm_bytes=plain_hbm_bytes,
          encoded_bytes=sum(observed.get("columnar.encoding.encoded_bytes", [])),
          decoded_bytes=sum(observed.get("columnar.encoding.decoded_bytes", [])),
          decoded_equal_plain=True)


def check_counters(c, label, **want) -> None:
    """``columnar.encoding.<name>`` counters of `c` against `want`."""
    got = {k: c.metrics[f"columnar.encoding.{k}"] for k in want}
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
        rung = c.metrics["resilience.rung.compiled_select"]
        transfers["d2h"] = 0
        t0 = time.perf_counter()
        got = c.sql(sql).compute()
        ms = (time.perf_counter() - t0) * 1e3
        if c.metrics["resilience.rung.compiled_select"] != rung + 1:
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
        hits = c.metrics["query.plan_cache.hit"]
        transfers["d2h"] = 0
        t0 = time.perf_counter()
        got = c.sql(sql).compute()
        runs.append((time.perf_counter() - t0) * 1e3)
        if c.metrics["query.plan_cache.hit"] != hits + 1:
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


def check_typed(segsum, gid, columns, domain, label):
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
    max_abs = float(err.max()) if err.numel() else 0.0
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
    from dask_sql_tpu_torch import Context

    cpu = Context(device="cpu")
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
    Returns {"launches": {query: n}, "max_abs_err": x}: the kernel is also
    held against its plain version on a call q4, q9, q22 (eager) and q14
    (join pipeline) make."""
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


def tpcds(card, segsum, transfers):
    """The `tpcds` phase: every TPC-DS query on `tests/tpcds.py
    generate(scale_rows=TPCDS_ROWS)` loaded on the card with the
    reference's encodings, cold once and TPCDS_WARM_RUNS times warm, each
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
            for i in range(1 + TPCDS_WARM_RUNS):
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
            expected = {k: v * (1 + TPCDS_WARM_RUNS)
                        for k, v in cpu_rungs.items()}
            if rungs != expected:
                fail(f"TPC-DS q{q} answered on rungs {rungs}, the CPU on "
                     f"{expected}")
            check_not_degraded(ct, f"tpcds q{q}")
            runs_per_query = 1 + TPCDS_WARM_RUNS
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
    return {"launches": launches, "max_abs_err": err}


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs on the card only")
    from dask_sql_tpu_torch import Context, _build
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
        before = {k: c.metrics[k] for k in binders}
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
            k: c.metrics[k] - before[k] for k in binders if c.metrics[k] != before[k]}
    if ran["native"] != {"planner.native.plan": WARM_RUNS}:
        fail(f"the native planner did not plan Q1: {ran['native']}")
    if ran["python"] != {"planner.python.bind": WARM_RUNS}:
        fail(f"sql.native.binder = off did not plan in Python: {ran['python']}")
    if c.metrics["planner.optimize.fallback"]:
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
        hits = c.metrics["families.hit"]
        TRANSFER_STATS["d2h"] = 0
        t0 = time.perf_counter()
        got = c.sql(sql).compute()
        ms = (time.perf_counter() - t0) * 1e3
        if TRANSFER_STATS["d2h"] != 1:
            fail(f"Q1 on {date} made {TRANSFER_STATS['d2h']} transfers")
        if c.metrics["families.hit"] - hits != (1 if i else 0):
            fail(f"Q1 on {date}: families.hit moved "
                 f"{c.metrics['families.hit'] - hits}, expected {1 if i else 0}")
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
          parameterized=c.metrics["families.parameterized"],
          hits=c.metrics["families.hit"])

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
    del cp

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
    pred_before = c.metrics["columnar.encoding.codespace_pred"]

    def check_dict_select(got):
        if len(got) != 100:
            fail(f"DICT select gave {len(got)} rows")
        for name in ("l_shipdate", "l_quantity"):
            if got[name].tolist() != dict_want[name].tolist():
                fail(f"DICT select {name} differs from the oracle")
        if got["l_extendedprice"].tolist() != dict_want["l_extendedprice"].tolist():
            fail("DICT select prices differ from the oracle")

    late_before = c.metrics["columnar.encoding.late_rows"]
    dsel_cold, dsel_runs, dsel_phases = run_select(
        c, DICT_SELECT_QUERY, TRANSFER_STATS, check_dict_select, "DICT select")
    if c.metrics["columnar.encoding.codespace_pred"] != pred_before + 1:
        fail("the DICT select's filter did not run on the codes")
    late = c.metrics["columnar.encoding.late_rows"] - late_before
    if late != 100 * (1 + WARM_RUNS):
        fail(f"the DICT select decoded {late} rows late")
    dsurv = int((df.l_quantity.to_numpy() < np.float32(10)).sum())
    phase("select_dict", card=card, rows=N_ROWS, survivors=dsurv,
          bucket=1 << (dsurv - 1).bit_length(), cold_ms=dsel_cold,
          ms=float(np.median(dsel_runs)), runs_ms=dsel_runs,
          phases_ms=dsel_phases, d2h=2, codespace_pred=1,
          late_rows_per_query=100)
    check_not_degraded(c, "select")
    del c, df, got

    # 9. TPC-H Q3 through the compiled join->aggregate pipeline, over the
    # encoded columns
    from dask_sql_tpu_torch.physical import compiled_join
    from tests.tpch import QUERIES, generate

    t0 = time.perf_counter()
    all_tables = generate(scale_rows=Q3_ROWS, seed=7)
    tables = {n: all_tables[n] for n in ("customer", "orders", "lineitem")}
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
    if c3.metrics["columnar.encoding.codespace_pred"] != 1:
        fail(f"Q3 code-space predicates "
             f"{c3.metrics['columnar.encoding.codespace_pred']}, expected 1")
    q3_late = c3.metrics["columnar.encoding.late_rows"]
    q3_runs = warm_runs(c3, QUERIES[3], TRANSFER_STATS, check_q3)
    q3_launches = dict(segsum.LAUNCHES)
    if c3.metrics["compiled_join.run"] != 1 + WARM_RUNS:
        fail(f"Q3 ran the join pipeline {c3.metrics['compiled_join.run']} "
             f"times in {1 + WARM_RUNS} runs")
    if c3.metrics["planner.optimize.fallback"]:
        fail("the optimizer fell back to an unoptimized plan for Q3")
    pipe = next(reversed(compiled_join._cache.values()))
    q3_ms = float(np.median(q3_runs))
    phase("q3", card=card, scale_rows=Q3_ROWS, setup_s=q3_setup_s,
          cold_ms=q3_cold_ms, cold_d2h=q3_cold_d2h, ms=q3_ms,
          runs_ms=q3_runs, rows_per_s=Q3_ROWS / (q3_ms / 1e3),
          join_pipeline_runs=c3.metrics["compiled_join.run"],
          gid="pointer" if pipe.gid_join is not None else "radix",
          group_domain=pipe.domain, segsum_mode=pipe.segsum_mode,
          launches=q3_launches, max_rel_err=q3_rel[0],
          codespace_pred=c3.metrics["columnar.encoding.codespace_pred"],
          late_rows_per_query=q3_late,
          scan_decodes=c3.metrics["columnar.encoding.decode"])
    check_not_degraded(c3, "q3")
    del c3, tables, got

    # 10. TPC-H q5-q19 on the same frames, all eight tables: the eager
    # aggregate (q5, q7, q8, q9, q10, q12) and the compiled rungs (q14,
    # q17, q19), each held against the port on the CPU (plain kernels) and
    # q14 and q19 against float64 pandas too
    tpch_launches = tpch_more(all_tables, card, segsum, TRANSFER_STATS)
    del all_tables
    q15_launches = q15_on_the_kernel(card, segsum, TRANSFER_STATS)

    # 10. a star join through the pipeline into the segment-sum kernel
    t0 = time.perf_counter()
    star = gen_star(STAR_ROWS)
    cs = Context(device="cuda")
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
    if cs.metrics["compiled_join.run"] != 1 + WARM_RUNS:
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

    # 11. TPC-DS: the set operations, window functions and the rest of
    # the evaluator on all 24 tables
    tpcds_launches = tpcds(card, segsum, TRANSFER_STATS)

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
                                tpcds_launches["launches"].items()}},
        "max_abs_err": max(typed_err, star_err, tpch_launches["max_abs_err"],
                           tpcds_launches["max_abs_err"]),
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
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
