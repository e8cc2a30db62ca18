"""Chip smoke test of the PyTorch port on one CUDA card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds every kernel of the port from ``dask_sql_tpu_torch/csrc`` (one
``nvcc`` per source, started together), holds each kernel against its plain
PyTorch version on the card, and drives three paths through
``Context(device="cuda")``, each checked against a float64 pandas/numpy
oracle: TPC-H Q1 at SF1 (6,000,000 synthetic ``lineitem`` rows), TPC-H Q3
over ``tests/tpch.py generate(scale_rows=1_000_000)`` (the scale of
``bench.py``'s Q3 line; the compiled join->aggregate pipeline, one transfer
and a plan-cache hit per warm run), and a star join of 6,000,000 fact rows
through that pipeline into the segment-sum kernel.  It times each query
cold and warm, Q1's planning cold and from the plan cache, and the kernel,
its plain version and the PyTorch library call that computes the same
function, at the typed shape Q1 gives the kernel and at the ``[k, n]``
stacked shape of earlier work; the kernel is also held against its plain
version on the very call the star join makes.  The kernel is timed on the card alone (``ms``, behind a spin kernel),
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


def q1_oracle(df):
    """Q1 in float64 numpy/pandas, from the same frame."""
    sel = df[df.l_shipdate <= np.datetime64("1998-09-02")]
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


def max_rel(got, want) -> float:
    g = np.asarray(got, dtype=np.float64)
    w = np.asarray(want, dtype=np.float64)
    if not np.all(np.isfinite(g)):
        fail("a result is not finite")
    return float(np.max(np.abs(g - w) / np.abs(w))) if len(w) else 0.0


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
    kc, replicas, blocks = segsum.launch_geometry(gid, columns, domain)
    phase("segsum_check", case=label, n=int(gid.shape[0]), domain=domain, k=k,
          replicas=replicas, blocks=blocks, chunks=-(-k // kc),
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

    # 2. build: every kernel source at once
    t0 = time.perf_counter()
    built = _build.build()
    phase("build", seconds=time.perf_counter() - t0, compiled=built)

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

    # 4. Q1 at SF1 through the port's entry points, on the card (each path
    # runs with the launch counts set to 0 just before it)
    t0 = time.perf_counter()
    df = gen_lineitem(N_ROWS)
    want = q1_oracle(df)
    c = Context(device="cuda")
    c.create_table("lineitem", df)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
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
    if list(got.columns) != list(want.columns) or len(got) != len(want):
        fail(f"Q1 result shape {got.shape} / columns {list(got.columns)}")
    for key in KEYS:
        if got[key].tolist() != want[key].tolist():
            fail(f"Q1 group keys differ in {key}")
    if got["count_order"].tolist() != want["count_order"].tolist():
        fail("Q1 counts differ from the oracle")
    q1_rel = 0.0
    for name in want.columns[2:-1]:
        g = got[name].to_numpy(np.float64)
        w = want[name].to_numpy(np.float64)
        if not np.all(np.isfinite(g)):
            fail(f"Q1 {name} is not finite")
        q1_rel = max(q1_rel, float(np.max(np.abs(g - w) / np.abs(w))))
    if not q1_rel <= REL_BOUND:
        fail(f"Q1 relative error {q1_rel} > {REL_BOUND}")
    phase("q1_sf1", rows=N_ROWS, groups=len(got), setup_s=setup_s,
          first_ms=first_ms, launches=launches, d2h=d2h, max_rel_err=q1_rel)

    # 5. times, beside the card's name and power limit
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        c.sql(QUERY).compute()
        runs.append((time.perf_counter() - t0) * 1e3)
    q1_ms = float(np.median(runs))
    phase("q1_time", card=card, ms=q1_ms, runs_ms=runs,
          rows_per_s=N_ROWS / (q1_ms / 1e3))

    # 6. Q1's planning: cold (parse, bind, optimize) and from the plan cache
    cold_plan, warm_plan = [], []
    for _ in range(WARM_RUNS):
        c._plan_cache.clear()
        t0 = time.perf_counter()
        c.sql(QUERY)
        cold_plan.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        c.sql(QUERY)
        warm_plan.append((time.perf_counter() - t0) * 1e3)
    if c.metrics["planner.optimize.fallback"]:
        fail("the optimizer fell back to an unoptimized plan")
    phase("plan", card=card, query="q1", cold_ms=float(np.median(cold_plan)),
          warm_ms=float(np.median(warm_plan)), cold_runs_ms=cold_plan,
          warm_runs_ms=warm_plan)
    del c, df, got

    # 7. TPC-H Q3 through the compiled join->aggregate pipeline
    from dask_sql_tpu_torch.physical import compiled_join
    from tests.tpch import QUERIES, generate

    t0 = time.perf_counter()
    tables = generate(scale_rows=Q3_ROWS, seed=7)
    tables = {n: tables[n] for n in ("customer", "orders", "lineitem")}
    c3 = Context(device="cuda")
    for name, frame in tables.items():
        c3.create_table(name, frame)
    torch.cuda.synchronize()
    q3_setup_s = time.perf_counter() - t0
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
          launches=q3_launches, max_rel_err=q3_rel[0])
    del c3, tables, got

    # 8. a star join through the pipeline into the segment-sum kernel
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
    del cs, star, captured, star_gid, star_cols

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
    kc, replicas, blocks = segsum.launch_geometry(tgid, tcols, q1_domain)
    phase("segsum_time", shape="typed_q1", card=card, n=N_ROWS,
          domain=q1_domain, k=tk, replicas=replicas, blocks=blocks, ms=t_ms,
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
    kc, replicas, blocks = segsum.launch_geometry(
        gid, [(c, None) for c in cols.unbind(0)], q1_domain)
    phase("segsum_time", shape="stacked_q1", card=card, n=N_ROWS,
          domain=q1_domain, k=q1_k, replicas=replicas, blocks=blocks,
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
                             "q3": q3_launches["segsum"],
                             "join_star": star_launches["segsum"]},
        "max_abs_err": max(typed_err, star_err),
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
