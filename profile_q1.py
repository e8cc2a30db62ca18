"""Where the time of TPC-H Q1 at SF1 (or of another TPC-H query, or of the
root select) goes in the PyTorch port, on one CUDA card.

Run from the root of a checkout on a machine with the card:

    python3 profile_q1.py [--query q1|q2|...|q22|select]

For Q1 (the default) it loads 6,000,000 synthetic ``lineitem`` rows (the
generator and query of ``chip_smoke.py``); for Q3 the customer, orders and
lineitem tables of ``tests/tpch.py generate(scale_rows=1_000_000)``, the
scale of ``bench.py``'s Q3 line; for every other TPC-H query (q9 the
eager aggregate, q12 eager joins under it, q14 the join pipeline, q21 the
semi and anti joins) all eight tables of that generator; for ``select`` the same 6,000,000 rows and
``bench.py``'s root top-k select.  Tables load with the column encodings
the reference picks.  It warms the query up, then prints JSON
lines, each phase named after the query: the host time of
planning (``c.sql``) and of execution (``.compute()``), medians of 5 runs;
the host time of each call Q1 makes to the segment-sum kernel's wrapper
(``segsum_typed``, or ``segsum_columns`` in a tree without it), over 5 more
runs; and, from ``torch.profiler`` over 5 more runs, the device time by
kernel (``segsum_partials`` is the kernel's first pass, ``segsum_combine``
its second) and the device's busy and idle shares of the wall time.  The
Chrome trace goes to ``profile_out/<query>_trace.json``.  For a query whose
segment reduction runs as ``index_add_`` (Q3), it also times one float64
``index_add_`` at the query's own group ids against the same call with the
rows the query does not select moved off group 0 (``scatter_probe``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

RUNS = 5


def time_wrapper(ops, times):
    """Wraps the segment-sum wrappers of module `ops` so that each outermost
    call appends its host microseconds to `times`.  Returns a function that
    puts the originals back."""
    depth, originals = [0], {}
    for name in ("segsum_typed", "segsum_columns"):
        fn = getattr(ops, name, None)
        if fn is None:
            continue
        originals[name] = fn

        def timed(*args, _fn=fn, **kwargs):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    times.append((time.perf_counter() - t0) * 1e6)

        setattr(ops, name, timed)
    return lambda: [setattr(ops, k, v) for k, v in originals.items()]


def scatter_probe(c, sql, q, card) -> None:
    """Times a float64 ``index_add_`` of the query's row selection at its
    group ids, as the reducer's scatter mode makes it, against the same
    call with the unselected rows spread over the domain (their
    contributions are 0 either way, so the sums agree)."""
    from dask_sql_tpu_torch.physical import compiled

    seen = []
    count = compiled.SegmentReducer.count

    def first_count(self, mask):
        if not seen:
            seen.append((self.gid, mask, self.domain))
        return count(self, mask)

    compiled.SegmentReducer.count = first_count
    try:
        c.sql(sql).compute()
    finally:
        compiled.SegmentReducer.count = count
    gid, sel, domain = seen[0]
    n = gid.shape[0]
    x = sel.to(torch.float64)
    spread = torch.where(sel, gid, (torch.arange(n, device=gid.device,
                                                 dtype=torch.int32) % domain))

    def timed(ids):
        out = torch.zeros(domain, dtype=torch.float64, device=gid.device)
        out.index_add_(0, ids, x)  # warm-up
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(20):
            out.zero_().index_add_(0, ids, x)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 20, out

    as_is_ms, a = timed(gid)
    spread_ms, b = timed(spread)
    if not torch.equal(a, b):
        raise SystemExit("scatter_probe: spread ids changed the sums")
    print(json.dumps({"phase": f"{q}_scatter_probe", "card": card, "rows": n,
                      "domain": domain,
                      "selected_rows": int(sel.sum()),
                      "unselected_at_group_0": int(((~sel) & (gid == 0)).sum()),
                      "index_add_ms": as_is_ms,
                      "index_add_spread_ms": spread_ms}))


def load(query: str):
    """(context, SQL text, probe rows) of the query, its tables on the card."""
    from dask_sql_tpu_torch import Context

    c = Context(device="cuda")
    if query in ("q1", "select"):
        from chip_smoke import N_ROWS, QUERY, SELECT_QUERY, gen_lineitem

        c.create_table("lineitem", gen_lineitem(N_ROWS))
        return c, QUERY if query == "q1" else SELECT_QUERY, N_ROWS
    from chip_smoke import Q3_ROWS
    from tests.tpch import QUERIES, generate

    tables = generate(scale_rows=Q3_ROWS, seed=7)
    names = ("customer", "orders", "lineitem") if query == "q3" else tables
    for name in names:
        c.create_table(name, tables[name])
    return c, QUERIES[int(query[1:])], Q3_ROWS


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--query",
                        choices=[f"q{i}" for i in range(1, 23)] + ["select"],
                        default="q1")
    q = parser.parse_args().query
    if not torch.cuda.is_available():
        print("profile_q1: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    c, QUERY, N_ROWS = load(q)
    for _ in range(2):
        c.sql(QUERY).compute()

    plan_ms, exec_ms = [], []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        frame = c.sql(QUERY)
        t1 = time.perf_counter()
        frame.compute()
        t2 = time.perf_counter()
        plan_ms.append((t1 - t0) * 1e3)
        exec_ms.append((t2 - t1) * 1e3)
    print(json.dumps({"phase": f"{q}_host_split", "card": card, "rows": N_ROWS,
                      "plan_ms": float(np.median(plan_ms)),
                      "execute_ms": float(np.median(exec_ms)),
                      "plan_runs_ms": plan_ms, "execute_runs_ms": exec_ms}))

    from dask_sql_tpu_torch.ops import segsum

    wrapper_us = []
    restore = time_wrapper(segsum, wrapper_us)
    for _ in range(RUNS):
        c.sql(QUERY).compute()
    restore()
    print(json.dumps({"phase": f"{q}_segsum_host", "card": card,
                      "calls_per_query": len(wrapper_us) / RUNS,
                      "host_us_per_call": (float(np.median(wrapper_us))
                                           if wrapper_us else None),
                      "runs_us": wrapper_us}))

    if q == "q3":
        scatter_probe(c, QUERY, q, card)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(RUNS):
            c.sql(QUERY).compute()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = Path("profile_out")
    out.mkdir(exist_ok=True)
    trace = out / f"{q}_trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    # device work is what the trace files under these categories; the
    # operator rows of key_averages() would count a kernel twice
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name = {}
    for e in device:
        d = by_name.setdefault(e["name"], [0.0, 0])
        d[0] += e["dur"]
        d[1] += 1
    device_us = sum(d[0] for d in by_name.values())
    print(json.dumps({"phase": f"{q}_device_split", "card": card, "runs": RUNS,
                      "wall_ms_per_query": wall_us / RUNS / 1e3,
                      "device_ms_per_query": device_us / RUNS / 1e3,
                      "device_busy_share": device_us / wall_us,
                      "device_idle_share": 1 - device_us / wall_us,
                      "device_ops_per_query": len(device) / RUNS}))
    for name, (dur, count) in sorted(by_name.items(), key=lambda x: -x[1][0])[:15]:
        print(json.dumps({"kernel": name[:90], "launches_per_query": count / RUNS,
                          "device_ms_per_query": dur / RUNS / 1e3,
                          "share_of_device": dur / device_us}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
