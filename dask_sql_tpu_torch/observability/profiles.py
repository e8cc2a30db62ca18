"""Per-fingerprint query profiles.

A copy of `dask_sql_tpu/observability/profiles.py`: `warm_candidates` is
the warm-up's work list (serving/warmup.py), `predicted_exec_ms` the
packing scheduler's drain prediction, and the exec and rung history the
ladder's cost-based skip.  One rolling profile per plan fingerprint (resilience/ladder.py
`plan_fingerprint`, or the family's): hit counts, recent execute wall
times, result bytes, the rows returned, the ladder rungs that answered
and per-rung compile (pipeline build) wall times.  ``SHOW PROFILES [LIKE
'pat']`` renders the store as a result set (physical/rel/custom/ddl.py);
`snapshot` and `load` give and take its JSON state, which the checkpoint
subsystem persists (checkpoint.py).

Everything is plain-JSON state (dicts, lists, floats) so snapshot/load is
`json.dump`/`json.load` with no schema mapping.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

#: truncation for the remembered SQL text of a fingerprint.  Sized so that
#: realistic serving statements survive whole: a pre-warm pass replays
#: this text after a restart, and a truncated statement is unreplayable
#: (flagged `sql_truncated`).
_SQL_KEEP = 4096


def _percentile(values: List[float], q: float) -> float:
    # lazy import: serving/__init__ may still be mid-import when this
    # module loads through the observability package
    from ..serving.metrics import nearest_rank

    return nearest_rank(sorted(values), q)


def _fmt(v: float) -> str:
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    return f"{v:.3f}" if isinstance(v, float) else str(v)


class ProfileStore:
    """Thread-safe bounded store: fingerprint -> rolling profile dict."""

    def __init__(self, window: int = 64, keep: int = 512):
        self.window = max(1, int(window))
        self.keep = max(1, int(keep))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()

    # ------------------------------------------------------------ writes
    def _entry_locked(self, fingerprint: str, sql: Optional[str],
                      family: Optional[str] = None) -> Dict[str, Any]:
        e = self._entries.get(fingerprint)
        if e is None:
            e = self._entries[fingerprint] = {
                "sql": (sql or "")[:_SQL_KEEP],
                "sql_truncated": len(sql or "") > _SQL_KEEP,
                #: the literal-stripped family fingerprint (families/);
                #: "" for profiles recorded with families disabled or
                #: restored from pre-family snapshots.  With families on,
                #: entries are KEYED by family, so hit counts roll up
                #: across every literal variant of the statement.
                "family": family or "",
                "hits": 0,
                "cache_hits": 0,
                "exec_ms": [],
                "result_bytes": [],
                #: observed output cardinalities (rolling) — the prior the
                #: estimator's feedback tightens its upper bounds with
                #: (analysis/estimator.py `apply_feedback`)
                "rows": [],
                #: the estimator's most recent rows upper bound for this
                #: family (None = unbounded/never estimated): SHOW PROFILES
                #: renders it beside the observed rows so operators can see
                #: where feedback tightened the estimate
                "est_rows_hi": None,
                "compile": {},  # rung -> {"count": n, "ms": [rolling]}
                #: per-ladder-rung exec wall times, surfaced as SHOW
                #: PROFILES ``rung.<rung>.*`` rows so operators can compare
                #: what each rung actually costs a family (the ladder's
                #: cost-based skip reads the family's exec history and the
                #: per-rung compile priors, resilience/ladder.py cost_skip)
                "rungs": {},  # rung -> {"count": n, "ms": [rolling]}
                "last_seen": 0.0,
            }
        else:
            if sql and not e["sql"]:
                e["sql"] = sql[:_SQL_KEEP]
                e["sql_truncated"] = len(sql) > _SQL_KEEP
            if family and not e.get("family"):
                e["family"] = family
        self._entries.move_to_end(fingerprint)
        while len(self._entries) > self.keep:
            self._entries.popitem(last=False)
        e["last_seen"] = time.time()
        return e

    def record_exec(self, fingerprint: str, sql: Optional[str] = None,
                    exec_ms: Optional[float] = None,
                    result_bytes: Optional[int] = None,
                    cache_hit: bool = False,
                    family: Optional[str] = None,
                    rows: Optional[int] = None) -> None:
        with self._lock:
            e = self._entry_locked(fingerprint, sql, family)
            e["hits"] += 1
            if cache_hit:
                e["cache_hits"] += 1
            if exec_ms is not None:
                e["exec_ms"].append(round(float(exec_ms), 3))
                del e["exec_ms"][:-self.window]
            if result_bytes is not None:
                e["result_bytes"].append(int(result_bytes))
                del e["result_bytes"][:-self.window]
            if rows is not None:
                e["rows"].append(int(rows))
                del e["rows"][:-self.window]

    def record_rung_exec(self, fingerprint: str, rung: str, ms: float,
                         family: Optional[str] = None) -> None:
        """One successful ladder-rung execution for this fingerprint — the
        per-(family, rung) cost evidence behind cost-based rung selection
        (resilience/ladder.py `attempt`)."""
        with self._lock:
            e = self._entry_locked(fingerprint, None, family)
            r = e["rungs"].setdefault(rung, {"count": 0, "ms": []})
            r["count"] += 1
            r["ms"].append(round(float(ms), 3))
            del r["ms"][:-self.window]

    def record_estimate(self, fingerprint: str,
                        rows_hi: Optional[int],
                        family: Optional[str] = None) -> None:
        """The estimator's latest rows upper bound for this fingerprint —
        paired with the observed ``rows`` history in SHOW PROFILES so the
        estimated-vs-observed gap (what feedback closes) is visible.

        Updates EXISTING entries only (no create, no LRU bump): estimation
        also runs for EXPLAIN ESTIMATE and never-executed plans, and a
        nominally read-only statement must not evict hot execution
        profiles that feed warm-up ordering and drain hints."""
        with self._lock:
            e = self._entries.get(fingerprint)
            if e is None:
                return
            e["est_rows_hi"] = None if rows_hi is None else int(rows_hi)

    def record_compile(self, fingerprint: str, rung: str, ms: float,
                       sql: Optional[str] = None,
                       family: Optional[str] = None) -> None:
        with self._lock:
            e = self._entry_locked(fingerprint, sql, family)
            r = e["compile"].setdefault(rung, {"count": 0, "ms": []})
            r["count"] += 1
            r["ms"].append(round(float(ms), 3))
            del r["ms"][:-self.window]

    # ------------------------------------------------------------- reads
    def rows(self) -> List[Tuple[str, str, str, str]]:
        """(fingerprint, family, metric, value) rows for ``SHOW PROFILES``
        — same flat shape as SHOW METRICS plus the family column, one
        group of rows per profile."""
        with self._lock:
            entries = {fp: _copy_entry(e) for fp, e in self._entries.items()}
        out: List[Tuple[str, str, str, str]] = []
        for fp in sorted(entries):
            e = entries[fp]
            fam = e.get("family", "")
            out.append((fp, fam, "sql", e["sql"]))
            out.append((fp, fam, "hits", str(e["hits"])))
            out.append((fp, fam, "cache_hits", str(e["cache_hits"])))
            if e["exec_ms"]:
                out.append((fp, fam, "exec_ms.p50",
                            _fmt(_percentile(e["exec_ms"], 0.5))))
                out.append((fp, fam, "exec_ms.max", _fmt(max(e["exec_ms"]))))
                out.append((fp, fam, "exec_ms.last", _fmt(e["exec_ms"][-1])))
            if e["result_bytes"]:
                out.append((fp, fam, "result_bytes.last",
                            str(e["result_bytes"][-1])))
            # estimated-vs-observed cardinality: where the estimator's
            # upper bound sits against what the family actually returned
            # (the gap profile feedback tightens, docs/analysis.md)
            if e.get("est_rows_hi") is not None:
                out.append((fp, fam, "rows.est_hi", str(e["est_rows_hi"])))
            if e.get("rows"):
                out.append((fp, fam, "rows.observed.last",
                            str(e["rows"][-1])))
                out.append((fp, fam, "rows.observed.max",
                            str(max(e["rows"]))))
            for rung in sorted(e.get("rungs", {})):
                r = e["rungs"][rung]
                out.append((fp, fam, f"rung.{rung}.count", str(r["count"])))
                if r["ms"]:
                    out.append((fp, fam, f"rung.{rung}.ms.p50",
                                _fmt(_percentile(r["ms"], 0.5))))
            for rung in sorted(e["compile"]):
                r = e["compile"][rung]
                out.append((fp, fam, f"compile.{rung}.count",
                            str(r["count"])))
                if r["ms"]:
                    out.append((fp, fam, f"compile.{rung}.ms.p50",
                                _fmt(_percentile(r["ms"], 0.5))))
                    out.append((fp, fam, f"compile.{rung}.ms.max",
                                _fmt(max(r["ms"]))))
        return out

    def warm_candidates(self, n: int = 10) -> List[Tuple[str, str]]:
        """(fingerprint, sql) for the hottest REPLAYABLE fingerprints — the
        warm-up's work list (serving/warmup.py).  Entries with no recorded
        SQL or a truncation-lossy one are excluded: replaying a prefix
        would warm (or fail) the wrong statement.  Deduped by family —
        one compiled executable serves every literal variant, so pre-warm
        replays ONE representative statement per family.  With the
        engine's current recording (entries KEYED by family fingerprint)
        the collapse is structural and this dedupe is a no-op guard; it
        exists to keep the store's contract honest for callers that key
        by literal fingerprint and pass `family` as the rollup field
        (the record_* API explicitly allows that split)."""
        with self._lock:
            ranked = sorted(self._entries.items(),
                            key=lambda kv: kv[1]["hits"], reverse=True)
            out: List[Tuple[str, str]] = []
            seen_families: set = set()
            for fp, e in ranked:
                if len(out) >= max(0, int(n)):
                    break
                if not e["sql"] or e.get("sql_truncated"):
                    continue
                family = e.get("family") or fp
                if family in seen_families:
                    continue
                seen_families.add(family)
                out.append((fp, e["sql"]))
            return out

    def get(self, fingerprint: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            e = self._entries.get(fingerprint)
            return None if e is None else _copy_entry(e)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # ------------------------------------------------------- persistence
    #: the pre-version-2 truncation cap: entries in legacy snapshots whose
    #: SQL reaches it may be silent prefixes of the real statement
    _LEGACY_SQL_KEEP = 200

    def predicted_exec_ms(self, fingerprint: str) -> Optional[float]:
        """The rolling p50 of observed exec wall times for one fingerprint
        — the packing scheduler's predicted exec_ms (drain hints, deadline
        ordering) and the ladder's interpreted-cost prior.  None when the
        fingerprint has no exec history (an unknown query earns no made-up
        prediction)."""
        with self._lock:
            e = self._entries.get(fingerprint)
            samples = list(e["exec_ms"]) if e is not None else []
        if not samples:
            return None
        return _percentile(samples, 0.5)

    def top_fingerprints(self, n: int = 10) -> List[str]:
        """Hottest fingerprints by hit count — the pre-warm ordering."""
        with self._lock:
            ranked = sorted(self._entries.items(),
                            key=lambda kv: kv[1]["hits"], reverse=True)
        return [fp for fp, _ in ranked[:max(0, int(n))]]

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready snapshot (checkpoint.py writes this as
        profiles.json next to the catalog snapshot).  Version 2 carries
        the per-entry ``sql_truncated`` flag the warm-up relies on."""
        with self._lock:
            return {
                "version": 2,
                "window": self.window,
                "profiles": {fp: _copy_entry(e)
                             for fp, e in self._entries.items()},
            }

    def load(self, data: Dict[str, Any]) -> int:
        """Replace the store's contents with a `snapshot()` payload;
        returns the number of profiles restored.  Unknown versions load
        best-effort (the schema is additive)."""
        profiles = (data or {}).get("profiles") or {}
        # a version-1 snapshot predates the flag AND used a 200-char cap:
        # an entry whose SQL reaches that cap may be a silent prefix of the
        # real statement — mark it truncated so warm-up never replays a
        # prefix that happens to parse as a different (wrong) query
        legacy = int((data or {}).get("version") or 1) < 2
        with self._lock:
            self._entries.clear()
            for fp, e in profiles.items():
                sql = str(e.get("sql", ""))[:_SQL_KEEP]
                self._entries[fp] = {
                    "sql": sql,
                    "sql_truncated": bool(e.get(
                        "sql_truncated",
                        legacy and len(sql) >= self._LEGACY_SQL_KEEP)),
                    # pre-family snapshots carry no family: "" (unknown),
                    # so warm-up dedupes them by fingerprint as before
                    "family": str(e.get("family", "") or ""),
                    "hits": int(e.get("hits", 0)),
                    "cache_hits": int(e.get("cache_hits", 0)),
                    "exec_ms": [float(v) for v in
                                e.get("exec_ms", [])][-self.window:],
                    "result_bytes": [int(v) for v in
                                     e.get("result_bytes", [])][-self.window:],
                    # additive since version 2: pre-scheduler snapshots
                    # simply restore with no observed-rows / rung history
                    "rows": [int(v) for v in
                             e.get("rows", [])][-self.window:],
                    "est_rows_hi": (None if e.get("est_rows_hi") is None
                                    else int(e["est_rows_hi"])),
                    "compile": {
                        rung: {"count": int(r.get("count", 0)),
                               "ms": [float(v) for v in
                                      r.get("ms", [])][-self.window:]}
                        for rung, r in (e.get("compile") or {}).items()
                    },
                    "rungs": {
                        rung: {"count": int(r.get("count", 0)),
                               "ms": [float(v) for v in
                                      r.get("ms", [])][-self.window:]}
                        for rung, r in (e.get("rungs") or {}).items()
                    },
                    "last_seen": float(e.get("last_seen", 0.0)),
                }
                if len(self._entries) >= self.keep:
                    break
            return len(self._entries)


def _copy_entry(e: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(e)
    out["exec_ms"] = list(e["exec_ms"])
    out["result_bytes"] = list(e["result_bytes"])
    out["rows"] = list(e.get("rows", []))
    out["compile"] = {rung: {"count": r["count"], "ms": list(r["ms"])}
                      for rung, r in e["compile"].items()}
    out["rungs"] = {rung: {"count": r["count"], "ms": list(r["ms"])}
                    for rung, r in e.get("rungs", {}).items()}
    return out
