"""``sartsolve metrics``: validate, summarize and diff run artifacts.

Counterpart of the ``metrics`` subcommand of ``sartsolver_tpu/obs/cli.py``,
whole, so that either package's tool reads either package's artifacts the
same way. Dispatched by ``sartsolver_tpu_torch.cli.main`` before the
solver's argument parser sees argv. Three modes:

- ``sartsolve metrics RUN.jsonl``: validate against the obs schema and
  print a human summary (frames by status, solve-ms stats, counters,
  events);
- ``sartsolve metrics --check RUN.jsonl``: validation only; exit 1 on any
  schema violation;
- ``sartsolve metrics --diff OLD.jsonl NEW.jsonl``: per-metric deltas
  between two artifacts; ``--threshold PCT`` additionally exits 2 on a
  regression past PCT percent: mean frame solve-ms going up for run
  artifacts, the bench headline value going down for BENCH artifacts (it
  is a rate).

Exit codes: 0 ok; 1 invalid input (unreadable file, schema violations);
2 ``--diff --threshold`` regression detected.

``sartsolve top FILE``: a refreshing one-screen view of a live run, from a
file it publishes — its SIGUSR1 status snapshot (``<output>.status.json``,
``obs/flight.py``), its heartbeat (``SART_HEARTBEAT_FILE``) or its
Prometheus textfile (``SART_METRICS_PROM``); ``--once`` renders one screen
and exits (1 where it could not), ``--lines`` caps it. It renders either
package's files, and a serving engine's live endpoints (``top
http://127.0.0.1:PORT``: its /status and /metrics).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from sartsolver_tpu_torch.obs import schema


def build_metrics_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sartsolve metrics",
        description="Validate, summarize and diff metrics artifacts "
                    "(JSONL, docs/OBSERVABILITY.md). BENCH_*.json single-"
                    "record artifacts validate too (shared schema).",
    )
    p.add_argument("artifacts", nargs="*", metavar="FILE",
                   help="Metrics JSONL artifact(s); one to summarize, "
                        "two with --diff.")
    p.add_argument("--check", action="store_true",
                   help="Validate only (no summary); exit 1 on any "
                        "schema violation.")
    p.add_argument("--diff", action="store_true",
                   help="Compare two artifacts: frame outcomes and "
                        "per-metric deltas.")
    p.add_argument("--threshold", type=float, default=None, metavar="PCT",
                   help="With --diff: exit 2 if mean frame solve-ms "
                        "regressed by more than PCT percent.")
    p.add_argument("--json", dest="json_", action="store_true",
                   help="Machine-readable output.")
    return p


def _load(path: str) -> Tuple[List[dict], List[str]]:
    """Validate + load one artifact in a single read/parse pass. An
    artifact that opens with a ``meta`` record claims to be a full run
    artifact and is held to the run contract (meta first, metrics
    present, summary consistent); anything else — e.g. a single-record
    BENCH file — only needs every record individually valid."""
    try:
        numbered, errors = schema.load_jsonl(path)
    except OSError as err:
        return [], [str(err)]
    records = [rec for _, rec in numbered if isinstance(rec, dict)]
    require_run = bool(records) and records[0].get("type") == "meta"
    errors = errors + schema.validate_records(
        numbered, require_run=require_run
    )
    return records, errors


def _stats(values: List[float]) -> Dict[str, float]:
    if not values:
        return {}
    ordered = sorted(values)
    return {
        "count": len(values),
        "mean": sum(values) / len(values),
        "p50": ordered[len(ordered) // 2],
        "min": ordered[0],
        "max": ordered[-1],
    }


def summarize(records: List[dict]) -> dict:
    frames = [r for r in records if r.get("type") == "frame"]
    events = [r for r in records if r.get("type") == "event"]
    metric_recs = [r for r in records if r.get("type") == "metric"]
    bench = [r for r in records if r.get("type") == "bench"]
    # solver-variant provenance (run meta, cli.py set_run_info): two runs
    # with different convergence accelerators must never have their
    # iteration/solve-ms behavior compared silently (docs §9). Frame
    # records carry the same fields (obs/run.py) precisely so a SLICED
    # artifact — frames without their meta line — still declares its
    # variant; fall back to the first frame that has them.
    meta = records[0] if records and records[0].get("type") == "meta" else {}
    variant_keys = ("os_subsets", "momentum", "logarithmic", "operator")
    variant = {k: meta[k] for k in variant_keys if k in meta}
    if not variant:
        for fr in frames:
            variant = {k: fr[k] for k in variant_keys if k in fr}
            if variant:
                break
    by_status: Dict[str, int] = {}
    for fr in frames:
        by_status[fr["status_name"]] = by_status.get(fr["status_name"], 0) + 1
    out = {
        "frames": len(frames),
        "by_status": by_status,
        "solve_ms": _stats([f["solve_ms"] for f in frames
                            if f.get("solve_ms") is not None]),
        "iterations": _stats([float(f["iterations"]) for f in frames
                              if f.get("iterations", -1) >= 0]),
        "events": [e["message"] for e in events],
        "counters": {
            _metric_key(m): m["value"] for m in metric_recs
            if m["kind"] == "counter"
        },
        "gauges": {
            _metric_key(m): m["value"] for m in metric_recs
            if m["kind"] == "gauge"
        },
        # moments histograms (count/sum/min/max + fixed-bucket quantile
        # estimates when the artifact generation carries them); mean
        # derived here so the diff below can gate on distribution drift
        # (in particular iterations_to_converge — convergence behavior)
        "histograms": {
            _metric_key(m): {
                "count": m["count"], "mean": m["sum"] / m["count"],
                "min": m["min"], "max": m["max"],
                **{q: m[q] for q in ("p50", "p95", "p99")
                   if m.get(q) is not None},
            }
            for m in metric_recs
            if m["kind"] == "histogram" and m.get("count")
        },
    }
    if variant:
        out["variant"] = variant
    # serving-engine section (docs/SERVING.md): queue-wait / request
    # solve-time moments and the deadline-miss rate, derived from the
    # engine's registry instruments whenever a serve run wrote them
    qw = out["histograms"].get("engine_queue_wait_s")
    admitted = out["counters"].get("engine_admitted_total")
    if qw or admitted is not None:
        miss = out["counters"].get("engine_deadline_miss_total", 0.0)
        shed = sum(v for k, v in out["counters"].items()
                   if k.startswith("engine_shed_total"))
        solve = out["histograms"].get("engine_request_solve_s")
        latency = out["histograms"].get("engine_request_latency_s")
        out["engine"] = {
            "queue_wait_mean_s": qw["mean"] if qw else None,
            "queue_wait_p50_s": (qw or {}).get("p50"),
            "queue_wait_p95_s": (qw or {}).get("p95"),
            "queue_wait_p99_s": (qw or {}).get("p99"),
            "request_solve_mean_s": solve["mean"] if solve else None,
            "latency_mean_s": latency["mean"] if latency else None,
            "latency_p95_s": (latency or {}).get("p95"),
            "latency_p99_s": (latency or {}).get("p99"),
            "admitted": admitted or 0.0,
            "shed": shed,
            "deadline_miss_rate": (
                miss / admitted if admitted else None
            ),
        }
        # SLO error-budget burn (docs/OBSERVABILITY.md §10): the
        # per-tenant ok/breach counter pair summed into one burn rate;
        # absent unless the serve run set --slo_ms
        slo_ok = sum(v for k, v in out["counters"].items()
                     if k.startswith("engine_slo_ok_total"))
        slo_breach = sum(v for k, v in out["counters"].items()
                         if k.startswith("engine_slo_breach_total"))
        if slo_ok or slo_breach:
            total = slo_ok + slo_breach
            out["engine"]["slo"] = {
                "target_ms": out["gauges"].get("engine_slo_target_ms"),
                "requests": total,
                "breaches": slo_breach,
                "burn_rate": slo_breach / total,
            }
        # the serving engine's resident-cache counters (docs/SERVING.md
        # §10): a drop in the hit rate means the byte budget thrashes
        # (evict/rebuild churn). Summed across label sets so fleet
        # artifacts (worker=... labels) roll up like the SLO pair.
        cache_hits = sum(v for k, v in out["counters"].items()
                         if k.startswith("session_cache_hits_total"))
        cache_misses = sum(v for k, v in out["counters"].items()
                           if k.startswith("session_cache_misses_total"))
        if cache_hits or cache_misses:
            out["engine"]["session_cache"] = {
                "hits": cache_hits,
                "misses": cache_misses,
                "evictions": sum(
                    v for k, v in out["counters"].items()
                    if k.startswith("session_cache_evictions_total")),
                "hit_rate": cache_hits / (cache_hits + cache_misses),
                "resident_bytes": out["gauges"].get(
                    "session_resident_bytes"),
            }
    if bench:
        out["bench"] = {
            "metric": bench[0]["metric"], "value": bench[0]["value"],
            "vs_baseline": bench[0]["vs_baseline"],
        }
        # continuous-batching straggler section (bench.py): the
        # occupancy-weighted frame throughput is its own gated headline —
        # a rate, like the bench value
        strag = (bench[0].get("detail") or {}).get("straggler")
        if isinstance(strag, dict) and "occ_frame_iter_s" in strag:
            out["straggler"] = {
                "occ_frame_iter_s": strag["occ_frame_iter_s"],
                "occupancy": strag.get("occupancy"),
            }
        # integrity-overhead section (bench.py): the integrity-on iter/s
        # is a gated rate — the ABFT check's cost must stay bounded
        # run-over-run (within the threshold of the integrity-off rate)
        integ = (bench[0].get("detail") or {}).get("integrity")
        if isinstance(integ, dict) and "iter_s_on" in integ:
            out["integrity"] = {
                "iter_s_on": integ["iter_s_on"],
                "iter_s_off": integ.get("iter_s_off"),
                "overhead_pct": integ.get("overhead_pct"),
            }
        # time-to-solution section (bench.py tts items, docs §9): the
        # log-path iterations-to-converge speedup of the accelerated
        # variants is a gated rate — a run-over-run drop means the
        # convergence accelerators regressed, which raw iter/s never sees
        tts = (bench[0].get("detail") or {}).get("tts")
        if isinstance(tts, dict):
            out["tts"] = {
                name: {
                    "iter_speedup": sec.get("iter_speedup"),
                    "iters_base": sec.get("iters_base"),
                    "iters_accel": sec.get("iters_accel"),
                    "parity": sec.get("parity"),
                }
                for name, sec in tts.items() if isinstance(sec, dict)
            }
        # block-sparse section (bench.py sparse items, docs §10): the
        # occ50 sparse-vs-dense iteration-rate speedup is a gated rate —
        # a run-over-run drop means the tile-skip stopped paying (or
        # silently densified), which raw iter/s never isolates
        sparse = (bench[0].get("detail") or {}).get("sparse")
        if isinstance(sparse, dict):
            out["sparse"] = {
                name: {
                    "iter_speedup": sec.get("iter_speedup"),
                    "tile_occupancy": sec.get("tile_occupancy"),
                    "parity": sec.get("parity"),
                }
                for name, sec in sparse.items() if isinstance(sec, dict)
            }
        # low-rank factored-RTM section (bench.py lowrank item, docs
        # §12): the measured FLOP reduction of the factored step over
        # the dense one is a gated rate — a run-over-run drop means the
        # factorization stopped paying (a fatter core, a densified
        # factor path), which raw iter/s never isolates
        lowrank = (bench[0].get("detail") or {}).get("lowrank")
        if isinstance(lowrank, dict):
            out["lowrank"] = {
                "flop_reduction": lowrank.get("flop_reduction"),
                "flop_reduction_vs_tileskip": lowrank.get(
                    "flop_reduction_vs_tileskip"),
                "core_occupancy": lowrank.get("core_occupancy"),
                "rank": lowrank.get("rank"),
                "parity": lowrank.get("parity"),
            }
        # roofline section (bench.py + obs/roofline.py): the headline
        # config's achieved-vs-peak MXU and HBM-bandwidth fractions —
        # gated rates like the headline itself (a utilization drop is a
        # regression even when a faster chip hides it in raw iter/s)
        roof = (bench[0].get("detail") or {}).get("roofline")
        if isinstance(roof, dict) and "hbm_util" in roof:
            out["roofline"] = {
                "mxu_util": roof.get("mxu_util"),
                "hbm_util": roof.get("hbm_util"),
                "bound": roof.get("bound"),
            }
    return out


def _metric_key(m: dict) -> str:
    labels = m.get("labels") or {}
    if not labels:
        return m["name"]
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{m['name']}{{{inner}}}"


def _print_summary(path: str, summary: dict) -> None:
    print(f"{path}: {summary['frames']} frame(s)")
    if summary["by_status"]:
        parts = ", ".join(f"{n} {s}" for s, n in
                          sorted(summary["by_status"].items()))
        print(f"  statuses: {parts}")
    if summary["solve_ms"]:
        s = summary["solve_ms"]
        print(f"  solve ms: mean {s['mean']:.2f}, p50 {s['p50']:.2f}, "
              f"min {s['min']:.2f}, max {s['max']:.2f}")
    if summary["iterations"]:
        s = summary["iterations"]
        print(f"  iterations: mean {s['mean']:.1f}, max {s['max']:.0f}")
    for key, h in summary["histograms"].items():
        line = (f"  histogram {key}: count {h['count']:g}, "
                f"mean {h['mean']:.2f}, min {h['min']:g}, "
                f"max {h['max']:g}")
        if h.get("p99") is not None:
            line += (f", p50 {h['p50']:.4g}, p95 {h['p95']:.4g}, "
                     f"p99 {h['p99']:.4g}")
        print(line)
    for key, value in summary["counters"].items():
        print(f"  counter {key} = {value:g}")
    for key, value in summary["gauges"].items():
        print(f"  gauge {key} = {value:g}")
    for message in summary["events"]:
        print(f"  event: {message}")
    if "bench" in summary:
        b = summary["bench"]
        print(f"  bench {b['metric']}: {b['value']:g} "
              f"(vs_baseline {b['vs_baseline']:g})")
    if "integrity" in summary:
        i = summary["integrity"]
        print(f"  integrity iter/s: on {i['iter_s_on']:g}, "
              f"off {i['iter_s_off']:g} "
              f"(overhead {i['overhead_pct']:+.1f}%)")
    if "roofline" in summary:
        r = summary["roofline"]
        print(f"  roofline: mxu_util {r['mxu_util']:g}, "
              f"hbm_util {r['hbm_util']:g} ({r['bound']}-bound)")
    if "engine" in summary:
        e = summary["engine"]
        line = f"  engine: admitted {e['admitted']:g}, shed {e['shed']:g}"
        if e.get("queue_wait_mean_s") is not None:
            line += f", queue-wait mean {e['queue_wait_mean_s']:.4g}s"
        if e.get("queue_wait_p99_s") is not None:
            line += f" p99 {e['queue_wait_p99_s']:.4g}s"
        if e.get("latency_p99_s") is not None:
            line += f", latency p99 {e['latency_p99_s']:.4g}s"
        print(line)
        slo = e.get("slo")
        if slo:
            print(f"  engine SLO ({slo['target_ms']:g} ms): "
                  f"{slo['breaches']:g}/{slo['requests']:g} breached "
                  f"(burn rate {slo['burn_rate']:.3f})")
    if "variant" in summary:
        v = summary["variant"]
        print("  solver variant: " + ", ".join(
            f"{k}={v[k]}" for k in sorted(v)))
    if "tts" in summary:
        for name, sec in sorted(summary["tts"].items()):
            if sec.get("iter_speedup") is not None:
                print(f"  tts {name}: {sec['iters_base']} -> "
                      f"{sec['iters_accel']} iters "
                      f"({sec['iter_speedup']:g}x, parity="
                      f"{sec.get('parity')})")
    if "sparse" in summary:
        for name, sec in sorted(summary["sparse"].items()):
            if sec.get("iter_speedup") is not None:
                print(f"  sparse {name}: {sec['iter_speedup']:g}x iter/s "
                      f"vs dense (occupancy "
                      f"{sec.get('tile_occupancy')}, parity="
                      f"{sec.get('parity')})")
    if "lowrank" in summary:
        sec = summary["lowrank"]
        if sec.get("flop_reduction") is not None:
            print(f"  lowrank rank {sec.get('rank')}: "
                  f"{sec['flop_reduction']:g}x fewer step FLOPs vs dense "
                  f"({sec.get('flop_reduction_vs_tileskip')}x vs "
                  f"tile-skip, core occupancy "
                  f"{sec.get('core_occupancy')}, parity="
                  f"{sec.get('parity')})")


def diff(old: dict, new: dict) -> dict:
    """Structured comparison of two artifact summaries."""
    out: dict = {"frames": {"old": old["frames"], "new": new["frames"]},
                 "by_status": {}, "metrics": {}}
    for status in sorted(set(old["by_status"]) | set(new["by_status"])):
        a = old["by_status"].get(status, 0)
        b = new["by_status"].get(status, 0)
        if a != b:
            out["by_status"][status] = {"old": a, "new": b}
    for scope in ("counters", "gauges"):
        for key in sorted(set(old[scope]) | set(new[scope])):
            a = old[scope].get(key)
            b = new[scope].get(key)
            if a != b:
                out["metrics"][key] = {"old": a, "new": b}
    solve_pct = None
    if old["solve_ms"] and new["solve_ms"] and old["solve_ms"]["mean"] > 0:
        solve_pct = 100.0 * (new["solve_ms"]["mean"]
                             / old["solve_ms"]["mean"] - 1.0)
    out["solve_ms_mean_pct"] = solve_pct
    # convergence-behavior drift: mean iterations_to_converge (SUCCESS
    # frames only, obs/run.py). Drift in EITHER direction is gated —
    # more iterations is slower convergence, but suddenly fewer is just
    # as suspicious (a broken stall test converges "instantly")
    conv_pct = None
    key = "iterations_to_converge"
    a = old.get("histograms", {}).get(key)
    b = new.get("histograms", {}).get(key)
    if a and b and a["mean"] > 0:
        conv_pct = 100.0 * (b["mean"] / a["mean"] - 1.0)
        out[key] = {"old": a["mean"], "new": b["mean"]}
    out["iterations_to_converge_mean_pct"] = conv_pct
    # bench headline delta (BENCH_*.json artifacts): value is a rate
    # (iterations/sec), so a DROP is the regression direction — the
    # opposite sign convention from solve_ms
    bench_pct = None
    if "bench" in old and "bench" in new and old["bench"]["value"] > 0:
        bench_pct = 100.0 * (new["bench"]["value"]
                             / old["bench"]["value"] - 1.0)
        out["bench"] = {"metric": new["bench"]["metric"],
                        "old": old["bench"]["value"],
                        "new": new["bench"]["value"]}
    out["bench_value_pct"] = bench_pct
    # occupancy-weighted straggler headline (continuous batching,
    # docs/PERFORMANCE.md §8): a rate, gated like the bench value
    strag_pct = None
    if ("straggler" in old and "straggler" in new
            and old["straggler"]["occ_frame_iter_s"] > 0):
        strag_pct = 100.0 * (new["straggler"]["occ_frame_iter_s"]
                             / old["straggler"]["occ_frame_iter_s"] - 1.0)
        out["straggler"] = {"old": old["straggler"]["occ_frame_iter_s"],
                            "new": new["straggler"]["occ_frame_iter_s"]}
    out["straggler_value_pct"] = strag_pct
    # integrity-on headline (numerical-integrity layer, RESILIENCE.md §8):
    # a rate, gated like the bench value — a run-over-run drop means the
    # ABFT check's overhead grew
    integ_pct = None
    if ("integrity" in old and "integrity" in new
            and old["integrity"]["iter_s_on"]):
        integ_pct = 100.0 * (new["integrity"]["iter_s_on"]
                             / old["integrity"]["iter_s_on"] - 1.0)
        out["integrity"] = {"old": old["integrity"]["iter_s_on"],
                            "new": new["integrity"]["iter_s_on"]}
    out["integrity_value_pct"] = integ_pct
    # accelerated time-to-solution (bench detail.tts, docs §9): the
    # log-path iteration-count speedup is a rate, gated like the bench
    # value — the gate the raw iter/s headline cannot provide
    tts_pct = None
    a = ((old.get("tts") or {}).get("log") or {}).get("iter_speedup")
    b = ((new.get("tts") or {}).get("log") or {}).get("iter_speedup")
    if a and b and a > 0:
        tts_pct = 100.0 * (b / a - 1.0)
        out["tts"] = {"old": a, "new": b}
    out["tts_log_speedup_pct"] = tts_pct
    # the parity verdict is a hard gate, not a rate: a NEW artifact whose
    # accelerated solve landed away from the unaccelerated stall point
    # (bench run_tts parity=False) is a correctness regression even when
    # the iteration speedup LOOKS better (fewer iterations to the wrong
    # answer)
    out["tts_parity_failed"] = sorted(
        name for name, sec in (new.get("tts") or {}).items()
        if isinstance(sec, dict) and sec.get("parity") is False
    )
    # block-sparse occ50 iteration-rate speedup (bench detail.sparse,
    # docs §10): a rate, gated like the bench value — a drop means the
    # tile-skip stopped paying or silently densified
    sparse_pct = None
    a = ((old.get("sparse") or {}).get("occ50") or {}).get("iter_speedup")
    b = ((new.get("sparse") or {}).get("occ50") or {}).get("iter_speedup")
    if a and b and a > 0:
        sparse_pct = 100.0 * (b / a - 1.0)
        out["sparse"] = {"old": a, "new": b}
    out["sparse_occ50_speedup_pct"] = sparse_pct
    # sparse parity is a hard gate like tts parity: a solve that drifted
    # from the dense reference is a correctness regression whatever the
    # speedup says
    out["sparse_parity_failed"] = sorted(
        name for name, sec in (new.get("sparse") or {}).items()
        if isinstance(sec, dict) and sec.get("parity") is False
    )
    # low-rank factored-RTM FLOP reduction (bench detail.lowrank, docs
    # §12): a rate, gated like the bench value — a drop means the
    # factorization stopped cutting FLOPs below the tile-skip floor
    lowrank_pct = None
    a = (old.get("lowrank") or {}).get("flop_reduction")
    b = (new.get("lowrank") or {}).get("flop_reduction")
    if a and b and a > 0:
        lowrank_pct = 100.0 * (b / a - 1.0)
        out["lowrank"] = {"old": a, "new": b}
    out["lowrank_flop_reduction_pct"] = lowrank_pct
    # lowrank parity is a hard gate like tts/sparse parity: a factored
    # solve that drifted from the dense reference is a correctness
    # regression whatever the FLOP ratio says
    out["lowrank_parity_failed"] = bool(
        isinstance(new.get("lowrank"), dict)
        and new["lowrank"].get("parity") is False
    )
    # solver-variant guard: run artifacts from different convergence
    # accelerators (os_subsets/momentum/logarithmic) are different
    # algorithms — their convergence-behavior and solve-ms gates are
    # SKIPPED, with a loud note (never a silent cross-variant compare)
    va, vb = old.get("variant"), new.get("variant")
    if va is not None and vb is not None and va != vb:
        out["variant_mismatch"] = {"old": va, "new": vb}
        out["solve_ms_mean_pct"] = None
        out["iterations_to_converge_mean_pct"] = None
    # serving-engine gates (docs/SERVING.md): queue wait is a cost (up
    # = worse, like solve_ms); the deadline-miss rate is compared in
    # percentage POINTS (a rate-of-rates would blow up on the healthy
    # zero-miss baseline)
    eng_wait_pct = None
    a = (old.get("engine") or {}).get("queue_wait_mean_s")
    b = (new.get("engine") or {}).get("queue_wait_mean_s")
    if a and b and a > 0:
        eng_wait_pct = 100.0 * (b / a - 1.0)
        out["engine_queue_wait"] = {"old": a, "new": b}
    out["engine_queue_wait_pct"] = eng_wait_pct
    miss_pts = None
    a = (old.get("engine") or {}).get("deadline_miss_rate")
    b = (new.get("engine") or {}).get("deadline_miss_rate")
    if a is not None and b is not None:
        miss_pts = 100.0 * (b - a)
        out["engine_deadline_miss"] = {"old": a, "new": b}
    out["engine_deadline_miss_pts"] = miss_pts
    # p99 queue wait (SLO accounting, docs §10): the tail is what an
    # SLO experiences — a mean gate can hide a regressed tail behind
    # many fast requests. Cost direction (up = worse), same threshold.
    p99_pct = None
    a = (old.get("engine") or {}).get("queue_wait_p99_s")
    b = (new.get("engine") or {}).get("queue_wait_p99_s")
    if a and b and a > 0:
        p99_pct = 100.0 * (b / a - 1.0)
        out["engine_queue_wait_p99"] = {"old": a, "new": b}
    out["engine_queue_wait_p99_pct"] = p99_pct
    # SLO error-budget burn, compared in percentage points like the
    # deadline-miss rate (a rate-of-rates blows up on a zero-burn
    # healthy baseline)
    burn_pts = None
    a = ((old.get("engine") or {}).get("slo") or {}).get("burn_rate")
    b = ((new.get("engine") or {}).get("slo") or {}).get("burn_rate")
    if a is not None and b is not None:
        burn_pts = 100.0 * (b - a)
        out["engine_slo_burn"] = {"old": a, "new": b}
    out["engine_slo_burn_pts"] = burn_pts
    # resident-cache hit rate, compared in percentage points with DROP
    # as the regression direction (positive = worse, matching the other
    # point gates): a thrashing cache rebuilds what it just evicted
    cache_pts = None
    a = ((old.get("engine") or {}).get("session_cache")
         or {}).get("hit_rate")
    b = ((new.get("engine") or {}).get("session_cache")
         or {}).get("hit_rate")
    if a is not None and b is not None:
        cache_pts = 100.0 * (a - b)
        out["engine_cache_hit"] = {"old": a, "new": b}
    out["engine_cache_hit_drop_pts"] = cache_pts
    # roofline utilization (bench detail.roofline, obs/roofline.py):
    # achieved-vs-peak MXU / HBM fractions are rates — a drop past the
    # threshold is a regression, independently of the raw headline
    for key in ("mxu_util", "hbm_util"):
        pct = None
        if "roofline" in old and "roofline" in new:
            a = old["roofline"].get(key)
            b = new["roofline"].get(key)
            if a is not None and b is not None and a > 0:
                pct = 100.0 * (b / a - 1.0)
                out.setdefault("roofline", {})[key] = {"old": a, "new": b}
        out[f"roofline_{key}_pct"] = pct
    out["notes"] = _diff_notes(old, new)
    return out


def _diff_notes(old: dict, new: dict) -> List[str]:
    """Why a gate did NOT run: sections present on one side only and
    zero-valued baselines. Printed by ``metrics_main`` so a skipped gate
    is a loud note on stderr, never a silent pass — an artifact missing
    its bench section must not read as "no regression"."""
    notes: List[str] = []
    va, vb = old.get("variant"), new.get("variant")
    if va is not None and vb is not None and va != vb:
        notes.append(
            f"solver variant differs (baseline {va} vs new {vb}) — "
            "convergence-behavior and solve-ms gates skipped: different "
            "algorithms are not comparable"
        )
    elif (va is None) != (vb is None):
        side = "baseline" if vb is not None else "new"
        notes.append(f"solver-variant meta missing from the {side} "
                     "artifact — variant comparability unknown")
    for section in ("bench", "straggler", "integrity", "roofline", "tts",
                    "sparse", "lowrank", "engine"):
        if (section in old) != (section in new):
            side = "baseline" if section in new else "new"
            notes.append(f"{section} section missing from the {side} "
                         "artifact — its rate gate skipped")
    if "engine" in old and "engine" in new:
        if not ((old["engine"].get("queue_wait_mean_s") or 0) > 0):
            notes.append("baseline engine queue-wait mean is zero/absent "
                         "— its gate skipped")
        for side, summ in (("baseline", old), ("new", new)):
            if summ["engine"].get("deadline_miss_rate") is None:
                notes.append(f"{side} engine admitted zero requests — "
                             "the deadline-miss gate skipped")
                break
        for side, summ in (("baseline", old), ("new", new)):
            if not (summ["engine"].get("queue_wait_p99_s") or 0) > 0:
                notes.append(
                    f"{side} engine queue-wait p99 is zero/absent (pre-"
                    "quantile artifact generation?) — the p99 gate "
                    "skipped"
                )
                break
        if ("slo" in old["engine"]) != ("slo" in new["engine"]):
            side = "baseline" if "slo" in new["engine"] else "new"
            notes.append(f"SLO accounting missing from the {side} "
                         "artifact (--slo_ms unset?) — the error-budget "
                         "burn comparison skipped")
        if (("session_cache" in old["engine"])
                != ("session_cache" in new["engine"])):
            side = ("baseline" if "session_cache" in new["engine"]
                    else "new")
            notes.append(f"session-cache counters missing from the "
                         f"{side} artifact (pre-multi-session engine?) "
                         "— the cache hit-rate comparison skipped")
    zero_checks = [
        ("bench", "value", "bench headline value"),
        ("straggler", "occ_frame_iter_s", "straggler occ frame-iter/s"),
        ("integrity", "iter_s_on", "integrity-on iter/s"),
    ]
    if "tts" in old and "tts" in new:
        # a zero/absent speedup on EITHER side skips the rate gate — and
        # on the new side that is itself suspicious (an errored tts item
        # or a speedup collapsed to 0 would otherwise sail through)
        for side, summ in (("baseline", old), ("new", new)):
            a = (summ["tts"].get("log") or {}).get("iter_speedup")
            if not (a or 0) > 0:
                notes.append(f"{side} tts log iteration speedup is zero/"
                             "absent — its rate gate skipped")
    if "sparse" in old and "sparse" in new:
        for side, summ in (("baseline", old), ("new", new)):
            a = (summ["sparse"].get("occ50") or {}).get("iter_speedup")
            if not (a or 0) > 0:
                notes.append(f"{side} sparse occ50 speedup is zero/"
                             "absent — its rate gate skipped")
    if "lowrank" in old and "lowrank" in new:
        for side, summ in (("baseline", old), ("new", new)):
            a = summ["lowrank"].get("flop_reduction")
            if not (a or 0) > 0:
                notes.append(f"{side} lowrank FLOP reduction is zero/"
                             "absent — its rate gate skipped")
                break
    for section, key, label in zero_checks:
        if (section in old and section in new
                and not (old[section].get(key) or 0) > 0):
            notes.append(f"baseline {label} is zero — its rate gate "
                         "skipped")
    if "roofline" in old and "roofline" in new:
        for key in ("mxu_util", "hbm_util"):
            a = old["roofline"].get(key)
            if a is not None and not a > 0:
                notes.append(f"baseline roofline {key} is zero — its "
                             "rate gate skipped")
    if (old.get("solve_ms") and new.get("solve_ms")
            and not old["solve_ms"]["mean"] > 0):
        notes.append("baseline mean solve-ms is zero — its gate skipped")
    old_h = set(old.get("histograms") or {})
    new_h = set(new.get("histograms") or {})
    for key in sorted(old_h.symmetric_difference(new_h)):
        side = "baseline" if key in new_h else "new"
        notes.append(f"histogram {key} missing from the {side} artifact "
                     "— not compared")
    key = "iterations_to_converge"
    a = (old.get("histograms") or {}).get(key)
    b = (new.get("histograms") or {}).get(key)
    if a and b and not a["mean"] > 0:
        notes.append(f"baseline {key} mean is zero — its drift gate "
                     "skipped")
    return notes


def metrics_main(argv: Optional[List[str]] = None) -> int:
    args = build_metrics_parser().parse_args(argv)
    expected = 2 if args.diff else 1
    if len(args.artifacts) != expected:
        print(f"sartsolve metrics: expected {expected} artifact path(s), "
              f"got {len(args.artifacts)} (see --help).", file=sys.stderr)
        return 1
    if args.threshold is not None and not args.diff:
        print("sartsolve metrics: --threshold needs --diff.",
              file=sys.stderr)
        return 1

    loaded = []
    ok = True
    for path in args.artifacts:
        records, errors = _load(path)
        for e in errors:
            print(f"{path}: {e}", file=sys.stderr)
        if errors:
            ok = False
        loaded.append(records)
    if not ok:
        return 1

    if args.check:
        if not args.json_:
            for path, records in zip(args.artifacts, loaded):
                print(f"{path}: ok ({len(records)} record(s))")
        else:
            print(json.dumps({"ok": True, "records":
                              [len(r) for r in loaded]}))
        return 0

    if args.diff:
        old, new = (summarize(r) for r in loaded)
        delta = diff(old, new)
        if args.json_:
            print(json.dumps(delta, indent=1))
        else:
            print(f"frames: {delta['frames']['old']} -> "
                  f"{delta['frames']['new']}")
            for status, d in delta["by_status"].items():
                print(f"  status {status}: {d['old']} -> {d['new']}")
            for key, d in delta["metrics"].items():
                print(f"  {key}: {d['old']} -> {d['new']}")
            if delta["solve_ms_mean_pct"] is not None:
                print(f"  mean solve ms: {old['solve_ms']['mean']:.2f} -> "
                      f"{new['solve_ms']['mean']:.2f} "
                      f"({delta['solve_ms_mean_pct']:+.1f}%)")
            if delta["iterations_to_converge_mean_pct"] is not None:
                d = delta["iterations_to_converge"]
                print(f"  mean iterations_to_converge: {d['old']:.2f} -> "
                      f"{d['new']:.2f} "
                      f"({delta['iterations_to_converge_mean_pct']:+.1f}%)")
            if delta["bench_value_pct"] is not None:
                print(f"  bench {delta['bench']['metric']}: "
                      f"{delta['bench']['old']:g} -> "
                      f"{delta['bench']['new']:g} "
                      f"({delta['bench_value_pct']:+.1f}%)")
            if delta["straggler_value_pct"] is not None:
                print(f"  straggler occ frame-iter/s: "
                      f"{delta['straggler']['old']:g} -> "
                      f"{delta['straggler']['new']:g} "
                      f"({delta['straggler_value_pct']:+.1f}%)")
            if delta["integrity_value_pct"] is not None:
                print(f"  integrity-on iter/s: "
                      f"{delta['integrity']['old']:g} -> "
                      f"{delta['integrity']['new']:g} "
                      f"({delta['integrity_value_pct']:+.1f}%)")
            if delta["tts_log_speedup_pct"] is not None:
                print(f"  tts log iteration speedup: "
                      f"{delta['tts']['old']:g}x -> "
                      f"{delta['tts']['new']:g}x "
                      f"({delta['tts_log_speedup_pct']:+.1f}%)")
            if delta["sparse_occ50_speedup_pct"] is not None:
                print(f"  sparse occ50 iter/s speedup: "
                      f"{delta['sparse']['old']:g}x -> "
                      f"{delta['sparse']['new']:g}x "
                      f"({delta['sparse_occ50_speedup_pct']:+.1f}%)")
            if delta["lowrank_flop_reduction_pct"] is not None:
                print(f"  lowrank step-FLOP reduction: "
                      f"{delta['lowrank']['old']:g}x -> "
                      f"{delta['lowrank']['new']:g}x "
                      f"({delta['lowrank_flop_reduction_pct']:+.1f}%)")
            for key in ("mxu_util", "hbm_util"):
                if delta[f"roofline_{key}_pct"] is not None:
                    d = delta["roofline"][key]
                    print(f"  roofline {key}: {d['old']:g} -> "
                          f"{d['new']:g} "
                          f"({delta[f'roofline_{key}_pct']:+.1f}%)")
            if delta["engine_queue_wait_pct"] is not None:
                d = delta["engine_queue_wait"]
                print(f"  engine queue-wait mean s: {d['old']:g} -> "
                      f"{d['new']:g} "
                      f"({delta['engine_queue_wait_pct']:+.1f}%)")
            if delta["engine_deadline_miss_pts"] is not None:
                d = delta["engine_deadline_miss"]
                print(f"  engine deadline-miss rate: {d['old']:g} -> "
                      f"{d['new']:g} "
                      f"({delta['engine_deadline_miss_pts']:+.1f} pts)")
            if delta["engine_queue_wait_p99_pct"] is not None:
                d = delta["engine_queue_wait_p99"]
                print(f"  engine queue-wait p99 s: {d['old']:g} -> "
                      f"{d['new']:g} "
                      f"({delta['engine_queue_wait_p99_pct']:+.1f}%)")
            if delta["engine_slo_burn_pts"] is not None:
                d = delta["engine_slo_burn"]
                print(f"  engine SLO burn rate: {d['old']:g} -> "
                      f"{d['new']:g} "
                      f"({delta['engine_slo_burn_pts']:+.1f} pts)")
            if delta["engine_cache_hit_drop_pts"] is not None:
                d = delta["engine_cache_hit"]
                print(f"  engine session-cache hit rate: {d['old']:g} "
                      f"-> {d['new']:g} "
                      f"({-delta['engine_cache_hit_drop_pts']:+.1f} "
                      "pts)")
        # a gate that did not run must say so — an artifact missing its
        # bench section, a zero baseline — never silently pass
        for note in delta.get("notes", ()):
            print(f"sartsolve metrics: note: {note}", file=sys.stderr)
        if args.threshold is not None:
            # regression directions differ by metric: solve_ms is a cost
            # (up = worse), the bench headline is a rate (down = worse)
            if (delta["solve_ms_mean_pct"] is not None
                    and delta["solve_ms_mean_pct"] > args.threshold):
                print(f"sartsolve metrics: mean solve-ms regression "
                      f"{delta['solve_ms_mean_pct']:+.1f}% exceeds the "
                      f"{args.threshold:g}% threshold.", file=sys.stderr)
                return 2
            if (delta["iterations_to_converge_mean_pct"] is not None
                    and abs(delta["iterations_to_converge_mean_pct"])
                    > args.threshold):
                print(f"sartsolve metrics: convergence-behavior drift "
                      f"{delta['iterations_to_converge_mean_pct']:+.1f}% "
                      f"(mean iterations_to_converge) exceeds the "
                      f"{args.threshold:g}% threshold.", file=sys.stderr)
                return 2
            if (delta["bench_value_pct"] is not None
                    and delta["bench_value_pct"] < -args.threshold):
                print(f"sartsolve metrics: bench value regression "
                      f"{delta['bench_value_pct']:+.1f}% exceeds the "
                      f"{args.threshold:g}% threshold.", file=sys.stderr)
                return 2
            if (delta["straggler_value_pct"] is not None
                    and delta["straggler_value_pct"] < -args.threshold):
                print(f"sartsolve metrics: straggler occupancy-weighted "
                      f"throughput regression "
                      f"{delta['straggler_value_pct']:+.1f}% exceeds the "
                      f"{args.threshold:g}% threshold.", file=sys.stderr)
                return 2
            if (delta["integrity_value_pct"] is not None
                    and delta["integrity_value_pct"] < -args.threshold):
                print(f"sartsolve metrics: integrity-on throughput "
                      f"regression {delta['integrity_value_pct']:+.1f}% "
                      f"exceeds the {args.threshold:g}% threshold.",
                      file=sys.stderr)
                return 2
            if delta.get("tts_parity_failed"):
                # correctness outranks the rate thresholds: parity=False
                # means the accelerated solve landed away from the
                # unaccelerated stall point, whatever the speedup says
                print(f"sartsolve metrics: accelerated time-to-solution "
                      f"parity FAILED for "
                      f"{', '.join(delta['tts_parity_failed'])} in the "
                      "new artifact (bench tts item).", file=sys.stderr)
                return 2
            if (delta["tts_log_speedup_pct"] is not None
                    and delta["tts_log_speedup_pct"] < -args.threshold):
                print(f"sartsolve metrics: accelerated log time-to-"
                      f"solution regression "
                      f"{delta['tts_log_speedup_pct']:+.1f}% (iteration "
                      f"speedup) exceeds the {args.threshold:g}% "
                      "threshold.", file=sys.stderr)
                return 2
            if delta.get("sparse_parity_failed"):
                print(f"sartsolve metrics: block-sparse parity FAILED "
                      f"for {', '.join(delta['sparse_parity_failed'])} "
                      "in the new artifact (bench sparse item).",
                      file=sys.stderr)
                return 2
            if (delta["sparse_occ50_speedup_pct"] is not None
                    and delta["sparse_occ50_speedup_pct"]
                    < -args.threshold):
                print(f"sartsolve metrics: block-sparse occ50 speedup "
                      f"regression "
                      f"{delta['sparse_occ50_speedup_pct']:+.1f}% "
                      f"exceeds the {args.threshold:g}% threshold.",
                      file=sys.stderr)
                return 2
            if delta.get("lowrank_parity_failed"):
                print("sartsolve metrics: low-rank factored-RTM parity "
                      "FAILED in the new artifact (bench lowrank item).",
                      file=sys.stderr)
                return 2
            if (delta["lowrank_flop_reduction_pct"] is not None
                    and delta["lowrank_flop_reduction_pct"]
                    < -args.threshold):
                print(f"sartsolve metrics: low-rank factored-RTM FLOP-"
                      f"reduction regression "
                      f"{delta['lowrank_flop_reduction_pct']:+.1f}% "
                      f"exceeds the {args.threshold:g}% threshold.",
                      file=sys.stderr)
                return 2
            for key in ("mxu_util", "hbm_util"):
                pct = delta[f"roofline_{key}_pct"]
                if pct is not None and pct < -args.threshold:
                    print(f"sartsolve metrics: roofline {key} "
                          f"utilization regression {pct:+.1f}% exceeds "
                          f"the {args.threshold:g}% threshold.",
                          file=sys.stderr)
                    return 2
            if (delta["engine_queue_wait_pct"] is not None
                    and delta["engine_queue_wait_pct"] > args.threshold):
                print(f"sartsolve metrics: engine queue-wait regression "
                      f"{delta['engine_queue_wait_pct']:+.1f}% exceeds "
                      f"the {args.threshold:g}% threshold.",
                      file=sys.stderr)
                return 2
            if (delta["engine_deadline_miss_pts"] is not None
                    and delta["engine_deadline_miss_pts"]
                    > args.threshold):
                print(f"sartsolve metrics: engine deadline-miss rate "
                      f"rose {delta['engine_deadline_miss_pts']:+.1f} "
                      f"percentage points, exceeding the "
                      f"{args.threshold:g}-point threshold.",
                      file=sys.stderr)
                return 2
            if (delta["engine_queue_wait_p99_pct"] is not None
                    and delta["engine_queue_wait_p99_pct"]
                    > args.threshold):
                print(f"sartsolve metrics: engine queue-wait p99 "
                      f"regression "
                      f"{delta['engine_queue_wait_p99_pct']:+.1f}% "
                      f"exceeds the {args.threshold:g}% threshold.",
                      file=sys.stderr)
                return 2
            if (delta["engine_slo_burn_pts"] is not None
                    and delta["engine_slo_burn_pts"] > args.threshold):
                print(f"sartsolve metrics: engine SLO error-budget "
                      f"burn rose "
                      f"{delta['engine_slo_burn_pts']:+.1f} percentage "
                      f"points, exceeding the {args.threshold:g}-point "
                      "threshold.", file=sys.stderr)
                return 2
            if (delta["engine_cache_hit_drop_pts"] is not None
                    and delta["engine_cache_hit_drop_pts"]
                    > args.threshold):
                print(f"sartsolve metrics: engine session-cache hit "
                      f"rate dropped "
                      f"{delta['engine_cache_hit_drop_pts']:+.1f} "
                      f"percentage points, exceeding the "
                      f"{args.threshold:g}-point threshold.",
                      file=sys.stderr)
                return 2
        return 0

    summary = summarize(loaded[0])
    if args.json_:
        print(json.dumps(summary, indent=1))
    else:
        _print_summary(args.artifacts[0], summary)
    return 0


# ---------------------------------------------------------------------------
# `sartsolve top`: refreshing one-screen view of a live run
# ---------------------------------------------------------------------------

def build_top_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sartsolve top",
        description="Refreshing one-screen view of a live run, rendered "
                    "from a file it already publishes: the Prometheus "
                    "textfile (SART_METRICS_PROM), the heartbeat file "
                    "(SART_HEARTBEAT_FILE), or a SIGUSR1 status snapshot "
                    "(<output>.status.json).",
    )
    p.add_argument("path", metavar="FILE",
                   help="Prometheus textfile, heartbeat file, or status "
                        "snapshot JSON to watch.")
    p.add_argument("--interval", type=float, default=2.0, metavar="S",
                   help="Refresh period in seconds (default 2).")
    p.add_argument("--once", action="store_true",
                   help="Render one frame and exit (scripting / tests).")
    p.add_argument("--lines", type=int, default=40,
                   help="Cap on rendered body lines (one screen).")
    return p


def _age_str(path: str) -> str:
    try:
        age = time.time() - os.stat(path).st_mtime
        return f"{age:.1f}s ago"
    except OSError:
        return "?"


def _fetch_url(url: str, timeout: float = 3.0) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8", "replace")


def _render_endpoint(base: str) -> List[str]:
    """One screen of a live engine's /status + /metrics endpoints.

    /status supplies the header/engine/sched view (its embedded metric
    list is skipped — /metrics is the canonical exposition and renders
    below it). A run with only one endpoint healthy still renders; both
    unreachable raises OSError, which preserves the ``--once`` exit-1
    contract for dead engines."""
    base = base.rstrip("/")
    lines: List[str] = []
    status_err: Optional[Exception] = None
    try:
        rec = json.loads(_fetch_url(base + "/status"))
        age = round(time.time() - rec["unix"], 1) if "unix" in rec \
            else "?"
        lines += _render_status(base + "/status", rec,
                                include_metrics=False,
                                age=f"{age}s ago")
    except (OSError, ValueError) as err:
        status_err = err
    try:
        text = _fetch_url(base + "/metrics")
        lines += _render_prom(base + "/metrics", text, age="live")
    except (OSError, ValueError) as err:
        if status_err is not None:
            raise OSError(
                f"engine endpoints unreachable ({status_err}; {err})"
            ) from err
    return lines


def _render_heartbeat(path: str, text: str) -> List[str]:
    fields = dict(
        tok.split("=", 1) for tok in text.split() if "=" in tok
    )
    lines = [f"heartbeat {path} (updated {_age_str(path)})"]
    for key in ("phase", "frames", "serial", "occupancy", "lanes"):
        if key in fields:
            lines.append(f"  {key:<10} {fields[key]}")
    return lines


def _render_prom(path: str, text: str,
                 age: Optional[str] = None) -> List[str]:
    lines = [f"prometheus {path} (updated {age or _age_str(path)})"]
    for raw in text.splitlines():
        raw = raw.strip()
        if not raw or raw.startswith("#"):
            continue
        name, _, value = raw.rpartition(" ")
        lines.append(f"  {name:<52} {value}")
    return lines


def _render_status(path: str, rec: dict, include_metrics: bool = True,
                   age: Optional[str] = None) -> List[str]:
    lines = [f"status {path} (snapshot {age or _age_str(path)})"]
    lb = rec.get("last_beacon") or {}
    lines.append(f"  frames_done {rec.get('frames_done')}   last beacon "
                 f"{lb.get('phase')} (serial {lb.get('serial')}, "
                 f"{lb.get('age_s')}s ago)")
    ages = rec.get("beacon_ages") or {}
    if ages:
        lines.append("  beacon ages: " + "  ".join(
            f"{ph}={age}s" for ph, age in ages.items()
        ))
    sched = rec.get("sched")
    if sched:
        lanes = sched.get("lanes")
        lines.append(
            f"  sched: occupancy {sched.get('occupancy')}  strides "
            f"{sched.get('strides')}  in-flight lanes "
            + (",".join(str(s) for s in lanes) if lanes else "-")
        )
    engine = rec.get("engine")
    if engine:
        active = engine.get("active_requests") or []
        lines.append(
            f"  engine: queue {engine.get('queue_depth')}  admitted "
            f"{engine.get('admitted')}  shed {engine.get('shed')}  "
            f"lanes {engine.get('lanes')}"
            + (f"  degraded ({engine['degraded']})"
               if engine.get("degraded") else "")
            + ("  draining" if engine.get("draining") else "")
        )
        requests = engine.get("requests") or {}
        if requests:
            # live request table: id, trace id, current lifecycle span
            for rid, info in sorted(requests.items()):
                lines.append(
                    f"  engine request {rid}: span "
                    f"{info.get('span')} trace {info.get('trace')}"
                )
        else:
            lines.append(
                "  engine requests in flight: "
                + (",".join(str(r) for r in active) if active else "-")
            )
        quarantined = engine.get("quarantined_tenants") or []
        tenants = engine.get("tenants") or {}
        if tenants:
            lines.append("  engine tenants: " + "  ".join(
                f"{name}(queued {st.get('queued', 0)}"
                + (f", quarantined {st.get('quarantined_s')}s"
                   if name in quarantined else "")
                + ")"
                for name, st in tenants.items()
            ))
    if include_metrics:
        for m in rec.get("metrics") or []:
            key = _metric_key(m)
            if m.get("kind") == "histogram":
                if m.get("count"):
                    lines.append(f"  {key:<44} count {m['count']:g} "
                                 f"mean {m['sum'] / m['count']:.2f}")
            else:
                lines.append(f"  {key:<44} {m.get('value', 0):g}")
    return lines


def render_top(path: str, max_lines: int = 40) -> str:
    """One screen of ``path``, whatever kind of live file — or live
    engine endpoint (``http://host:port``) — it is."""
    if path.startswith(("http://", "https://")):
        lines = _render_endpoint(path)
        if len(lines) > max_lines:
            dropped = len(lines) - max_lines
            lines = lines[:max_lines] + [f"  ... (+{dropped} more)"]
        return "\n".join(lines)
    with open(path) as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith("{"):
        lines = _render_status(path, json.loads(stripped.splitlines()[0]))
    elif stripped.startswith("#") or "# TYPE" in text:
        lines = _render_prom(path, text)
    elif "phase=" in stripped:
        lines = _render_heartbeat(path, stripped)
    else:
        raise ValueError(
            "unrecognized format (expected a Prometheus textfile, "
            "heartbeat line, or status snapshot JSON)"
        )
    if len(lines) > max_lines:
        dropped = len(lines) - max_lines
        lines = lines[:max_lines] + [f"  ... (+{dropped} more)"]
    return "\n".join(lines)


def top_main(argv: Optional[List[str]] = None) -> int:
    args = build_top_parser().parse_args(argv)
    try:
        while True:
            failed = False
            try:
                screen = render_top(args.path, max_lines=args.lines)
            except OSError as err:
                screen, failed = f"{args.path}: {err}", True
            except ValueError as err:
                screen, failed = f"{args.path}: unparseable ({err})", True
            if not args.once and sys.stdout.isatty():
                # clear + home: a refreshing view, not a scrolling log
                sys.stdout.write("\x1b[2J\x1b[H")
            print(screen, flush=True)
            if args.once:
                # scripting mode: a probe that could not render must be
                # distinguishable from a healthy screen (the live loop
                # keeps going — the file may simply not exist *yet*)
                return 1 if failed else 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
