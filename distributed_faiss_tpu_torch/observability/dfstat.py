"""dfstat, the live cluster CLI (counterpart of
distributed_faiss_tpu/observability/dfstat.py):

    python -m distributed_faiss_tpu_torch.observability.dfstat \\
        --discovery /path/to/disc.txt [--watch] [--interval 2] [--json]

Each poll sends ``get_perf_stats`` to every rank of the discovery file at
once (a dead rank becomes an error row: the CLI exists for outages), diffs
the cumulative counters against the previous poll with
``LatencyStats.delta``, and prints one line per rank: search rate and
latency, scheduler queue, shed and busy counts, RPC calls in flight,
anti-entropy suspects and mismatches, the compaction lease and the lowest
live fraction of the rank's indexes. ``--watch`` repaints every
``--interval`` seconds; ``--json`` prints one JSON document a poll.

``--trace <id>`` prints one sampled request's timeline instead: every
rank's spans for it (the ``get_trace_spans`` op), merged and listed with
offset, duration, stage, rank and the stage's extras. Trace ids come from
the ``p99_exemplar`` fields of the stats view.
"""

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from distributed_faiss_tpu_torch.observability import spans as obs_spans
from distributed_faiss_tpu_torch.parallel import replication, rpc
from distributed_faiss_tpu_torch.utils.tracing import LatencyStats


def _connect(discovery_path: str, connect_timeout: float = 3.0):
    """A mutable ``[host, port, stub or None]`` per discovery entry: a rank
    that is down keeps its row with no stub, and every poll dials it again
    (``_stub_of``)."""
    with open(discovery_path) as f:
        _num, entries = replication.parse_discovery_lines(f)
    out = []
    for i, (host, port) in enumerate(entries):
        try:
            stub = rpc.Client(i, host, port, connect_timeout=connect_timeout)
        except OSError:
            stub = None
        out.append([host, port, stub])
    return out


def _stub_of(entry, connect_timeout: float = 1.0):
    """The entry's stub, dialing one that never connected; None while the
    rank stays down."""
    if entry[2] is None:
        try:
            # the stub id is only a log label; -1 marks a CLI redial
            entry[2] = rpc.Client(-1, entry[0], entry[1], connect_timeout=connect_timeout)
        except OSError:
            return None
    return entry[2]


def _fanout_pool(stubs) -> ThreadPoolExecutor:
    """One executor a dfstat run, reused by every poll."""
    return ThreadPoolExecutor(max_workers=max(len(stubs), 1),
                              thread_name_prefix="dfstat-fanout")


def poll(stubs, pool: ThreadPoolExecutor) -> list:
    """One stats sweep over every rank at once: per rank its
    ``get_perf_stats`` dict or an ``{"error", "host", "port"}`` row."""

    def one(entry):
        stub = _stub_of(entry)
        if stub is None:
            return {"error": "unreachable", "host": entry[0], "port": entry[1]}
        try:
            return stub.generic_fun("get_perf_stats", timeout=5.0)
        except rpc.RETRYABLE_ERRORS + (rpc.ServerException,) as e:
            return {"error": f"{type(e).__name__}: {e}", "host": entry[0], "port": entry[1]}

    return list(pool.map(one, stubs))


def _rate_row(prev: dict, cur: dict, dt: float) -> dict:
    """One rank's numbers for one poll interval, through
    ``LatencyStats.delta``."""
    ops = LatencyStats.delta(prev if isinstance(prev, dict) else None, cur)
    search = ops.get("search", {})
    row = {
        "search_per_s": (search.get("count", 0) / dt) if dt > 0 else 0.0,
        "search_ms": search.get("interval_mean_s", 0.0) * 1e3,
        "search_p99_ms": cur.get("search", {}).get("p99_s", 0.0) * 1e3,
        "p99_exemplar": cur.get("search", {}).get("p99_exemplar"),
    }
    counters = (cur.get("scheduler") or {}).get("counters") or {}
    prev_counters = ((prev or {}).get("scheduler") or {}).get("counters") or {}

    def counter_delta(key):
        # a counter that went backward: the rank restarted, count from zero
        c, p = counters.get(key, 0), prev_counters.get(key, 0)
        return c if c < p else c - p

    row.update({"queued": counters.get("queued", 0), "shed": counter_delta("shed_deadline"),
                "busy": counter_delta("rejected_busy")})
    row["in_flight"] = (cur.get("rpc") or {}).get("in_flight", 0)
    repl = cur.get("replication") or {}
    row["rank"] = repl.get("rank")
    row["group"] = repl.get("shard_group")
    ae = cur.get("antientropy") or {}
    row["suspects"] = len(ae.get("suspect_peers") or ())
    row["mismatched"] = ae.get("digests_mismatched", 0)
    row["lease"] = ae.get("compaction_held")
    live = [m.get("live_fraction") for m in (cur.get("mutation") or {}).values()
            if isinstance(m, dict) and m.get("live_fraction") is not None]
    row["live_frac"] = min(live) if live else 1.0
    return row


_HEADER = (f"{'rank':>4} {'grp':>3} {'srch/s':>8} {'ms':>7} {'p99ms':>8} "
           f"{'queued':>6} {'shed':>5} {'busy':>5} {'infl':>4} "
           f"{'susp':>4} {'mism':>4} {'lease':>5} {'live%':>6}")


def _render_row(row: dict) -> str:
    lease = "yes" if row["lease"] else ("-" if row["lease"] is None else "no")
    return (f"{row['rank'] if row['rank'] is not None else '?':>4} "
            f"{row['group'] if row['group'] is not None else '-':>3} "
            f"{row['search_per_s']:>8.1f} {row['search_ms']:>7.2f} "
            f"{row['search_p99_ms']:>8.2f} {row['queued']:>6} "
            f"{row['shed']:>5} {row['busy']:>5} {row['in_flight']:>4} "
            f"{row['suspects']:>4} {row['mismatched']:>4} {lease:>5} "
            f"{row['live_frac'] * 100:>6.1f}")


def render_stats(prev: list, cur: list, dt: float, as_json: bool) -> str:
    rows = []
    lines = [] if as_json else [_HEADER]
    for i, entry in enumerate(cur):
        p = prev[i] if prev and i < len(prev) else None
        if "error" in entry:
            rows.append({"rank": None, "error": entry["error"], "host": entry.get("host"),
                         "port": entry.get("port")})
            if not as_json:
                lines.append(f"   ? DEAD {entry.get('host')}:{entry.get('port')} — "
                             f"{entry['error']}")
            continue
        row = _rate_row(p if p and "error" not in p else None, entry, dt)
        rows.append(row)
        if not as_json:
            lines.append(_render_row(row))
            if row.get("p99_exemplar"):
                lines.append(f"     └ p99 exemplar trace: {row['p99_exemplar']} "
                             f"(dfstat --trace {row['p99_exemplar']})")
    if as_json:
        return json.dumps({"interval_s": round(dt, 3), "ranks": rows})
    return "\n".join(lines)


def render_trace(spans: list, trace_id: str, as_json: bool) -> str:
    """One timeline, offsets from the earliest span's start."""
    if as_json:
        return json.dumps({"trace_id": trace_id, "spans": spans})
    if not spans:
        return (f"trace {trace_id}: no spans retained (evicted ring, unsampled request, "
                "or wrong id)")
    t0 = min(s["start_s"] for s in spans)
    end = max(s["start_s"] + s["dur_s"] for s in spans)
    lines = [f"trace {trace_id} — {len(spans)} spans, {(end - t0) * 1e3:.2f} ms end-to-end"]
    for s in spans:
        rank = s.get("rank")
        where = f"rank {rank}" if rank is not None else "client"
        extras = " ".join(f"{k}={v}" for k, v in (s.get("extra") or {}).items())
        lines.append(f"  +{(s['start_s'] - t0) * 1e3:>9.3f} ms {s['dur_s'] * 1e3:>9.3f} ms  "
                     f"{s['name']:<16} {where:<8} {extras}")
    return "\n".join(lines)


def fetch_trace(stubs, trace_id: str, pool: ThreadPoolExecutor) -> list:
    """Every reachable rank's spans of ``trace_id``, merged."""

    def one(entry):
        stub = _stub_of(entry)
        if stub is None:
            return []
        try:
            return stub.generic_fun("get_trace_spans", (trace_id,), timeout=5.0)
        except rpc.RETRYABLE_ERRORS + (rpc.ServerException,):
            return []  # a dead rank: the timeline shows the others

    return obs_spans.merge_timelines(*pool.map(one, stubs))


def main(argv=None, out=None) -> int:
    out = sys.stdout if out is None else out
    parser = argparse.ArgumentParser(prog="dfstat", description=__doc__.splitlines()[0])
    parser.add_argument("--discovery", required=True,
                        help="cluster discovery file (host,port per rank)")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="seconds between polls (rates are per interval)")
    parser.add_argument("--watch", action="store_true",
                        help="repaint continuously until interrupted")
    parser.add_argument("--count", type=int, default=1,
                        help="polls to run without --watch (default 1; the first poll "
                             "shows totals as rates)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output (one JSON document a poll)")
    parser.add_argument("--trace", default=None, metavar="TRACE_ID",
                        help="print the merged span timeline of one sampled request "
                             "instead of the stats view")
    args = parser.parse_args(argv)

    stubs = _connect(args.discovery)
    pool = _fanout_pool(stubs)
    try:
        if args.trace is not None:
            spans = fetch_trace(stubs, args.trace, pool)
            print(render_trace(spans, args.trace, args.json), file=out)
            return 0 if spans else 1
        prev, prev_t = None, time.monotonic() - max(args.interval, 1e-9)
        n = 0
        while True:
            cur = poll(stubs, pool)
            now = time.monotonic()
            text = render_stats(prev, cur, now - prev_t, args.json)
            if args.watch and not args.json:
                out.write("\x1b[2J\x1b[H")  # clear + home
            print(text, file=out, flush=True)
            prev, prev_t = cur, now
            n += 1
            if not args.watch and n >= args.count:
                return 0
            try:
                time.sleep(args.interval)
            except KeyboardInterrupt:
                return 0
    finally:
        pool.shutdown(wait=False)
        for _h, _p, stub in stubs:
            if stub is not None:
                stub.close()


if __name__ == "__main__":
    sys.exit(main())
