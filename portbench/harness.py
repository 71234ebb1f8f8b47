"""One run of one cell: set-up, the timed closed-loop window over
``IndexClient.search``, the traced sub-window, and the comparison with the
plain reference that decides ``correct``.

The served path under test: the harness's client threads, each with the
port's ``IndexClient`` over a discovery file → rpc and wire → the rank's
``IndexServer`` (``rank.py``, a process of its own) → ``SearchScheduler``
→ ``engine.Index.search_batched`` → the model's captured programs → K1 or
K3 over the probed lists → the per-group top-k → the client's merge.
"""

import gc
import json
import os
import threading
import time

import numpy as np

from portbench import corpus as corpus_mod
from portbench import reference, spec, traffic
from portbench.rank import forbidden_modules
from portbench.rankproc import RankProcess, RunError

INDEX_ID = "bench"
# rows an add_index_data frame carries (load_data's --bs)
FRAME_ROWS = 50_000
# requests each client sends to warm its connection and the request shape
WARM_REQUESTS = 2
# the loop runs this long before the window opens
RAMP_S = 1.0
# the traced sub-window at the window's end: this share of it, at most
TRACE_SHARE, TRACE_MAX_S = 0.25, 3.0
# answered requests drawn from the seed for the comparison
SAMPLE_REQUESTS = 8
# a minute past the close for the answers still in flight
LATE_S = 60.0
# a traced window's loop runs on until its sub-window is traced, at most
TRACE_LIMIT_S = 120.0
# the profiler's stop and the trace's summary, at most
TRACE_STOP_S = 90.0
BUILD_LIMIT_S = 600.0
GIB = float(1 << 30)


def log(msg: str) -> None:
    print(msg, flush=True)


def wait_until(pred, limit_s: float, what: str, poll_s: float = 0.05) -> None:
    deadline = time.perf_counter() + limit_s
    while not pred():
        if time.perf_counter() > deadline:
            raise RunError(f"{what}: not reached in {limit_s:.0f} s")
        time.sleep(poll_s)


def build_shard(client, cfg, x: np.ndarray, times: dict) -> None:
    """``create_index`` and ``add_index_data`` in 50,000-row frames with the
    row number as each row's metadata (``load_data``'s way): the frames
    up to ``train_num`` first, then the threshold training runs on them
    alone, then the rest and the add drain."""
    from distributed_faiss_tpu_torch.utils.state import IndexState

    if client.create_index(INDEX_ID, cfg) != [True]:
        raise RunError("create_index failed")
    n = x.shape[0]
    train_rows = min(n, -(-int(cfg.train_num) // FRAME_ROWS) * FRAME_ROWS)

    def send(lo: int, hi: int) -> None:
        for s in range(lo, hi, FRAME_ROWS):
            e = min(hi, s + FRAME_ROWS)
            client.add_index_data(INDEX_ID, x[s:e], list(range(s, e)))

    t = time.perf_counter()
    send(0, train_rows)
    times["ingest_train_rows_s"] = time.perf_counter() - t
    t = time.perf_counter()
    wait_until(lambda: client.get_state(INDEX_ID) in (IndexState.ADD, IndexState.TRAINED),
               BUILD_LIMIT_S, "training")
    times["train_s"] = time.perf_counter() - t
    t = time.perf_counter()
    send(train_rows, n)
    times["ingest_rest_s"] = time.perf_counter() - t
    t = time.perf_counter()
    wait_until(lambda: (client.get_state(INDEX_ID) == IndexState.TRAINED
                        and client.get_buffer_depth(INDEX_ID) == 0
                        and client.get_ntotal(INDEX_ID) == n), BUILD_LIMIT_S, "add drain")
    times["add_drain_s"] = time.perf_counter() - t


def perf_snapshot(client) -> dict:
    """The rank's host counters and the kernel wrappers' launches."""
    stats = client.get_perf_stats()[0]
    stats["kernels"] = client.ping()[0]["kernels"]
    return stats


def sample_requests(requests: list, seed: int) -> list:
    """Up to SAMPLE_REQUESTS answered requests, drawn from the seed."""
    answered = [r for r in requests if r.error is None and r.ids is not None]
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 7])
    pick = rng.choice(len(answered), size=min(SAMPLE_REQUESTS, len(answered)), replace=False)
    return [answered[i] for i in sorted(pick)]


def checks_of(numbers: dict, failed: int, mix: dict, point: dict) -> dict:
    """Each compared number beside its limit; ``ok`` per number."""
    lim = point.get("limits", {})
    return {
        "unanswered": {"value": failed, "limit": 0, "ok": failed == 0},
        "bad_rows": {"value": numbers["bad_rows"], "limit": 0,
                     "ok": numbers["bad_rows"] == 0},
        "recall10": {"value": numbers["recall10"], "limit": mix["recall_bar"],
                     "ok": numbers["recall10"] >= mix["recall_bar"]},
        "dist_gap": {"value": numbers["dist_gap"], "limit": lim.get("dist_gap"),
                     "ok": lim.get("dist_gap") is not None
                     and numbers["dist_gap"] <= lim["dist_gap"]},
    }


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", rank: RankProcess = None) -> dict:
    """Run ``cell`` once; returns the result line's object (with the
    checks' numbers under ``checks``, last). ``rank``: the rank's process,
    spawned early so that it imports while this process draws the data
    (spawned here when not given); closed before the comparison."""
    import torch

    from distributed_faiss_tpu_torch.parallel.client import IndexClient
    from distributed_faiss_tpu_torch.utils.config import IndexCfg

    cfg_json, mix, point = cell.config, cell.mix, cell.point
    times = {"imports_s": time.perf_counter() - t_start}
    rows_req, k, clients = int(mix["rows_per_request"]), int(mix["k"]), int(mix["clients"])

    if rank is None:
        rank = RankProcess(device)
    window_clients = []
    loader = observer = qpool = None
    try:
        # data: drawn on the card from the seed, kept on the host, card freed
        t = time.perf_counter()
        gen = corpus_mod.make_corpus(cfg_json, device)
        x = gen.draw(int(cfg_json["rows"]), seed, "rows").cpu().numpy()
        # the pool's first chunks cover the cell's pool_rate over the window;
        # later ones are drawn on the host while the window runs
        n_chunk = traffic.chunk_rows(rows_req)
        first = max(1, -(-int(point["pool_rate"] * (seconds + RAMP_S)) // n_chunk))
        chunks = [gen.draw(n_chunk, seed, "queries", i).cpu().numpy() for i in range(first)]
        warm = gen.draw(clients * WARM_REQUESTS * rows_req, seed, "warm").cpu().numpy()
        del gen
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        times["data_s"] = time.perf_counter() - t

        t = time.perf_counter()
        hello = rank.start()
        times["rank_start_s"] = time.perf_counter() - t
        for key in ("imports_s", "cuda_init_s", "kernel_load_s"):
            times[f"rank_{key}"] = hello[key]
        disc = hello["disc"]

        index_kw = dict(cfg_json["index"])
        index_kw["nprobe"] = int(point["nprobe"])
        cfg = IndexCfg(**index_kw)
        loader = IndexClient(disc)
        build_shard(loader, cfg, x, times)
        loader.set_nprobe(INDEX_ID, int(point["nprobe"]))

        # warm-up: each client's connection and the request shape (its
        # program is captured on the first request)
        t = time.perf_counter()
        for _ in range(clients):
            c = IndexClient(disc)
            c.cfg = cfg
            window_clients.append(c)
        for i, c in enumerate(window_clients):
            for j in range(WARM_REQUESTS):
                s = (i * WARM_REQUESTS + j) * rows_req
                c.search(warm[s:s + rows_req], k, INDEX_ID)
        times["warm_s"] = time.perf_counter() - t
        programs_warm = rank.call("programs", index=INDEX_ID)
        times["captures"] = programs_warm["captures"]
        times["capture_s"] = programs_warm["capture_s"]
        observer = IndexClient(disc) if trace else None
        if trace:
            # the profiler's own start-up, outside the window
            rank.call("trace_start")
            rank.call("trace_stop")

        # the window: the loop runs RAMP_S before it opens; a traced run's
        # closes once its sub-window is traced
        host_gen = corpus_mod.make_corpus(cfg_json, "cpu")
        qpool = traffic.Pool(
            chunks, rows_req,
            more=lambda i: host_gen.draw(n_chunk, seed, "queries", i).numpy())
        loop = traffic.ClosedLoop(
            [lambda q, kk, c=c: c.search(q, kk, INDEX_ID) for c in window_clients], qpool, k)
        ramp0 = time.perf_counter()
        w0 = ramp0 + RAMP_S
        w1 = w0 + seconds
        sub_s = min(TRACE_MAX_S, TRACE_SHARE * seconds)
        tp = w1 - sub_s
        snaps = {}
        trace_out = None
        box = {}
        stop_at = w1 + (TRACE_LIMIT_S if trace else 0.0)

        def drive():
            try:
                box["reqs"] = loop.run(stop_at, LATE_S)
            except traffic.PoolExhausted as e:
                box["error"] = e

        runner = threading.Thread(target=drive, name="bench-loop", daemon=True)
        setup_s = w0 - t_start
        # the clients' own objects leave the collector's scans
        gc.freeze()
        runner.start()
        if trace:
            time.sleep(max(0.0, w0 - time.perf_counter()))
            snaps["w0"] = perf_snapshot(observer)
            time.sleep(max(0.0, tp - time.perf_counter()))
            tp = time.perf_counter()
            snaps["tp"] = perf_snapshot(observer)
            rank.call("trace_start")
            time.sleep(sub_s)
            w1 = time.perf_counter()
            loop.stop.set()
            runner.join(timeout=LATE_S + 5)
            t = time.perf_counter()
            trace_out = rank.call("trace_stop", timeout=TRACE_STOP_S, until=w1)
            times["trace_stop_s"] = time.perf_counter() - t
        runner.join(timeout=max(0.0, stop_at - time.perf_counter()) + LATE_S + 5)
        if "error" in box:
            raise box["error"]
        if "reqs" not in box:
            raise RunError("the client loop did not end")
        requests = box["reqs"]
        late = loop.stragglers
        gc.unfreeze()

        memory = rank.call("memory")
        programs_after = rank.call("programs", index=INDEX_ID)
        snapshot = None
        if trace:
            path = os.path.join(rank.work, "snapshot.npz")
            rank.call("snapshot", index=INDEX_ID, path=path)
            with np.load(path) as z:
                snapshot = {"centroids": z["centroids"], "sizes": z["sizes"]}
        rank_forbidden = rank.call("modules")["forbidden"]
    finally:
        if qpool is not None:
            qpool.close()
        for c in window_clients + [loader, observer]:
            if c is not None:
                c.close()
        rank.close()

    found = sorted(set(forbidden_modules()) | set(rank_forbidden))
    if found:
        raise RunError(f"modules of JAX or of the JAX package loaded: {found}")

    stats = traffic.window_stats(requests, w0, w1)
    attempted = len(requests)
    failed = sum(r.error is not None for r in requests) + late
    times["cpus"] = sorted(os.sched_getaffinity(0))
    log("setup: " + json.dumps({"setup_s": setup_s, **times}))
    log(f"window: {json.dumps(stats)}; {attempted} requests sent, {failed} failed "
        f"or unanswered, {late} still in flight a minute past the close; query pool: "
        f"{qpool.first} chunks of {qpool.chunk_rows} rows drawn in set-up, {qpool.drawn} "
        f"in {qpool.draw_s:.2f} s while the loop ran, {qpool.waits} requests waited "
        f"{qpool.wait_s:.3f} s for one")

    # the comparison, once the program is gone from the card
    t = time.perf_counter()
    sample = sample_requests(requests, seed)
    if sample:
        xs = torch.as_tensor(x, device=device)
        q = np.concatenate([qpool.batch(r.offset) for r in sample])
        numbers = reference.compare(xs, torch.as_tensor(q, device=device),
                                    np.concatenate([r.dist for r in sample]),
                                    np.concatenate([r.ids for r in sample]))
        del xs
    else:
        numbers = {"bad_rows": 0, "recall10": 0.0, "dist_gap": float("inf")}
    checks = checks_of(numbers, failed, mix, point)
    log(f"recall@10 {numbers['recall10']:.4f} at nprobe {point['nprobe']} over "
        f"{len(sample) * rows_req} sampled queries (the operating point: "
        f"{point['recall10']}); reference {time.perf_counter() - t:.2f} s")

    ctx = dict(cell=cell, requests=requests, w0=w0, w1=w1, tp=tp, snaps=snaps,
               trace=trace_out, programs=programs_after, snapshot=snapshot, pool=qpool,
               device=device, index_id=INDEX_ID, seed=seed)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = spec.load_reader(m["name"], cell.bench_dir)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"qps": stats["qps"], "p95_ms": stats["p95_ms"],
               "device_mem_gib": memory["max_reserved"] / GIB, "setup_s": setup_s}
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell.chips, "memory_peak_bytes": int(memory["max_reserved"])}
    out = {"correct": all(c["ok"] for c in checks.values()), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if trace and trace_out is not None:
        dev["busy_s"] = trace_out["busy_s"]
        dev["window_s"] = trace_out["window_s"]
        out["breakdown"] = {"device_ops": trace_out["device_ops"],
                            "idle_gaps": trace_out["idle_gaps"]}
    out["checks"] = {name: {"value": c["value"], "limit": c["limit"]}
                     for name, c in checks.items()}
    return out
