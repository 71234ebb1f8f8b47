#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (distributed_faiss_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--seed 0] [--n 1000000] [--nq 10000] [--nprobe-from 1]
                          [--profile]

Phases, in order; any failure raises and the script exits nonzero:

1. Environment: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the build of every kernel source under
   ``distributed_faiss_tpu_torch/csrc`` (one nvcc per source, started
   together) with nvcc's register/spill report.
2. Kernel phase: the flat list-scan kernel (K1, ``csrc/flat_scan.cu``)
   against its plain PyTorch version on the card, for every variant
   (f32/f16/sq8 lists x l2 with stored norms, l2 with recomputed norms,
   dot; plus scan_bf16), at d=128 and d=768, nq=256, g=1..4, cap=2048.
   The -inf masks must be identical and the finite scores agree within
   rtol/atol 1e-4 (5e-2/5e-1 for scan_bf16). Both are timed with CUDA
   events after warm-up.
3. Main path: one port ``IndexServer(device="cuda")`` on a loopback port
   and an ``IndexClient`` over a discovery file. create_index with the
   README Quickstart cfg on the ``ivfsq`` builder, add ``--n`` clustered
   rows (the generator of bench.py, 1024 centers) with metadata in
   batches, wait for the threshold training and the add drain, sweep
   nprobe by doubling from ``--nprobe-from`` until recall@10 >= 0.95
   against the port's exact FlatIndex on the card, then serve ``--nq`` queries at top-10 from
   concurrent clients (QPS and p50/p99 request latency), and
   save -> drop -> load and check the same ids come back. K1's launch
   count is zeroed just before this phase and read just after it.
4. K1 at the main path's own shapes (the loaded index's lists and one
   query block's first probe group): kernel vs plain time, its bound, and
   the kernels JSON line.

The last line is {"ok": true, "device": {"platform": "gpu", ...}}. Without
CUDA, or outside a checkout of the repo, the script exits nonzero before
printing any result.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and fp32
# rate outside the tensor cores. K1 does fp32 FMAs on CUDA cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

K1_REPLACES = "distributed_faiss_tpu/ops/flat_pallas.py:113"
K1_SOURCE = "distributed_faiss_tpu_torch/csrc/flat_scan.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean device time of one ``fn()`` call, from CUDA events around
    ``iters`` back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_bound(q, list_data, li, list_sizes, stored_norms: bool):
    """(bound_ms, bound_by, bytes, flops) of one K1 call on these inputs.
    Bytes: each input byte the call needs read once — the live rows
    (payload + id + stored norm) of every distinct probed list, the query
    block, the probe indices and their fill counts — and the (nq, g, cap)
    fp32 scores written once. Operations: 2*d flops (the dot) for each
    (query, probe, live row) triple; decode and the l2 combine add a few
    more per row, which are left out."""
    nq, d = q.shape
    g = li.shape[1]
    cap = list_data.shape[1]
    sizes = list_sizes.clamp(max=cap)
    unique_live = int(sizes[torch.unique(li.long())].sum().item())
    pair_live = int(sizes[li.long()].sum().item())
    row_bytes = d * list_data.element_size() + 4 + (4 if stored_norms else 0)
    nbytes = unique_live * row_bytes + nq * g * cap * 4 + nq * d * 4 + 2 * nq * g * 4
    flops = pair_live * 2 * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def compare_scores(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float,
                   what: str) -> float:
    """Identical -inf masks and allclose finite scores; returns the max
    absolute error over the finite entries."""
    got_inf, want_inf = torch.isinf(got), torch.isinf(want)
    if not torch.equal(got_inf, want_inf):
        bad = int((got_inf != want_inf).sum().item())
        raise AssertionError(f"{what}: -inf masks differ in {bad} slots")
    if not bool(torch.isfinite(got[~got_inf]).all()):
        raise AssertionError(f"{what}: NaN in kernel scores")
    f = ~want_inf
    if not bool(f.any()):
        return 0.0
    err = (got[f] - want[f]).abs()
    lim = atol + rtol * want[f].abs()
    if not bool((err <= lim).all()):
        i = int(torch.argmax(err - lim).item())
        raise AssertionError(
            f"{what}: scores disagree beyond rtol={rtol} atol={atol}: max abs err "
            f"{float(err.max()):.4g}, worst {float(got[f][i]):.6g} vs {float(want[f][i]):.6g}")
    return float(err.max().item())


# ---------------------------------------------------------------- phase 2


def kernel_variants():
    """(codec, metric, stored_norms, scan_bf16): every K1 variant."""
    out = []
    for codec in ("f32", "f16", "sq8"):
        out.append((codec, "l2", True, False))
        out.append((codec, "l2", False, False))
        out.append((codec, "dot", False, False))
        out.append((codec, "l2", True, True))
    return out


def kernel_phase(flat_scan, distance, seed: int) -> list:
    """K1 vs its plain version for every variant at d=128 and d=768."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    nq, cap, nlist = 256, 2048, 32
    rows = []
    for d in (128, 768):
        for vi, (codec, metric, stored, bf16) in enumerate(kernel_variants()):
            g = 1 + vi % 4
            dev = "cuda"
            q = torch.randn((nq, d), generator=gen, device=dev)
            if codec == "sq8":
                data = torch.randint(0, 256, (nlist, cap, d), generator=gen, device=dev,
                                     dtype=torch.int32).to(torch.uint8)
                vmin = torch.randn((d,), generator=gen, device=dev)
                span = torch.rand((d,), generator=gen, device=dev) + 0.5
                decoded = vmin + data.float() * (span / 255.0)
            else:
                vmin = span = None
                data = torch.randn((nlist, cap, d), generator=gen, device=dev).to(
                    flat_scan.CODECS[codec][1])
                decoded = data.float()
            norms = distance.row_norms_f32(decoded) if (metric == "l2" and stored) else None
            del decoded
            ids = torch.randint(0, 1 << 20, (nlist, cap), generator=gen, device=dev,
                                dtype=torch.int32)
            ids[torch.rand((nlist, cap), generator=gen, device=dev) < 0.05] = -1
            sizes = torch.randint(0, cap + 1, (nlist,), generator=gen, device=dev,
                                  dtype=torch.int32)
            sizes[0] = cap  # one full list
            li = torch.randint(0, nlist, (nq, g), generator=gen, device=dev,
                               dtype=torch.int32)
            li[0, 0] = 0
            sizes_g = sizes[li.long()].contiguous()
            args = (q, data, ids, li, sizes_g, norms, vmin, span)
            kw = dict(metric=metric, codec=codec, scan_bf16=bf16)
            got = flat_scan.flat_list_scan(*args, **kw)
            want = flat_scan.flat_list_scan_plain(*args, **kw)
            torch.cuda.synchronize()
            rtol, atol = (5e-2, 5e-1) if bf16 else (1e-4, 1e-4)
            name = (f"d={d} {codec} {metric}"
                    f"{' stored' if stored else (' recompute' if metric == 'l2' else '')}"
                    f"{' bf16' if bf16 else ''} g={g}")
            err = compare_scores(got, want, rtol, atol, f"K1 {name}")
            ms = time_ms(lambda: flat_scan.flat_list_scan(*args, **kw))
            plain_ms = time_ms(lambda: flat_scan.flat_list_scan_plain(*args, **kw),
                               warmup=1, iters=5)
            bound_ms, bound_by, _, _ = k1_bound(q, data, li, sizes, norms is not None)
            rows.append(dict(variant=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by))
            log(f"K1 {name}: ok max_abs_err={err:.3g} (rtol={rtol} atol={atol}) "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by})")
            del args, got, want, data, ids, norms
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- phase 3


def make_corpus(rng, n: int, d: int, centers: np.ndarray) -> np.ndarray:
    """bench.py's generator: points drawn from gaussian-mixture centers."""
    assign = rng.integers(0, centers.shape[0], n)
    return (centers[assign] + rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


def check_result(D: np.ndarray, meta, nq: int, k: int, what: str) -> None:
    """(nq, k) l2 distances, ascending, finite where a row was found and
    +inf where fewer than k candidates were live (metadata None)."""
    live = np.array([[m is not None for m in row] for row in meta], bool)
    with np.errstate(invalid="ignore"):  # inf - inf between two pad slots
        unsorted = (np.diff(D, axis=1) < 0).any()
    if (D.shape != (nq, k) or live.shape != (nq, k) or not np.isfinite(D[live]).all()
            or not np.isposinf(D[~live]).all() or unsorted):
        raise AssertionError(f"bad {what} result")


def recall_at_10(meta, gt_ids: np.ndarray) -> float:
    hits = 0
    for i, row in enumerate(meta):
        hits += len({m for m in row if m is not None} & set(gt_ids[i].tolist()))
    return hits / (10 * len(meta))


def serve_queries(client, q: np.ndarray, index_id: str, rows_per_request: int,
                  concurrency: int):
    """Send ``q`` as requests of ``rows_per_request`` rows from
    ``concurrency`` threads; returns (wall seconds, request latencies,
    per-request (D, meta))."""
    starts = list(range(0, q.shape[0], rows_per_request))
    lat = [0.0] * len(starts)
    results = [None] * len(starts)
    errors = []
    next_i = iter(range(len(starts)))
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = next(next_i, None)
            if i is None:
                return
            s = starts[i]
            t0 = time.perf_counter()
            try:
                results[i] = client.search(q[s:s + rows_per_request], 10, index_id)
            except Exception as e:  # re-raised below, on the main thread
                errors.append(e)
                return
            lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=worker, name=f"smoke-client-{t}")
               for t in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return wall, np.asarray(lat), results


def main_path(args, flat_scan, card: str) -> dict:
    from distributed_faiss_tpu_torch.models.flat import FlatIndex
    from distributed_faiss_tpu_torch.parallel.client import IndexClient
    from distributed_faiss_tpu_torch.parallel.server import IndexServer
    from distributed_faiss_tpu_torch.utils.config import IndexCfg
    from distributed_faiss_tpu_torch.utils.state import IndexState

    d, k, n = 128, 10, args.n
    rng = np.random.default_rng(args.seed)
    centers = rng.standard_normal((1024, d)).astype(np.float32) * 4.0
    t0 = time.perf_counter()
    x = make_corpus(rng, n, d, centers)
    q_all = make_corpus(rng, args.nq, d, centers)
    q_eval = q_all[:1000]
    log(f"main: made {n} x {d} corpus and {args.nq} queries in "
        f"{time.perf_counter() - t0:.2f} s (seed {args.seed})")

    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    server = IndexServer(0, os.path.join(work, "store"), device="cuda")
    port = server.bind(0)
    serve = threading.Thread(target=server.start_blocking, name="smoke-server", daemon=True)
    serve.start()
    client = None
    out = {}
    try:
        disc = os.path.join(work, "discovery.txt")
        with open(disc, "w") as f:
            f.write(f"1\nlocalhost,{port}\n")
        client = IndexClient(disc)
        iid = "quickstart"
        cfg = IndexCfg(index_builder_type="ivfsq", dim=d, metric="l2", train_num=100_000,
                       centroids=1024, nprobe=32, pallas_flat=True)
        flat_scan.flat_list_scan.launches = 0
        if client.create_index(iid, cfg) != [True]:
            raise AssertionError("create_index failed")

        t0 = time.perf_counter()
        bsz = 50_000
        for s in range(0, n, bsz):
            client.add_index_data(iid, x[s:s + bsz], list(range(s, min(n, s + bsz))))
        sent_s = time.perf_counter() - t0
        deadline = time.monotonic() + 900
        while True:
            state = client.get_state(iid)
            if (state == IndexState.TRAINED and client.get_buffer_depth(iid) == 0
                    and client.get_ntotal(iid) == n):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"index not built in time: state {state}, "
                                   f"ntotal {client.get_ntotal(iid)}")
            time.sleep(0.2)
        build_s = time.perf_counter() - t0
        log(f"main: added {n} rows in {sent_s:.2f} s of RPC; trained + indexed after "
            f"{build_s:.2f} s")

        t0 = time.perf_counter()
        exact = FlatIndex(d, "l2", device="cuda")
        exact.add(x)
        gt_d, gt_ids = exact.search(q_eval, k)
        del exact
        torch.cuda.empty_cache()
        if not np.isfinite(gt_d).all() or gt_ids.shape != (q_eval.shape[0], k):
            raise AssertionError("exact FlatIndex returned bad results")
        log(f"main: exact FlatIndex ground truth in {time.perf_counter() - t0:.2f} s")

        nprobe, rec = args.nprobe_from, 0.0
        while True:
            client.set_nprobe(iid, nprobe)
            D, meta = client.search(q_eval, k, iid)
            check_result(D, meta, q_eval.shape[0], k, f"search at nprobe={nprobe}")
            rec = recall_at_10(meta, gt_ids)
            log(f"main: nprobe={nprobe} recall@10={rec:.4f}")
            if rec >= 0.95:
                break
            if nprobe >= 1024:
                raise AssertionError("recall@10 < 0.95 even at nprobe = nlist")
            nprobe = min(2 * nprobe, 1024)
        sweep_launches = flat_scan.flat_list_scan.launches

        serve_queries(client, q_all[:1000], iid, 100, 8)  # warm
        wall, lat, results = serve_queries(client, q_all, iid, 100, 8)
        qps = q_all.shape[0] / wall
        p50, p99 = (float(np.percentile(lat, p) * 1e3) for p in (50, 99))
        for D, meta in results:
            check_result(D, meta, 100, k, "served search")
        log(f"main: served {q_all.shape[0]} queries at top-{k}, nprobe={nprobe}: "
            f"{qps:.1f} QPS, request p50 {p50:.3f} ms p99 {p99:.3f} ms "
            f"(100-row requests, 8 concurrent clients) on {card}")
        search_launches = flat_scan.flat_list_scan.launches - sweep_launches
        if search_launches <= 0:
            raise AssertionError("K1 launch count did not rise during the searches")
        if args.profile:
            profile_window(client, q_all[:2000], iid)

        D1, meta1 = client.search(q_eval, k, iid)
        client.save_index(iid)
        client.drop_index(iid)
        if not client.load_index(iid):
            raise AssertionError("load_index failed")
        client.set_nprobe(iid, nprobe)
        D2, meta2 = client.search(q_eval, k, iid)
        if meta1 != meta2:
            raise AssertionError("ids after save/drop/load differ from before")
        np.testing.assert_array_equal(D1, D2)
        log("main: save -> drop -> load served identical ids and distances")
        out = dict(launches=flat_scan.flat_list_scan.launches, nprobe=nprobe,
                   recall=rec, qps=qps, p50_ms=p50, p99_ms=p99)

        # the loaded model's tensors, for timing K1 at the main path's shapes
        # (read after the launch count above, so these launches do not count)
        out["model"] = server.indexes[iid].model
        out["q_block"] = q_all[:256]
    finally:
        if client is not None:
            client.close()
        server.stop()
        serve.join(timeout=10)
        shutil.rmtree(work, ignore_errors=True)
    return out


def host_stats(client) -> dict:
    """{layer/op: (count, total)} of the server's latency counters and the
    client stub's: rpc ops on the server, the scheduler's queue wait and
    window sizes, the engine's locked device search."""
    stats = client.get_perf_stats()[0]
    out = {}
    sections = [("server", {k: v for k, v in stats.items() if isinstance(v, dict)
                            and "count" in v}),
                ("scheduler", stats.get("scheduler", {}).get("queues", {})),
                ("client-rpc", stats.get("rpc_client", {}))]
    sections += [(f"engine[{iid}]", v) for iid, v in stats.get("engine", {}).items()]
    for layer, ops in sections:
        for op, v in ops.items():
            if isinstance(v, dict) and "count" in v:
                out[f"{layer} {op}"] = (v["count"], v["total_s"])
    return out


def profile_window(client, q: np.ndarray, index_id: str) -> None:
    """--profile: serve ``q`` once more under torch.profiler and print the
    device's busy share of the window and its kernel time by name."""
    from torch.profiler import ProfilerActivity, profile

    before = host_stats(client)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, _, _ = serve_queries(client, q, index_id, 100, 8)
        torch.cuda.synchronize()
    after = host_stats(client)
    for name, (n, total) in after.items():
        n0, total0 = before.get(name, (0, 0.0))
        if n > n0:
            mean = (total - total0) / (n - n0)
            counts = name.endswith(("_rows", "_requests", "_depth"))
            value = f"{mean:.1f}" if counts else f"{mean * 1e3:.3f} ms"
            log(f"profile: host {name}: {n - n0} x mean {value}")
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log("profile: the profiler recorded no device activity: not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    total_us = sum(t for _, t in by_name.values())
    log(f"profile: {q.shape[0]} queries in {wall * 1e3:.3f} ms of host time; device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / 1e6 / wall:.1f}% of the window), "
        f"{len(kernels)} kernel launches")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"profile:   {t / 1e3:9.3f} ms {100 * t / total_us:5.1f}% {n:6d}x {name[:90]}")


# ---------------------------------------------------------------- phase 4


def k1_main_shape(flat_scan, distance, ivf, base, model, q_block: np.ndarray,
                  nprobe: int) -> dict:
    """K1 and its plain version on the main path's own inputs: the loaded
    index's lists and the first probe group of one query block."""
    cap = model.lists.cap
    nb = base.pick_query_block(cap * model.dim * 4)
    g = ivf.probe_group_size(nprobe, nb * cap * model.dim * 4)
    q = torch.from_numpy(np.ascontiguousarray(q_block[:nb])).cuda()
    coarse = distance.pairwise_scores(q, model.centroids, model.metric)
    _, probes = distance.segmented_argtopk(coarse, nprobe)
    li = probes[:, :g].to(torch.int32).contiguous()
    sizes_g = model.lists.sizes[li.long()].contiguous()
    norms = model._scan_norms()
    args = (q, model.lists.data, model.lists.ids, li, sizes_g, norms)
    kw = dict(metric=model.metric, codec=model.codec, scan_bf16=model.scan_bf16)
    got = flat_scan.flat_list_scan(*args, **kw)
    want = flat_scan.flat_list_scan_plain(*args, **kw)
    err = compare_scores(got, want, 1e-4, 1e-4, "K1 main-path shape")
    ms = time_ms(lambda: flat_scan.flat_list_scan(*args, **kw), iters=50)
    plain_ms = time_ms(lambda: flat_scan.flat_list_scan_plain(*args, **kw), iters=10)
    bound_ms, bound_by, nbytes, flops = k1_bound(q, model.lists.data, li,
                                                 model.lists.sizes, norms is not None)
    log(f"K1 main-path shape: nq={q.shape[0]} g={g} cap={cap} d={model.dim} "
        f"codec={model.codec} live rows={int(sizes_g.sum())}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {nbytes} bytes, "
        f"{flops} flops), {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, "
        f"max_abs_err {err:.3g}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000, help="rows in the main-path index")
    ap.add_argument("--nq", type=int, default=10_000, help="queries served on the main path")
    ap.add_argument("--nprobe-from", type=int, default=1,
                    help="first nprobe of the recall sweep (the Quickstart cfg says 32)")
    ap.add_argument("--profile", action="store_true",
                    help="also serve 2000 queries under torch.profiler and print where the "
                         "device time goes")
    args = ap.parse_args(argv)
    if args.nq < 1000:
        ap.error("--nq must be >= 1000 (the recall sweep uses the first 1000)")
    if not 1 <= args.nprobe_from <= 1024:
        ap.error("--nprobe-from must be in 1..1024 (the index has 1024 lists)")
    if not os.path.isdir(os.path.join(REPO, "distributed_faiss_tpu_torch", "csrc")):
        print(f"chip_smoke: {REPO} is not a checkout of the repo (no "
              "distributed_faiss_tpu_torch/csrc beside this script)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from distributed_faiss_tpu_torch.models import base, ivf
    from distributed_faiss_tpu_torch.ops import cuda_build, distance, flat_scan
    from distributed_faiss_tpu_torch.utils.device import resolve_device

    t_start = time.perf_counter()
    resolve_device("cuda")  # pins TF32 off for the plain versions' matmuls
    card = nvidia_smi_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = cuda_build.build()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{name} -> {os.path.relpath(p, REPO)}" for name, p in libs.items()))
    for name in libs:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    variants = kernel_phase(flat_scan, distance, args.seed)
    log(f"kernel phase: {len(variants)} K1 variants agree with the plain version "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    mp = main_path(args, flat_scan, card)
    log(f"main path: {time.perf_counter() - t0:.1f} s, K1 launches {mp['launches']}")

    shape = k1_main_shape(flat_scan, distance, ivf, base, mp["model"], mp["q_block"],
                          mp["nprobe"])
    kernels = [dict(name="flat_list_scan", route="cuda", source=K1_SOURCE,
                    replaces=K1_REPLACES, launches=mp["launches"],
                    max_abs_err=shape["max_abs_err"], ms=shape["ms"],
                    plain_ms=shape["plain_ms"], bound_ms=shape["bound_ms"],
                    bound_by=shape["bound_by"], library_ms=None, status="ok")]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
