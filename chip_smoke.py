#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (distributed_faiss_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--seed 0] [--n 1000000] [--nq 10000]
                          [--nprobe-from 1] [--profile]

Phases, in order; any failure raises and the script exits nonzero:

1. Environment: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the build of every kernel source under
   ``distributed_faiss_tpu_torch/csrc`` (one nvcc per source, started
   together) with nvcc's register/spill report.
2. Kernel phase, every kernel against its plain PyTorch version on the
   card, both timed with CUDA events after warm-up (``time_ms``: back-to-
   back calls that take copies of the inputs in turn, so many that no call
   finds its inputs in L2, with the card kept busy while the host issues
   the timed calls):
   - the flat list scan (K1, ``csrc/flat_scan.cu``), every variant
     (f32/f16/sq8 lists x l2 with stored norms, l2 with recomputed norms,
     dot; plus scan_bf16), at d=128 and d=768, nq=256, g=1..4, cap=2048:
     identical -inf masks, finite scores within rtol/atol 1e-4
     (5e-2/5e-1 for scan_bf16);
   - the ADC scans (``csrc/adc_scan.cu``): K2 at m=4 and 12, K3 at m=8 and
     64, each with an f32 and a bf16 LUT, P=256 pairs, L=1, 1000 and 2048
     code rows, then K2 at m=190 and K3 at m=256 with an f32 LUT (wider
     than a block's shared memory: several subspace slices, the count
     logged): scores within rtol/atol 1e-4 (both sides sum the same LUT
     values in fp32, bf16 tables included); K3 over the probed lists
     themselves (``adc_scan_lists``: it reads li, stops at each list's
     size and masks -1 ids) at m=8 and 64, f32 and bf16 LUT, 64 lists of
     capacity 1000 and 2048 with sizes from 0 to the capacity, 128
     queries x 2 probes, then at m=256 with an f32 LUT (slices):
     identical -inf masks, scores within rtol/atol 1e-4; the shared-list
     scan K4 at
     m=16 and 64, f32 and bf16 LUT, nq=4 and 256 queries, L=13, 5000 and
     65536 rows, and at m=128 f32, nq=256, L=65536 (slices): bit-exact
     (both sides add the same fp32 values in subspace order).
3. ``ivfsq`` path (K1): one port ``IndexServer(device="cuda")`` on a
   loopback port and an ``IndexClient`` over a discovery file.
   create_index with the README Quickstart cfg on the ``ivfsq`` builder,
   add ``--n`` clustered rows (the generator of bench.py, 1024 centers)
   with metadata in batches, wait for the threshold training and the add
   drain, sweep nprobe by doubling from ``--nprobe-from`` until recall@10
   >= 0.95 against the port's exact FlatIndex on the card, serve ``--nq``
   queries at top-10 from concurrent clients (QPS and p50/p99 request
   latency), and save -> drop -> load and check the same ids come back.
4. ``knnlm`` path (K3): a second server and client. The ``knnlm`` builder
   at BASELINE.json config 3's widths (d=768, 4096 centroids, PQ m=64,
   8-bit) with a bf16 LUT and an exact refine of 8x the shortlist, over
   ``KNNLM_N`` (500,000) rows of the low-intrinsic-dimension corpus of
   benchmarks/baseline_configs.py (queries from the same generator): add,
   wait, sweep nprobe by doubling from ``--nprobe-from`` until recall@10
   >= 0.95 (failing at nprobe 4096), serve ``--nq`` queries, save -> drop
   -> load with identical ids and distances.
5. K2 path: an ``IVF1024,PQ12,RFlat`` index (m=12, so K2's geometry) on
   the same server over the first ``K2_N`` (100,000) rows of that corpus; a few
   requests are served and checked, and its recall is logged.
6. Flat-PQ path (K4): a ``PQ64,RFlat`` index (one list, config 3's PQ
   widths, the factory's 8x exact refine, train_num 100,000) on the same
   server over phase 4's rows, queries and ground truth: recall@10 >= 0.95
   on the 1000 eval queries, ``--nq`` queries served, save -> drop -> load
   identical.
7. Pre-transform path: an ``OPQ64,PQ64,RFlat`` index over phase 5's rows
   (train_num 50,000): a few requests checked, recall@10 logged, save ->
   drop -> load identical (the ``pretransform`` snapshot kind).
8. Wide flat PQ: a ``PQ128,RFlat`` index over phase 5's rows (an f32
   LUT wider than a block's shared memory, so K4 runs in subspace slices):
   a few requests checked, recall@10 logged, the slice count logged.
9. Each kernel at its path's own shapes (the loaded index's lists and one
   query block's first probe group, or for K4 its LUT and first chunk of
   the list, built by the model's own helpers): kernel vs plain time, its
   bound, its max error, and the kernels JSON line. On the knnlm path K3
   runs twice: over the probed lists, with the group step it replaced
   timed beside it (the gather of the probed lists' codes, K3 over the
   gathered copy, the mask), and over the gathered codes (that entry's
   row reports its own launches, none on the knnlm path); the kernel's
   time on
   one set of inputs, which back-to-back calls may find in L2, is logged
   beside it, labelled. For K4 one PyTorch call that computes the same
   sums (``embedding_bag``) is timed as a yardstick (``library_ms``); the
   port never calls it.

Before each of phases 3-8 every kernel's launch count is zeroed, and it is
read after the phase: K1 must have launched on the ivfsq path, K3 on the
knnlm path through ``adc_scan_lists`` (and neither K2 nor K4: the
dispatch is fixed by the geometry),
K2 on the K2 path, K4 on the flat-PQ path (and neither K2 nor K3) and on
the pre-transform path and the wide flat-PQ path.

The last line is {"ok": true, "device": {"platform": "gpu", ...}}. Without
CUDA, or outside a checkout of the repo, the script exits nonzero before
printing any result.
"""

import argparse
import functools
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
# rate outside the tensor cores. The kernels do fp32 FMAs and adds on
# CUDA cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# at most the SM clock (1.98 GHz boost): a spin of this many cycles per
# second asked for lasts at least that long at any clock
SLEEP_CYCLES_PER_S = 2e9

K1_REPLACES = "distributed_faiss_tpu/ops/flat_pallas.py:113"
K1_SOURCE = "distributed_faiss_tpu_torch/csrc/flat_scan.cu"
K2_REPLACES = "distributed_faiss_tpu/ops/adc_pallas.py:139"
K3_REPLACES = "distributed_faiss_tpu/ops/adc_pallas.py:209"
K4_REPLACES = "distributed_faiss_tpu/ops/adc_pallas.py:110"
ADC_SOURCE = "distributed_faiss_tpu_torch/csrc/adc_scan.cu"

# the nibble-supported geometry only takes ksub = 256; so do both kernels'
# phases here
KSUB = 256

# rows of the knnlm shard (the repo's full-size knnlm row) and of the
# IVF1024,PQ12,RFlat index (the first rows of the same corpus)
KNNLM_N = 500_000
K2_N = 100_000

# H100 L2 is 50 MB: timed calls that read four times that before they take
# the same inputs again find none of them there, and read them from HBM as
# their bound assumes
L2_ROTATE_BYTES = 200 * 1024 * 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def l2_copies(args: tuple, nbytes: int) -> list:
    """``args`` and enough copies of it (tensors cloned) that calls reading
    ``nbytes`` each and taking the copies in turn read ``L2_ROTATE_BYTES``
    before a copy comes round again."""
    n = max(2, -(-L2_ROTATE_BYTES // max(1, nbytes)) + 1)
    return [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
                     for _ in range(n - 1)]


def time_ms(call, arg_sets: list, warmup: int = 3, iters: int = 20,
            queued: bool = True) -> float:
    """Mean time of one ``call(*args)``, from CUDA events around back-to-back
    calls after ``warmup`` calls, taking ``arg_sets`` in turn for at least
    one round. Given ``l2_copies`` the calls read their inputs from HBM;
    given one set, inputs that fit the 50 MB L2 may be read from there.

    ``queued``: the card first spins for longer than the host takes to
    issue the timed calls, so they run back to back on the card and the
    events see device time only. Without it the events also see the host's
    time between launches wherever issuing a call (Python, checks,
    allocation) takes longer than running it."""
    n = len(arg_sets)
    iters = max(iters, n)
    for i in range(warmup):
        call(*arg_sets[i % n])
    torch.cuda.synchronize()
    if queued:
        t0 = time.perf_counter()
        call(*arg_sets[0])
        torch.cuda.synchronize()
        one_call_s = time.perf_counter() - t0
        torch.cuda._sleep(int(SLEEP_CYCLES_PER_S * (2 * iters * one_call_s + 1e-3)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        call(*arg_sets[i % n])
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


def adc_bound(lut, codes):
    """(bound_ms, bound_by, bytes, ops) of one K2/K3 call on these inputs.
    Bytes: every pair's LUT (P * m * ksub * itemsize) and every code row it
    is given (P * L * m) read once, the (P, L) fp32 scores written once.
    Operations: one fp32 add per code byte (P * L * m); the table lookups
    are loads, not arithmetic."""
    P, m, _ = lut.shape
    L = codes.shape[1]
    nbytes = lut.numel() * lut.element_size() + codes.numel() + P * L * 4
    ops = P * L * m
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def lists_bound(lut, list_codes, li, list_sizes):
    """(bound_ms, bound_by, bytes, ops) of one ``adc_scan_lists`` call on
    these inputs. Bytes: every pair's LUT, the live code rows and ids of
    every distinct probed list, the probe indices and their fill counts,
    each read once, and the (nq, g, cap) fp32 scores written once.
    Operations: one fp32 add per code byte of each (pair, live row)."""
    nq, g = li.shape
    m = lut.shape[1]
    cap = list_codes.shape[1]
    sizes = list_sizes.clamp(min=0, max=cap)
    unique_live = int(sizes[torch.unique(li.long())].sum().item())
    pair_live = int(sizes[li.long()].sum().item())
    nbytes = (lut.numel() * lut.element_size() + unique_live * (m + 4) + 2 * nq * g * 4
              + nq * g * cap * 4)
    ops = pair_live * m
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def shared_bound(lut, codes):
    """(bound_ms, bound_by, bytes, ops) of one K4 call on these inputs.
    Bytes: the (L, m) codes, the (nq, m, ksub) LUTs and the (nq, L) fp32
    scores, each once. Operations: one fp32 add per (query, code byte)."""
    nq, m, _ = lut.shape
    L = codes.shape[0]
    nbytes = codes.numel() + lut.numel() * lut.element_size() + nq * L * 4
    ops = nq * L * m
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


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


def launch_counters(flat_scan, adc):
    """name -> the wrapper that counts that kernel's launches."""
    return {"K1": flat_scan.flat_list_scan, "K2": adc.adc_scan, "K3": adc.adc_scan_nibble,
            "K3 lists": adc.adc_scan_lists, "K4": adc.adc_scan_shared}


def zero_counts(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters) -> dict:
    return {name: fn.launches for name, fn in counters.items()}


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
            bound_ms, bound_by, nbytes, _ = k1_bound(q, data, li, sizes, norms is not None)
            sets = l2_copies(args, nbytes)
            ms = time_ms(functools.partial(flat_scan.flat_list_scan, **kw), sets)
            plain_ms = time_ms(functools.partial(flat_scan.flat_list_scan_plain, **kw), sets,
                               warmup=1, iters=5)
            rows.append(dict(variant=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by))
            log(f"K1 {name}: ok max_abs_err={err:.3g} (rtol={rtol} atol={atol}) "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by})")
            del args, sets, got, want, data, ids, norms
        torch.cuda.empty_cache()
    return rows


def adc_kernel_phase(adc, seed: int) -> list:
    """K2 (m=4, 12) and K3 (m=8, 64) vs the plain version, f32 and bf16
    LUT, P=256 pairs, L=1, 1000, 2048 code rows; then K2 at m=190 and K3 at
    m=256, f32 LUT, L=1000: wider than a block's shared memory, so scored
    in subspace slices."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    P = 256
    rows = []
    cases = [(kid, fn, m, dtype, L)
             for kid, fn, ms_ in (("K2", adc.adc_scan, (4, 12)),
                                  ("K3", adc.adc_scan_nibble, (8, 64)))
             for m in ms_ for dtype in (torch.float32, torch.bfloat16) for L in (1, 1000, 2048)]
    cases += [("K2", adc.adc_scan, 190, torch.float32, 1000),
              ("K3", adc.adc_scan_nibble, 256, torch.float32, 1000)]
    for kid, fn, m, dtype, L in cases:
        lut = torch.randn((P, m, KSUB), generator=gen, device="cuda").to(dtype)
        codes = torch.randint(0, KSUB, (P, L, m), generator=gen, device="cuda",
                              dtype=torch.int32).to(torch.uint8)
        got = fn(lut, codes)
        want = adc.adc_scan_plain(lut, codes)
        torch.cuda.synchronize()
        name = (f"{kid} m={m} {'bf16' if dtype == torch.bfloat16 else 'f32'} L={L} "
                f"slices={fn.slices}")
        err = compare_scores(got, want, 1e-4, 1e-4, name)
        bound_ms, bound_by, nbytes, _ = adc_bound(lut, codes)
        sets = l2_copies((lut, codes), nbytes)
        ms = time_ms(fn, sets)
        plain_ms = time_ms(adc.adc_scan_plain, sets, warmup=1, iters=5)
        rows.append(dict(variant=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        log(f"{name}: ok max_abs_err={err:.3g} (rtol=0.0001 atol=0.0001) "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}: {nbytes} bytes)")
        del lut, codes, sets, got, want
    torch.cuda.empty_cache()
    return rows


def lists_kernel_phase(adc, seed: int) -> list:
    """K3 over the probed lists (``adc_scan_lists``) vs its plain version:
    m=8 and 64, f32 and bf16 LUT, 64 lists of capacity 1000 and 2048
    (sizes from 0 to the capacity, 5% of the ids -1), 128 queries x 2
    probes with a list probed twice; then m=256 with an f32 LUT, wider
    than a block's shared memory, so scored in subspace slices."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 3)
    nq, g, nlist = 128, 2, 64
    rows = []
    cases = [(m, dtype, cap) for m in (8, 64) for dtype in (torch.float32, torch.bfloat16)
             for cap in (1000, 2048)]
    cases.append((256, torch.float32, 1000))
    for m, dtype, cap in cases:
        lut = torch.randn((nq * g, m, KSUB), generator=gen, device="cuda").to(dtype)
        list_codes = torch.randint(0, KSUB, (nlist, cap, m), generator=gen, device="cuda",
                                   dtype=torch.int32).to(torch.uint8)
        list_ids = torch.randint(0, 1 << 20, (nlist, cap), generator=gen, device="cuda",
                                 dtype=torch.int32)
        list_ids[torch.rand((nlist, cap), generator=gen, device="cuda") < 0.05] = -1
        sizes = torch.randint(0, cap + 1, (nlist,), generator=gen, device="cuda",
                              dtype=torch.int32)
        sizes[:3] = torch.tensor([cap, 0, 1], dtype=torch.int32, device="cuda")
        li = torch.randint(0, nlist, (nq, g), generator=gen, device="cuda", dtype=torch.int32)
        li[0] = 0  # the full list, twice
        li[1, 0] = 1
        li[2, 0] = 2
        args = (lut, list_codes, li, sizes[li.long()].contiguous(), list_ids)
        got = adc.adc_scan_lists(*args)
        want = adc.adc_scan_lists_plain(*args)
        torch.cuda.synchronize()
        name = (f"K3 lists m={m} {'bf16' if dtype == torch.bfloat16 else 'f32'} cap={cap} "
                f"slices={adc.adc_scan_lists.slices}")
        err = compare_scores(got, want, 1e-4, 1e-4, name)
        bound_ms, bound_by, nbytes, _ = lists_bound(lut, list_codes, li, sizes)
        sets = l2_copies(args, nbytes)
        ms = time_ms(adc.adc_scan_lists, sets)
        plain_ms = time_ms(adc.adc_scan_lists_plain, sets[:8], warmup=1, iters=5)
        rows.append(dict(variant=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        log(f"{name}: ok max_abs_err={err:.3g} (rtol=0.0001 atol=0.0001, -inf masks "
            f"identical) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}: {nbytes} bytes)")
        del args, sets, got, want, lut, list_codes, list_ids
    torch.cuda.empty_cache()
    return rows


def shared_kernel_phase(adc, seed: int) -> list:
    """K4 vs its plain version at tpu_validate.py's shared geometries: m=16
    and 64, f32 and bf16 LUT, nq=4 and 256 queries, L=13, 5000 and 65536
    code rows; then m=128 with an f32 LUT at nq=256, L=65536, wider than a
    block's shared memory, so scored in subspace slices. Bit-exact: both
    sides add the same fp32 values in subspace order."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 2)
    rows = []
    cases = [(m, dtype, nq, L) for m in (16, 64) for dtype in (torch.float32, torch.bfloat16)
             for nq in (4, 256) for L in (13, 5000, 65536)]
    cases.append((128, torch.float32, 256, 65536))
    for m, dtype, nq, L in cases:
        lut = torch.randn((nq, m, KSUB), generator=gen, device="cuda").to(dtype)
        codes = torch.randint(0, KSUB, (L, m), generator=gen, device="cuda",
                              dtype=torch.int32).to(torch.uint8)
        got = adc.adc_scan_shared(lut, codes)
        want = adc.adc_scan_shared_plain(lut, codes)
        torch.cuda.synchronize()
        name = (f"K4 m={m} {'bf16' if dtype == torch.bfloat16 else 'f32'} "
                f"nq={nq} L={L} slices={adc.adc_scan_shared.slices}")
        err = compare_scores(got, want, 0.0, 0.0, name)
        bound_ms, bound_by, nbytes, _ = shared_bound(lut, codes)
        sets = l2_copies((lut, codes), nbytes)
        ms = time_ms(adc.adc_scan_shared, sets)
        # the plain version's time on a few of the copies: at small inputs
        # a whole rotation would be thousands of host-paced calls
        plain_ms = time_ms(adc.adc_scan_shared_plain, sets[:8], warmup=1, iters=5)
        rows.append(dict(variant=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        log(f"{name}: ok, bit-exact, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes} bytes), "
            f"{nq * L * m / (ms * 1e-3) / 1e9:.1f} G lookups/s")
        del lut, codes, sets, got, want
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- phases 3-8


def make_corpus(rng, n: int, d: int, centers: np.ndarray) -> np.ndarray:
    """bench.py's generator: points drawn from gaussian-mixture centers."""
    assign = rng.integers(0, centers.shape[0], n)
    return (centers[assign] + rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


def make_lowrank_corpus(rng, d: int, r: int, n_latent_clusters: int,
                        ambient_sigma: float = 0.05):
    """The knnlm corpus of benchmarks/baseline_configs.py (a copy: this
    script imports nothing of the JAX package): a mixture of
    ``n_latent_clusters`` gaussians in r dims, embedded by a fixed random
    orthonormal (r, d) map, plus small isotropic ambient noise. A model's
    hidden states concentrate on such a low-dimensional manifold; an
    isotropic 768-d mixture cannot reach recall@10 0.95 under any
    quantizer. Returns gen(n) -> (n, d) fp32."""
    W = np.linalg.qr(rng.standard_normal((d, r)))[0].T.astype(np.float32)
    centers_z = rng.standard_normal((n_latent_clusters, r)).astype(np.float32) * 4.0

    def gen(nn):
        a = rng.integers(0, centers_z.shape[0], nn)
        z = centers_z[a] + rng.standard_normal((nn, r)).astype(np.float32)
        x = z @ W + ambient_sigma * rng.standard_normal((nn, d)).astype(np.float32)
        return x.astype(np.float32)

    return gen


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


class Serving:
    """One port IndexServer on a loopback port, serving from a thread, and
    an IndexClient over a discovery file under ``work``; closed on exit."""

    def __init__(self, work: str):
        from distributed_faiss_tpu_torch.parallel.client import IndexClient
        from distributed_faiss_tpu_torch.parallel.server import IndexServer

        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        self.work = work
        self.server = IndexServer(0, os.path.join(work, "store"), device="cuda")
        port = self.server.bind(0)
        self.thread = threading.Thread(target=self.server.start_blocking,
                                       name="smoke-server", daemon=True)
        self.thread.start()
        self.client = None
        try:
            disc = os.path.join(work, "discovery.txt")
            with open(disc, "w") as f:
                f.write(f"1\nlocalhost,{port}\n")
            self.client = IndexClient(disc)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        if self.client is not None:
            self.client.close()
        self.server.stop()
        self.thread.join(timeout=10)
        shutil.rmtree(self.work, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def build_index(client, iid: str, cfg, x: np.ndarray, what: str) -> None:
    """create_index, add ``x`` with its row numbers as metadata in 50,000-row
    batches, and wait for the threshold training and the add drain."""
    from distributed_faiss_tpu_torch.utils.state import IndexState

    n = x.shape[0]
    if client.create_index(iid, cfg) != [True]:
        raise AssertionError(f"{what}: create_index failed")
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
            raise RuntimeError(f"{what}: index not built in time: state {state}, "
                               f"ntotal {client.get_ntotal(iid)}")
        time.sleep(0.2)
    log(f"{what}: added {n} rows in {sent_s:.2f} s of RPC; trained + indexed after "
        f"{time.perf_counter() - t0:.2f} s")


def exact_ground_truth(x: np.ndarray, q: np.ndarray, k: int, what: str) -> np.ndarray:
    """Top-k ids of the port's exact FlatIndex on the card."""
    from distributed_faiss_tpu_torch.models.flat import FlatIndex

    t0 = time.perf_counter()
    exact = FlatIndex(x.shape[1], "l2", device="cuda")
    exact.add(x)
    gt_d, gt_ids = exact.search(q, k)
    del exact
    torch.cuda.empty_cache()
    if not np.isfinite(gt_d).all() or gt_ids.shape != (q.shape[0], k):
        raise AssertionError(f"{what}: exact FlatIndex returned bad results")
    log(f"{what}: exact FlatIndex ground truth in {time.perf_counter() - t0:.2f} s")
    return gt_ids


def sweep_nprobe(client, iid: str, q_eval: np.ndarray, gt_ids: np.ndarray, start: int,
                 nlist: int, what: str):
    """Double nprobe from ``start`` until recall@10 >= 0.95; fails when
    nprobe reaches ``nlist`` first. Returns (nprobe, recall)."""
    nprobe = start
    while True:
        client.set_nprobe(iid, nprobe)
        D, meta = client.search(q_eval, 10, iid)
        check_result(D, meta, q_eval.shape[0], 10, f"{what} search at nprobe={nprobe}")
        rec = recall_at_10(meta, gt_ids)
        log(f"{what}: nprobe={nprobe} recall@10={rec:.4f}")
        if rec >= 0.95:
            return nprobe, rec
        if nprobe >= nlist:
            raise AssertionError(f"{what}: recall@10 < 0.95 even at nprobe = {nlist}")
        nprobe = min(2 * nprobe, nlist)


def serve_and_report(args, client, iid: str, q_all: np.ndarray, nprobe: int, card: str,
                     what: str) -> dict:
    serve_queries(client, q_all[:1000], iid, 100, 8)  # warm
    wall, lat, results = serve_queries(client, q_all, iid, 100, 8)
    qps = q_all.shape[0] / wall
    p50, p99 = (float(np.percentile(lat, p) * 1e3) for p in (50, 99))
    for D, meta in results:
        check_result(D, meta, 100, 10, f"{what} served search")
    log(f"{what}: served {q_all.shape[0]} queries at top-10, nprobe={nprobe}: "
        f"{qps:.1f} QPS, request p50 {p50:.3f} ms p99 {p99:.3f} ms "
        f"(100-row requests, 8 concurrent clients) on {card}")
    if args.profile:
        profile_window(client, q_all[:2000], iid)
    return dict(qps=qps, p50_ms=p50, p99_ms=p99)


def save_drop_load(client, iid: str, q_eval: np.ndarray, nprobe: int, what: str) -> None:
    D1, meta1 = client.search(q_eval, 10, iid)
    client.save_index(iid)
    client.drop_index(iid)
    if not client.load_index(iid):
        raise AssertionError(f"{what}: load_index failed")
    client.set_nprobe(iid, nprobe)
    D2, meta2 = client.search(q_eval, 10, iid)
    if meta1 != meta2:
        raise AssertionError(f"{what}: ids after save/drop/load differ from before")
    np.testing.assert_array_equal(D1, D2)
    log(f"{what}: save -> drop -> load served identical ids and distances")


def ivfsq_path(args, counters, card: str) -> dict:
    """Phase 3: the Quickstart shard on the ivfsq builder (K1)."""
    from distributed_faiss_tpu_torch.utils.config import IndexCfg

    d, n, what = 128, args.n, "ivfsq"
    rng = np.random.default_rng(args.seed)
    centers = rng.standard_normal((1024, d)).astype(np.float32) * 4.0
    t0 = time.perf_counter()
    x = make_corpus(rng, n, d, centers)
    q_all = make_corpus(rng, args.nq, d, centers)
    q_eval = q_all[:1000]
    log(f"{what}: made {n} x {d} corpus and {args.nq} queries in "
        f"{time.perf_counter() - t0:.2f} s (seed {args.seed})")
    with Serving(os.path.join(REPO, "build", "chip_smoke")) as s:
        iid = "quickstart"
        cfg = IndexCfg(index_builder_type="ivfsq", dim=d, metric="l2", train_num=100_000,
                       centroids=1024, nprobe=32, pallas_flat=True)
        zero_counts(counters)
        build_index(s.client, iid, cfg, x, what)
        gt_ids = exact_ground_truth(x, q_eval, 10, what)
        nprobe, rec = sweep_nprobe(s.client, iid, q_eval, gt_ids, args.nprobe_from, 1024, what)
        out = serve_and_report(args, s.client, iid, q_all, nprobe, card, what)
        save_drop_load(s.client, iid, q_eval, nprobe, what)
        out.update(counts=read_counts(counters), recall=rec)
        if out["counts"]["K1"] <= 0:
            raise AssertionError(f"{what}: K1 was not launched on this path")
        # the loaded model's tensors, for timing K1 at the path's shapes
        # (read after the counts above, so those launches do not count)
        out["model"] = s.server.indexes[iid].model
    out["q_block"] = q_all[:256]
    log(f"{what}: launches {out['counts']}")
    return out


def check_requests(client, iid: str, q_all: np.ndarray, what: str) -> None:
    """Four 100-row requests, each (100, 10) finite ascending distances."""
    for r in range(4):
        D, meta = client.search(q_all[r * 100:(r + 1) * 100], 10, iid)
        check_result(D, meta, 100, 10, f"{what} request {r}")


def knnlm_path(args, counters, card: str) -> dict:
    """Phases 4-8 on one server over the low-rank corpus: the knnlm shard
    (K3), IVF1024,PQ12,RFlat (K2), flat PQ64,RFlat (K4),
    OPQ64,PQ64,RFlat (K4 behind the OPQ rotation) and flat PQ128,RFlat
    (K4 in subspace slices)."""
    from distributed_faiss_tpu_torch.utils.config import IndexCfg

    d, n, what = 768, KNNLM_N, "knnlm"
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    gen = make_lowrank_corpus(rng, d, r=64, n_latent_clusters=8192)
    x = gen(n)
    q_all = gen(args.nq)
    q_eval = q_all[:1000]
    log(f"{what}: made {n} x {d} low-rank corpus and {args.nq} queries in "
        f"{time.perf_counter() - t0:.2f} s (seed {args.seed})")
    out = {}
    with Serving(os.path.join(REPO, "build", "chip_smoke_pq")) as s:
        iid = "knnlm"
        cfg = IndexCfg(index_builder_type="knnlm", dim=d, metric="l2", centroids=4096,
                       train_num=100_000, nprobe=32, code_size=64, pallas_adc=True,
                       adc_lut_bf16=True, refine_k_factor=8)
        zero_counts(counters)
        build_index(s.client, iid, cfg, x, what)
        gt_full = exact_ground_truth(x, q_eval, 10, what)
        nprobe, rec = sweep_nprobe(s.client, iid, q_eval, gt_full, args.nprobe_from, 4096,
                                   what)
        pq_out = serve_and_report(args, s.client, iid, q_all, nprobe, card, what)
        save_drop_load(s.client, iid, q_eval, nprobe, what)
        pq_out.update(counts=read_counts(counters), recall=rec)
        log(f"{what}: launches {pq_out['counts']}")
        if pq_out["counts"]["K3"] <= 0 or pq_out["counts"]["K3 lists"] <= 0:
            raise AssertionError(f"{what}: K3 was not launched over the probed lists on "
                                 "this path")
        if pq_out["counts"]["K2"] != 0 or pq_out["counts"]["K4"] != 0:
            raise AssertionError(f"{what}: K2 or K4 launched on a path whose geometry is K3's")
        pq_out.update(model=s.server.indexes[iid].model, q_block=q_all[:256])
        out["knnlm"] = pq_out

        what, iid, n2 = "IVF1024,PQ12,RFlat", "k2", K2_N
        cfg = IndexCfg(faiss_factory="IVF1024,PQ12,RFlat", dim=d, metric="l2",
                       train_num=50_000, nprobe=32)
        zero_counts(counters)
        build_index(s.client, iid, cfg, x[:n2], what)
        check_requests(s.client, iid, q_all, what)
        D, meta = s.client.search(q_eval, 10, iid)
        check_result(D, meta, q_eval.shape[0], 10, f"{what} recall request")
        k2_out = dict(counts=read_counts(counters))
        log(f"{what}: launches {k2_out['counts']}")
        if k2_out["counts"]["K2"] <= 0:
            raise AssertionError(f"{what}: K2 was not launched on this path")
        gt_head = exact_ground_truth(x[:n2], q_eval, 10, what)
        k2_out["recall"] = recall_at_10(meta, gt_head)
        log(f"{what}: recall@10={k2_out['recall']:.4f} at nprobe=32 (logged, not gated)")
        k2_out.update(model=s.server.indexes[iid].model, q_block=q_all[:256])
        out["k2"] = k2_out

        # phase 6: flat PQ (K4) over the whole corpus, phase 4's queries and
        # ground truth
        what, iid = "PQ64,RFlat", "flatpq"
        cfg = IndexCfg(faiss_factory="PQ64,RFlat", dim=d, metric="l2", train_num=100_000)
        zero_counts(counters)
        build_index(s.client, iid, cfg, x, what)
        D, meta = s.client.search(q_eval, 10, iid)
        check_result(D, meta, q_eval.shape[0], 10, f"{what} recall request")
        rec = recall_at_10(meta, gt_full)
        log(f"{what}: recall@10={rec:.4f} (one list, every row scored)")
        if rec < 0.95:
            raise AssertionError(f"{what}: recall@10 {rec:.4f} < 0.95")
        flat_out = serve_and_report(args, s.client, iid, q_all, 1, card, what)
        save_drop_load(s.client, iid, q_eval, 1, what)
        flat_out.update(counts=read_counts(counters), recall=rec)
        log(f"{what}: launches {flat_out['counts']}")
        if flat_out["counts"]["K4"] <= 0:
            raise AssertionError(f"{what}: K4 was not launched on this path")
        if flat_out["counts"]["K2"] != 0 or flat_out["counts"]["K3"] != 0:
            raise AssertionError(f"{what}: K2 or K3 launched on the one-list path")
        flat_out.update(model=s.server.indexes[iid].model, q_block=q_all[:256])
        out["flatpq"] = flat_out

        # phase 7: the OPQ rotation in front of flat PQ, over the K2 path's
        # rows and ground truth
        what, iid = "OPQ64,PQ64,RFlat", "opq"
        cfg = IndexCfg(faiss_factory="OPQ64,PQ64,RFlat", dim=d, metric="l2",
                       train_num=50_000)
        zero_counts(counters)
        build_index(s.client, iid, cfg, x[:n2], what)
        check_requests(s.client, iid, q_all, what)
        D, meta = s.client.search(q_eval, 10, iid)
        check_result(D, meta, q_eval.shape[0], 10, f"{what} recall request")
        save_drop_load(s.client, iid, q_eval, 1, what)
        opq_out = dict(counts=read_counts(counters), recall=recall_at_10(meta, gt_head))
        log(f"{what}: recall@10={opq_out['recall']:.4f} (logged, not gated); "
            f"launches {opq_out['counts']}")
        if opq_out["counts"]["K4"] <= 0:
            raise AssertionError(f"{what}: K4 was not launched on this path")
        out["opq"] = opq_out

        # phase 8: flat PQ at m=128, whose f32 LUT is wider than a block's
        # shared memory: K4 runs in subspace slices; the K2 path's rows
        what, iid = "PQ128,RFlat", "flatpq128"
        cfg = IndexCfg(faiss_factory="PQ128,RFlat", dim=d, metric="l2", train_num=50_000)
        zero_counts(counters)
        build_index(s.client, iid, cfg, x[:n2], what)
        check_requests(s.client, iid, q_all, what)
        D, meta = s.client.search(q_eval, 10, iid)
        check_result(D, meta, q_eval.shape[0], 10, f"{what} recall request")
        wide_out = dict(counts=read_counts(counters), recall=recall_at_10(meta, gt_head))
        slices = counters["K4"].slices
        log(f"{what}: recall@10={wide_out['recall']:.4f} (logged, not gated); "
            f"launches {wide_out['counts']}, {slices} subspace slices a K4 call")
        if wide_out["counts"]["K4"] <= 0 or slices < 2:
            raise AssertionError(f"{what}: K4 did not run in subspace slices on this path")
        out["flatpq128"] = wide_out
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

    from distributed_faiss_tpu_torch.ops import adc_scan, flat_scan

    counters = launch_counters(flat_scan, adc_scan)
    before, launched = host_stats(client), read_counts(counters)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, _, _ = serve_queries(client, q, index_id, 100, 8)
        torch.cuda.synchronize()
    after = host_stats(client)
    launched = {k: n - launched[k] for k, n in read_counts(counters).items() if n > launched[k]}
    log(f"profile[{index_id}]: wrapper launches in the window {launched}")
    for name, (n, total) in after.items():
        n0, total0 = before.get(name, (0, 0.0))
        if n > n0:
            mean = (total - total0) / (n - n0)
            counts = name.endswith(("_rows", "_requests", "_depth"))
            value = f"{mean:.1f}" if counts else f"{mean * 1e3:.3f} ms"
            log(f"profile[{index_id}]: host {name}: {n - n0} x mean {value}")
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"profile[{index_id}]: the profiler recorded no device activity: not measured")
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
    log(f"profile[{index_id}]: {q.shape[0]} queries in {wall * 1e3:.3f} ms of host time; "
        f"device busy {busy_us / 1e3:.3f} ms ({100 * busy_us / 1e6 / wall:.1f}% of the "
        f"window), {len(kernels)} kernel launches")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"profile[{index_id}]:   {t / 1e3:9.3f} ms {100 * t / total_us:5.1f}% {n:6d}x "
            f"{name[:90]}")


# ---------------------------------------------------------------- phase 9


def k1_main_shape(flat_scan, ivf, model, q_block: np.ndarray) -> dict:
    """K1 and its plain version on the ivfsq path's own inputs: the loaded
    index's lists and the first probe group of one query block, built by
    the model's own helpers."""
    nprobe, nb, g = model._search_plan()
    q = torch.from_numpy(np.ascontiguousarray(q_block[:nb])).cuda()
    li = ivf._probe_groups(model.centroids, q, nprobe, g, model.metric)[0].contiguous()
    sizes_g = model.lists.sizes[li.long()].contiguous()
    opts = model._scan_options()
    args = (q, model.lists.data, model.lists.ids, li, sizes_g, opts["list_norms"],
            opts.get("vmin"), opts.get("span"))
    kw = dict(metric=model.metric, codec=model.codec, scan_bf16=opts["scan_bf16"])
    got = flat_scan.flat_list_scan(*args, **kw)
    want = flat_scan.flat_list_scan_plain(*args, **kw)
    err = compare_scores(got, want, 1e-4, 1e-4, "K1 main-path shape")
    bound_ms, bound_by, nbytes, flops = k1_bound(q, model.lists.data, li, model.lists.sizes,
                                                 opts["list_norms"] is not None)
    sets = l2_copies(args, nbytes)
    kernel = functools.partial(flat_scan.flat_list_scan, **kw)
    ms = time_ms(kernel, sets, iters=50)
    warm_ms = time_ms(kernel, [args], iters=50)
    call_ms = time_ms(kernel, [args], iters=50, queued=False)
    plain_ms = time_ms(functools.partial(flat_scan.flat_list_scan_plain, **kw), sets,
                       iters=10)
    del sets
    cap = model.lists.cap
    log(f"K1 ivfsq-path shape: nq={q.shape[0]} g={g} cap={cap} d={model.dim} "
        f"codec={model.codec} live rows={int(sizes_g.sum())}: kernel {ms:.4f} ms "
        f"(L2-warm back to back {warm_ms:.4f} ms; {call_ms:.4f} ms a call when the host "
        f"issues them), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{nbytes} bytes, {flops} flops), {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, "
        f"max_abs_err {err:.3g}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def adc_main_shape(adc, ivf, model, q_block: np.ndarray, what: str) -> dict:
    """The ADC kernel the model dispatches to, and the plain version, on
    the path's own inputs: the first probe group of one query block, its
    LUT and gathered code rows built by the model's own helpers."""
    nprobe, nb, g = model._search_plan()
    q = torch.from_numpy(np.ascontiguousarray(q_block[:nb])).cuda()
    li = ivf._probe_groups(model.centroids, q, nprobe, g, model.metric)[0].contiguous()
    lut, codes = ivf._pq_group_inputs(model.centroids, model.codebooks, model.lists.data, q,
                                      li, model.metric, model.lut_bf16)
    P, m, ksub = lut.shape
    nibble = adc.nibble_supported(m, ksub)
    fn = adc.adc_scan_nibble if nibble else adc.adc_scan
    kid = "K3" if nibble else "K2"
    got = fn(lut, codes)
    want = adc.adc_scan_plain(lut, codes)
    err = compare_scores(got, want, 1e-4, 1e-4, f"{kid} {what}-path shape")
    bound_ms, bound_by, nbytes, ops = adc_bound(lut, codes)
    sets = l2_copies((lut, codes), nbytes)
    ms = time_ms(fn, sets, iters=50)
    warm_ms = time_ms(fn, [(lut, codes)], iters=50)
    call_ms = time_ms(fn, [(lut, codes)], iters=50, queued=False)
    plain_ms = time_ms(adc.adc_scan_plain, sets, iters=10)
    del sets
    log(f"{kid} {what}-path shape: P={P} (nq={q.shape[0]} g={g}) L={codes.shape[1]} m={m} "
        f"lut={'bf16' if model.lut_bf16 else 'f32'} "
        f"live rows={int(model.lists.sizes[li.long()].sum())}: kernel {ms:.4f} ms "
        f"(L2-warm back to back {warm_ms:.4f} ms; {call_ms:.4f} ms a call when the host "
        f"issues them), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{nbytes} bytes, {ops} adds), {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, "
        f"max_abs_err {err:.3g}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def _old_group_step(adc, lut, list_codes, li, sizes_g, list_ids):
    """The knnlm path's probe group step before K3 read the lists itself:
    the probed lists' code rows gathered, K3 over the gathered copy, the
    mask."""
    nq, g = li.shape
    _, cap, m = list_codes.shape
    codes = list_codes[li.long()].reshape(nq * g, cap, m)
    s = adc.adc_scan_nibble(lut, codes).reshape(nq, g, cap)
    return adc.mask_lists(s, li, sizes_g, list_ids)


def lists_main_shape(adc, ivf, model, q_block: np.ndarray) -> dict:
    """K3 over the probed lists, its plain version and the group step it
    replaced, on the knnlm path's own inputs: the first probe group of one
    query block and its LUT, built by the model's own helpers, and the
    index's lists."""
    nprobe, nb, g = model._search_plan()
    q = torch.from_numpy(np.ascontiguousarray(q_block[:nb])).cuda()
    li = ivf._probe_groups(model.centroids, q, nprobe, g, model.metric)[0].contiguous()
    lut = ivf._pq_group_lut(model.centroids, model.codebooks, q, li, model.metric,
                            model.lut_bf16)
    sizes_g = model.lists.sizes[li.long()].contiguous()
    args = (lut, model.lists.data, li, sizes_g, model.lists.ids)
    got = adc.adc_scan_lists(*args)
    want = adc.adc_scan_lists_plain(*args)
    err = compare_scores(got, want, 1e-4, 1e-4, "K3 lists knnlm-path shape")
    old = functools.partial(_old_group_step, adc)
    compare_scores(old(*args), want, 1e-4, 1e-4, "the old group step")
    bound_ms, bound_by, nbytes, ops = lists_bound(lut, model.lists.data, li, model.lists.sizes)
    sets = l2_copies(args, nbytes)
    ms = time_ms(adc.adc_scan_lists, sets, iters=50)
    old_ms = time_ms(old, sets, iters=50)
    warm_ms = time_ms(adc.adc_scan_lists, [args], iters=50)
    call_ms = time_ms(adc.adc_scan_lists, [args], iters=50, queued=False)
    plain_ms = time_ms(adc.adc_scan_lists_plain, sets, iters=10)
    del sets
    P, m, _ = lut.shape
    log(f"K3 lists knnlm-path shape: P={P} (nq={q.shape[0]} g={g}) cap={model.lists.cap} "
        f"m={m} lut={'bf16' if model.lut_bf16 else 'f32'} live rows={int(sizes_g.sum())}: "
        f"kernel {ms:.4f} ms against the old group step (gather + K3 + mask) {old_ms:.4f} ms "
        f"({old_ms / ms:.2f}x) (L2-warm back to back {warm_ms:.4f} ms; {call_ms:.4f} ms a "
        f"call when the host issues them), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes} bytes, of which LUT {lut.numel() * lut.element_size()}; "
        f"{ops} adds), {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, max_abs_err {err:.3g}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def shared_main_shape(adc, ivf, model, q_block: np.ndarray) -> dict:
    """K4, its plain version and the library yardstick on the flat-PQ
    path's own inputs: one query block's LUT and the first chunk of the
    list, built by the model's own helpers."""
    _, nb, _ = model._search_plan()
    q = torch.from_numpy(np.ascontiguousarray(q_block[:nb])).cuda()
    lut, codes = ivf._pq_shared_inputs(model.centroids, model.codebooks, model.lists.data,
                                       int(model.lists.sizes_host[0]), q, model.metric,
                                       model.lut_bf16)
    codes = codes[:ivf.shared_chunk_rows(nb)]
    got = adc.adc_scan_shared(lut, codes)
    want = adc.adc_scan_shared_plain(lut, codes)
    err = compare_scores(got, want, 0.0, 0.0, "K4 flat-PQ-path shape")
    bound_ms, bound_by, nbytes, ops = shared_bound(lut, codes)
    sets = l2_copies((lut, codes), nbytes)
    ms = time_ms(adc.adc_scan_shared, sets)
    warm_ms = time_ms(adc.adc_scan_shared, [(lut, codes)])
    plain_ms = time_ms(adc.adc_scan_shared_plain, sets, warmup=1, iters=5)
    del sets
    # the yardstick: one PyTorch call computing the same sums, (L, nq),
    # its index and table built beforehand, in f32; used nowhere in the port
    nq, m, ksub = lut.shape
    index = codes.long() + torch.arange(m, device=codes.device) * ksub
    table = lut.float().reshape(nq, m * ksub).T.contiguous()
    bag = functools.partial(torch.nn.functional.embedding_bag, mode="sum")
    lib_err = compare_scores(bag(index, table).T, want, 1e-4, 1e-4, "embedding_bag")
    lib_bytes = index.numel() * 8 + table.numel() * 4 + nq * codes.shape[0] * 4
    lib_sets = l2_copies((index, table), lib_bytes)
    library_ms = time_ms(bag, lib_sets)
    del lib_sets, index, table
    log(f"K4 flat-PQ-path shape: nq={nq} L={codes.shape[0]} m={m} "
        f"lut={'bf16' if model.lut_bf16 else 'f32'}: kernel {ms:.4f} ms (L2-warm back to "
        f"back {warm_ms:.4f} ms), plain {plain_ms:.4f} ms, embedding_bag {library_ms:.4f} ms "
        f"(max_abs_err {lib_err:.3g}), bound {bound_ms:.4f} ms ({bound_by}: {nbytes} bytes, "
        f"{ops} adds), {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, "
        f"{ops / (ms * 1e-3) / 1e9:.1f} G lookups/s, max_abs_err {err:.3g}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000, help="rows in the ivfsq index")
    ap.add_argument("--nq", type=int, default=10_000, help="queries served on each path")
    ap.add_argument("--nprobe-from", type=int, default=1,
                    help="first nprobe of the ivfsq and knnlm recall sweeps (both cfgs "
                         "say 32)")
    ap.add_argument("--profile", action="store_true",
                    help="also serve 2000 queries on the ivfsq, knnlm and flat-PQ paths "
                         "under torch.profiler and print where the device time goes")
    args = ap.parse_args(argv)
    if args.nq < 1000:
        ap.error("--nq must be >= 1000 (the recall sweeps use the first 1000)")
    if not 1 <= args.nprobe_from <= 1024:
        ap.error("--nprobe-from must be in 1..1024 (the ivfsq index has 1024 lists)")
    if not os.path.isdir(os.path.join(REPO, "distributed_faiss_tpu_torch", "csrc")):
        print(f"chip_smoke: {REPO} is not a checkout of the repo (no "
              "distributed_faiss_tpu_torch/csrc beside this script)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from distributed_faiss_tpu_torch.models import ivf
    from distributed_faiss_tpu_torch.ops import adc_scan, cuda_build, distance, flat_scan
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
    adc_variants = adc_kernel_phase(adc_scan, args.seed)
    lists_variants = lists_kernel_phase(adc_scan, args.seed)
    shared_variants = shared_kernel_phase(adc_scan, args.seed)
    log(f"kernel phase: {len(variants)} K1 variants, {len(adc_variants)} K2/K3 cases, "
        f"{len(lists_variants)} K3-over-the-lists cases and {len(shared_variants)} K4 cases "
        f"agree with the plain version ({time.perf_counter() - t0:.1f} s)")

    counters = launch_counters(flat_scan, adc_scan)
    t0 = time.perf_counter()
    sq_out = ivfsq_path(args, counters, card)
    log(f"ivfsq path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    outs = knnlm_path(args, counters, card)
    pq_out, k2_out, flat_out = outs["knnlm"], outs["k2"], outs["flatpq"]
    log(f"knnlm, IVF1024,PQ12,RFlat, PQ64,RFlat, OPQ64,PQ64,RFlat and PQ128,RFlat paths: "
        f"{time.perf_counter() - t0:.1f} s")

    k1 = k1_main_shape(flat_scan, ivf, sq_out["model"], sq_out["q_block"])
    k3 = adc_main_shape(adc_scan, ivf, pq_out["model"], pq_out["q_block"], "knnlm")
    k3_lists = lists_main_shape(adc_scan, ivf, pq_out["model"], pq_out["q_block"])
    k2 = adc_main_shape(adc_scan, ivf, k2_out["model"], k2_out["q_block"],
                        "IVF1024,PQ12,RFlat")
    k4 = shared_main_shape(adc_scan, ivf, flat_out["model"], flat_out["q_block"])
    kernels = [
        dict(name="flat_list_scan", route="cuda", source=K1_SOURCE, replaces=K1_REPLACES,
             launches=sq_out["counts"]["K1"], **k1, library_ms=None),
        dict(name="adc_scan", route="cuda", source=ADC_SOURCE, replaces=K2_REPLACES,
             launches=k2_out["counts"]["K2"], **k2, library_ms=None),
        # K3's counter counts both of its entries; this row is the gathered
        # entry alone (0 on the knnlm path, which scores over the lists)
        dict(name="adc_scan_nibble", route="cuda", source=ADC_SOURCE, replaces=K3_REPLACES,
             launches=pq_out["counts"]["K3"] - pq_out["counts"]["K3 lists"], **k3,
             library_ms=None),
        dict(name="adc_scan_lists", route="cuda", source=ADC_SOURCE, replaces=K3_REPLACES,
             launches=pq_out["counts"]["K3 lists"], **k3_lists, library_ms=None),
        dict(name="adc_scan_shared", route="cuda", source=ADC_SOURCE, replaces=K4_REPLACES,
             launches=flat_out["counts"]["K4"], **k4),
    ]
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
