"""Find a configuration's operating points once, on the card: build its
shard through the served path as a run does, then double nprobe (from 1) and
read recall@10 over 1000 eval queries against the exact top-10 of
``reference.py``, with a short closed loop of a mix at each nprobe for its
rate. A cell's nprobe is the smallest at which every seed swept reaches
the mix's recall bar (``cells/<cell>.json`` records it).

    python3 portbench/sweep.py --config sift1m-ivfsq --mix r95 --seeds 1 2 3 \\
        [--min-nprobe 1] [--max-nprobe 256] [--loop-seconds 3]

Prints one JSON line a (seed, nprobe).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

EVAL_QUERIES = 1000


def sweep_seed(config: dict, mix: dict, seed: int, max_nprobe: int, loop_s: float,
               device: str = "cuda", min_nprobe: int = 1) -> list:
    import numpy as np
    import torch

    from distributed_faiss_tpu_torch.parallel.client import IndexClient
    from distributed_faiss_tpu_torch.utils.config import IndexCfg
    from portbench import corpus, harness, rankproc, reference, traffic

    rows_req, k, clients = int(mix["rows_per_request"]), int(mix["k"]), int(mix["clients"])
    gen = corpus.make_corpus(config, device)
    x_dev = gen.draw(int(config["rows"]), seed, "rows")
    q_eval = gen.draw(EVAL_QUERIES, seed, "eval")
    _, gt = reference.exact_topk(x_dev, q_eval, k)
    gt = gt.cpu().numpy()
    x, q_eval = x_dev.cpu().numpy(), q_eval.cpu().numpy()
    pool = gen.draw(int(loop_s * 400_000) // rows_req * rows_req, seed, "queries").cpu().numpy()
    del gen, x_dev
    if device == "cuda":
        torch.cuda.empty_cache()
    rank, conns, out = rankproc.RankProcess(device, ROOT), [], []
    try:
        disc = rank.start()["disc"]
        cfg = IndexCfg(**dict(config["index"], nprobe=1))
        times = {}
        loader = IndexClient(disc)
        conns.append(loader)
        harness.build_shard(loader, cfg, x, times)
        for _ in range(clients):
            c = IndexClient(disc)
            c.cfg = cfg
            conns.append(c)
        nlist = int(config["index"]["centroids"])
        nprobe = min_nprobe
        while nprobe <= min(max_nprobe, nlist):
            loader.set_nprobe(harness.INDEX_ID, nprobe)
            ids = np.concatenate([traffic.meta_ids(loader.search(
                q_eval[s:s + rows_req], k, harness.INDEX_ID)[1])
                for s in range(0, EVAL_QUERIES, rows_req)])
            recall = sum(len(set(a.tolist()) & set(b.tolist()))
                         for a, b in zip(ids, gt)) / float(gt.size)
            for c in conns[1:]:
                c.search(q_eval[:rows_req], k, harness.INDEX_ID)
            loop = traffic.ClosedLoop(
                [lambda qq, kk, c=c: c.search(qq, kk, harness.INDEX_ID) for c in conns[1:]],
                traffic.Pool([pool], rows_req), k)
            t0 = time.perf_counter()
            reqs = loop.run(t0 + loop_s, 60.0)
            stats = traffic.window_stats(reqs, t0 + loop_s / 4, t0 + loop_s)
            line = dict(config=config["name"], seed=seed, nprobe=nprobe, recall10=recall,
                        qps=stats["qps"], p95_ms=stats["p95_ms"], build=times)
            print(json.dumps(line), flush=True)
            out.append(line)
            nprobe *= 2
        programs = rank.call("programs", index=harness.INDEX_ID)
        memory = rank.call("memory")
        path = os.path.join(rank.work, "snapshot.npz")
        rank.call("snapshot", index=harness.INDEX_ID, path=path)
        with np.load(path) as z:
            sizes = z["sizes"]
        lists = {"largest": int(sizes.max()), "p99": float(np.percentile(sizes, 99)),
                 "empty": int((sizes == 0).sum())}
        print(json.dumps(dict(config=config["name"], seed=seed, programs=programs,
                              memory=memory, lists=lists)), flush=True)
    finally:
        for c in conns:
            c.close()
        rank.close()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--mix", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--min-nprobe", type=int, default=1)
    p.add_argument("--max-nprobe", type=int, default=256)
    p.add_argument("--loop-seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    from portbench import spec

    config = spec.load_config(args.config)
    mix = spec.load_mix(args.mix)
    for seed in args.seeds:
        sweep_seed(config, mix, seed, args.max_nprobe, args.loop_seconds,
                   min_nprobe=args.min_nprobe)
    return 0


if __name__ == "__main__":
    sys.exit(main())
