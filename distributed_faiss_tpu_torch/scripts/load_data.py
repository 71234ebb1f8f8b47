"""Bulk-ingest a numpy memmap into a running cluster of the port
(counterpart of scripts/load_data.py; reference scripts/load_data.py):
batched adds with integer-id metadata, a periodic save, training when the
cluster is not trained yet, a wait for TRAINED, and a smoke search.

    python -m distributed_faiss_tpu_torch.scripts.load_data --data /path/emb.mmap \\
        --dtype fp16 --dim 768 --discovery /tmp/disc.txt --index-id wiki

``--make-random N`` writes a random memmap of N rows instead and exits.
``--device`` (default ``cuda``) is the device the cluster must serve on:
every server's ``ping`` must report it, or the load stops before the first
add.
"""

import argparse
import logging
import os
import sys
import time

import numpy as np

logger = logging.getLogger()


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True, help="memmap/npy path")
    p.add_argument("--dtype", choices=["fp16", "fp32"], default="fp16")
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--num-rows", type=int, default=-1, help="-1: infer from file size")
    p.add_argument("--bs", type=int, default=1000)
    p.add_argument("--discovery", required=True)
    p.add_argument("--index-id", default="default")
    p.add_argument("--cfg", default=None, help="IndexCfg json path")
    p.add_argument("--save-every-rows", type=int, default=10_000_000,
                   help="per-server save cadence in ingested rows")
    p.add_argument("--make-random", type=int, default=0,
                   help="write a random memmap with this many rows and exit")
    p.add_argument("--device", default="cuda",
                   help="the device every server must report in its ping")
    return p.parse_args(argv)


def save_random_mmap(path: str, rows: int, dim: int, dtype) -> None:
    mm = np.memmap(path, dtype=dtype, mode="w+", shape=(rows, dim))
    bs = 100_000
    rng = np.random.default_rng(0)
    for s in range(0, rows, bs):
        n = min(bs, rows - s)
        mm[s:s + n] = rng.standard_normal((n, dim)).astype(dtype)
    mm.flush()
    logger.info("wrote %d x %d %s memmap to %s", rows, dim, np.dtype(dtype).name, path)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = get_args(argv)
    dtype = np.float16 if args.dtype == "fp16" else np.float32
    if args.make_random:
        save_random_mmap(args.data, args.make_random, args.dim, dtype)
        return 0

    from distributed_faiss_tpu_torch.parallel.client import IndexClient
    from distributed_faiss_tpu_torch.utils.config import IndexCfg
    from distributed_faiss_tpu_torch.utils.state import IndexState

    rows = args.num_rows
    if rows < 0:
        rows = os.path.getsize(args.data) // (np.dtype(dtype).itemsize * args.dim)
    data = np.memmap(args.data, dtype=dtype, mode="r", shape=(rows, args.dim))

    client = IndexClient(args.discovery, cfg_path=args.cfg)
    try:
        devices = {p.get("device") for p in client.ping()}
        if any(d is None or not str(d).startswith(args.device) for d in devices):
            raise RuntimeError(f"--device {args.device}: the servers answer on {devices}")
        cfg = client.cfg or IndexCfg(dim=args.dim)
        cfg.dim = args.dim
        client.create_index(args.index_id, cfg)
        save_every = args.save_every_rows * client.get_num_servers()
        t0 = time.time()
        logger.info("ingest start ts=%.3f", t0)
        since_save = 0
        for s in range(0, rows, args.bs):
            batch = np.asarray(data[s:s + args.bs], np.float32)
            client.add_index_data(args.index_id, batch, list(range(s, s + batch.shape[0])))
            since_save += batch.shape[0]
            if since_save >= save_every:
                logger.info("periodic save at %d rows", s + batch.shape[0])
                client.save_index(args.index_id)
                since_save = 0
            if (s // args.bs) % 100 == 0:
                done = s + batch.shape[0]
                logger.info("ingested %d/%d rows (%.0f rows/s)", done, rows,
                            done / max(time.time() - t0, 1e-9))
        if client.get_state(args.index_id) != IndexState.TRAINED:
            logger.info("triggering training")
            client.sync_train(args.index_id)
            while client.get_state(args.index_id) != IndexState.TRAINED:
                logger.info("waiting for cluster to reach TRAINED...")
                time.sleep(5)
        logger.info("load complete: %d rows in %.1fs; ntotal=%d", rows, time.time() - t0,
                    client.get_ntotal(args.index_id))
        scores, meta = client.search(np.asarray(data[:16], np.float32), 5, args.index_id)
        logger.info("smoke search ok: scores %s, top1 meta %s", scores.shape,
                    [m[0] for m in meta[:4]])
        client.save_index(args.index_id)
    finally:
        client.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
