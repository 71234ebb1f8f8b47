"""Launch an index-server cluster of the port (counterpart of
scripts/server_launcher.py; reference scripts/server_launcher.py).

Local mode (no SLURM needed):
    python -m distributed_faiss_tpu_torch.scripts.server_launcher --num-servers 4 \\
        --discovery-config /tmp/disc.txt --index-storage-dir /tmp/idx

SLURM mode (requires submitit):
    python -m distributed_faiss_tpu_torch.scripts.server_launcher --backend slurm \\
        --num-servers 64 --num-servers-per-node 32 --partition learnlab ...

Every rank serves on ``--device`` (default ``cuda``).
"""

import argparse
import logging
import sys


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--backend", choices=["local", "slurm"], default="local",
                   help="slurm submits through submitit; local starts the ranks on "
                        "this host")
    p.add_argument("--discovery-config", required=True,
                   help="shared file: first line server count, then host,port lines")
    p.add_argument("--num-servers", type=int, required=True)
    p.add_argument("--num-servers-per-node", type=int, default=8)
    p.add_argument("--base-port", type=int, default=12033)
    p.add_argument("--index-storage-dir", required=True)
    p.add_argument("--load-index", action="store_true",
                   help="restore the default index from storage on start")
    p.add_argument("--partition", default="learnlab")
    p.add_argument("--mem-gb", type=int, default=400)
    p.add_argument("--timeout-min", type=int, default=4320)
    p.add_argument("--log-dir", default="slurm_logs")
    p.add_argument("--device", default="cuda", help="the device every rank serves on")
    return p.parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = get_args(argv)
    from distributed_faiss_tpu_torch.parallel import launcher

    if args.backend == "local":
        procs = launcher.launch_local(
            args.num_servers, args.discovery_config, args.index_storage_dir,
            base_port=args.base_port, load_index=args.load_index, device=args.device)
        logging.info("launched %d local servers (pids %s); Ctrl-C to stop",
                     len(procs), [p.pid for p in procs])
        try:
            for p in procs:
                p.wait()
        except KeyboardInterrupt:
            for p in procs:
                p.terminate()
    else:
        job = launcher.launch_slurm(
            args.num_servers, args.num_servers_per_node, args.discovery_config,
            args.index_storage_dir, base_port=args.base_port, load_index=args.load_index,
            partition=args.partition, mem_gb=args.mem_gb, timeout_min=args.timeout_min,
            log_dir=args.log_dir, device=args.device)
        logging.info("submitted SLURM job %s", job)
    return 0


if __name__ == "__main__":
    sys.exit(main())
