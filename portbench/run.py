"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit); the same checks are the last lines of standard error. Without a
CUDA card, or with fewer cards than the cell asks for, it exits 2 and
prints no result.
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


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def emit(result: dict) -> None:
    """The checks on standard error, then the result as the last line of
    standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    from portbench import spec, traffic
    from portbench.rank import forbidden_modules
    from portbench.rankproc import RankProcess, RunError

    cell = spec.Cell(spec.load_benchmark(ROOT), args.workload)
    # the rank's process imports while this one does; it touches the card
    # only once the data is drawn and the card freed
    rank = RankProcess("cuda", ROOT)
    try:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        from portbench import harness

        result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START,
                                  rank=rank)
    except (RunError, spec.SpecError, traffic.PoolExhausted) as e:
        print(f"run failed: {e}", file=sys.stderr)
        return 1
    finally:
        rank.close()
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package loaded: {found}", file=sys.stderr)
        return 1
    emit(result)
    return 0

if __name__ == "__main__":
    sys.exit(main())
