"""The control of ``correct``: what a cell's comparison reads when the
program's answers come one precision below what its configuration serves.
It has to come out as not correct; the readings set the upper end of each
limit (``cells/<cell>.json`` ``limits``). Benchmark runs do not run it.

A configuration's ``control`` says which:

- ``{"kind": "program", "index": {...}}``: the program with its own
  lower-precision path switched on (the index keys given replace the
  configuration's), served and compared as a run does;
- ``{"kind": "reference", "precision": "int8"}``: the reference put in the
  program's place, its rows stored at that precision, answering the
  queries a run would send, compared by the same ``reference.compare``.

    python3 portbench/control.py --workload sift1m-ivfsq.r95 --seeds 1 2 3 [--seconds 5]

Prints one JSON line a seed with the numbers compared.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def reference_control(cell, seed: int, device: str = "cuda") -> dict:
    """The reference at the control's precision in the program's place,
    over the queries a run sends first, as many as a run compares."""
    import torch

    from portbench import corpus, harness, reference

    rows_req = int(cell.mix["rows_per_request"])
    gen = corpus.make_corpus(cell.config, device)
    x = gen.draw(int(cell.config["rows"]), seed, "rows")
    q = gen.draw(harness.SAMPLE_REQUESTS * rows_req, seed, "queries")
    d, ids = reference.control_answers(x, q, int(cell.mix["k"]),
                                       cell.config["control"]["precision"])
    out = reference.compare(x, q, d, ids)
    del x, q
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def program_control(cell, seed: int, seconds: float, device: str = "cuda") -> dict:
    """A run of the cell with the program's lower-precision path on."""
    from portbench import harness

    ctl = copy.copy(cell)
    ctl.config = copy.deepcopy(cell.config)
    ctl.config["index"].update(cell.config["control"]["index"])
    ctl.config["index"] = {k: v for k, v in ctl.config["index"].items() if v is not None}
    out = harness.run_cell(ctl, seed, seconds, False, time.perf_counter(), device=device)
    return {name: c["value"] for name, c in out["checks"].items()}


def control_numbers(cell, seed: int, seconds: float, device: str = "cuda") -> dict:
    kind = cell.config["control"]["kind"]
    if kind == "program":
        return program_control(cell, seed, seconds, device)
    if kind == "reference":
        return reference_control(cell, seed, device)
    raise ValueError(f"unknown control kind {kind!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    from portbench import spec

    cell = spec.Cell(spec.load_benchmark(ROOT), args.workload)
    for seed in args.seeds:
        numbers = control_numbers(cell, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": cell.config["control"], **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
