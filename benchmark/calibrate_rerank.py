"""Readings the limits of a `closed_rerank` cell are set from; never run by
a cell's own runs.

    python3 benchmark/calibrate_rerank.py --workload W --seeds 1,2,3 [--controls quantized,all_global,rope_unrestarted] [--seconds 2]

For each seed, drives the cell's timed path with a short window and prints
one JSON line per side with every number the comparison computes: side
"program", then each control in the program's place (plaidbench's
`closed_rerank` docstring: the int8 mode and the two planted faults).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

from plaidbench import deploy  # noqa: E402
from plaidbench.harness import Run  # noqa: E402
from plaidbench.registry import Registry  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    device = torch.device("cuda")
    reg = Registry()
    cell = reg.cell(args.workload)
    cfg, mix = reg.config(cell["config"]), reg.mix(cell["traffic"])
    driver = reg.driver(mix["driver"])
    sides = [None] + [{"kind": k} for k in args.controls.split(",") if k]
    for seed in (int(s) for s in args.seeds.split(",")):
        for control in sides:
            run = Run(args.workload, cfg, mix, seed, args.seconds, False, device,
                      time.perf_counter(), control)
            out = driver.drive(run)
            deploy.release(device)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": control["kind"] if control else "program",
                              "numbers": out["numbers"], "e2e": out["e2e"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
