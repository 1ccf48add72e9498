"""Readings the benchmark's limits and fixed rates are set from; never run
by a cell's own runs.

    python3 benchmark/calibrate.py --workloads A,B --seeds 1,2,3 [--control] [--seconds 2]
    python3 benchmark/calibrate.py --workloads A,B --seeds 1,2,3 --build-only [--control]

The first form drives each workload's timed path on each seed, with a
short window, and prints one JSON line per (workload, seed, side) with
every number the comparison computes: side "program", and with --control
side "control", the mix's `control` in the program's place ("program_pin":
the program with a lower-precision grid pinned; "reference": the plain
reference at that precision). Workloads of one configuration share each
seed's build. The second form only builds each configuration and prints
the build's own numbers (plaidbench/judge.py:build_check), with --control
also those of the faults they catch (judge.build_faults), as side "fault".
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
os.environ.setdefault("USE_FLAX", "0")

import torch  # noqa: E402

from plaidbench import deploy  # noqa: E402
from plaidbench.harness import Run  # noqa: E402
from plaidbench.registry import Registry  # noqa: E402


def readings(reg, workloads, seeds, seconds, control, device):
    """Yield one dict per (workload, seed, side)."""
    by_config = {}
    for w in workloads:
        by_config.setdefault(reg.cell(w)["config"], []).append(w)
    for seed in seeds:
        for cfg_name, cells in by_config.items():
            cfg = reg.config(cfg_name)
            dep = deploy.build(cfg, seed, device)
            try:
                for w in cells:
                    mix = reg.mix(reg.cell(w)["traffic"])
                    driver = reg.driver(mix["driver"])
                    sides = [("program", None)] + ([("control", mix["control"])] if control else [])
                    for side, ctl in sides:
                        run = Run(w, cfg, mix, seed, seconds, False, device, time.perf_counter(), ctl)
                        out = driver.drive(run, dep)
                        deploy.release(device)
                        yield {"workload": w, "seed": seed, "side": side,
                               "numbers": out["numbers"], "e2e": out["e2e"]}
            finally:
                dep.close()


def build_readings(reg, workloads, seeds, control, device):
    """Yield one dict per (configuration, seed, side) of the build's numbers."""
    from reference import plaid

    from plaidbench import judge

    configs = sorted({reg.cell(w)["config"] for w in workloads})
    for seed in seeds:
        for name in configs:
            cfg = reg.config(name)
            t = time.perf_counter()
            dep = deploy.build(cfg, seed, device)
            build_s = time.perf_counter() - t
            try:
                files = plaid.IndexFiles(dep.path, device)
                numbers = judge.build_check(files, cfg, seed, dep.lens, files.ivf(), device)
                yield {"config": name, "seed": seed, "side": "program", "numbers": numbers,
                       "build_s": build_s}
                if control:
                    yield {"config": name, "seed": seed, "side": "fault",
                           "numbers": judge.build_faults(files, cfg, seed, dep.lens, device)}
                del files
                deploy.release(device)
            finally:
                dep.close()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args()
    device = torch.device("cuda")
    reg = Registry()
    seeds = [int(s) for s in args.seeds.split(",")]
    workloads = args.workloads.split(",")
    if args.build_only:
        lines = build_readings(reg, workloads, seeds, args.control, device)
    else:
        lines = readings(reg, workloads, seeds, args.seconds, args.control, device)
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
