"""One run of one cell: resolve it by name, refuse without the cards it
asks for, drive it, judge it, and print the result line.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and
last `checks`: each number compared beside its limit, which also close
standard error.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

from plaidbench import judge
from plaidbench.registry import Registry

# Top-level module names that may not be loaded once the window has closed.
FORBIDDEN = {"jax", "jaxlib", "flax", "nextplaid_tpu"}


@dataclass
class Run:
    """What a driver is given."""

    cell: str
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: Any  # torch.device
    t0: float  # perf_counter() at the process's start: set-up runs from it
    control: Optional[dict] = None  # the mix's control, for calibration only


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def run_cell(reg: Registry, name: str, seed: int, seconds: float, trace: bool,
             device, t0: float) -> Optional[dict]:
    """Drive the cell once and build its result line; None (and the reason
    on standard error) when the run may print no result."""
    cell = reg.cell(name)
    mix = reg.mix(cell["traffic"])
    run = Run(name, reg.config(cell["config"]), mix, seed, seconds, trace, device, t0)
    out = reg.driver(mix["driver"]).drive(run)
    bad = forbidden_modules()
    if bad:
        print(f"refused: the run loaded {', '.join(bad)}", file=sys.stderr)
        return None
    if trace:
        metrics = {}
        for m in reg.per_layer(name):
            value = reg.reader(m["name"]).read(out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {
            m["name"]: {"value": float(out["e2e"][m["name"]]), "unit": m["unit"]}
            for m in reg.end_to_end(name)
        }
    numbers = out["numbers"]
    correct, checks = judge.verdict(numbers, mix["limits"])
    for k, v in sorted(numbers.items()):
        if k not in checks:
            print(f"reading {k} = {v!r}", file=sys.stderr)
    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": _device_name(device),
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(out["memory_peak_bytes"]),
    }
    line = {"correct": correct, "attempted": int(out["attempted"]), "failed": int(out["failed"]),
            "metrics": metrics, "device": device_info}
    if trace:
        tr = out["trace"]
        device_info["busy_s"] = float(tr["busy_s"])
        device_info["window_s"] = float(tr["window_s"])
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["checks"] = checks
    return line


def _device_name(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        reg = Registry()
        chips = int(reg.cell(args.workload)["chips"])
    except (OSError, KeyError, ValueError) as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"refused: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    try:
        import nextplaid_tpu_torch
    except ImportError as e:
        print(f"refused: the program is not in this checkout ({e})", file=sys.stderr)
        return 2
    home = Path(nextplaid_tpu_torch.__file__).resolve()
    if reg.root.resolve() not in home.parents:
        print(f"refused: nextplaid_tpu_torch comes from {home}, not this checkout", file=sys.stderr)
        return 2
    line = run_cell(reg, args.workload, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda"), t0)
    if line is None:
        return 3
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
