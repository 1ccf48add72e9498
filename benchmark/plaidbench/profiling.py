"""Device-trace reduction: a torch.profiler window read as busy seconds,
device time by operation name, and the longest idle gaps labelled by what
the host was doing (the innermost host span open at the gap's middle).
Python's garbage collections, which the profiler does not see, are added
as host spans of their own.

The pattern of scripts/profile_torch_search.py: CPU and CUDA activities,
device events summed by name. Names are cut to 90 characters, since
templated kernels run to hundreds.
"""

from __future__ import annotations

import bisect
import gc
import time
from typing import Dict, List, Optional, Tuple

import torch

NAME_CHARS = 90
TOP_N = 10
MARK = "bench.trace_start"


def _cut(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[: NAME_CHARS - 3] + "..."


class DeviceTrace:
    """Profile the card between `start()` and `stop()`; `summary()` then
    gives busy_s, window_s, device seconds by name and the idle gaps."""

    def __init__(self) -> None:
        self._prof: Optional[torch.profiler.profile] = None
        self._t0 = self._t1 = 0.0
        self.events: List[Tuple[str, float, float]] = []  # device (name, start_s, end_s)
        self.host: List[Tuple[float, float, str]] = []  # host (start_s, end_s, name)
        self._gc: List[Tuple[float, float, int]] = []  # perf_counter spans
        self._gc_t = 0.0

    def start(self) -> None:
        """Profile from now on. One warm-up step first, not recorded: the
        profiler's first device copy and launch take hundreds of ms."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(
            activities=acts, acc_events=True,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
        )
        self._prof.__enter__()
        if torch.cuda.is_available():
            x = torch.ones(1 << 18).cuda()
            (x @ x).cpu()
        _sync()
        self._prof.step()
        _sync()
        with torch.profiler.record_function(MARK):
            self._t0 = time.perf_counter()
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t = time.perf_counter()
        else:
            self._gc.append((self._gc_t, time.perf_counter(), info["generation"]))

    def stop(self) -> None:
        _sync()
        self._t1 = time.perf_counter()
        gc.callbacks.remove(self._on_gc)
        self._prof.__exit__(None, None, None)
        for evt in self._prof.events():
            span = (evt.time_range.start / 1e6, evt.time_range.end / 1e6)
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                self.events.append((evt.name, *span))
            else:
                self.host.append((*span, evt.name))
        # A record_function range also shows on the device timeline under
        # its host name; it is no operation of its own.
        host_names = {h[2] for h in self.host}
        self.events = [e for e in self.events if e[0] not in host_names]
        # The mark opens at perf_counter() == t0: it maps the collections'
        # perf_counter spans onto the profiler's clock.
        mark = min((h[0] for h in self.host if h[2] == MARK), default=None)
        if mark is not None:
            off = mark - self._t0
            self.host += [(a + off, b + off, f"python gc (generation {g})") for a, b, g in self._gc]
        self._prof = None

    def summary(self) -> Dict[str, object]:
        return summarize(self.events, self.host, self._t1 - self._t0)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _busy_intervals(events: List[Tuple[str, float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _host_label(host_sorted: List[Tuple[float, float, str]], starts: List[float], t: float) -> str:
    """The innermost host span open at time t (the latest-starting one that
    has not ended), or "host" when none is."""
    i = bisect.bisect_right(starts, t)
    best = None
    for s, e, name in reversed(host_sorted[max(0, i - 4096) : i]):
        if e >= t:
            best = name
            break
    return best or "host"


def summarize(
    events: List[Tuple[str, float, float]],
    host: List[Tuple[float, float, str]],
    window_s: float,
) -> Dict[str, object]:
    """busy_s (the union of device intervals), window_s, the device
    operations that took most time and the longest idle gaps between device
    intervals, each at most TOP_N [name, seconds] pairs; also
    `device_s_by_name` whole, for the per-layer readers."""
    by_name: Dict[str, float] = {}
    for name, s, e in events:
        key = _cut(name)
        by_name[key] = by_name.get(key, 0.0) + (e - s)
    busy = _busy_intervals(events)
    busy_s = sum(e - s for s, e in busy)
    gaps = sorted(
        ((busy[i + 1][0] - busy[i][1], busy[i][1]) for i in range(len(busy) - 1)),
        reverse=True,
    )[:TOP_N]
    host_sorted = sorted(host)
    starts = [h[0] for h in host_sorted]
    idle = [[_cut(_host_label(host_sorted, starts, t + g / 2)), g] for g, t in gaps if g > 0]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "device_ops": [[k, v] for k, v in ops[:TOP_N]],
        "idle_gaps": idle,
        "device_s_by_name": by_name,
    }
