"""Driver kind `closed_batch`: one in-process caller of the library keeps
`window` batches in flight through `search_batch_async` ->
`PendingSearch.result`, cycling a pool of distinct queries drawn from the
seed.

Mix keys: `route` ("pin": `with_token_grid()` as it chooses, which must
give the grid dtype `grid`; "unpinned": `DeviceIndex.load` alone, whose
answers must come from the route named by `reference`), `search` (the
SearchParameters), `batch`, `pool_batches`, `window`, `trace_seconds` (the
profiled stretch of the traced run), `mark_batches` (staged batches timed
stage by stage in the traced run), `check` and `limits` (plaidbench/judge.py).

The window counts the queries whose results were read inside it, over its
seconds. Nothing compiles there: every batch of the pool runs once before.
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from plaidbench import corpus, deploy, judge
from plaidbench.peaks import maxsim_ops
from plaidbench.profiling import DeviceTrace
from reference import plaid


def _pad(batch: List[np.ndarray], dim: int, bucket: int = 32):
    """Zero-padded [Q, Tq, d] queries and their mask, Tq rounded up to 32,
    as the program pads them."""
    tq = max(bucket, -(-max(q.shape[0] for q in batch) // bucket) * bucket)
    arr = np.zeros((len(batch), tq, dim), np.float32)
    mask = np.zeros((len(batch), tq), bool)
    for i, q in enumerate(batch):
        arr[i, : q.shape[0]] = q
        mask[i, : q.shape[0]] = True
    return arr, mask


def closed_loop(index, batches, params, window: int, seconds: float,
                keep: Optional[Callable] = None, label: bool = False):
    """Keep `window` batches in flight for `seconds`, then drain. Returns the
    records (batch no, dispatch start, dispatch end, read start, read end)
    and the window's end; `keep(batch no, results)` sees every batch read."""
    from nextplaid_tpu_torch.index import search_batch_async

    def span(name):
        return torch.profiler.record_function(name) if label else nullcontext()

    records, pending = [], deque()
    n = 0
    t_end = time.perf_counter() + seconds
    while True:
        while len(pending) < window and time.perf_counter() < t_end:
            ta = time.perf_counter()
            with span("bench.dispatch"):
                p = search_batch_async(index, batches[n % len(batches)], params)
            pending.append((n, p, ta, time.perf_counter()))
            n += 1
        if not pending:
            break
        j, p, ta, tb = pending.popleft()
        tc = time.perf_counter()
        with span("bench.result"):
            res = p.result()
        records.append((j, ta, tb, tc, time.perf_counter()))
        if keep is not None:
            keep(j, res)
    return records, t_end


class Reservoir:
    """A uniform sample of at most `k` items of a stream, drawn from a seed
    (Algorithm R): the window keeps k answers to compare, not every one."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self._rng = np.random.default_rng(seed)

    def offer(self, n: int, item: Callable[[int], tuple]) -> None:
        """Offer the next `n` items of the stream; item(i) builds the i-th."""
        fill = min(n, self.k - len(self.items))
        self.items.extend(item(i) for i in range(fill))
        if fill < n:
            draws = self._rng.integers(0, np.arange(self.seen + fill, self.seen + n) + 1)
            for i in np.nonzero(draws < self.k)[0]:
                self.items[draws[i]] = item(fill + int(i))
        self.seen += n


def stage_marks(index, batches, params, count: int) -> List[Dict[str, float]]:
    """Stage boundaries of `count` staged batches by the port's CUDA-event
    `marks`, in ms from the batch's start, each batch run as
    search_batch_async runs it (PipelineShapes.derive, then search_pipeline)."""
    from nextplaid_tpu_torch.index.search import PipelineShapes, search_pipeline

    if index.device.type != "cuda":  # the marks are CUDA events
        return []
    out = []
    for b in batches[:count]:
        arr, mask = _pad(b, index.dim)
        q_t = torch.from_numpy(arr).to(index.device)
        m_t = torch.from_numpy(mask).to(index.device)
        shapes = PipelineShapes.derive(index, params, len(b), arr.shape[1])
        marks: list = []
        search_pipeline(index, q_t, m_t, None, shapes, marks=marks)
        torch.cuda.synchronize()
        start = marks[0][1]
        out.append({name: start.elapsed_time(ev) for name, ev in marks})
    return out


def _serve(dep, mix, device, control):
    from nextplaid_tpu_torch.index import DeviceIndex

    index = DeviceIndex.load(dep.path, device=device)
    if control and control["kind"] == "program_pin":
        return index.with_token_grid(dtype=control["dtype"])
    if mix["route"] == "pin":
        index = index.with_token_grid()
        got = {torch.bfloat16: "bf16", torch.int8: "int8"}.get(
            None if index.token_grid is None else index.token_grid.dtype, "none"
        )
        if got != mix["grid"]:
            raise RuntimeError(f"the pin gave a {got} grid, the mix states {mix['grid']}")
    return index


def drive(run, dep: Optional[deploy.Deployment] = None) -> dict:
    from nextplaid_tpu_torch.index import SearchParameters

    cfg, mix, dev = run.config, run.mix, run.device
    own = dep is None
    if own:
        dep = deploy.build(cfg, run.seed, dev)
    try:
        bsz, staged = int(mix["batch"]), mix["reference"] == "staged"
        pool = corpus.queries(cfg, dep.topics, bsz * int(mix["pool_batches"]), run.seed)
        batches = [pool[s : s + bsz] for s in range(0, len(pool), bsz)]
        control = run.control
        sample = _reservoir(run, staged)
        if control and control["kind"] == "reference":
            for j, b in enumerate(batches):  # the reference answers the pool itself
                _offer(sample, staged, j, [None] * len(b))
            out = {"e2e": {}, "attempted": 0, "failed": 0, "memory_peak_bytes": 0}
            return dict(out, numbers=_judge(run, dep, batches, sample.items, control["precision"]))
        index = _serve(dep, mix, dev, control)
        params = SearchParameters(**mix["search"])
        from nextplaid_tpu_torch.index import search_batch_async

        for b in batches:  # warm-up: every batch the window sends
            p = search_batch_async(index, b, params)
            p.result()
            if (p.shapes is not None) != staged and not control:
                raise RuntimeError(f"the route did not take the {mix['reference']} path")
        _sync(dev)
        deploy.settle()
        setup_s = time.perf_counter() - run.t0
        window = int(mix["window"])
        records, t_end = closed_loop(
            index, batches, params, window, run.seconds,
            keep=lambda j, res: _offer(sample, staged, j, res),
        )
        read = sum(bsz for r in records if r[4] <= t_end)
        out = {
            "e2e": {"qps": read / run.seconds, "setup_s": setup_s},
            "attempted": bsz * len(records),
            "failed": 0,
        }
        if run.trace:
            out.update(_traced(run, index, batches, params, records, dep, staged, read // bsz))
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        del index
        deploy.release(dev)
        out["numbers"] = _judge(run, dep, batches, sample.items, None)
        return out
    finally:
        if own:
            dep.close()


def _traced(run, index, batches, params, records, dep, staged, window_batches) -> dict:
    mix = run.mix
    trace = DeviceTrace()
    trace.start()
    seg, _ = closed_loop(index, batches, params, int(mix["window"]), float(mix["trace_seconds"]), label=True)
    trace.stop()
    grid = None
    if index.token_grid is not None:
        grid = "int8" if index.token_scales is not None else "bf16"
    ops = maxsim_ops(int(mix["batch"]) * int(run.config["query_tokens"]), dep.tokens, int(run.config["dim"]))
    ctx = {
        "dispatch_s": [r[2] - r[1] for r in records],
        "window_s": run.seconds,
        "window_batches": window_batches,
        "trace": trace.summary(),
        "trace_batches": len(seg),
        "ops_per_batch": ops,
        "grid_dtype": grid,
        "on_card": index.device.type == "cuda",
        "marks": stage_marks(index, batches, params, int(mix.get("mark_batches", 0))) if staged else [],
    }
    return {"trace": ctx["trace"], "ctx": ctx}


def _reservoir(run, staged: bool) -> Reservoir:
    """What is compared: a sample drawn from the seed of the answers read,
    whole batches on the staged route (the reference needs the batch's
    pool), single queries on the exact ones."""
    check = run.mix["check"]
    k = int(check["batches"]) if staged else int(check["queries"])
    return Reservoir(k, corpus.sub_seed(run.seed, "check"))


def _answer(r) -> tuple:
    return None if r is None else (list(r.passage_ids), list(r.scores))


def _offer(sample: Reservoir, staged: bool, j: int, res) -> None:
    if staged:
        sample.offer(1, lambda i: (j, [_answer(r) for r in res]))
    else:
        sample.offer(len(res), lambda i: (j, i, _answer(res[i])))


def _judge(run, dep, batches, sample, precision) -> Dict[str, float]:
    """The sample's answers against the reference; with `precision`, the
    reference at that precision answers in the program's place."""
    mix, dev = run.mix, run.device
    files = plaid.IndexFiles(dep.path, dev)
    ivf = files.ivf()
    nb = len(batches)
    staged = mix["reference"] == "staged"
    search = dict(mix["search"])
    if staged:
        qb = [batches[j % nb] for j, _ in sample]
        answers = [a for _, a in sample]
    else:
        qb = [[batches[j % nb][r] for j, r, _ in sample]]
        answers = [[a for _, _, a in sample]]
    if precision is not None:
        answers = judge.reference_answers(files, ivf, qb, search, precision, staged)
    if staged:
        numbers = judge.check_staged(files, ivf, qb, answers, search)
    else:
        numbers = judge.check_exact(files, qb[0], answers[0], int(search["top_k"]))
    numbers.update(judge.build_check(files, run.config, run.seed, dep.lens, ivf, dev))
    return numbers


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
