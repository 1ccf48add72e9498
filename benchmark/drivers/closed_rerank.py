"""Driver kind `closed_rerank`: one in-process caller reranks with the
ColBERT encoder, one request in flight, in a closed loop. A request does
what `/rerank_with_encoding` does: `Colbert.encode_queries` on its query,
`Colbert.encode_documents` on its documents, and the rerank handlers'
scoring, `ops.maxsim.rerank_scores` (exact f32 MaxSim, one readback), then
the ranking. The encoder is `Colbert(model_dir=...)` over a model
directory written at set-up from the seed (plaidbench/encoder_corpus.py);
the requests cycle a pool of distinct ones drawn from the seed.

Mix keys: `documents_per_request`, `query_words`, `doclens` (tokens a
document, [CLS], prefix and [SEP] included), `pool_requests`,
`pool_factor`, `batch_size` (the encoder's), `trace_seconds` (the
profiled stretch of the traced run), `check` (`requests`: how many of the
window's requests are recomputed) and `limits`.

The window counts the requests whose scores were read inside it, over its
seconds. Nothing compiles there: every request of the pool runs once
before, and that counts as set-up.

`correct`: a reservoir of the window's requests, drawn from the seed, is
recomputed by the plain float32 reference (benchmark/reference/
moderncolbert.py) on the card, one document at a time from the token rows
the benchmark itself formed:
- `missing`: outputs of another shape than the reference's (a query's
  query_length tokens; a document's tokens less the skiplist's), or not
  finite, and scores not finite. Limit 0.
- `emb_cos_gap_mean`, `emb_cos_gap_max`: 1 - cosine between the
  program's and the reference's embedding of each token compared.
- `score_err_mean`: |served score - the reference's MaxSim of the
  reference's embeddings|, over the documents compared.
Controls, for calibration only (`run.control`): {"kind": "quantized"},
the program's int8 mode; {"kind": "all_global"}, every layer attending to
its whole document; {"kind": "rope_unrestarted"}, RoPE positions counted
over the whole packed forward.
"""

from __future__ import annotations

import contextlib
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from drivers.closed_batch import Reservoir
from plaidbench import corpus, deploy, encoder_corpus, encoder_work
from plaidbench.profiling import DeviceTrace
from reference.moderncolbert import ModernColbertReference, maxsim


def drive(run, dep=None) -> dict:
    if run.device.type != "cuda":
        raise RuntimeError("closed_rerank runs on a CUDA card: its encoder and reference are "
                           "sized for 8,192-token documents")
    return run_rerank(run)


def run_rerank(run) -> dict:
    """The cell's run on `run.device` (the CPU only at test sizes)."""
    from nextplaid_tpu_torch.encoder import Colbert
    from nextplaid_tpu_torch.ops.maxsim import rerank_scores
    from nextplaid_tpu_torch.utils import trace

    cfg, mix, dev, control = run.config, run.mix, run.device, run.control or {}
    root = Path(tempfile.mkdtemp(prefix="plaidbench-"))
    try:
        model_dir = encoder_corpus.write_model_dir(cfg, run.seed, dev, root)
        pool = encoder_corpus.requests(cfg, mix, run.seed)
        ops = [encoder_work.request_ops(len(r.query_row), [len(d) for d in r.doc_rows], cfg)
               for r in pool]
        enc = Colbert(str(model_dir), batch_size=int(mix["batch_size"]),
                      quantized=bool(cfg["quantized"]) or control.get("kind") == "quantized",
                      device=dev)
        if enc.config.document_length != int(cfg["document_length"]):
            raise RuntimeError("the encoder did not take the configuration's document_length")
        pool_factor = int(mix["pool_factor"])

        def serve(req):
            with trace.batch_scope():
                q = enc.encode_queries([req.query])[0]
                docs = enc.encode_documents(req.documents, pool_factor=pool_factor)
                scores = rerank_scores(q, docs, dev)
            return q, docs, scores, np.argsort(-scores, kind="stable")

        with _planted(enc, control):
            for req in pool:  # warm-up: every request the window sends
                serve(req)
            _sync(dev)
            deploy.settle()
            setup_s = time.perf_counter() - run.t0
            sample = Reservoir(int(mix["check"]["requests"]), corpus.sub_seed(run.seed, "check"))
            n = read = 0
            window_ops = 0.0
            t_end = time.perf_counter() + run.seconds
            while time.perf_counter() < t_end:
                j = n % len(pool)
                out = serve(pool[j])
                n += 1
                if time.perf_counter() <= t_end:
                    read += 1
                    window_ops += ops[j]
                sample.offer(1, lambda i: (j, out))
            res = {"e2e": {"qps": read / run.seconds, "setup_s": setup_s},
                   "attempted": n, "failed": 0}
            if run.trace:
                res.update(_traced(run, serve, pool, window_ops, trace))
            res["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        del enc
        deploy.release(dev)
        res["numbers"] = judge(ModernColbertReference.from_dir(model_dir, dev), pool, sample.items)
        return res
    finally:
        shutil.rmtree(root, ignore_errors=True)


@contextlib.contextmanager
def _planted(enc, control):
    """The calibration's planted faults (module docstring), undone after."""
    import nextplaid_tpu_torch.encoder.colbert as colbert

    kind = control.get("kind")
    layers = [getattr(enc.model.backbone, f"layer_{i}")
              for i in range(enc.backbone_config.num_hidden_layers)]
    windows = [layer.attn.half_window for layer in layers]
    positions = colbert.packed_positions
    if kind == "all_global":
        for layer in layers:
            layer.attn.half_window = None
    elif kind == "rope_unrestarted":
        colbert.packed_positions = lambda lens: np.arange(int(np.sum(lens)), dtype=np.int64)
    try:
        yield
    finally:
        colbert.packed_positions = positions
        for layer, w in zip(layers, windows):
            layer.attn.half_window = w


def _traced(run, serve, pool, window_ops, trace) -> dict:
    trace.clear()
    dt = DeviceTrace()
    dt.start()
    n = 0
    t_end = time.perf_counter() + float(run.mix["trace_seconds"])
    while time.perf_counter() < t_end:
        serve(pool[n % len(pool)])
        n += 1
    dt.stop()
    ctx = {
        "on_card": run.device.type == "cuda",
        "trace": dt.summary(),
        "trace_requests": n,
        "config": run.config,
        "window_s": run.seconds,
        "window_ops": window_ops,
    }
    return {"trace": ctx["trace"], "ctx": ctx}


def judge(ref: ModernColbertReference, pool, sample) -> dict:
    """The sampled requests' outputs against the reference (module
    docstring)."""
    skip = torch.tensor([encoder_corpus.PERIOD, encoder_corpus.COMMA])
    gaps, errs = [], []
    missing = compared = 0
    for j, (q, docs, scores, _) in sample:
        req = pool[j]
        rq = ref.encode(req.query_row)
        compared += 1
        if not _same(q, rq):
            missing += 1
        else:
            gaps.append(_cos_gap(q, rq))
        if len(docs) != len(req.doc_rows) or len(scores) != len(req.doc_rows):
            missing += len(req.doc_rows)
            continue
        for row, d, s in zip(req.doc_rows, docs, scores):
            keep = ~torch.isin(torch.tensor(row), skip).to(ref.device)
            rd = ref.encode(row)[keep]
            compared += 1
            if not _same(d, rd) or not np.isfinite(s):
                missing += 1
                continue
            gaps.append(_cos_gap(d, rd))
            errs.append(abs(float(s) - maxsim(rq, rd)))
    gap = torch.cat(gaps) if gaps else torch.ones(1, dtype=torch.float64)
    return {
        "missing": float(missing),
        "emb_cos_gap_mean": float(gap.mean()),
        "emb_cos_gap_max": float(gap.max()),
        "score_err_mean": float(np.mean(errs)) if errs else float("inf"),
        "score_err_max": float(np.max(errs)) if errs else float("inf"),
        "compared": float(compared),
    }


def _same(got: np.ndarray, want: torch.Tensor) -> bool:
    return tuple(got.shape) == tuple(want.shape) and bool(np.isfinite(got).all())


def _cos_gap(got: np.ndarray, want: torch.Tensor) -> torch.Tensor:
    a = torch.from_numpy(np.asarray(got)).to(want.device, torch.float64)
    b = want.double()
    return (1.0 - (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)).clamp_min(1e-30)).cpu()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
