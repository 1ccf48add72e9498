"""Driver kind `closed_rerank_xlmr`: `closed_rerank`'s closed loop for
jina-colbert-v2, the rotary XLM-RoBERTa family. One in-process caller
reranks, one request in flight: `Colbert.encode_queries` on its query,
`Colbert.encode_documents` on its documents, `ops.maxsim.rerank_scores`,
then the ranking, as `/rerank_with_encoding` does. The encoder is
`Colbert(model_dir=...)` over a model directory written at set-up from the
seed (plaidbench/xlmr_corpus.py); the requests are `encoder_corpus`'s,
cycling a pool of distinct ones drawn from the seed.

Mix keys, window, `correct` and the traced stretch are `closed_rerank`'s
(its docstring): this module imports its `judge` and `_traced`, and
`closed_batch`'s `Reservoir`. The reference is benchmark/reference/
jina_colbert.py in float32 on the card; the work of a request is
plaidbench/xlmr_work.py's, which the traced run hands the readers as
`window_ops`.

Controls, for calibration only (`run.control`): {"kind": "quantized"},
the program's int8 mode; {"kind": "cross_document"}, each packed forward's
attention over all of its tokens as one document (`cu_seqlens` [0, N]),
the fault a packed layout can have. Positions still restart per document.
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
from drivers.closed_rerank import _sync, _traced, judge
from plaidbench import corpus, deploy, encoder_corpus, xlmr_corpus, xlmr_work
from reference.jina_colbert import JinaColbertReference


def drive(run, dep=None) -> dict:
    if run.device.type != "cuda":
        raise RuntimeError("closed_rerank_xlmr runs on a CUDA card: its encoder and reference "
                           "are sized for 8,192-token documents")
    return run_rerank(run)


def run_rerank(run) -> dict:
    """The cell's run on `run.device` (the CPU only at test sizes)."""
    from nextplaid_tpu_torch.encoder import Colbert
    from nextplaid_tpu_torch.ops.maxsim import rerank_scores
    from nextplaid_tpu_torch.utils import trace

    cfg, mix, dev, control = run.config, run.mix, run.device, run.control or {}
    root = Path(tempfile.mkdtemp(prefix="plaidbench-"))
    try:
        model_dir = xlmr_corpus.write_model_dir(cfg, run.seed, dev, root)
        pool = encoder_corpus.requests(cfg, mix, run.seed)
        ops = [xlmr_work.request_ops(len(r.query_row), [len(d) for d in r.doc_rows], cfg)
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

        with _planted(control):
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
        res["numbers"] = judge(JinaColbertReference.from_dir(model_dir, dev), pool, sample.items)
        return res
    finally:
        shutil.rmtree(root, ignore_errors=True)


@contextlib.contextmanager
def _planted(control):
    """The calibration's planted fault (module docstring), undone after;
    the int8 control is the encoder's own mode."""
    from nextplaid_tpu_torch.encoder.model import ColbertModel

    forward = ColbertModel.forward_packed
    if control.get("kind") == "cross_document":
        ColbertModel.forward_packed = lambda self, ids, pos, cu: forward(self, ids, pos, cu[[0, -1]])
    try:
        yield
    finally:
        ColbertModel.forward_packed = forward
