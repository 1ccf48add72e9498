"""Real-data eval assets for the port: from an empty machine to BEIR metrics
on the card, and an offline dry run of every step of that path but the
download.

Online (the default):
  python scripts/fetch_torch_eval_assets.py --dataset scifact \\
      --model lightonai/GTE-ModernColBERT-v1 [--assets-dir DIR] [--device cuda]
  1. The BEIR zip `<BEIR_BASE>/<dataset>.zip`, downloaded into --assets-dir
     and checked against its md5 (DATASET_MD5), then unpacked; a zip already
     at `<assets-dir>/<dataset>.zip` is not downloaded again, and a dataset
     already unpacked (`<assets-dir>/<dataset>/corpus.jsonl`) is used as it
     is.
  2. The model: --model as a directory when it is one; otherwise a snapshot
     of that Hugging Face id through `huggingface_hub` (revision recorded),
     which must be installed.
  3. scripts/eval_torch_beir.py --mode api --device <device> over them, as
     a child process; its metrics JSON, with the provenance (dataset url and
     md5, model, revision) added.
  So a local zip in --assets-dir and a model directory run it with no
  download at all.

Offline (--offline):
  python scripts/fetch_torch_eval_assets.py --offline [--device cpu] [--out FILE]
  1. The mini BEIR dataset in the real on-disk format (tests/fixtures/mini_beir:
     corpus.jsonl, queries.jsonl, qrels/test.tsv; each query an 8-word excerpt
     of its one relevant document), regenerated when it is missing.
  2. A checkpoint in the real Hugging Face format, written fresh with random
     weights: torch-named (`bert.*`) model.safetensors, the `1_Dense/`
     projection, config.json, a WordPiece tokenizer.json and onnx_config.json,
     loaded by the port's `Colbert` through the path real checkpoints take.
  3. A tokenizer probe with hand-computed ids.
  4. scripts/eval_torch_beir.py's local and api modes over them, each gated at
     NDCG@10 >= 0.85 and recall@10 >= 0.95 (a non-zero exit below either).

Everything runs on --device (default cuda, which fails without a card).
Counterpart of scripts/fetch_eval_assets.py, with the same flags plus
--device. Prints one JSON object, also written to --out.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURE_DIR = REPO / "tests" / "fixtures" / "mini_beir"
MIN_NDCG10 = 0.85
MIN_RECALL10 = 0.95

BEIR_BASE = (
    "https://public.ukp.informatik.tu-darmstadt.de/thakur/BEIR/datasets"
)
# md5 checksums as published by the BEIR maintainers (beir.util downloads
# verify the same values). Extend per dataset as needed.
DATASET_MD5 = {
    "scifact": "5f7d1de60b170fc8027bb7898e2efca1",
}

# --------------------------------------------------------------------------
# Offline fixtures
# --------------------------------------------------------------------------

VOCAB_WORDS = 993  # + 7 specials = 1000
SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[Q]", "[D]"]


def fixture_vocab():
    words = [f"w{i:03d}" for i in range(VOCAB_WORDS)]
    return {w: i for i, w in enumerate(SPECIALS + words)}


def make_fixture_tokenizer():
    from tokenizers import Tokenizer
    from tokenizers.models import WordPiece
    from tokenizers.normalizers import Lowercase
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.processors import TemplateProcessing

    vocab = fixture_vocab()
    tok = Tokenizer(WordPiece(vocab, unk_token="[UNK]"))
    tok.normalizer = Lowercase()
    tok.pre_tokenizer = Whitespace()
    tok.post_processor = TemplateProcessing(
        single="[CLS] $A [SEP]",
        special_tokens=[("[CLS]", vocab["[CLS]"]), ("[SEP]", vocab["[SEP]"])],
    )
    return tok, vocab


def generate_fixture_dataset(out_dir: Path, n_docs=60, n_queries=12, seed=7):
    """Deterministic mini BEIR dataset in the real on-disk format. Queries
    are 8-word excerpts of their (only) relevant document."""
    rng = np.random.default_rng(seed)
    words = [w for w in fixture_vocab() if not w.startswith("[")]
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "qrels").mkdir(exist_ok=True)
    docs = []
    with open(out_dir / "corpus.jsonl", "w") as f:
        for i in range(n_docs):
            body = " ".join(rng.choice(words, size=40).tolist())
            docs.append(body)
            f.write(json.dumps({
                "_id": f"doc{i}",
                "title": f"Fixture document {i}",
                "text": body,
            }) + "\n")
    q_src = rng.choice(n_docs, size=n_queries, replace=False)
    with open(out_dir / "queries.jsonl", "w") as f, open(
        out_dir / "qrels" / "test.tsv", "w"
    ) as q:
        q.write("query-id\tcorpus-id\tscore\n")
        for j, s in enumerate(q_src):
            toks = docs[s].split()
            start = int(rng.integers(0, len(toks) - 8))
            f.write(json.dumps({
                "_id": f"q{j}",
                "text": " ".join(toks[start : start + 8]),
            }) + "\n")
            q.write(f"q{j}\tdoc{s}\t1\n")


def write_fixture_checkpoint(model_dir: Path, seed=0):
    """A real-FORMAT HF ColBERT checkpoint with random weights: torch-named
    safetensors (with the `bert.` prefix real BERT exports carry, so
    _strip_prefix runs), sentence-transformers `1_Dense/` projection,
    config.json, tokenizer.json, onnx_config.json."""
    from safetensors.numpy import save_file

    model_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    vocab = fixture_vocab()
    hidden, layers, heads, inter, dim = 64, 2, 2, 128, 32
    cfg = {
        "model_type": "bert",
        "vocab_size": len(vocab),
        "hidden_size": hidden,
        "num_hidden_layers": layers,
        "num_attention_heads": heads,
        "intermediate_size": inter,
        "max_position_embeddings": 128,
        "type_vocab_size": 2,
        "layer_norm_eps": 1e-12,
        "hidden_act": "gelu",
    }
    (model_dir / "config.json").write_text(json.dumps(cfg, indent=2))

    def w(*shape, scale=0.05):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    # Word embeddings dominate position/type (x25 scale): an excerpt query
    # must match its source doc's tokens wherever they sit in the doc —
    # with equal scales the positional component breaks MaxSim matching
    # and the dry-run's quality assertion loses its teeth.
    sd = {
        "bert.embeddings.word_embeddings.weight": w(len(vocab), hidden),
        "bert.embeddings.position_embeddings.weight": w(
            128, hidden, scale=0.002
        ),
        "bert.embeddings.token_type_embeddings.weight": w(
            2, hidden, scale=0.002
        ),
        "bert.embeddings.LayerNorm.weight": np.ones(hidden, np.float32),
        "bert.embeddings.LayerNorm.bias": np.zeros(hidden, np.float32),
    }
    for i in range(layers):
        b = f"bert.encoder.layer.{i}."
        sd.update({
            b + "attention.self.query.weight": w(hidden, hidden),
            b + "attention.self.query.bias": w(hidden),
            b + "attention.self.key.weight": w(hidden, hidden),
            b + "attention.self.key.bias": w(hidden),
            b + "attention.self.value.weight": w(hidden, hidden),
            b + "attention.self.value.bias": w(hidden),
            b + "attention.output.dense.weight": w(hidden, hidden),
            b + "attention.output.dense.bias": w(hidden),
            b + "attention.output.LayerNorm.weight": np.ones(
                hidden, np.float32
            ),
            b + "attention.output.LayerNorm.bias": np.zeros(
                hidden, np.float32
            ),
            b + "intermediate.dense.weight": w(inter, hidden),
            b + "intermediate.dense.bias": w(inter),
            b + "output.dense.weight": w(hidden, inter),
            b + "output.dense.bias": w(hidden),
            b + "output.LayerNorm.weight": np.ones(hidden, np.float32),
            b + "output.LayerNorm.bias": np.zeros(hidden, np.float32),
        })
    save_file(sd, str(model_dir / "model.safetensors"))
    (model_dir / "1_Dense").mkdir(exist_ok=True)
    save_file(
        {"linear.weight": w(dim, hidden)},
        str(model_dir / "1_Dense" / "model.safetensors"),
    )
    tok, vocab = make_fixture_tokenizer()
    tok.save(str(model_dir / "tokenizer.json"))
    (model_dir / "onnx_config.json").write_text(json.dumps({
        "query_prefix": "[Q] ",
        "document_prefix": "[D] ",
        "query_length": 24,
        "document_length": 48,
        "do_query_expansion": True,
        "embedding_dim": dim,
        "uses_token_type_ids": True,
        "mask_token_id": vocab["[MASK]"],
        "pad_token_id": vocab["[PAD]"],
        "skiplist_words": [],
        "model_name": "fixture-mini-colbert",
    }, indent=2))
    return model_dir


def tokenizer_parity_probe(encoder) -> None:
    """Hand-computed expectations through the real `_prepare` path: prefix
    after CLS, SEP kept, MASK expansion to query_length. Raises on a
    mismatch."""
    vocab = fixture_vocab()
    ids, mask, _, _ = encoder._prepare(["w001 w002"], is_query=True)
    row = ids[0].tolist()
    want = [vocab[t] for t in ("[CLS]", "[Q]", "w001", "w002", "[SEP]")]
    # Query expansion pads with MASK to query_length, attention all-ones.
    want += [vocab["[MASK]"]] * (encoder.config.query_length - len(want))
    if row != want or not mask[0].all():
        raise AssertionError(f"query ids {row}, expected {want}")
    ids_d, mask_d, _, _ = encoder._prepare(["w003 w004"], is_query=False)
    row_d = ids_d[0].tolist()
    n_real = int(mask_d[0].sum())
    if row_d[1] != vocab["[D]"] or row_d[n_real - 1] != vocab["[SEP]"]:
        raise AssertionError(f"document ids {row_d}")
    print("tokenizer parity probe: OK", flush=True)


def run_offline(device=None) -> dict:
    """The dry run on `device`; raises when a mode misses a gate."""
    from eval_torch_beir import evaluate, kernel_launches, load_beir, run_api, run_local

    from nextplaid_tpu_torch.encoder import Colbert

    data_dir = FIXTURE_DIR
    if not (data_dir / "corpus.jsonl").exists():
        generate_fixture_dataset(data_dir)
        print(f"generated fixture dataset at {data_dir}", flush=True)

    documents, queries, qrels = load_beir(str(data_dir))
    results = {}
    with tempfile.TemporaryDirectory(prefix="fixture_ckpt_") as tmp:
        ckpt = Path(tmp) / "mini-colbert"
        write_fixture_checkpoint(ckpt)
        t0 = time.perf_counter()
        encoder = Colbert(str(ckpt), batch_size=16, device=device)  # the real loading path
        load_s = time.perf_counter() - t0
        print(f"checkpoint loaded via HF path in {load_s:.1f}s", flush=True)
        tokenizer_parity_probe(encoder)
        for mode, runner in (("local", run_local), ("api", run_api)):
            run, timings = runner(documents, queries, qrels, encoder, 10, 4, device=device)
            metrics = evaluate(qrels, run, ("map", "ndcg@10", "recall@10"))
            results[mode] = {"metrics": metrics, "timings": timings}
            print(f"{mode}: {metrics}", flush=True)
            if metrics["ndcg@10"] < MIN_NDCG10 or metrics["recall@10"] < MIN_RECALL10:
                raise RuntimeError(
                    f"offline dry-run quality regression ({mode}): {metrics}; gates "
                    f"ndcg@10 >= {MIN_NDCG10}, recall@10 >= {MIN_RECALL10}")
    return {
        "what": "offline dry-run of the real-data eval path: real-format fixture dataset + "
        "real-format HF checkpoint (bert.* safetensors, 1_Dense projection, WordPiece "
        "tokenizer.json) loaded by the port's Colbert, tokenizer-parity probe, "
        "eval_torch_beir local+api",
        "mode": "offline",
        "device": str(device),
        "dataset": str(data_dir.relative_to(REPO)),
        "checkpoint_format": [
            "config.json", "model.safetensors (bert.* torch names)",
            "1_Dense/model.safetensors", "tokenizer.json", "onnx_config.json",
        ],
        "results": results,
        "kernel_launches": kernel_launches(),
    }


# --------------------------------------------------------------------------
# Online path
# --------------------------------------------------------------------------


def _download(url: str, dest: Path, md5: str | None) -> None:
    """`url` into `dest` through `dest.with_suffix(".part")`, checked
    against `md5` when one is given: on a mismatch the partial file is
    removed and RuntimeError raised, so `dest` appears only when whole."""
    import urllib.request

    print(f"downloading {url}", flush=True)
    tmp = dest.with_suffix(".part")
    urllib.request.urlretrieve(url, tmp)
    if md5:
        h = hashlib.md5()
        with open(tmp, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if h.hexdigest() != md5:
            tmp.unlink()
            raise RuntimeError(
                f"checksum mismatch for {url}: got {h.hexdigest()}, expected {md5}"
            )
    os.replace(tmp, dest)


def run_online(args, device) -> dict:
    """Fetch what is missing of the dataset and the model, then run
    scripts/eval_torch_beir.py --mode api on `device` as a child process.
    Returns its metrics record with the provenance added."""
    import subprocess
    import zipfile

    assets = Path(args.assets_dir)
    assets.mkdir(parents=True, exist_ok=True)
    data_dir = assets / args.dataset
    url = f"{BEIR_BASE}/{args.dataset}.zip"
    if not (data_dir / "corpus.jsonl").exists():
        zip_path = assets / f"{args.dataset}.zip"
        if not zip_path.exists():
            _download(url, zip_path, DATASET_MD5.get(args.dataset))
        with zipfile.ZipFile(zip_path) as z:
            z.extractall(assets)
    model_dir = args.model
    revision = None
    if not os.path.isdir(model_dir):
        try:
            from huggingface_hub import snapshot_download
        except ImportError as e:
            raise RuntimeError(
                f"--model {args.model!r} is not a directory, and fetching it from the hub "
                "needs huggingface_hub, which is not installed") from e
        model_dir = snapshot_download(args.model)
        revision = Path(model_dir).name  # the snapshot's hash directory
    with tempfile.TemporaryDirectory(prefix="beir_metrics_") as tmp:
        out = Path(tmp) / "beir_metrics.json"
        subprocess.run([
            sys.executable, str(REPO / "scripts" / "eval_torch_beir.py"),
            "--data-dir", str(data_dir), "--model", str(model_dir),
            "--mode", "api", "--device", str(device), "--out", str(out),
        ], check=True)
        rec = json.loads(out.read_text())
    rec["provenance"] = {
        "dataset_url": url,
        "dataset_md5": DATASET_MD5.get(args.dataset),
        "model": args.model,
        "model_revision": revision,
    }
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--offline", action="store_true",
                    help="dry-run the full path on the committed fixtures")
    ap.add_argument("--dataset", default="scifact")
    ap.add_argument("--model", default="lightonai/GTE-ModernColBERT-v1")
    ap.add_argument("--assets-dir", default="/tmp/eval_assets")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda, which fails without a card)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from eval_torch_beir import reset_kernel_launches

    from nextplaid_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.offline:
        reset_kernel_launches()
        rec = run_offline(device)
    else:
        rec = run_online(args, device)
    line = json.dumps(rec)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
