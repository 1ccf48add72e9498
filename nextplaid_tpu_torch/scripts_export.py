"""Convert a PyLate / sentence-transformers ColBERT checkpoint into a
model directory the port's `Colbert` (and the JAX package's) loads.

Counterpart of next-plaid's `pylate-onnx-export` tool
(next-plaid-onnx/python/src/colbert_export): instead of tracing to ONNX,
this normalizes the directory layout the loaders read — HF `config.json` +
weights, `tokenizer.json`, `1_Dense/` projection — and writes the behavior
config (`onnx_config.json`, next-plaid's export schema, so either stack can
consume the directory). The files written are byte-equal to
`nextplaid_tpu.scripts_export`'s.

Usage:
  python -m nextplaid_tpu_torch.scripts_export SRC_DIR DST_DIR \
      [--query-prefix "[Q] "] [--document-prefix "[D] "] \
      [--query-length 48] [--document-length 300] [--dim 128] \
      [--quantize] [--device cpu]

SRC_DIR must be a local checkout of the model (no network access is
performed). Weights are converted torch->safetensors when needed. The
export's smoke encode runs on --device ("cuda" by default).
"""

import argparse
import json
import shutil
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--query-prefix", default="[Q] ")
    ap.add_argument("--document-prefix", default="[D] ")
    ap.add_argument("--query-length", type=int, default=48)
    ap.add_argument("--document-length", type=int, default=300)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--no-query-expansion", action="store_true")
    ap.add_argument(
        "--quantize", action="store_true",
        help="also write model.int8.safetensors: int8 weights + per-"
        "column scales for the INT8 serving mode (next-plaid "
        "colbert_export/quantize.py parity; load with "
        "Colbert(dst, quantized=True))",
    )
    ap.add_argument(
        "--push-to-hub", metavar="REPO_ID", default=None,
        help="upload the exported directory to a HF hub repo (next-plaid "
        "colbert_export/hub.py parity; needs network + HF_TOKEN)",
    )
    ap.add_argument(
        "--device", default=None,
        help="torch device of the smoke encodes (default cuda)",
    )
    args = ap.parse_args()

    src, dst = Path(args.src), Path(args.dst)
    dst.mkdir(parents=True, exist_ok=True)

    for name in ("config.json", "tokenizer.json", "tokenizer_config.json",
                 "special_tokens_map.json", "vocab.txt"):
        if (src / name).exists():
            shutil.copy2(src / name, dst / name)

    # Weights: prefer safetensors; convert a torch bin if that's all we have.
    if (src / "model.safetensors").exists():
        shutil.copy2(src / "model.safetensors", dst / "model.safetensors")
    elif (src / "pytorch_model.bin").exists():
        import torch
        from safetensors.numpy import save_file

        sd = torch.load(
            src / "pytorch_model.bin", map_location="cpu", weights_only=True
        )
        save_file(
            {k: v.float().numpy() for k, v in sd.items()},
            str(dst / "model.safetensors"),
        )
    else:
        sys.exit(f"No weights found in {src}")

    # Projection head (sentence-transformers module layout).
    dense_src = src / "1_Dense"
    if dense_src.exists():
        (dst / "1_Dense").mkdir(exist_ok=True)
        for f in dense_src.iterdir():
            if f.suffix in (".safetensors", ".bin", ".json"):
                shutil.copy2(f, dst / "1_Dense" / f.name)

    # Behavior config — next-plaid's onnx_config.json schema (lib.rs:555-697).
    # PyLate stores some of these in config_sentence_transformers.json.
    st_cfg = {}
    st_path = src / "config_sentence_transformers.json"
    if st_path.exists():
        st_cfg = json.loads(st_path.read_text())
    hf_cfg = json.loads((src / "config.json").read_text())
    model_type = hf_cfg.get("model_type", "bert")
    config = {
        "model_type": "ColBERT",
        "model_name": src.name,
        "query_prefix": st_cfg.get("query_prefix", args.query_prefix),
        "document_prefix": st_cfg.get("document_prefix", args.document_prefix),
        "query_length": st_cfg.get("query_length", args.query_length),
        "document_length": st_cfg.get("document_length", args.document_length),
        "do_query_expansion": not args.no_query_expansion,
        "embedding_dim": args.dim,
        "uses_token_type_ids": model_type not in ("modernbert",),
        "mask_token_id": hf_cfg.get("mask_token_id", 103),
        "pad_token_id": hf_cfg.get("pad_token_id", 0),
        "skiplist_words": st_cfg.get(
            "skiplist_words",
            list("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"),
        ),
        "do_lower_case": st_cfg.get("do_lower_case", False),
    }
    (dst / "onnx_config.json").write_text(json.dumps(config, indent=2))

    # Smoke-load through the real loader.
    from nextplaid_tpu_torch.encoder import Colbert

    enc = Colbert(str(dst), device=args.device)
    out = enc.encode_documents(["smoke test document"])
    print(
        f"exported to {dst}: backbone={model_type}, "
        f"encoded shape={out[0].shape}"
    )

    if args.quantize:
        # INT8 quantization step (next-plaid quantize.py: onnxruntime
        # quantize_dynamic). Kernels become int8 + per-output-column f32
        # scales; the serving path re-derives them at load
        # (Colbert(quantized=True) -> quantize_dense_params), so the
        # artifact is a verification + distribution convenience: it pins
        # the exact int8 weights this export produced. Quantized from the
        # checkpoint's float32 weights, with the Flax tree's names
        # ("params." + the state_dict name), as the JAX package writes it.
        import numpy as np
        from safetensors.numpy import save_file

        from nextplaid_tpu_torch.encoder.model import (
            BackboneConfig,
            load_params,
            quantize_dense_params,
        )

        params = load_params(dst, BackboneConfig.from_model_dir(dst))
        qparams = quantize_dense_params(params)
        flat = {f"params.{k}": np.asarray(v.cpu().numpy()) for k, v in qparams.items()}
        save_file(flat, str(dst / "model.int8.safetensors"))
        qenc = Colbert(str(dst), quantized=True, device=args.device)
        qout = qenc.encode_documents(["smoke test document"])
        a, b = out[0], qout[0]
        cos = float(
            np.min(
                np.sum(a * b, -1)
                / (
                    np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
                    + 1e-9
                )
            )
        )
        print(f"int8 quantized: min per-token cosine vs full precision "
              f"{cos:.4f}")
        assert cos >= 0.99, cos

    if args.push_to_hub:
        # Hub upload (next-plaid colbert_export/hub.py push_to_hub): create
        # the repo if needed and upload the whole export directory. Fails
        # with an actionable message in offline environments.
        try:
            from huggingface_hub import HfApi

            api = HfApi()
            api.create_repo(args.push_to_hub, exist_ok=True)
            api.upload_folder(
                folder_path=str(dst), repo_id=args.push_to_hub
            )
            print(f"pushed to hub: {args.push_to_hub}")
        except Exception as e:
            sys.exit(
                f"hub push failed (offline? missing HF_TOKEN?): {e}"
            )


if __name__ == "__main__":
    main()
