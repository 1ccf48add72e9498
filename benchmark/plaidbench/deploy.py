"""A configuration made real for one run: its corpus made on the device from
the seed and indexed by the program into a directory under the run's
temporary directory, as an on-device encoder's output would be."""

from __future__ import annotations

import gc
import shutil
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from plaidbench import corpus


@dataclass
class Deployment:
    root: Path  # the run's own directory, removed by close()
    index_dir: Path  # <root>/indices
    name: str  # the index: <index_dir>/<name>
    lens: np.ndarray
    topics: np.ndarray

    @property
    def path(self) -> str:
        return str(self.index_dir / self.name)

    @property
    def tokens(self) -> int:
        return int(self.lens.sum())

    def close(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)


def build(cfg: dict, seed: int, device: torch.device) -> Deployment:
    """Make the corpus from `seed` and build its index with the program."""
    from nextplaid_tpu_torch.index import IndexConfig, create_index_from_device

    root = Path(tempfile.mkdtemp(prefix="plaidbench-"))
    dep = Deployment(root, root / "indices", cfg["name"], corpus.doclens(cfg, seed), None)
    toks, dep.topics = corpus.corpus_device(cfg, dep.lens, seed, device)
    create_index_from_device(
        toks, dep.lens, dep.path,
        IndexConfig(nbits=int(cfg["nbits"]), seed=int(cfg["index_seed"])),
        device=device,
    )
    del toks
    release(device)
    return dep


def settle() -> None:
    """End of set-up: collect, then freeze what set-up left alive (the
    interpreter, torch, the benchmark's own state) out of the collector's
    reach, so that a full collection inside the window scans only what the
    window allocates and not the harness's heap."""
    gc.collect()
    gc.freeze()


def release(device: torch.device) -> None:
    """Hand freed blocks back, so that what follows starts clean."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
