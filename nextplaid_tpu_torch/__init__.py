"""nextplaid_tpu_torch — the PyTorch/CUDA port of nextplaid_tpu.

A multi-vector (late-interaction / ColBERT) search engine: PLAID-style index
build (k-means, 2/4-bit residual codec, IVF, next-plaid's on-disk NPY+JSON
format), exact search over a pinned bf16 or int8 token grid through
hand-written CUDA MaxSim kernels for Hopper (sm_90a), the staged PLAID
pipeline, index mutations (update, in-place device append, delete) with
the SQLite metadata and FTS5 store they keep in sync, the ColBERT
encoder (`nextplaid_tpu_torch.encoder`) that turns text into the token
embeddings all of it indexes, the REST service over all of it
(`nextplaid_tpu_torch.api`; its SDK and CLI in `nextplaid_tpu_torch.client`),
the residual-quantized centroid structure for huge K
(`nextplaid_tpu_torch.ops.rq`) and code search over a project tree
(`nextplaid_tpu_torch.codesearch`, the `cgrep` CLI).

The JAX package `nextplaid_tpu` stays beside it as the reference; this
package imports neither it nor jax. Entry points take a `device` argument
and run on "cuda" when it is not given (raising when CUDA is unavailable);
tests pass device="cpu", where every kernel runs as its plain PyTorch
version. Setting up a device turns TF32 off
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`): the reference sums per-token
maxima in full f32 and its oracle runs at "highest" precision.
"""

__version__ = "0.1.0"

from nextplaid_tpu_torch.index.config import IndexConfig, SearchParameters  # noqa: F401
from nextplaid_tpu_torch.index.container import DeviceIndex  # noqa: F401
from nextplaid_tpu_torch.index.delete import delete_with_options  # noqa: F401
from nextplaid_tpu_torch.index.update import (  # noqa: F401
    UpdateConfig,
    update_or_create,
    update_or_create_with_metadata,
)
