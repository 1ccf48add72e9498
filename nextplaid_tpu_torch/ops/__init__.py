"""Device compute ops (PyTorch, and a CUDA kernel): codec, k-means, MaxSim."""

from nextplaid_tpu_torch.ops.codec import (  # noqa: F401
    assign_codes,
    bucketize,
    compute_residuals,
    decompress_residuals,
    pack_buckets,
    quantize_residuals,
    train_codec_buckets,
    unpack_buckets,
)
from nextplaid_tpu_torch.ops.kmeans import KMeansConfig, compute_kmeans, lloyd  # noqa: F401
from nextplaid_tpu_torch.ops.maxsim import maxsim_batch, maxsim_pairwise, maxsim_score  # noqa: F401
