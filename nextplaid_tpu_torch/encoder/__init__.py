"""ColBERT text encoding on the card (next-plaid-onnx's `Colbert`, with a
`torch.nn` forward in place of ONNX Runtime)."""

from nextplaid_tpu_torch.encoder.colbert import Colbert  # noqa: F401
from nextplaid_tpu_torch.encoder.config import ColbertConfig  # noqa: F401
from nextplaid_tpu_torch.encoder.model import (  # noqa: F401
    BackboneConfig,
    ColbertModel,
    init_random_params,
    load_params,
)
from nextplaid_tpu_torch.encoder.pooling import (  # noqa: F401
    pool_document_embeddings,
    pool_embeddings_hierarchical,
)
