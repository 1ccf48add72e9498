"""Host-side persistence: NPY index directories, atomic writes, file locks;
the native host library (`native`), the merged-chunk cache (`merge_cache`)
and the fast-plaid converter (`convert`)."""

from nextplaid_tpu_torch.storage.npy import (  # noqa: F401
    IndexLayout,
    atomic_write_bytes,
    atomic_write_json,
    atomic_write_npy,
    file_lock,
    load_json,
    load_npy,
)
