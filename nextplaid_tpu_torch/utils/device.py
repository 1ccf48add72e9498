"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
`device` argument they take "cuda", and raise when CUDA is unavailable
rather than quietly running on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: `device`, or "cuda" when None.

    Also turns TF32 off for matmuls and convolutions: the reference sums
    per-token maxima in full f32 and its oracle runs at "highest"
    precision, so no f32 product of this package may drop to TF32.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)

