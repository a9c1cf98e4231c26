"""Device selection for the port's entry points.

Entry points run on the card. They run on the CPU only when the caller
asks for it (``device="cpu"``, as the tests do), and they never carry on
quietly on the CPU when the card is missing.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU explicitly"
        )
    return dev
