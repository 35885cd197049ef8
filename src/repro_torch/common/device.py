"""Where the port's entry points run: the GPU unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike, who: str) -> torch.device:
    """``None`` means ``cuda``; a CUDA device gets its index filled in.

    Raises if a CUDA device is asked for (or defaulted to) and none is
    present: the entry points never drop to the CPU on their own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who} runs on the GPU and no CUDA device is available; "
                "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
