"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``cuda``, and with no CUDA present that raises
instead of carrying on on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> the current CUDA device (raises when CUDA is
    unavailable); an explicit device is taken as given, and an explicit
    CUDA device is checked the same way."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ray_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain "
                "versions on the CPU")
        if dev.index is None:   # name the device tensors report
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
