"""The control of the comparison: the reference with every product's
operands rounded to float8 (e4m3, one scale per tensor, the largest
magnitude mapped to 448), forward and backward: the nearest precision
below the bf16 that the configurations state, and the step that would
tempt a faster program."""

from __future__ import annotations

import torch

from portbench.reference.model import Precision

E4M3_MAX = 448.0


class FP8(Precision):
    name = "float8_e4m3"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        s = x.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
        return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


CONTROL = FP8()
