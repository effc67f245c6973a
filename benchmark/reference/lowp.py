"""The benchmark's control: the reference computed a precision below the
configuration's.  The shipped configurations compute in bfloat16, so the
control rounds both operands of every convolution, linear layer and
attention product to float8 (e4m3, one scale a tensor from its largest
magnitude), as fp8 tensor-core products would take them, and accumulates
in fp32.  Gradients pass the rounding unchanged (straight through), so a
backward pass multiplies by the same rounded operands."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(t.detach().abs().amax(), min=1e-30) / E4M3_MAX
    rounded = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (rounded - t).detach() if t.requires_grad else rounded
