"""Numeric policy and random initialisation shared by the port's models.

Port of ``flowtrack_tpu/models/layers.py``:

* ``_precision_for`` (layers.py:25): float32 configs run in full float32
  (the reference's ``Precision.HIGHEST``). PyTorch runs float32
  convolutions in TF32 by default (``torch.backends.cudnn.allow_tf32``), so
  :func:`apply_precision_policy` switches TF32 off for cuDNN and cuBLAS
  whenever a float32 model is built. bfloat16 configs compute in bfloat16
  with float32 parameters, as the reference does: the models run their
  forward under ``torch.autocast(dtype=torch.bfloat16)``, which casts
  convolution operands to bfloat16 and leaves batch norm's statistics and
  the parameters in float32. What that costs, measured at full width with
  random weights on an NVIDIA H100 80GB HBM3 at 700 W: PoseResNet-50's
  heatmaps differ from the float32 model's by 1.5% of their peak and
  FlowNetC's flow by 0.5% (``chip_smoke.py`` holds them to 5% and 2%).
* ``ConvTransposeTorch`` (:34) is ``nn.ConvTranspose2d`` itself; the
  reference's flipped-HWIO kernels come back through
  ``torch_convert.deconv_kernel_to_torch``.
* ``BatchNormTorch`` (:85) at inference is ``nn.BatchNorm2d`` in eval mode.
* ``max_pool_same_as_torch`` (:151) is ``nn.MaxPool2d(3, 2, 1)``.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype string ("float32", "bfloat16") as a torch dtype."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"unsupported model dtype {name!r}")
    return dtypes[name]


def apply_precision_policy(dtype: torch.dtype) -> None:
    """float32 models compute in full float32: TF32 off for cuDNN
    convolutions and cuBLAS matmuls (process-wide switches)."""
    if dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def compute_context(x: torch.Tensor, dtype: torch.dtype):
    """bfloat16 compute with float32 parameters (autocast) for a bfloat16
    model; nothing for a float32 one."""
    if dtype == torch.bfloat16:
        return torch.autocast(x.device.type, dtype=torch.bfloat16)
    return contextlib.nullcontext()


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, drawn on the CPU from ``generator`` and copied
    to each parameter's device, with the reference's initialisers: He-normal
    (fan-in) convolutions, normal(0, 0.001) transposed convolutions, zero
    biases, identity batch norm."""

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    for m in module.modules():
        if isinstance(m, nn.ConvTranspose2d):
            normal_(m.weight, 0.001)
        elif isinstance(m, nn.Conv2d):
            fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
            normal_(m.weight, math.sqrt(2.0 / fan_in))
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
            continue
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
    return module
