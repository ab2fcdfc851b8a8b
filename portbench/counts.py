"""The yardstick's arithmetic: the H100's published peaks, and the
operations and bytes that the work of a run needs, worked out from its
shapes (not from what the program happens to launch).

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit: 989
TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM. A share is stated
against these with the card's power limit beside it (the run's
``device``).
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import spec

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def _flops(net, shape) -> int:
    with torch.device("meta"):
        x = torch.empty(shape)
    with FlopCounterMode(display=False) as counter:
        net(x)
    return counter.get_total_flops()


def _meta(module, config: dict):
    with torch.device("meta"):
        return module.build(config, "meta")


def pose_flops(config: dict) -> int:
    """Operations of one pose forward of one crop (the flip test makes
    two), on the net that the configuration's ``reference`` names."""
    h, w = config["model"]["image_size"]
    return _flops(_meta(spec.reference(config, "pose"), config), (1, 3, h, w))


def flow_flops(config: dict, frame_hw) -> int:
    """Operations of the flow net on one pair of ``frame_hw`` frames: the
    net from its own input (``core`` at the module's ``net_input``), plus
    the operations that the module says the counter does not see."""
    module = spec.reference(config, "flow")
    return (_flops(_meta(module, config).core,
                   module.net_input(config, frame_hw))
            + module.uncounted_flops(config, frame_hw))


def corr_flops(volume) -> int:
    """The products and sums of one cost volume of shape ``volume``, (C,
    h, w, D): D^2 displacements at h w positions over C channels,
    2 C D^2 h w."""
    c, h, w, d = volume
    return 2 * c * d * d * h * w


def corr_bound_s(volume, pairs: int) -> float:
    """The least time of ``pairs`` cost volumes of shape ``volume``: the
    larger of their operations at the bf16 peak and their bytes (two bf16
    feature maps read, the float32 volume written) at the memory rate."""
    c, h, w, d = volume
    nbytes = pairs * (2 * c * h * w * 2 + d * d * h * w * 4)
    return max(pairs * corr_flops(volume) / PEAK_BF16_FLOPS,
               nbytes / PEAK_BYTES)


def crop_bound_s(frames: int, crops: int, frame_hw, crop_hw,
                 out_bytes: int) -> float:
    """The least time of cropping ``crops`` persons from ``frames`` uint8
    frames: each frame read once, each crop written once."""
    nbytes = (frames * frame_hw[0] * frame_hw[1] * 3
              + crops * 3 * crop_hw[0] * crop_hw[1] * out_bytes)
    return nbytes / PEAK_BYTES


def warp_bound_s(warps: int, net_hw, channels: int = 3,
                 elem_bytes: int = 4) -> float:
    """The least time of ``warps`` dense warps at ``net_hw``: the image and
    the flow read once, the warped image written once."""
    px = net_hw[0] * net_hw[1]
    return warps * (2 * channels + 2) * px * elem_bytes / PEAK_BYTES
