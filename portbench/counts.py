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

from portbench.reference import nets

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
CORR_CHANNELS = 256     # FlowNetC's conv3 features, which the volume compares


def _flops(net, shape) -> int:
    with torch.device("meta"):
        x = torch.empty(shape)
    with FlopCounterMode(display=False) as counter:
        net(x)
    return counter.get_total_flops()


def pose_flops(model: dict) -> int:
    """Operations of one pose forward of one crop (the flip test makes
    two)."""
    with torch.device("meta"):
        net = nets.PoseResNet(model["num_layers"], model["num_joints"],
                              model["num_deconv_filters"],
                              model["num_deconv_kernels"],
                              model["final_conv_kernel"])
    h, w = model["image_size"]
    return _flops(net, (1, 3, h, w))


def corr_shape(flow: dict, net_hw) -> tuple:
    """(C, h, w, D) of FlowNetC's cost volume at a net input of ``net_hw``:
    conv3's features at an eighth of it."""
    d = len(range(-flow["corr_max_displacement"],
                  flow["corr_max_displacement"] + 1, flow["corr_stride2"]))
    return CORR_CHANNELS, net_hw[0] // 8, net_hw[1] // 8, d


def corr_flops(flow: dict, net_hw) -> int:
    """The cost volume's products and sums for one pair: 2 C D^2 h w."""
    c, h, w, d = corr_shape(flow, net_hw)
    return 2 * c * d * d * h * w


def flow_flops(flow: dict, net_hw) -> int:
    """Operations of the flow net on one pair at ``net_hw``: the counted
    convolutions plus the cost volume, which the counter does not see."""
    with torch.device("meta"):
        net = nets.flow_net(flow["variant"], flow["div_flow"],
                            flow["corr_max_displacement"],
                            flow["corr_stride2"])
    has_corr = flow["variant"] in ("flownet_c", "flownet2")
    return (_flops(net, (1, 6, *net_hw))
            + (corr_flops(flow, net_hw) if has_corr else 0))


def corr_bound_s(flow: dict, net_hw, pairs: int) -> float:
    """The least time of ``pairs`` cost volumes: the larger of their
    operations at the bf16 peak and their bytes (two bf16 feature maps
    read, the float32 volume written) at the memory rate."""
    c, h, w, d = corr_shape(flow, net_hw)
    nbytes = pairs * (2 * c * h * w * 2 + d * d * h * w * 4)
    return max(pairs * corr_flops(flow, net_hw) / PEAK_BF16_FLOPS,
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
