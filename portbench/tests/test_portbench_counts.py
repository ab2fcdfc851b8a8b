"""The yardstick's counts of operations and bytes against hand counts at
small shapes, and the counts and seeded weights of the benchmark's
configurations pinned."""

import hashlib
import json

import pytest
import torch
from torch import nn

from conftest import ROOT
from portbench import counts, spec

# at a cell's 720x1280 frames and a batched step's 60 pairs: counts, bounds
# and the sha256 of each net's seeded state (seed 2**32 + 5), as the
# harness gave them when each configuration built its nets by a fixed name
PINNED = {
    "simplebaseline-r50-flownetc": {
        "pose_flops": 10852761600, "flow_flops": 227288317440,
        "corr_bound_s": 0.0007669912835820895,
        "warp_bound_s": 0.002253655880597015,
        "states": ("c3e03e5c3c9d758db0d2407d21e1f81a"
                   "80045a9de93ee6e64594d70f4419382e",
                   "62f1a6b84e4da5746bd30853ad992517"
                   "3b8ec3304daf4573aac082dd7a5f55b5")},
    "flowtrack-r152-flownet2": {
        "pose_flops": 25398607872, "flow_flops": 994675806720,
        "corr_bound_s": 0.0007669912835820895,
        "warp_bound_s": 0.002253655880597015,
        "states": ("3987187b644c554fd69474df01010fbf"
                   "209db0d9a368d7ff8b75aa8d9d08ebf9",
                   "e50398959369ed067755ae71cb54895f"
                   "cc9c89e38579c03d46d92aa0d9915953")},
}


def _digest(state: dict) -> str:
    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_configurations_counts_and_weights_are_pinned(name):
    from portbench.drivers import offline

    cfg = json.load(open(ROOT / "portbench" / "configs" / f"{name}.json"))
    pin = PINNED[name]
    hw = (720, 1280)
    flow = spec.reference(cfg, "flow")
    assert counts.pose_flops(cfg) == pin["pose_flops"]
    assert counts.flow_flops(cfg, hw) == pin["flow_flops"]
    assert counts.corr_bound_s(flow.cost_volume(cfg, hw), 60) \
        == pin["corr_bound_s"]
    assert counts.warp_bound_s(240, flow.net_input(cfg, hw)[-2:]) \
        == pin["warp_bound_s"]
    states = offline.states(cfg, 2 ** 32 + 5, torch.device("cpu"))
    assert tuple(_digest(s) for s in states) == pin["states"]


def test_the_counter_counts_a_convolution_as_two_operations_a_product():
    conv = nn.Conv2d(8, 16, 3, padding=1)
    assert counts._flops(conv, (1, 8, 10, 12)) == 2 * 8 * 16 * 9 * 10 * 12


def test_pose_operations_scale_with_the_crop():
    model = {"num_layers": 50, "num_joints": 17, "image_size": [128, 96],
             "num_deconv_filters": [256, 256, 256],
             "num_deconv_kernels": [4, 4, 4], "final_conv_kernel": 1}
    ref = {"pose": "pose_resnet"}
    small = counts.pose_flops({"reference": ref, "model": model})
    big = counts.pose_flops({"reference": ref,
                             "model": dict(model, image_size=[256, 192])})
    assert big == 4 * small
    # by hand: ResNet-50's 4.09 G multiply-adds at 224x224 scaled to
    # 256x192 pixels, and the head: three 4x4 stride-2 deconvolutions
    # (each output pixel takes 4 taps a channel) and the 1x1 to 17 joints
    head = (16 * 12 * 256 * 2048 * 4 + 32 * 24 * 256 * 256 * 4
            + 64 * 48 * 256 * 256 * 4 + 64 * 48 * 256 * 17)
    macs = 4.09e9 * 256 * 192 / (224 * 224) + head
    assert abs(big / 2 - macs) < 0.02 * macs


def test_the_cost_volume():
    config = {"reference": {"flow": "flownet"},
              "flow": {"variant": "flownet_c", "div_flow": 20.0,
                       "rgb_max": 255.0, "corr_max_displacement": 4,
                       "corr_stride2": 2}}
    module = spec.reference(config, "flow")
    volume = module.cost_volume(config, (64, 128))
    assert volume == (256, 8, 16, 5)
    assert counts.corr_flops(volume) == 2 * 256 * 25 * 8 * 16
    nbytes = 3 * (2 * 256 * 8 * 16 * 2 + 25 * 8 * 16 * 4)
    assert counts.corr_bound_s(volume, 3) == max(
        3 * 2 * 256 * 25 * 128 / counts.PEAK_BF16_FLOPS,
        nbytes / counts.PEAK_BYTES)
    # frames off the /64 grid count at the grid, the volume beside the net
    assert module.cost_volume(config, (60, 100)) == volume
    assert module.uncounted_flops(config, (60, 100)) == counts.corr_flops(
        volume)
    assert counts.flow_flops(config, (60, 100)) == counts._flops(
        counts._meta(module, config).core, (1, 6, 64, 128)) \
        + counts.corr_flops(volume)
    assert counts.flow_flops(config, (64, 128)) > counts.corr_flops(volume)


def test_crop_and_warp_bytes():
    assert counts.crop_bound_s(2, 5, (10, 20), (8, 6), 2) == (
        2 * 10 * 20 * 3 + 5 * 3 * 8 * 6 * 2) / counts.PEAK_BYTES
    assert counts.warp_bound_s(4, (8, 16)) == 4 * 8 * 128 * 4 \
        / counts.PEAK_BYTES
