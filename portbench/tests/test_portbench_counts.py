"""The yardstick's counts of operations and bytes against hand counts at
small shapes."""

from torch import nn

from portbench import counts


def test_the_counter_counts_a_convolution_as_two_operations_a_product():
    conv = nn.Conv2d(8, 16, 3, padding=1)
    assert counts._flops(conv, (1, 8, 10, 12)) == 2 * 8 * 16 * 9 * 10 * 12


def test_pose_operations_scale_with_the_crop():
    model = {"num_layers": 50, "num_joints": 17, "image_size": [128, 96],
             "num_deconv_filters": [256, 256, 256],
             "num_deconv_kernels": [4, 4, 4], "final_conv_kernel": 1}
    small = counts.pose_flops(model)
    big = counts.pose_flops(dict(model, image_size=[256, 192]))
    assert big == 4 * small
    # by hand: ResNet-50's 4.09 G multiply-adds at 224x224 scaled to
    # 256x192 pixels, and the head: three 4x4 stride-2 deconvolutions
    # (each output pixel takes 4 taps a channel) and the 1x1 to 17 joints
    head = (16 * 12 * 256 * 2048 * 4 + 32 * 24 * 256 * 256 * 4
            + 64 * 48 * 256 * 256 * 4 + 64 * 48 * 256 * 17)
    macs = 4.09e9 * 256 * 192 / (224 * 224) + head
    assert abs(big / 2 - macs) < 0.02 * macs


def test_the_cost_volume():
    flow = {"variant": "flownet_c", "div_flow": 20.0,
            "corr_max_displacement": 4, "corr_stride2": 2}
    c, h, w, d = counts.corr_shape(flow, (64, 128))
    assert (c, h, w, d) == (256, 8, 16, 5)
    assert counts.corr_flops(flow, (64, 128)) == 2 * 256 * 25 * 8 * 16
    nbytes = 3 * (2 * 256 * 8 * 16 * 2 + 25 * 8 * 16 * 4)
    assert counts.corr_bound_s(flow, (64, 128), 3) == max(
        3 * 2 * 256 * 25 * 128 / counts.PEAK_BF16_FLOPS,
        nbytes / counts.PEAK_BYTES)
    assert counts.flow_flops(flow, (64, 128)) > counts.corr_flops(
        flow, (64, 128))


def test_crop_and_warp_bytes():
    assert counts.crop_bound_s(2, 5, (10, 20), (8, 6), 2) == (
        2 * 10 * 20 * 3 + 5 * 3 * 8 * 6 * 2) / counts.PEAK_BYTES
    assert counts.warp_bound_s(4, (8, 16)) == 4 * 8 * 128 * 4 \
        / counts.PEAK_BYTES
