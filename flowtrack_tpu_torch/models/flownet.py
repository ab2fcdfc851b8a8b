"""The FlowNet family in PyTorch, with the flow pre- and post-processing.

Port of ``flowtrack_tpu/models/flownet.py``: ``ConvLeaky`` (flownet.py:45),
``IConv`` (:64), ``Deconv`` (:82), ``_predict_flow`` / ``_upflow``
(:96-105), ``_RefinementTrunk`` (:108), ``FlowNetS`` (:144), ``FlowNetC``
(:176), ``FlowNetSD`` (:223), ``FlowNetFusion`` (:279), ``_upsample4``
(:316), the cascades ``FlowNet2`` (:322) and ``FlowNet2CSS`` (:403),
``preprocess_pair`` (:448), ``flow_at_full_res`` (:461),
``flow_output_is_full_res`` (:466), ``postprocess_flow`` (:474) and
``get_flow_net`` (:488).

The models take NCHW input (two stacked normalized frames, 6 channels, H
and W multiples of 64). FlowNetS/C/SD return the quarter-resolution flow
(N, 2, H/4, W/4) in float32, scaled by 1/div_flow, and in train mode the
pyramid (flow2, ..., flow6), each float32, as the reference's ``flows if
train else flows[0]`` (flownet.py:173,220,276); batch-norm variants then
normalise with the batch's statistics. The FlowNet2 cascades return the
final full-resolution flow (N, 2, H, W) in pixels in either mode; their
sub-nets stay in inference mode (running statistics, flow2 only), as the
reference's cascades call them with ``train=False``. Module names
are the lineage's state-dict names (``conv1.0.weight``, ``deconv5.0.*``,
``predict_flow6.*``, ``upsampled_flow6_to_5.weight``; the refinement
trunk's layers sit at the top level; the cascades' sub-nets are
``flownetc``, ``flownets_1``, ``flownets_2``, ``flownets_d`` and
``flownetfusion``), so the reference's weights load through
``torch_convert.reverse_flownet`` / ``reverse_flownet2`` with
``strict=True``. FlowNetC's cost volume is the correlation kernel K2
(ops/correlation.py); the cascades' four dense warps are the warp kernel
(ops/warp.py, K3/K4).

The pre- and post-processing functions keep the reference's NHWC layout.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flowtrack_tpu_torch.config import FlowConfig
from flowtrack_tpu_torch.models.layers import (
    apply_precision_policy,
    compute_context,
    init_weights,
    torch_dtype,
)
from flowtrack_tpu_torch.ops.correlation import (
    correlation_nchw,
    displacement_grid,
)
from flowtrack_tpu_torch.ops.warp import channelnorm, resample2d_nchw

LEAK = 0.1


def _conv_bn(cin, cout, kernel_size, stride, use_bn, device):
    """Conv2d (bias unless batch norm follows) + optional BatchNorm2d."""
    layers = [nn.Conv2d(cin, cout, kernel_size, stride,
                        (kernel_size - 1) // 2, bias=not use_bn,
                        device=device)]
    if use_bn:
        layers.append(nn.BatchNorm2d(cout, device=device))
    return layers


class ConvLeaky(nn.Sequential):
    """conv() of the lineage: Conv2d (+ BatchNorm2d) + LeakyReLU(0.1)."""

    def __init__(self, cin, cout, kernel_size=3, stride=1, use_bn=False,
                 device=None):
        super().__init__(*_conv_bn(cin, cout, kernel_size, stride, use_bn,
                                   device), nn.LeakyReLU(LEAK))


class IConv(nn.Sequential):
    """i_conv() of the lineage: Conv2d (+ BatchNorm2d), no activation."""

    def __init__(self, cin, cout, kernel_size=3, use_bn=False, device=None):
        super().__init__(*_conv_bn(cin, cout, kernel_size, 1, use_bn, device))


class Deconv(nn.Sequential):
    """deconv() of the lineage: ConvTranspose2d(4, 2, 1, bias) + LeakyReLU."""

    def __init__(self, cin, cout, device=None):
        super().__init__(nn.ConvTranspose2d(cin, cout, 4, 2, 1, bias=True,
                                            device=device),
                         nn.LeakyReLU(LEAK))


def _predict_flow(cin, device):
    """predict_flow of the lineage: 3x3 conv to 2 channels, bias, no act."""
    return nn.Conv2d(cin, 2, 3, 1, 1, bias=True, device=device)


def _upflow(device):
    """upsampled_flow of the lineage: ConvTranspose2d(2, 2, 4, 2, 1), no bias."""
    return nn.ConvTranspose2d(2, 2, 4, 2, 1, bias=False, device=device)


class _RefinementTrunk(nn.Module):
    """The decode path FlowNetS and FlowNetC share, from out_conv6 down to
    flow2. Its layers are registered on the model itself (the lineage's
    flat names); the model calls :meth:`refine`."""

    def _build_trunk(self, device):
        self.predict_flow6 = _predict_flow(1024, device)
        self.upsampled_flow6_to_5 = _upflow(device)
        self.deconv5 = Deconv(1024, 512, device)
        self.predict_flow5 = _predict_flow(1026, device)
        self.upsampled_flow5_to_4 = _upflow(device)
        self.deconv4 = Deconv(1026, 256, device)
        self.predict_flow4 = _predict_flow(770, device)
        self.upsampled_flow4_to_3 = _upflow(device)
        self.deconv3 = Deconv(770, 128, device)
        self.predict_flow3 = _predict_flow(386, device)
        self.upsampled_flow3_to_2 = _upflow(device)
        self.deconv2 = Deconv(386, 64, device)
        self.predict_flow2 = _predict_flow(194, device)

    def refine(self, out_conv2, out_conv3, out_conv4, out_conv5, out_conv6):
        """-> (flow2, ..., flow6); flow2 at 1/4 resolution."""
        flow6 = self.predict_flow6(out_conv6)
        concat5 = torch.cat([out_conv5, self.deconv5(out_conv6),
                             self.upsampled_flow6_to_5(flow6)], 1)
        flow5 = self.predict_flow5(concat5)
        concat4 = torch.cat([out_conv4, self.deconv4(concat5),
                             self.upsampled_flow5_to_4(flow5)], 1)
        flow4 = self.predict_flow4(concat4)
        concat3 = torch.cat([out_conv3, self.deconv3(concat4),
                             self.upsampled_flow4_to_3(flow4)], 1)
        flow3 = self.predict_flow3(concat3)
        concat2 = torch.cat([out_conv2, self.deconv2(concat3),
                             self.upsampled_flow3_to_2(flow3)], 1)
        return self.predict_flow2(concat2), flow3, flow4, flow5, flow6


def _flow_outputs(module, flows):
    """flow2 in float32; in train mode the pyramid, each in float32."""
    if module.training:
        return tuple(f.float() for f in flows)
    return flows[0].float()


class FlowNetS(_RefinementTrunk):
    """FlowNetSimple: (N, in_channels, H, W) -> flow2 (N, 2, H/4, W/4)
    float32 (the pyramid in train mode). 6 input channels alone; 12 as a stage of the cascades (the
    pair, the warped second frame, the flow, the brightness error)."""

    def __init__(self, use_bn: bool = False, dtype=torch.float32,
                 device=None, in_channels: int = 6):
        super().__init__()
        self.dtype = dtype
        c = lambda cin, cout, k, s: ConvLeaky(cin, cout, k, s, use_bn, device)
        self.conv1 = c(in_channels, 64, 7, 2)
        self.conv2 = c(64, 128, 5, 2)
        self.conv3 = c(128, 256, 5, 2)
        self.conv3_1 = c(256, 256, 3, 1)
        self.conv4 = c(256, 512, 3, 2)
        self.conv4_1 = c(512, 512, 3, 1)
        self.conv5 = c(512, 512, 3, 2)
        self.conv5_1 = c(512, 512, 3, 1)
        self.conv6 = c(512, 1024, 3, 2)
        self.conv6_1 = c(1024, 1024, 3, 1)
        self._build_trunk(device)

    def forward(self, x):
        with compute_context(x, self.dtype):
            out_conv2 = self.conv2(self.conv1(x))
            out_conv3 = self.conv3_1(self.conv3(out_conv2))
            out_conv4 = self.conv4_1(self.conv4(out_conv3))
            out_conv5 = self.conv5_1(self.conv5(out_conv4))
            out_conv6 = self.conv6_1(self.conv6(out_conv5))
            flows = self.refine(out_conv2, out_conv3, out_conv4, out_conv5,
                                out_conv6)
        return _flow_outputs(self, flows)


class FlowNetC(_RefinementTrunk):
    """FlowNetCorr: (N, 6, H, W) -> flow2 (N, 2, H/4, W/4) float32. The two
    frames go through the same conv1..conv3 modules; their 1/8-resolution
    features meet in the correlation kernel."""

    def __init__(self, use_bn: bool = False, max_displacement: int = 20,
                 corr_stride2: int = 2, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.max_displacement = max_displacement
        self.corr_stride2 = corr_stride2
        d = len(displacement_grid(max_displacement, corr_stride2))
        c = lambda cin, cout, k, s: ConvLeaky(cin, cout, k, s, use_bn, device)
        self.conv1 = c(3, 64, 7, 2)
        self.conv2 = c(64, 128, 5, 2)
        self.conv3 = c(128, 256, 5, 2)
        self.conv_redir = c(256, 32, 1, 1)
        self.conv3_1 = c(32 + d * d, 256, 3, 1)
        self.conv4 = c(256, 512, 3, 2)
        self.conv4_1 = c(512, 512, 3, 1)
        self.conv5 = c(512, 512, 3, 2)
        self.conv5_1 = c(512, 512, 3, 1)
        self.conv6 = c(512, 1024, 3, 2)
        self.conv6_1 = c(1024, 1024, 3, 1)
        self._build_trunk(device)

    def forward(self, x):
        with compute_context(x, self.dtype):
            x1, x2 = x[:, :3], x[:, 3:]
            out_conv2a = self.conv2(self.conv1(x1))
            out_conv3a = self.conv3(out_conv2a)
            out_conv3b = self.conv3(self.conv2(self.conv1(x2)))
            corr = correlation_nchw(out_conv3a, out_conv3b,
                                    self.max_displacement, self.corr_stride2)
            corr = F.leaky_relu(corr.to(out_conv3a.dtype), LEAK)
            x3 = torch.cat([self.conv_redir(out_conv3a), corr], 1)
            out_conv3 = self.conv3_1(x3)
            out_conv4 = self.conv4_1(self.conv4(out_conv3))
            out_conv5 = self.conv5_1(self.conv5(out_conv4))
            out_conv6 = self.conv6_1(self.conv6(out_conv5))
            flows = self.refine(out_conv2a, out_conv3, out_conv4, out_conv5,
                                out_conv6)
        return _flow_outputs(self, flows)


class FlowNetSD(nn.Module):
    """FlowNet2-SD (small displacement): an all-3x3 encoder and i_conv heads
    before each predict_flow. (N, 6, H, W) -> flow2 (N, 2, H/4, W/4)
    float32."""

    def __init__(self, use_bn: bool = False, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        c = lambda cin, cout, s=1: ConvLeaky(cin, cout, 3, s, use_bn, device)
        i = lambda cin, cout: IConv(cin, cout, 3, use_bn, device)
        self.conv0 = c(6, 64)
        self.conv1 = c(64, 64, 2)
        self.conv1_1 = c(64, 128)
        self.conv2 = c(128, 128, 2)
        self.conv2_1 = c(128, 128)
        self.conv3 = c(128, 256, 2)
        self.conv3_1 = c(256, 256)
        self.conv4 = c(256, 512, 2)
        self.conv4_1 = c(512, 512)
        self.conv5 = c(512, 512, 2)
        self.conv5_1 = c(512, 512)
        self.conv6 = c(512, 1024, 2)
        self.conv6_1 = c(1024, 1024)
        self.predict_flow6 = _predict_flow(1024, device)
        self.upsampled_flow6_to_5 = _upflow(device)
        self.deconv5 = Deconv(1024, 512, device)
        self.inter_conv5 = i(1026, 512)
        self.predict_flow5 = _predict_flow(512, device)
        self.upsampled_flow5_to_4 = _upflow(device)
        self.deconv4 = Deconv(1026, 256, device)
        self.inter_conv4 = i(770, 256)
        self.predict_flow4 = _predict_flow(256, device)
        self.upsampled_flow4_to_3 = _upflow(device)
        self.deconv3 = Deconv(770, 128, device)
        self.inter_conv3 = i(386, 128)
        self.predict_flow3 = _predict_flow(128, device)
        self.upsampled_flow3_to_2 = _upflow(device)
        self.deconv2 = Deconv(386, 64, device)
        self.inter_conv2 = i(194, 64)
        self.predict_flow2 = _predict_flow(64, device)

    def forward(self, x):
        with compute_context(x, self.dtype):
            out_conv1 = self.conv1_1(self.conv1(self.conv0(x)))
            out_conv2 = self.conv2_1(self.conv2(out_conv1))
            out_conv3 = self.conv3_1(self.conv3(out_conv2))
            out_conv4 = self.conv4_1(self.conv4(out_conv3))
            out_conv5 = self.conv5_1(self.conv5(out_conv4))
            out_conv6 = self.conv6_1(self.conv6(out_conv5))
            flow6 = self.predict_flow6(out_conv6)
            concat5 = torch.cat([out_conv5, self.deconv5(out_conv6),
                                 self.upsampled_flow6_to_5(flow6)], 1)
            flow5 = self.predict_flow5(self.inter_conv5(concat5))
            concat4 = torch.cat([out_conv4, self.deconv4(concat5),
                                 self.upsampled_flow5_to_4(flow5)], 1)
            flow4 = self.predict_flow4(self.inter_conv4(concat4))
            concat3 = torch.cat([out_conv3, self.deconv3(concat4),
                                 self.upsampled_flow4_to_3(flow4)], 1)
            flow3 = self.predict_flow3(self.inter_conv3(concat3))
            concat2 = torch.cat([out_conv2, self.deconv2(concat3),
                                 self.upsampled_flow3_to_2(flow3)], 1)
            flow2 = self.predict_flow2(self.inter_conv2(concat2))
        return _flow_outputs(self, (flow2, flow3, flow4, flow5, flow6))


class FlowNetFusion(nn.Module):
    """FlowNet2's fusion net, at full resolution: (N, 11, H, W) = frame 1
    (3), the SD and CSS flows (2 + 2), their norms (1 + 1) and brightness
    errors (1 + 1) -> flow0 (N, 2, H, W) float32."""

    def __init__(self, use_bn: bool = False, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        c = lambda cin, cout, s=1: ConvLeaky(cin, cout, 3, s, use_bn, device)
        i = lambda cin, cout: IConv(cin, cout, 3, use_bn, device)
        self.conv0 = c(11, 64)
        self.conv1 = c(64, 64, 2)
        self.conv1_1 = c(64, 128)
        self.conv2 = c(128, 128, 2)
        self.conv2_1 = c(128, 128)
        self.predict_flow2 = _predict_flow(128, device)
        self.upsampled_flow2_to_1 = _upflow(device)
        self.deconv1 = Deconv(128, 32, device)
        self.inter_conv1 = i(162, 32)
        self.predict_flow1 = _predict_flow(32, device)
        self.upsampled_flow1_to_0 = _upflow(device)
        self.deconv0 = Deconv(162, 16, device)
        self.inter_conv0 = i(82, 16)
        self.predict_flow0 = _predict_flow(16, device)

    def forward(self, x):
        # the glue may be bfloat16 under a float32 model: the reference
        # casts its input to the model dtype
        x = x.to(self.dtype)
        with compute_context(x, self.dtype):
            out_conv0 = self.conv0(x)
            out_conv1 = self.conv1_1(self.conv1(out_conv0))
            out_conv2 = self.conv2_1(self.conv2(out_conv1))
            flow2 = self.predict_flow2(out_conv2)
            concat1 = torch.cat([out_conv1, self.deconv1(out_conv2),
                                 self.upsampled_flow2_to_1(flow2)], 1)
            flow1 = self.predict_flow1(self.inter_conv1(concat1))
            concat0 = torch.cat([out_conv0, self.deconv0(concat1),
                                 self.upsampled_flow1_to_0(flow1)], 1)
            flow0 = self.predict_flow0(self.inter_conv0(concat0))
        return flow0.float()


def _div(x, divisor: float):
    """``x / divisor`` as a true division on every device: by a Python
    scalar a CUDA tensor is multiplied by the rounded reciprocal, one ulp
    off the CPU's and the reference's where 1 / divisor is not exact (20,
    255)."""
    return x / x.new_full((), divisor)


def _upsample4(flow):
    """(N, C, h, w) -> (N, C, 4h, 4w) bilinear with half-pixel centres."""
    h, w = flow.shape[2], flow.shape[3]
    return resize_bilinear(flow.permute(0, 2, 3, 1),
                           (4 * h, 4 * w)).permute(0, 3, 1, 2)


class _Cascade(nn.Module):
    """The inter-stage glue FlowNet2 and FlowNet2-CS/CSS share. Tensors at
    full resolution (upsampled flows, warped frames, brightness errors, the
    fusion input) are held in ``glue_dtype``, cast where the reference
    casts them; the sub-nets compute in the model dtype."""

    def __init__(self, use_bn, div_flow, dtype, glue_dtype, device):
        super().__init__()
        self.div_flow = div_flow
        self.glue_dtype = glue_dtype
        self.flownetc = FlowNetC(use_bn, dtype=dtype, device=device)

    def train(self, mode: bool = True):
        """Train mode for the cascade; its sub-nets stay in inference
        mode."""
        self.training = mode
        for sub in self.children():
            sub.train(False)
        return self

    def _up(self, flow2):
        """A sub-net's (rescaled) quarter-resolution flow -> full
        resolution in the glue dtype."""
        return _upsample4(flow2).to(self.glue_dtype)

    def _stage_input(self, x, flow_full):
        """The 12 channels of an S stage: the pair, the second frame warped
        by ``flow_full``, ``flow_full / div_flow`` and the brightness
        error."""
        gdt = self.glue_dtype
        warped = resample2d_nchw(x[:, 3:].to(gdt), flow_full)
        err = channelnorm(x[:, :3].to(gdt) - warped, dim=1).to(gdt)
        return torch.cat([x, warped.to(x.dtype),
                          _div(flow_full, self.div_flow).to(x.dtype),
                          err.to(x.dtype)], 1)


class FlowNet2(_Cascade):
    """The full cascade, C -> S -> S (CSS) || SD -> Fusion: (N, 6, H, W)
    pairs (``preprocess_pair``) -> full-resolution flow (N, 2, H, W)
    float32. Four dense warps per forward."""

    def __init__(self, use_bn: bool = False, div_flow: float = 20.0,
                 dtype=torch.float32, glue_dtype=torch.float32, device=None):
        super().__init__(use_bn, div_flow, dtype, glue_dtype, device)
        self.flownets_1 = FlowNetS(use_bn, dtype, device, in_channels=12)
        self.flownets_2 = FlowNetS(use_bn, dtype, device, in_channels=12)
        self.flownets_d = FlowNetSD(use_bn, dtype, device)
        self.flownetfusion = FlowNetFusion(use_bn, dtype, device)
        self.train()

    def forward(self, x):
        gdt, div = self.glue_dtype, self.div_flow
        flow_c = self._up(self.flownetc(x) * div)
        flow_s1 = self._up(self.flownets_1(self._stage_input(x, flow_c)) * div)
        flow_s2 = self._up(self.flownets_2(self._stage_input(x, flow_s1))
                           * div)
        # the SD branch's flow is divided by div_flow, as in the reference
        flow_sd = self._up(_div(self.flownets_d(x), div))
        norm_sd = channelnorm(flow_sd, dim=1).to(gdt)
        norm_s2 = channelnorm(flow_s2, dim=1).to(gdt)
        img1, img2 = x[:, :3].to(gdt), x[:, 3:].to(gdt)
        err_sd = channelnorm(img1 - resample2d_nchw(img2, flow_sd),
                             dim=1).to(gdt)
        err_s2 = channelnorm(img1 - resample2d_nchw(img2, flow_s2),
                             dim=1).to(gdt)
        return self.flownetfusion(torch.cat(
            [img1, flow_sd, flow_s2, norm_sd, norm_s2, err_sd, err_s2], 1))


class FlowNet2CSS(_Cascade):
    """The truncated cascades C -> S (FlowNet2-CS, ``stages=1``) and
    C -> S -> S (FlowNet2-CSS, ``stages=2``), with FlowNet2's glue and
    names: (N, 6, H, W) -> the last S stage's full-resolution flow
    (N, 2, H, W) float32."""

    def __init__(self, stages: int = 2, use_bn: bool = False,
                 div_flow: float = 20.0, dtype=torch.float32,
                 glue_dtype=torch.float32, device=None):
        super().__init__(use_bn, div_flow, dtype, glue_dtype, device)
        self.stages = stages
        for k in range(stages):
            setattr(self, f"flownets_{k + 1}",
                    FlowNetS(use_bn, dtype, device, in_channels=12))
        self.train()

    def forward(self, x):
        flow = self._up(self.flownetc(x) * self.div_flow)
        for k in range(self.stages):
            net = getattr(self, f"flownets_{k + 1}")
            flow = self._up(net(self._stage_input(x, flow)) * self.div_flow)
        return flow.float()


def _shrink_weights(in_size: int, out_size: int, device):
    """(in_size, out_size) float32 weights of jax.image.resize's "bilinear"
    along one axis (``compute_weight_mat``, antialiased): the triangle
    kernel widened by in/out when it shrinks, each output's weights
    normalised to sum 1, outputs sampling outside the input zeroed."""
    inv_scale = 1.0 / (out_size / in_size)
    sample = ((torch.arange(out_size, dtype=torch.float32, device=device)
               + 0.5) * inv_scale - 0.5)
    taps = torch.arange(in_size, dtype=torch.float32, device=device)
    x = (sample[None, :] - taps[:, None]).abs() / max(inv_scale, 1.0)
    weights = (1.0 - x).clamp(min=0.0)
    total = weights.sum(0, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > 1000.0 * eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_bilinear(x, out_hw):
    """(N, H, W, C) -> (N, oh, ow, C), the reference's
    ``jax.image.resize(..., "bilinear")`` with half-pixel centres. An
    enlargement is ``F.interpolate``; when either axis shrinks, each changed
    axis is contracted in float32 with jax's antialiased triangle weights
    (:func:`_shrink_weights`). The result is float32 for a shrink and
    ``x``'s dtype for an enlargement."""
    h, w = x.shape[1], x.shape[2]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    if oh >= h and ow >= w:
        y = F.interpolate(x.permute(0, 3, 1, 2), size=(oh, ow),
                          mode="bilinear", align_corners=False)
        return y.permute(0, 2, 3, 1)
    y = x.float()
    if oh != h:
        y = torch.einsum("nhwc,hk->nkwc", y, _shrink_weights(h, oh, x.device))
    if ow != w:
        y = torch.einsum("nhwc,wk->nhkc", y, _shrink_weights(w, ow, x.device))
    return y


def preprocess_pair(im1, im2, rgb_max: float = 255.0):
    """Two (N, H, W, 3) uint8/float frames -> (N, H, W, 6) network input:
    minus the per-pair per-channel mean over both frames, over rgb_max."""
    pair = torch.stack([im1.float(), im2.float()], dim=1)   # (N, 2, H, W, 3)
    # jnp.mean's form, the float32 sum times the float32 1 / count, with the
    # sum taken in float64 and rounded once: exact for integer frames in any
    # order, so the card's run equals the CPU's bit for bit (a float32 sum
    # of a 384x640 pair is not exact, and its order is the device's)
    total = pair.sum(dim=(1, 2, 3), keepdim=True, dtype=torch.float64)
    mean = total.float() * float(np.float32(1.0 / pair[0, ..., 0].numel()))
    pair = _div(pair - mean, rgb_max)
    return torch.cat([pair[:, 0], pair[:, 1]], dim=-1)


def flow_at_full_res(model_out_quarter, div_flow: float = 20.0):
    """(N, h, w, 2) quarter-resolution output -> x4 bilinear, times div_flow."""
    n, h, w, _ = model_out_quarter.shape
    return resize_bilinear(model_out_quarter * div_flow, (h * 4, w * 4))


def flow_output_is_full_res(variant: str) -> bool:
    """FlowNetS/C/SD emit quarter-resolution flow scaled by 1/div_flow; the
    FlowNet2 cascades emit the final full-resolution flow in pixels, which
    must not be upsampled or rescaled again."""
    return variant in ("flownet2", "flownet2_cs", "flownet2_css")


def postprocess_flow(flow_out, variant: str, out_hw, div_flow: float = 20.0):
    """(N, fh, fw, 2) model output -> flow (N, oh, ow, 2) in pixels of
    ``out_hw``, components rescaled by the resize. Quarter-resolution
    outputs are first taken times div_flow at 4x their size
    (see :func:`flow_output_is_full_res`)."""
    fh, fw = flow_out.shape[1], flow_out.shape[2]
    if not flow_output_is_full_res(variant):
        flow_out = flow_out * div_flow
        fh, fw = fh * 4, fw * 4
    oh, ow = out_hw
    flow = resize_bilinear(flow_out, (oh, ow))
    # filled on the device: no copy from the host inside a clip
    scale = torch.stack([flow.new_full((), ow / fw, dtype=torch.float32),
                         flow.new_full((), oh / fh, dtype=torch.float32)])
    return flow * scale


def get_flow_net(cfg: FlowConfig, device=None,
                 generator: torch.Generator | None = None):
    """The flow net of ``cfg.variant`` in eval mode; with ``generator``,
    seeded random weights. An unknown variant raises KeyError.
    ``use_pallas_corr``, ``use_pallas_warp`` and ``pallas_warp_impl`` have
    no counterpart: a CUDA tensor always takes the correlation and warp
    kernels, and one warp kernel serves both impl names."""
    dtype = torch_dtype(cfg.dtype)
    apply_precision_policy(dtype)
    bn = cfg.batch_norm
    if cfg.variant == "flownet_s":
        model = FlowNetS(bn, dtype, device)
    elif cfg.variant == "flownet_c":
        model = FlowNetC(bn, cfg.corr_max_displacement, cfg.corr_stride2,
                         dtype, device)
    elif cfg.variant == "flownet_sd":
        model = FlowNetSD(bn, dtype, device)
    elif cfg.variant == "flownet2":
        model = FlowNet2(bn, cfg.div_flow, dtype, torch_dtype(cfg.glue_dtype),
                         device)
    elif cfg.variant in ("flownet2_cs", "flownet2_css"):
        model = FlowNet2CSS(1 if cfg.variant == "flownet2_cs" else 2, bn,
                            cfg.div_flow, dtype, torch_dtype(cfg.glue_dtype),
                            device)
    else:
        raise KeyError(f"unknown flow variant {cfg.variant!r}")
    if generator is not None:
        init_weights(model, generator)
    return model.eval()
