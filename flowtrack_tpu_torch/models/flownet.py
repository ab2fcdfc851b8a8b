"""FlowNetS and FlowNetC in PyTorch, with the flow pre- and post-processing.

Port of ``flowtrack_tpu/models/flownet.py``: ``ConvLeaky`` (flownet.py:45),
``Deconv`` (:82), ``_predict_flow`` / ``_upflow`` (:96-105),
``_RefinementTrunk`` (:108), ``FlowNetS`` (:144), ``FlowNetC`` (:176),
``preprocess_pair`` (:448), ``flow_at_full_res`` (:461),
``postprocess_flow`` (:474) and ``get_flow_net`` (:488) for ``flownet_s``
and ``flownet_c``. FlowNetSD, FlowNetFusion and the FlowNet2 cascades (with
the warp kernels) are ROADMAP slice 2.

The models take NCHW input (two stacked normalized frames, 6 channels, H
and W multiples of 64) and return the quarter-resolution flow (N, 2, H/4,
W/4) in float32, scaled by 1/div_flow. Module names are the lineage's
state-dict names (``conv1.0.weight``, ``deconv5.0.*``, ``predict_flow6.*``,
``upsampled_flow6_to_5.weight``; the refinement trunk's layers sit at the
top level), so the reference's weights load through
``torch_convert.reverse_flownet`` with ``strict=True``. FlowNetC's cost
volume is the correlation kernel K2 (ops/correlation.py).

The pre- and post-processing functions keep the reference's NHWC layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from flowtrack_tpu.config import FlowConfig
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

LEAK = 0.1


class ConvLeaky(nn.Sequential):
    """conv() of the lineage: Conv2d (+ BatchNorm2d) + LeakyReLU(0.1)."""

    def __init__(self, cin, cout, kernel_size=3, stride=1, use_bn=False,
                 device=None):
        layers = [nn.Conv2d(cin, cout, kernel_size, stride,
                            (kernel_size - 1) // 2, bias=not use_bn,
                            device=device)]
        if use_bn:
            layers.append(nn.BatchNorm2d(cout, device=device))
        layers.append(nn.LeakyReLU(LEAK))
        super().__init__(*layers)


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
        """-> flow2 at 1/4 resolution (the inference output)."""
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
        return self.predict_flow2(concat2)


class FlowNetS(_RefinementTrunk):
    """FlowNetSimple: (N, 6, H, W) -> flow2 (N, 2, H/4, W/4) float32."""

    def __init__(self, use_bn: bool = False, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        c = lambda cin, cout, k, s: ConvLeaky(cin, cout, k, s, use_bn, device)
        self.conv1 = c(6, 64, 7, 2)
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
            flow2 = self.refine(out_conv2, out_conv3, out_conv4, out_conv5,
                                out_conv6)
        return flow2.float()


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
            flow2 = self.refine(out_conv2a, out_conv3, out_conv4, out_conv5,
                                out_conv6)
        return flow2.float()


def resize_bilinear(x, out_hw):
    """(N, H, W, C) -> (N, oh, ow, C) bilinear with half-pixel centres, the
    reference's ``jax.image.resize(..., "bilinear")`` when it enlarges. Both
    resizes of the main path enlarge; a shrink would need jax's antialiased
    kernel and raises."""
    h, w = x.shape[1], x.shape[2]
    oh, ow = out_hw
    if oh < h or ow < w:
        raise ValueError(f"resize_bilinear only enlarges: {(h, w)} -> {(oh, ow)}")
    if (oh, ow) == (h, w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(oh, ow), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def preprocess_pair(im1, im2, rgb_max: float = 255.0):
    """Two (N, H, W, 3) uint8/float frames -> (N, H, W, 6) network input:
    minus the per-pair per-channel mean over both frames, over rgb_max."""
    pair = torch.stack([im1.float(), im2.float()], dim=1)   # (N, 2, H, W, 3)
    mean = pair.mean(dim=(1, 2, 3), keepdim=True)
    pair = (pair - mean) / rgb_max
    return torch.cat([pair[:, 0], pair[:, 1]], dim=-1)


def flow_at_full_res(model_out_quarter, div_flow: float = 20.0):
    """(N, h, w, 2) quarter-resolution output -> x4 bilinear, times div_flow."""
    n, h, w, _ = model_out_quarter.shape
    return resize_bilinear(model_out_quarter * div_flow, (h * 4, w * 4))


def postprocess_flow(flow_out, variant: str, out_hw, div_flow: float = 20.0):
    """(N, h, w, 2) quarter-resolution model output -> full-resolution flow
    (N, oh, ow, 2) in pixels of ``out_hw``, components rescaled by the
    resize."""
    if variant not in ("flownet_s", "flownet_c"):
        raise NotImplementedError(f"flow variant {variant!r} is ROADMAP "
                                  "slice 2 (FlowNet2 cascade)")
    fh, fw = flow_out.shape[1] * 4, flow_out.shape[2] * 4
    oh, ow = out_hw
    flow = resize_bilinear(flow_out * div_flow, (oh, ow))
    scale = torch.tensor([ow / fw, oh / fh], dtype=torch.float32,
                         device=flow.device)
    return flow * scale


def get_flow_net(cfg: FlowConfig, device=None,
                 generator: torch.Generator | None = None):
    """FlowNetS or FlowNetC for ``cfg`` in eval mode; with ``generator``,
    seeded random weights. ``cfg.use_pallas_corr`` has no counterpart: a
    CUDA tensor always takes the correlation kernel."""
    dtype = torch_dtype(cfg.dtype)
    apply_precision_policy(dtype)
    if cfg.variant == "flownet_s":
        model = FlowNetS(cfg.batch_norm, dtype, device)
    elif cfg.variant == "flownet_c":
        model = FlowNetC(cfg.batch_norm, cfg.corr_max_displacement,
                         cfg.corr_stride2, dtype, device)
    else:
        raise NotImplementedError(f"flow variant {cfg.variant!r} is ROADMAP "
                                  "slice 2 (FlowNet2 cascade)")
    if generator is not None:
        init_weights(model, generator)
    return model.eval()
