"""Plain float32 nets of the benchmark's reference: PoseResNet (Simple
Baselines, arXiv:1804.06208) and the FlowNet family (FlowNetC,
arXiv:1504.06852; FlowNet2, arXiv:1612.01925), written from the published
descriptions in plain PyTorch.

Module names follow the lineage's state-dict names, so one state dict loads
into these nets and into the program's alike. Every convolution goes
through ``QConv2d`` / ``QConvTranspose2d``, whose ``quant`` (identity by
default) rounds the operands before the float32 product: the control of the
benchmark's check sets it to an fp8 rounding (``precision.py``).

Nothing here imports the program or JAX. Float32 throughout: the caller
turns TF32 off (``precision.float32_exact``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LEAK = 0.1


def _identity(x):
    return x


class QConv2d(nn.Conv2d):
    quant = staticmethod(_identity)

    def forward(self, x):
        return F.conv2d(self.quant(x), self.quant(self.weight), self.bias,
                        self.stride, self.padding, self.dilation, self.groups)


class QConvTranspose2d(nn.ConvTranspose2d):
    quant = staticmethod(_identity)

    def forward(self, x):
        return F.conv_transpose2d(self.quant(x), self.quant(self.weight),
                                  self.bias, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


def set_quant(net: nn.Module, quant) -> nn.Module:
    """Round every convolution's operands of ``net`` with ``quant``."""
    for m in net.modules():
        if isinstance(m, (QConv2d, QConvTranspose2d)):
            m.quant = quant
    if hasattr(net, "corr_quant"):
        net.corr_quant = quant
    for m in net.modules():
        if hasattr(m, "corr_quant"):
            m.corr_quant = quant
    return net


# ---- PoseResNet ---------------------------------------------------------

RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, down):
        super().__init__()
        out = planes * 4
        self.conv1 = QConv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = QConv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = QConv2d(planes, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.downsample = (nn.Sequential(
            QConv2d(cin, out, 1, stride, bias=False), nn.BatchNorm2d(out))
            if down else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class PoseResNet(nn.Module):
    """(N, 3, h, w) crops -> (N, K, h/4, w/4) heatmaps: a ResNet of
    bottleneck blocks, three 4x4 stride-2 deconvolutions with batch norm and
    ReLU, a 1x1 conv to the joints."""

    def __init__(self, num_layers: int, num_joints: int,
                 deconv_filters=(256, 256, 256), deconv_kernels=(4, 4, 4),
                 final_kernel: int = 1):
        super().__init__()
        self.conv1 = QConv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for stage, n in enumerate(RESNET_BLOCKS[num_layers]):
            planes = 64 * 2 ** stage
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(n):
                blocks.append(Bottleneck(cin, planes, stride if b == 0 else 1,
                                         b == 0))
                cin = planes * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        head = []
        for filters, k in zip(deconv_filters, deconv_kernels):
            head += [QConvTranspose2d(cin, filters, k, 2, (k - 2) // 2,
                                      bias=False),
                     nn.BatchNorm2d(filters), nn.ReLU()]
            cin = filters
        self.deconv_layers = nn.Sequential(*head)
        self.final_layer = QConv2d(cin, num_joints, final_kernel, 1,
                                   (final_kernel - 1) // 2)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
        return self.final_layer(self.deconv_layers(x))


# ---- FlowNet family -------------------------------------------------------

def _conv(cin, cout, k=3, s=1):
    return nn.Sequential(QConv2d(cin, cout, k, s, (k - 1) // 2),
                         nn.LeakyReLU(LEAK))


def _iconv(cin, cout):
    return nn.Sequential(QConv2d(cin, cout, 3, 1, 1))


def _deconv(cin, cout):
    return nn.Sequential(QConvTranspose2d(cin, cout, 4, 2, 1),
                         nn.LeakyReLU(LEAK))


def _predict(cin):
    return QConv2d(cin, 2, 3, 1, 1)


def _upflow():
    return QConvTranspose2d(2, 2, 4, 2, 1, bias=False)


def correlation(f1, f2, md: int, s2: int, quant=_identity):
    """Cost volume (N, C, H, W) x2 -> (N, D*D, H, W): channel (dy, dx),
    dy-major, is the mean over C of f1[y, x] * f2[y + dy, x + dx], zero
    outside the map, for dy, dx in {-md, -md + s2, ..., md}."""
    n, c, h, w = f1.shape
    f1, f2 = quant(f1), quant(f2)
    f2p = F.pad(f2, (md, md, md, md))
    shifts = range(-md, md + 1, s2)
    out = [(f1 * f2p[:, :, md + dy:md + dy + h, md + dx:md + dx + w]).mean(1)
           for dy in shifts for dx in shifts]
    return torch.stack(out, 1)


class _Trunk(nn.Module):
    def _trunk(self):
        self.predict_flow6 = _predict(1024)
        self.upsampled_flow6_to_5 = _upflow()
        self.deconv5 = _deconv(1024, 512)
        self.predict_flow5 = _predict(1026)
        self.upsampled_flow5_to_4 = _upflow()
        self.deconv4 = _deconv(1026, 256)
        self.predict_flow4 = _predict(770)
        self.upsampled_flow4_to_3 = _upflow()
        self.deconv3 = _deconv(770, 128)
        self.predict_flow3 = _predict(386)
        self.upsampled_flow3_to_2 = _upflow()
        self.deconv2 = _deconv(386, 64)
        self.predict_flow2 = _predict(194)

    def refine(self, c2, c3, c4, c5, c6):
        f6 = self.predict_flow6(c6)
        x5 = torch.cat([c5, self.deconv5(c6), self.upsampled_flow6_to_5(f6)], 1)
        f5 = self.predict_flow5(x5)
        x4 = torch.cat([c4, self.deconv4(x5), self.upsampled_flow5_to_4(f5)], 1)
        f4 = self.predict_flow4(x4)
        x3 = torch.cat([c3, self.deconv3(x4), self.upsampled_flow4_to_3(f4)], 1)
        f3 = self.predict_flow3(x3)
        x2 = torch.cat([c2, self.deconv2(x3), self.upsampled_flow3_to_2(f3)], 1)
        return self.predict_flow2(x2)


class FlowNetS(_Trunk):
    """(N, in, H, W) -> quarter-resolution flow / div_flow (N, 2, H/4, W/4)."""

    def __init__(self, in_channels: int = 6):
        super().__init__()
        self.conv1 = _conv(in_channels, 64, 7, 2)
        self.conv2 = _conv(64, 128, 5, 2)
        self.conv3 = _conv(128, 256, 5, 2)
        self.conv3_1 = _conv(256, 256)
        self.conv4 = _conv(256, 512, 3, 2)
        self.conv4_1 = _conv(512, 512)
        self.conv5 = _conv(512, 512, 3, 2)
        self.conv5_1 = _conv(512, 512)
        self.conv6 = _conv(512, 1024, 3, 2)
        self.conv6_1 = _conv(1024, 1024)
        self._trunk()

    def forward(self, x):
        c2 = self.conv2(self.conv1(x))
        c3 = self.conv3_1(self.conv3(c2))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        return self.refine(c2, c3, c4, c5, c6)


class FlowNetC(_Trunk):
    """FlowNetCorr: both frames through conv1..conv3, their cost volume,
    the refinement trunk."""

    corr_quant = staticmethod(_identity)

    def __init__(self, max_displacement: int = 20, stride2: int = 2):
        super().__init__()
        self.md, self.s2 = max_displacement, stride2
        d = len(range(-max_displacement, max_displacement + 1, stride2))
        self.conv1 = _conv(3, 64, 7, 2)
        self.conv2 = _conv(64, 128, 5, 2)
        self.conv3 = _conv(128, 256, 5, 2)
        self.conv_redir = _conv(256, 32, 1, 1)
        self.conv3_1 = _conv(32 + d * d, 256)
        self.conv4 = _conv(256, 512, 3, 2)
        self.conv4_1 = _conv(512, 512)
        self.conv5 = _conv(512, 512, 3, 2)
        self.conv5_1 = _conv(512, 512)
        self.conv6 = _conv(512, 1024, 3, 2)
        self.conv6_1 = _conv(1024, 1024)
        self._trunk()

    def forward(self, x):
        c2a = self.conv2(self.conv1(x[:, :3]))
        c3a = self.conv3(c2a)
        c3b = self.conv3(self.conv2(self.conv1(x[:, 3:])))
        corr = F.leaky_relu(correlation(c3a, c3b, self.md, self.s2,
                                        self.corr_quant), LEAK)
        c3 = self.conv3_1(torch.cat([self.conv_redir(c3a), corr], 1))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        return self.refine(c2a, c3, c4, c5, c6)


class FlowNetSD(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = _conv(6, 64)
        self.conv1 = _conv(64, 64, 3, 2)
        self.conv1_1 = _conv(64, 128)
        self.conv2 = _conv(128, 128, 3, 2)
        self.conv2_1 = _conv(128, 128)
        self.conv3 = _conv(128, 256, 3, 2)
        self.conv3_1 = _conv(256, 256)
        self.conv4 = _conv(256, 512, 3, 2)
        self.conv4_1 = _conv(512, 512)
        self.conv5 = _conv(512, 512, 3, 2)
        self.conv5_1 = _conv(512, 512)
        self.conv6 = _conv(512, 1024, 3, 2)
        self.conv6_1 = _conv(1024, 1024)
        self.predict_flow6 = _predict(1024)
        self.upsampled_flow6_to_5 = _upflow()
        self.deconv5 = _deconv(1024, 512)
        self.inter_conv5 = _iconv(1026, 512)
        self.predict_flow5 = _predict(512)
        self.upsampled_flow5_to_4 = _upflow()
        self.deconv4 = _deconv(1026, 256)
        self.inter_conv4 = _iconv(770, 256)
        self.predict_flow4 = _predict(256)
        self.upsampled_flow4_to_3 = _upflow()
        self.deconv3 = _deconv(770, 128)
        self.inter_conv3 = _iconv(386, 128)
        self.predict_flow3 = _predict(128)
        self.upsampled_flow3_to_2 = _upflow()
        self.deconv2 = _deconv(386, 64)
        self.inter_conv2 = _iconv(194, 64)
        self.predict_flow2 = _predict(64)

    def forward(self, x):
        c1 = self.conv1_1(self.conv1(self.conv0(x)))
        c2 = self.conv2_1(self.conv2(c1))
        c3 = self.conv3_1(self.conv3(c2))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        f6 = self.predict_flow6(c6)
        x5 = torch.cat([c5, self.deconv5(c6), self.upsampled_flow6_to_5(f6)], 1)
        f5 = self.predict_flow5(self.inter_conv5(x5))
        x4 = torch.cat([c4, self.deconv4(x5), self.upsampled_flow5_to_4(f5)], 1)
        f4 = self.predict_flow4(self.inter_conv4(x4))
        x3 = torch.cat([c3, self.deconv3(x4), self.upsampled_flow4_to_3(f4)], 1)
        f3 = self.predict_flow3(self.inter_conv3(x3))
        x2 = torch.cat([c2, self.deconv2(x3), self.upsampled_flow3_to_2(f3)], 1)
        return self.predict_flow2(self.inter_conv2(x2))


class FlowNetFusion(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = _conv(11, 64)
        self.conv1 = _conv(64, 64, 3, 2)
        self.conv1_1 = _conv(64, 128)
        self.conv2 = _conv(128, 128, 3, 2)
        self.conv2_1 = _conv(128, 128)
        self.predict_flow2 = _predict(128)
        self.upsampled_flow2_to_1 = _upflow()
        self.deconv1 = _deconv(128, 32)
        self.inter_conv1 = _iconv(162, 32)
        self.predict_flow1 = _predict(32)
        self.upsampled_flow1_to_0 = _upflow()
        self.deconv0 = _deconv(162, 16)
        self.inter_conv0 = _iconv(82, 16)
        self.predict_flow0 = _predict(16)

    def forward(self, x):
        c0 = self.conv0(x)
        c1 = self.conv1_1(self.conv1(c0))
        c2 = self.conv2_1(self.conv2(c1))
        f2 = self.predict_flow2(c2)
        x1 = torch.cat([c1, self.deconv1(c2), self.upsampled_flow2_to_1(f2)], 1)
        f1 = self.predict_flow1(self.inter_conv1(x1))
        x0 = torch.cat([c0, self.deconv0(x1), self.upsampled_flow1_to_0(f1)], 1)
        return self.predict_flow0(self.inter_conv0(x0))


def warp(img, flow):
    """img (N, C, H, W) sampled bilinearly at (x + u, y + v), the
    coordinates clamped to the image (FlowNet2's Resample2d)."""
    n, c, h, w = img.shape
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device)
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device)[:, None]
    sx = (xs + flow[:, 0]).clamp(0, w - 1)
    sy = (ys + flow[:, 1]).clamp(0, h - 1)
    x0 = sx.floor().clamp(max=w - 2)
    y0 = sy.floor().clamp(max=h - 2)
    wx, wy = (sx - x0)[:, None], (sy - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    flat = img.reshape(n, c, h * w)

    def at(yi, xi):
        idx = (yi * w + xi).reshape(n, 1, h * w).expand(n, c, h * w)
        return flat.gather(2, idx).reshape(n, c, h, w)

    top = at(y0, x0) * (1 - wx) + at(y0, x0 + 1) * wx
    bot = at(y0 + 1, x0) * (1 - wx) + at(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def channel_norm(x):
    return x.square().sum(1, keepdim=True).sqrt()


def upsample4(flow):
    return F.interpolate(flow, scale_factor=4, mode="bilinear",
                         align_corners=False)


class FlowNet2(nn.Module):
    """C -> S -> S, with SD beside, fused at full resolution. (N, 6, H, W)
    -> full-resolution flow (N, 2, H, W) in pixels."""

    def __init__(self, div_flow: float = 20.0, max_displacement: int = 20,
                 stride2: int = 2):
        super().__init__()
        self.div_flow = div_flow
        self.flownetc = FlowNetC(max_displacement, stride2)
        self.flownets_1 = FlowNetS(12)
        self.flownets_2 = FlowNetS(12)
        self.flownets_d = FlowNetSD()
        self.flownetfusion = FlowNetFusion()

    def _stage(self, x, flow):
        warped = warp(x[:, 3:], flow)
        err = channel_norm(x[:, :3] - warped)
        return torch.cat([x, warped, flow / self.div_flow, err], 1)

    def forward(self, x):
        d = self.div_flow
        fc = upsample4(self.flownetc(x) * d)
        f1 = upsample4(self.flownets_1(self._stage(x, fc)) * d)
        f2 = upsample4(self.flownets_2(self._stage(x, f1)) * d)
        fsd = upsample4(self.flownets_d(x) / d)
        img1, img2 = x[:, :3], x[:, 3:]
        err_sd = channel_norm(img1 - warp(img2, fsd))
        err_s2 = channel_norm(img1 - warp(img2, f2))
        return self.flownetfusion(torch.cat(
            [img1, fsd, f2, channel_norm(fsd), channel_norm(f2), err_sd,
             err_s2], 1))


def flow_net(variant: str, div_flow: float, max_displacement: int,
             stride2: int) -> nn.Module:
    if variant == "flownet_c":
        return FlowNetC(max_displacement, stride2)
    if variant == "flownet_s":
        return FlowNetS()
    if variant == "flownet2":
        return FlowNet2(div_flow, max_displacement, stride2)
    raise KeyError(f"no reference for flow variant {variant!r}")


def full_res_output(variant: str) -> bool:
    """FlowNet2 emits full-resolution flow in pixels; FlowNetS/C a quarter-
    resolution flow over div_flow."""
    return variant == "flownet2"
