"""The pose reference of Simple Baselines (arXiv:1804.06208): PoseResNet,
a ResNet of bottleneck blocks with a deconvolution head, in plain float32
PyTorch (the pose contract of ``nets.py``)."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from portbench.reference.nets import QConv2d, QConvTranspose2d

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


def build(config: dict, device) -> nn.Module:
    """The configuration's PoseResNet (its ``model`` section)."""
    m = config["model"]
    net = PoseResNet(m["num_layers"], m["num_joints"], m["num_deconv_filters"],
                     m["num_deconv_kernels"], m["final_conv_kernel"])
    return net.to(device).eval()
