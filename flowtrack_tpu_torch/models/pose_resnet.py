"""PoseResNet (Simple Baselines) in PyTorch.

Port of ``flowtrack_tpu/models/pose_resnet.py``: ``BasicBlock``,
``Bottleneck``, ``ResNetBackbone``, ``PoseResNet`` and ``get_pose_net``
(pose_resnet.py:39-150), depths 18 to 152. A ResNet backbone (ImageNet stem,
no avgpool/fc), ``num_deconv_layers`` x [ConvTranspose2d, BatchNorm, ReLU]
and a final conv to ``num_joints`` heatmaps at 1/4 of the input.

NCHW in, NCHW float32 heatmaps out. Module names are the lineage's
state-dict names (conv1, bn1, layerL.B.*, deconv_layers.N, final_layer), so
the reference's weights load through ``torch_convert.reverse_pose_resnet``
with ``strict=True`` (utils/convert.py).

``cfg.remat`` is the reference's ``nn.remat`` of each residual block
(pose_resnet.py:102-103): in train mode with gradients on, each block runs
under ``torch.utils.checkpoint``, so its activations are recomputed in the
backward instead of kept, and the numbers do not change.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from flowtrack_tpu_torch.config import ModelConfig
from flowtrack_tpu_torch.models.layers import (
    apply_precision_policy,
    compute_context,
    init_weights,
    torch_dtype,
)

RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _downsample(inplanes, planes, stride, device):
    return nn.Sequential(
        nn.Conv2d(inplanes, planes, 1, stride, bias=False, device=device),
        nn.BatchNorm2d(planes, device=device))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False,
                               device=device)
        self.bn1 = nn.BatchNorm2d(planes, device=device)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False,
                               device=device)
        self.bn2 = nn.BatchNorm2d(planes, device=device)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (_downsample(inplanes, planes, stride, device)
                           if downsample else None)

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 device=None):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False, device=device)
        self.bn1 = nn.BatchNorm2d(planes, device=device)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False,
                               device=device)
        self.bn2 = nn.BatchNorm2d(planes, device=device)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False, device=device)
        self.bn3 = nn.BatchNorm2d(out, device=device)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (_downsample(inplanes, out, stride, device)
                           if downsample else None)

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


@contextlib.contextmanager
def _running_stats_kept(block: nn.Module):
    """The recomputation of a checkpointed block runs its batch norms'
    train-mode forward a second time; inside this context it leaves their
    buffers as they are, so running mean, variance and
    ``num_batches_tracked`` are updated once, by the first run, as the
    reference's ``nn.remat`` updates ``batch_stats`` once. Momentum 0 makes
    the running update ``1 * running + 0 * batch``, which is ``running``
    bit for bit; ``num_batches_tracked`` set to None skips its increment.
    Both are attribute flips on the host: no device work, and the batch
    norm kernels and the tensors they save for the backward are those of
    the first run. The outputs do not depend on the buffers: train mode
    normalises by the batch's own statistics. The flips write the module's
    attribute and buffer dicts directly: ``nn.Module.__setattr__`` takes
    ~10 us a call, and a step of R152 makes 600 of them."""
    norms = [m for m in block.modules() if isinstance(m, nn.BatchNorm2d)]
    saved = [(m.momentum, m.num_batches_tracked) for m in norms]
    for m in norms:
        vars(m)["momentum"] = 0.0
        m._buffers["num_batches_tracked"] = None
    try:
        yield
    finally:
        for m, (momentum, tracked) in zip(norms, saved):
            vars(m)["momentum"] = momentum
            m._buffers["num_batches_tracked"] = tracked


def _remat(block: nn.Module, x):
    return checkpoint(block, x, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _running_stats_kept(block)))


class PoseResNet(nn.Module):
    """backbone -> deconv head -> heatmaps. ``forward``: (N, 3, H, W)
    -> (N, num_joints, H/4, W/4) float32. The backbone's modules sit at the
    top level (conv1, bn1, layer1..4), as the lineage names them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.dtype = torch_dtype(cfg.dtype)
        self.remat = cfg.remat
        apply_precision_policy(self.dtype)
        kind, stages = RESNET_SPECS[cfg.num_layers]
        block = Bottleneck if kind == "bottleneck" else BasicBlock
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False, device=device)
        self.bn1 = nn.BatchNorm2d(64, device=device)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for stage, num_blocks in enumerate(stages):
            planes = 64 * 2 ** stage
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(num_blocks):
                down = b == 0 and (stride != 1
                                   or inplanes != planes * block.expansion)
                blocks.append(block(inplanes, planes,
                                    stride if b == 0 else 1, down, device))
                inplanes = planes * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        head = []
        for i in range(cfg.num_deconv_layers):
            k = cfg.num_deconv_kernels[i]
            filters = cfg.num_deconv_filters[i]
            head += [nn.ConvTranspose2d(inplanes, filters, k, 2, (k - 2) // 2,
                                        bias=cfg.deconv_with_bias,
                                        device=device),
                     nn.BatchNorm2d(filters, device=device),
                     nn.ReLU(inplace=True)]
            inplanes = filters
        self.deconv_layers = nn.Sequential(*head)
        k = cfg.final_conv_kernel
        self.final_layer = nn.Conv2d(inplanes, cfg.num_joints, k, 1,
                                     (k - 1) // 2, device=device)

    def forward(self, x):
        layers = (self.layer1, self.layer2, self.layer3, self.layer4)
        with compute_context(x, self.dtype):
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            if self.remat and self.training and torch.is_grad_enabled():
                for block in (b for layer in layers for b in layer):
                    x = _remat(block, x)
            else:
                for layer in layers:
                    x = layer(x)
            x = self.final_layer(self.deconv_layers(x))
        return x.float()


def get_pose_net(cfg: ModelConfig, device=None,
                 generator: torch.Generator | None = None) -> PoseResNet:
    """The inference model in eval mode; with ``generator``, seeded random
    weights (the reference's initialisers, final conv normal(0, 0.001))."""
    model = PoseResNet(cfg, device=device)
    if generator is not None:
        init_weights(model, generator)
        with torch.no_grad():
            w = model.final_layer.weight
            w.copy_(torch.randn(w.shape, generator=generator) * 0.001)
    return model.eval()
