"""Seeded random weights, made on the device in one draw per net.

The same state dict loads into the program's net and into the
benchmark's reference net (their parameter names are the lineage's), so
both sides compute with the same numbers. Convolutions are He-normal
(fan-in; a transposed convolution's fan-in is its input channels times
its kernel over its stride squared), biases zero, batch norm the identity.
The configuration file's ``weights`` section adds, by parameter name (a
glob): a batch-norm scale (``bn_scale``), so that a deep residual stack
keeps its activations in range, and a standard deviation or a constant
(``std``, ``fill``), which gives the pose head heatmaps whose peaks reach
the detection thresholds: with the lineage's own init (a final conv of
std 0.001) every pose of a random net scores under ``pose_score_thre``,
and the tracker's stages 3 and 4 would see no person at all.
"""

from __future__ import annotations

import fnmatch
import math

import numpy as np
import torch
from torch import nn


def _seed(seed: int, stream: int) -> int:
    state = np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)
    return int(state[0]) & (2 ** 63 - 1)


def _match(name: str, table: dict):
    for pattern, value in table.items():
        if fnmatch.fnmatchcase(name, pattern):
            return value
    return None


@torch.no_grad()
def make_state(net: nn.Module, seed: int, stream: int, rules: dict,
               device) -> dict:
    """A state dict for ``net``'s parameters and buffers from ``seed``:
    one normal draw on ``device`` for every weight, cut into the
    parameters and scaled. ``rules`` is the configuration's ``weights``
    section for this net."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, stream))
    convs = [(name, m) for name, m in net.named_modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    total = sum(m.weight.numel() for _, m in convs)
    draw = torch.randn(total, generator=gen, device=device)
    std_rules = rules.get("std", {})
    fill_rules = rules.get("fill", {})
    bn_rules = rules.get("bn_scale", {})
    state = {}
    at = 0
    for name, m in convs:
        w = m.weight
        if isinstance(m, nn.ConvTranspose2d):
            fan_in = w.shape[0] * w.shape[2] * w.shape[3] / (m.stride[0]
                                                              * m.stride[1])
        else:
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        std = _match(f"{name}.weight", std_rules)
        std = math.sqrt(2.0 / fan_in) if std is None else std
        state[f"{name}.weight"] = (draw[at:at + w.numel()] * std).view(
            w.shape)
        at += w.numel()
        if m.bias is not None:
            fill = _match(f"{name}.bias", fill_rules)
            state[f"{name}.bias"] = torch.full(m.bias.shape, fill or 0.0,
                                               device=device)
    for name, m in net.named_modules():
        if isinstance(m, nn.BatchNorm2d):
            scale = _match(f"{name}.weight", bn_rules)
            n = m.num_features
            state[f"{name}.weight"] = torch.full(
                (n,), 1.0 if scale is None else scale, device=device)
            state[f"{name}.bias"] = torch.zeros(n, device=device)
            state[f"{name}.running_mean"] = torch.zeros(n, device=device)
            state[f"{name}.running_var"] = torch.ones(n, device=device)
            state[f"{name}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.int64, device=device)
    return state
