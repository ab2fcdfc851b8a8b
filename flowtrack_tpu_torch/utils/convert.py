"""Load the reference package's weights into the port's modules.

The reference's variables (numpy trees of ``{"params", "batch_stats"}``, as
``flax`` init or an ``.npz`` checkpoint gives them) become lineage-named
state dicts through ``flowtrack_tpu.utils.torch_convert`` (numpy only, no
jax) and load with ``strict=True``, so a missing or extra name fails.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from flowtrack_tpu.utils.torch_convert import (
    reverse_flownet,
    reverse_flownet2,
    reverse_pose_resnet,
)


def _load(module: nn.Module, sd) -> nn.Module:
    state = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    module.load_state_dict(state, strict=True)
    return module


def load_pose_resnet(module: nn.Module, variables) -> nn.Module:
    """Reference PoseResNet variables -> the port's PoseResNet (in place)."""
    return _load(module, reverse_pose_resnet(variables))


def load_flownet(module: nn.Module, variables) -> nn.Module:
    """Reference FlowNetS / C / SD / Fusion variables -> the port's model."""
    return _load(module, reverse_flownet(variables))


def load_flownet2(module: nn.Module, variables) -> nn.Module:
    """Reference FlowNet2 variables -> the port's FlowNet2, or, given the
    subset of sub-nets they hold (``flownetc``, ``flownets_1`` and for CSS
    ``flownets_2``), its FlowNet2-CS / CSS."""
    return _load(module, reverse_flownet2(variables))
