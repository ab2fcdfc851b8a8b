"""What the port's CLIs share: the ``--device`` argument and the loading of
weights into the port's nets.

Weights are the JAX package's ``.npz`` trees (``engine/checkpoint.
load_npz_variables``), carried into the port's modules by
``utils/convert.py``, so one file gives both packages the same nets; any
other file is a torch state dict in the lineage's names (a ``.pth``,
optionally wrapped in ``{"state_dict": ...}`` and with ``module.``
prefixes), loaded as it is.
"""

from __future__ import annotations

import argparse

import torch

from flowtrack_tpu_torch.config import Config
from flowtrack_tpu_torch.engine.checkpoint import load_npz_variables
from flowtrack_tpu_torch.models.flownet import get_flow_net
from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
from flowtrack_tpu_torch.utils.convert import (load_flow_tree,
                                               load_lineage_state_dict,
                                               load_pose_resnet)


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (the default) needs a CUDA "
                         "card and raises without one; 'cpu' runs the "
                         "plain versions of the kernels")


def load_torch_state_dict(module: torch.nn.Module, path: str):
    """A torch state dict file -> ``module`` (in place). Every tensor must
    match a name of the module; a missing ``num_batches_tracked`` (older
    torch) is allowed."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    try:
        return load_lineage_state_dict(module, sd)
    except KeyError as e:
        raise KeyError(f"{path}: {e.args[0]}") from None


def pose_net(cfg: Config, path: str) -> torch.nn.Module:
    """cfg.model's PoseResNet (on the CPU, eval mode) with the weights of
    ``path``."""
    model = get_pose_net(cfg.model)
    if path.endswith(".npz"):
        return load_pose_resnet(model, load_npz_variables(path)).eval()
    return load_torch_state_dict(model, path).eval()


def flow_net(cfg: Config, path: str) -> torch.nn.Module:
    """cfg.flow's flow net (on the CPU, eval mode) with the weights of
    ``path``."""
    model = get_flow_net(cfg.flow)
    if path.endswith(".npz"):
        return load_flow_tree(model, load_npz_variables(path),
                              cfg.flow.variant).eval()
    return load_torch_state_dict(model, path).eval()
