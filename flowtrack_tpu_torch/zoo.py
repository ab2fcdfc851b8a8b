"""The model zoo: one name -> the preset that builds its architecture and
the reference checkpoint it takes.

Port of ``flowtrack_tpu/zoo.py`` (``ZooEntry`` :20, ``ZOO`` :36,
``load_zoo_model`` :75), with the same 11 names, presets and checkpoint
names. Weights come from local files only: a torch state dict of the
lineage (``FlowNet2-C_checkpoint.pth.tar``'s ``state_dict``, a
``pose_resnet_50_256x192.pth``) loads into the port's module as it is,
since the module's names are the lineage's; the JAX package's ``.npz``
tree loads through ``utils/convert.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial
from typing import Callable

from flowtrack_tpu_torch.config import get_config
from flowtrack_tpu_torch.engine.checkpoint import load_npz_variables
from flowtrack_tpu_torch.models.flownet import get_flow_net
from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
from flowtrack_tpu_torch.utils.convert import (load_flow_tree,
                                               load_lineage_state_dict,
                                               load_pose_resnet)


@dataclass(frozen=True)
class ZooEntry:
    name: str
    config_name: str
    build: Callable              # cfg -> the port's module
    load_tree: Callable          # (module, the reference's tree) -> module
    reference_checkpoint: str    # what the reference calls it


def _build_pose(cfg):
    return get_pose_net(cfg.model)


def _build_flow(cfg):
    return get_flow_net(cfg.flow)


def _pose(depth, size):
    return ZooEntry(f"pose_resnet_{depth}_{size}", f"coco_res{depth}_{size}",
                    _build_pose, load_pose_resnet,
                    f"pose_resnet_{depth}_{size}.pth (COCO)")


def _flow(variant, config_name, checkpoint):
    return ZooEntry(variant, config_name, _build_flow,
                    partial(load_flow_tree, variant=variant),
                    f"{checkpoint}_checkpoint.pth.tar")


ZOO = {
    e.name: e for e in [
        _pose(50, "256x192"), _pose(50, "384x288"),
        _pose(101, "256x192"), _pose(101, "384x288"),
        _pose(152, "256x192"), _pose(152, "384x288"),
        _flow("flownet_s", "flownet_s", "FlowNet2-S"),
        _flow("flownet_c", "flownet_c", "FlowNet2-C"),
        # the FlowNet2 variants build from flownet_s with the variant
        # overridden (load_zoo_model)
        _flow("flownet2", "flownet_s", "FlowNet2"),
        _flow("flownet2_cs", "flownet_s", "FlowNet2-CS"),
        _flow("flownet2_css", "flownet_s", "FlowNet2-CSS"),
    ]
}


def load_zoo_model(name: str, torch_state_dict=None, npz_path=None):
    """-> (module on the CPU in eval mode, config, loaded).

    Give a torch state dict of the lineage, or the path of the reference's
    ``.npz``, or neither for the architecture alone (random init,
    ``loaded`` False)."""
    entry = ZOO[name]
    cfg = get_config(entry.config_name)
    if name in ("flownet2", "flownet2_cs", "flownet2_css"):
        cfg = replace(cfg, flow=replace(cfg.flow, variant=name))
    module = entry.build(cfg)
    loaded = True
    if torch_state_dict is not None:
        load_lineage_state_dict(module, torch_state_dict)
    elif npz_path is not None:
        entry.load_tree(module, load_npz_variables(npz_path))
    else:
        loaded = False
    return module.eval(), cfg, loaded
