"""The ImageNet backbone init against the JAX package's, on the CPU:
``tools/train``'s ``--imagenet-backbone`` by the ``.npz`` and the ``.pth``
route against the reference's ``initial_variables``, and the numpy halves
(``convert_resnet_backbone``, ``overlay_backbone``, the tree form of
``init_backbone_from_imagenet``) against the reference's
``utils/torch_convert.py``.
"""

import argparse

import numpy as np
import torch

import jax.numpy as jnp

from flowtrack_tpu import config as ref_config
from flowtrack_tpu.engine.checkpoint import save_npz_variables as ref_save_npz
from flowtrack_tpu.models.pose_resnet import get_pose_net as ref_get_pose_net
from flowtrack_tpu.utils import torch_convert as tc
from flowtrack_tpu_torch.tools import train
from flowtrack_tpu_torch.utils import convert as cv
from flowtrack_tpu_torch.utils.convert import reverse_pose_resnet
from tests.oracles.pose_resnet_torch import random_pose_resnet
from tools import train as ref_train


def _torchvision(net):
    """A PoseResNet's backbone under torchvision's names, with an fc."""
    sd = {k: v for k, v in net.state_dict().items()
          if not k.startswith(("deconv_layers", "final_layer"))}
    sd["fc.weight"], sd["fc.bias"] = torch.ones(1000, 2048), torch.ones(1000)
    return sd


def test_imagenet_backbone_matches_reference(tmp_path):
    """tests/test_train_cli.py::test_initial_variables_backbone_npz's case:
    a torchvision-named R50 backbone (the oracle's, seed 7), through the
    port's --imagenet-backbone as the converted .npz and as the .pth (with
    an fc layer, which is ignored), gives bit for bit the backbone the
    reference's ``initial_variables`` gives; the head keeps the port's
    seeded init."""
    oracle = random_pose_resnet(50, seed=7)
    sd = {k: v for k, v in tc.state_dict_to_numpy(oracle.state_dict()).items()
          if not k.startswith(("deconv_layers", "final_layer"))}
    ref_save_npz(str(tmp_path / "bb.npz"), tc.convert_resnet_backbone(sd))
    pth = {k: torch.from_numpy(v) for k, v in sd.items()}
    pth["fc.weight"], pth["fc.bias"] = torch.zeros(1000, 2048), \
        torch.zeros(1000)
    torch.save(pth, tmp_path / "bb.pth")

    rcfg = ref_config.Config(model=ref_config.ModelConfig(
        num_layers=50, image_size=(64, 64), heatmap_size=(16, 16),
        dtype="float32"))
    want = reverse_pose_resnet(ref_train.initial_variables(
        argparse.Namespace(init_weights=None,
                           imagenet_backbone=str(tmp_path / "bb.npz")),
        ref_get_pose_net(rcfg.model), rcfg,
        jnp.zeros((1, 64, 64, 3), jnp.float32)))

    cfg = train.apply_overrides(train.get_config("coco_res50_256x192"), [
        "model.image_size=64,64", "model.heatmap_size=16,16",
        "model.dtype=float32"])
    fresh = train.initial_model(argparse.Namespace(
        init_weights=None, imagenet_backbone=None), cfg).state_dict()
    for path in ("bb.npz", "bb.pth"):
        got = train.initial_model(argparse.Namespace(
            init_weights=None, imagenet_backbone=str(tmp_path / path)),
            cfg).state_dict()
        for k, v in got.items():
            if k.endswith("num_batches_tracked"):
                continue
            if k.startswith(("deconv_layers", "final_layer")):
                torch.testing.assert_close(v, fresh[k], rtol=0, atol=0)
            else:
                np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
                np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_backbone_overlay_matches_reference():
    """The numpy halves of the ImageNet init on the reference's trees: a
    torchvision-named backbone (with fc) over full PoseResNet variables
    gives the reference's tree array for array, through
    ``init_backbone_from_imagenet`` and through ``overlay_backbone`` of
    ``convert_resnet_backbone``; the head keeps the variables' own."""
    fresh = tc.convert_pose_resnet(tc.state_dict_to_numpy(
        random_pose_resnet(50, seed=8).state_dict()))
    sd = tc.state_dict_to_numpy(_torchvision(random_pose_resnet(50, seed=9)))
    want = tc.init_backbone_from_imagenet(fresh, sd)

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,), np.asarray(v)

    for got in (cv.init_backbone_from_imagenet(fresh, sd),
                cv.overlay_backbone(fresh, cv.convert_resnet_backbone(sd))):
        got, ref = dict(flat(got)), dict(flat(want))
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))
    head = dict(flat(fresh["params"]["final"]))
    for k, v in flat(want["params"]["final"]):
        np.testing.assert_array_equal(v, head[k])
