"""The port's ``zoo``, ``tools/export_weights`` and ImageNet backbone init
against the JAX package's, on the CPU.

* ``export_weights``: the same lineage ``.pth`` (the repository's torch
  oracles, seeded) through both CLIs gives the same ``.npz`` array for
  array, bit for bit, and the same json line; ``--reverse`` of the
  reference's ``.npz`` gives the same ``.pth`` tensor for tensor.
* ``zoo``: the same 11 names, presets and checkpoint names;
  ``load_zoo_model`` with an oracle's state dict gives the reference's
  forward (both in the preset's bf16, within the tolerance stated), and an
  ``.npz`` of the reference's tree the same weights.
"""

import contextlib
import io
import json
import shutil
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flowtrack_tpu import zoo as ref_zoo
from flowtrack_tpu.engine.checkpoint import save_npz_variables as ref_save_npz
from flowtrack_tpu.utils import torch_convert as tc
from flowtrack_tpu_torch import zoo
from flowtrack_tpu_torch.tools import export_weights
from tests.oracles import flownet_torch as fo
from tests.oracles.pose_resnet_torch import random_pose_resnet
from tools import export_weights as ref_export_weights

# the oracle nets a kind's .pth comes from (pose: R50 with random batch
# norm statistics; backbone: its torchvision-named part with an fc layer)
ORACLES = {
    "pose": lambda: random_pose_resnet(50, seed=1).state_dict(),
    "backbone_imagenet": lambda: _torchvision(random_pose_resnet(50, seed=2)),
    "flownet_s": lambda: fo.random_net(fo.FlowNetSTorch, seed=3).state_dict(),
    "flownet_c": lambda: fo.random_net(fo.FlowNetCTorch, seed=4).state_dict(),
    "flownet_sd": lambda: fo.random_net(fo.FlowNetSDTorch,
                                        seed=5).state_dict(),
    "flownet_fusion": lambda: fo.random_net(fo.FlowNetFusionTorch,
                                            seed=6).state_dict(),
}
# load_zoo_model's forward in the preset's bf16, port against reference:
# max |diff| over max |reference| (bf16 rounding in other places through
# the net; read 4.1e-3)
ZOO_BF16_RTOL = 0.02


def _torchvision(net):
    sd = {k: v for k, v in net.state_dict().items()
          if not k.startswith(("deconv_layers", "final_layer"))}
    sd["fc.weight"], sd["fc.bias"] = torch.ones(1000, 2048), torch.ones(1000)
    return sd


def run_cli(main, argv=None):
    """A CLI's printed json line; the reference's reads sys.argv."""
    buf = io.StringIO()
    mp = pytest.MonkeyPatch()
    try:
        if argv is None:
            argv = []
        else:
            mp.setattr(sys, "argv", ["export_weights.py", *argv])
            argv = None
        with contextlib.redirect_stdout(buf):
            main(argv) if argv is not None else main()
    finally:
        mp.undo()
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def npz_arrays(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture
def weights_dir(tmp_path):
    """tmp_path, emptied after the test: a FlowNet2 case writes ~0.7 GB of
    weight files, which pytest would otherwise keep for three runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("kind", sorted(ORACLES))
def test_export_weights_matches_reference(kind, weights_dir):
    """Forward: the same .npz, array for array, and the same json line;
    then --reverse of that .npz (kinds the reference reverses): the same
    .pth tensor for tensor."""
    tmp_path = weights_dir
    pth = tmp_path / "in.pth"
    torch.save({"state_dict": {f"module.{k}": v
                               for k, v in ORACLES[kind]().items()}}, pth)
    outs = {}
    for who, main in (("ref", ref_export_weights.main),
                      ("port", export_weights.main)):
        out = str(tmp_path / f"{who}.npz")
        args = ["--kind", kind, "--pth", str(pth), "--out", out]
        line = run_cli(main, args) if who == "ref" else \
            run_cli(lambda a: main(args))
        assert line.pop("out") == out
        outs[who] = (line, npz_arrays(out))
    (ref_line, want), (port_line, got) = outs["ref"], outs["port"]
    assert port_line == ref_line
    assert got.keys() == want.keys() and len(got) == ref_line["num_arrays"]
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    if kind not in export_weights.REVERSERS:
        return
    sds = {}
    for who, main in (("ref", ref_export_weights.main),
                      ("port", export_weights.main)):
        out = str(tmp_path / f"{who}.pth")
        args = ["--kind", kind, "--reverse", "--npz",
                str(tmp_path / "ref.npz"), "--out", out]
        line = run_cli(main, args) if who == "ref" else \
            run_cli(lambda a: main(args))
        assert line == {"kind": kind, "out": out, "reverse": True,
                        "num_arrays": line["num_arrays"]}
        sds[who] = torch.load(out, weights_only=True)
    assert sds["port"].keys() == sds["ref"].keys()
    for k, v in sds["ref"].items():
        torch.testing.assert_close(sds["port"][k], v, rtol=0, atol=0, msg=k)


def test_export_weights_refuses_as_the_reference_does(tmp_path):
    with pytest.raises(SystemExit):
        export_weights.main(["--kind", "backbone_imagenet", "--reverse",
                             "--npz", "x.npz", "--out", "y.pth"])
    with pytest.raises(SystemExit):
        export_weights.main(["--kind", "pose", "--out", "y.npz"])
    assert sorted(export_weights.CONVERTERS) == \
        sorted(ref_export_weights.CONVERTERS)
    assert sorted(export_weights.REVERSERS) == \
        sorted(ref_export_weights.REVERSERS)


def test_zoo_entries_match_reference():
    assert list(zoo.ZOO) == list(ref_zoo.ZOO) and len(zoo.ZOO) == 11
    for name, want in ref_zoo.ZOO.items():
        got = zoo.ZOO[name]
        assert (got.name, got.config_name, got.reference_checkpoint) == \
            (want.name, want.config_name, want.reference_checkpoint)
    module, cfg, loaded = zoo.load_zoo_model("pose_resnet_152_384x288")
    assert not loaded and cfg.model.num_layers == 152
    assert not module.training
    for name in ("flownet2", "flownet2_cs", "flownet2_css"):
        _, cfg, _ = zoo.load_zoo_model(name)
        assert cfg.flow.variant == ref_zoo.load_zoo_model(name)[1].flow.variant


def test_zoo_load_gives_reference_forward(tmp_path):
    """FlowNetS from an oracle's state dict through both zoos: the port's
    module holds it bit for bit and its forward, in the preset's bf16, is
    the reference's within ZOO_BF16_RTOL; the reference's tree saved as .npz
    loads into the port's module as the same weights."""
    sd = fo.random_net(fo.FlowNetSTorch, seed=2).state_dict()
    module, cfg, loaded = zoo.load_zoo_model("flownet_s", torch_state_dict=sd)
    assert loaded and not module.training
    assert_holds(module, sd)
    rmodule, rcfg, variables = ref_zoo.load_zoo_model(
        "flownet_s", torch_state_dict=tc.state_dict_to_numpy(sd))
    assert cfg.name == rcfg.name and cfg.flow.dtype == "bfloat16"
    x = np.random.default_rng(0).normal(0, 1, (1, 64, 64, 6)).astype(
        np.float32)
    want = np.asarray(rmodule.apply(variables, jnp.asarray(x), train=False),
                      np.float32)
    with torch.no_grad():
        got = module(torch.from_numpy(x).permute(0, 3, 1, 2)).float()
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 16, 16, 2)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= ZOO_BF16_RTOL, err

    ref_save_npz(str(tmp_path / "w.npz"), variables)
    from_npz, _, loaded = zoo.load_zoo_model(
        "flownet_s", npz_path=str(tmp_path / "w.npz"))
    assert loaded
    assert_holds(from_npz, sd)


def test_zoo_loads_pose_weights(tmp_path):
    """PoseResNet-50 (the oracle, random batch norm statistics) from its
    state dict, and from the reference's converted tree as .npz: the same
    weights bit for bit."""
    sd = random_pose_resnet(50, seed=3).state_dict()
    module, cfg, loaded = zoo.load_zoo_model("pose_resnet_50_256x192",
                                             torch_state_dict=sd)
    assert loaded and cfg.model.image_size == (256, 192)
    assert_holds(module, sd)
    ref_save_npz(str(tmp_path / "p.npz"),
                 tc.convert_pose_resnet(tc.state_dict_to_numpy(sd)))
    module, _, _ = zoo.load_zoo_model("pose_resnet_50_256x192",
                                      npz_path=str(tmp_path / "p.npz"))
    assert_holds(module, sd)


def assert_holds(module, sd):
    own = module.state_dict()
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(own[k], v, rtol=0, atol=0, msg=k)
