"""The port's PoseResNet and FlowNetS/C against the JAX models, on the CPU.

The JAX variables (random init, randomised batch-norm statistics) load into
the port through ``utils.convert`` with ``strict=True``; the same
numpy inputs go through both (NHWC <-> NCHW), at float32.
"""

from dataclasses import asdict, replace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowtrack_tpu.config import FlowConfig, ModelConfig
from flowtrack_tpu.models.flownet import get_flow_net as jax_flow_net
from flowtrack_tpu.models.pose_resnet import get_pose_net as jax_pose_net
from flowtrack_tpu_torch.models.flownet import FlowNetC, get_flow_net
from flowtrack_tpu_torch.models.layers import apply_precision_policy
from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
from flowtrack_tpu_torch.utils.convert import load_flownet, load_pose_resnet
from tests.test_torch_clip_pipeline import _random_variables

POSE_CFG = ModelConfig(num_layers=18, image_size=(64, 48),
                       heatmap_size=(16, 12), dtype="float32")


def _randomize_bn(variables, rng):
    def draw(path, a):
        lo_hi = (-0.2, 0.2) if path[-1].key == "mean" else (0.5, 1.5)
        return rng.uniform(*lo_hi, a.shape).astype(np.float32)

    out = dict(variables)
    if "batch_stats" in out:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            draw, out["batch_stats"])
    return out


def _init(model, shape, seed):
    return _random_variables(model, shape, seed)


@pytest.fixture(scope="module")
def pose_pair():
    jm = jax_pose_net(POSE_CFG)
    v = _randomize_bn(_init(jm, (1, 64, 48, 3), 0), np.random.default_rng(0))
    return jm, v, load_pose_resnet(get_pose_net(POSE_CFG), v)


@pytest.fixture(scope="module")
def flow_pairs():
    out = {}
    for i, variant in enumerate(("flownet_s", "flownet_c")):
        cfg = FlowConfig(variant=variant, dtype="float32")
        jm = jax_flow_net(cfg)
        v = _init(jm, (1, 64, 64, 6), i + 1)
        out[variant] = (jm, v, load_flownet(get_flow_net(cfg), v))
    return out


def test_pose_resnet18_matches_reference(pose_pair):
    """float32 heatmaps within 1e-4 of their peak magnitude (the same convs
    summed in another order through 18 layers)."""
    jm, v, tm = pose_pair
    x = np.random.default_rng(1).normal(size=(3, 64, 48, 3)).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * scale, rtol=0)


@pytest.mark.parametrize("variant", ["flownet_s", "flownet_c"])
def test_flownet_matches_reference(flow_pairs, variant):
    """Quarter-resolution flow at 64x64, float32: 1e-4 of the output's
    magnitude (FlowNetC's correlation is the plain version on the CPU)."""
    jm, v, tm = flow_pairs[variant]
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 6)).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 16, 16, 2)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)


def test_flownetc_shares_one_tower(flow_pairs):
    """Both frames go through the same conv1..conv3 modules: the state
    dict has one tower, and swapping the frames only changes the flow."""
    _, _, tm = flow_pairs["flownet_c"]
    names = set(tm.state_dict())
    assert "conv1.0.weight" in names and not any("conv1b" in n for n in names)
    assert {"conv_redir.0.weight", "conv3_1.0.weight", "deconv5.0.bias",
            "upsampled_flow6_to_5.weight"} <= names
    assert isinstance(tm, FlowNetC)
    assert tm.conv3_1[0].in_channels == 32 + 441


def test_deconv_layers_load_strictly(pose_pair):
    """reverse_pose_resnet's deconv names and shapes are the port's
    ConvTranspose2d(k=4, s=2, p=1): the strict load above went through, and
    each deconv doubles the resolution."""
    _, _, tm = pose_pair
    deconvs = [m for m in tm.deconv_layers
               if isinstance(m, torch.nn.ConvTranspose2d)]
    assert len(deconvs) == 3
    assert all(d.kernel_size == (4, 4) and d.stride == (2, 2)
               and d.padding == (1, 1) for d in deconvs)


def test_float32_models_switch_tf32_off():
    """Building a float32 model turns TF32 off for cuDNN and cuBLAS (the
    reference's Precision.HIGHEST); a bfloat16 model leaves them alone."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        apply_precision_policy(torch.bfloat16)
        assert torch.backends.cudnn.allow_tf32
        get_pose_net(POSE_CFG)
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        get_flow_net(FlowConfig(variant="flownet_s", dtype="float32"))
        assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def test_bfloat16_pose_runs_in_bfloat16_with_float32_params(pose_pair):
    """A bfloat16 config keeps float32 parameters, computes the convs in
    bfloat16 (autocast) and returns float32 heatmaps close to the float32
    model's (bf16 rounding through 18 layers: 5% of the peak)."""
    from dataclasses import replace

    _, v, tm32 = pose_pair
    tm16 = load_pose_resnet(get_pose_net(replace(POSE_CFG, dtype="bfloat16")),
                            v)
    assert all(p.dtype == torch.float32 for p in tm16.parameters())
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 3, 64, 48)).astype(np.float32))
    with torch.no_grad():
        want, got = tm32(x), tm16(x)
    assert got.dtype == torch.float32
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 0.05 * scale


@pytest.mark.parametrize("variant,cls", [
    ("flownet_s", "FlowNetS"), ("flownet_c", "FlowNetC"),
    ("flownet_sd", "FlowNetSD"), ("flownet2", "FlowNet2"),
    ("flownet2_cs", "FlowNet2CSS"), ("flownet2_css", "FlowNet2CSS")])
def test_every_flow_variant_builds(variant, cls):
    """Each FlowConfig variant builds its net (on the meta device: shapes
    only), with the config's glue dtype for the cascades; an unknown
    variant raises KeyError, as in the reference."""
    from flowtrack_tpu_torch.models import flownet as tflownet

    cfg = FlowConfig(variant=variant, glue_dtype="bfloat16")
    net = get_flow_net(cfg, device="meta")
    assert type(net).__name__ == cls and not net.training
    if variant.startswith("flownet2"):
        assert net.glue_dtype == torch.bfloat16 and net.div_flow == 20.0
    if variant.startswith("flownet2_"):
        assert net.stages == (1 if variant == "flownet2_cs" else 2)
        assert hasattr(net, "flownets_2") == (variant == "flownet2_css")
    with pytest.raises(KeyError):
        get_flow_net(replace(cfg, variant="flownet3"), device="meta")
    assert isinstance(net, getattr(tflownet, cls))


def test_smoke_flownet2_config_is_the_experiment_yaml():
    """chip_smoke.py builds the FlowNet2 path's config without PyYAML (the
    card's machine has none); its model and flow sections are those of
    experiments/flowtrack_posetrack_flownet2.yaml, glue float32, and its
    track section too but for the smoke's 8 persons."""
    import chip_smoke
    from flowtrack_tpu.config import get_config

    repo = Path(__file__).resolve().parents[1]
    want = get_config(str(repo / "experiments"
                          / "flowtrack_posetrack_flownet2.yaml"))
    got = chip_smoke.flownet2_config()
    assert asdict(got.model) == asdict(want.model)
    assert asdict(got.flow) == asdict(want.flow)
    assert asdict(replace(got.track, max_persons=want.track.max_persons)) \
        == asdict(want.track)
    assert got.flow.glue_dtype == "float32"
    assert got.flow.variant == "flownet2" and got.model.num_layers == 152


@pytest.mark.parametrize("net", ["pose", "flownet_s", "flownet_c"])
def test_reverse_converters_match_reference(net, pose_pair, flow_pairs):
    """The port's copies of the reference's tree-to-state-dict converters
    give the reference's names, dtypes and values, bitwise."""
    from flowtrack_tpu.utils import torch_convert as ref
    from flowtrack_tpu_torch.utils import convert

    v = pose_pair[1] if net == "pose" else flow_pairs[net][1]
    fn = "reverse_pose_resnet" if net == "pose" else "reverse_flownet"
    got, want = getattr(convert, fn)(v), getattr(ref, fn)(v)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
