"""The port's FlowNet2 cascade against the JAX models, on the CPU.

One random FlowNet2 variable tree in the reference's layout serves every
test: its structure comes from ``jax.eval_shape`` of ``FlowNet2.init`` (a
trace, no compile), its values from numpy (He-normal kernels, the flow
heads scaled down so that the cascade's flows stay within a few pixels of
a 64x64 frame, small random biases, so that a misplaced bias shows).
FlowNetSD and FlowNetFusion take their sub-trees, FlowNet2-CS/CSS the
subset of sub-nets they hold; every port model loads them through
``utils.convert`` with ``strict=True``. The JAX models use the XLA warp
(tests/test_flownet2_stack.py pins the Pallas cascade to it) and the XLA
correlation; the port runs its plain versions.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowtrack_tpu.config import Config, FlowConfig, ModelConfig
from flowtrack_tpu.models import flownet as jflownet
from flowtrack_tpu.models.pose_resnet import get_pose_net as jax_pose_net
from flowtrack_tpu.tracking.clip_pipeline import ClipTracker as JaxClipTracker
from flowtrack_tpu_torch.models import flownet as tflownet
from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker, pad_detections
from flowtrack_tpu_torch.utils.convert import (
    load_flownet,
    load_flownet2,
    load_pose_resnet,
)
from tests.test_torch_clip_pipeline import _random_variables

HW = 64
CASCADE_NETS = {"flownet2_cs": ("flownetc", "flownets_1"),
                "flownet2_css": ("flownetc", "flownets_1", "flownets_2")}


@pytest.fixture(scope="module")
def variables():
    shapes = jax.eval_shape(lambda: jflownet.FlowNet2().init(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 6)), train=False))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        if names[-1] == "kernel":
            std = np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
            if any(n.startswith("predict_flow") for n in names):
                std *= 0.3
            return rng.normal(0.0, std, leaf.shape).astype(np.float32)
        return rng.uniform(-0.05, 0.05, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _subset(variables, nets):
    return {"params": {k: variables["params"][k] for k in nets}}


def _pairs(seed, n=2, hw=HW):
    return np.random.default_rng(seed).normal(
        0, 0.3, (n, hw, hw, 6)).astype(np.float32)


def _jax(model, variables, x, jit=True):
    fn = lambda v, x: model.apply(v, x, train=False)
    if not jit:
        with jax.disable_jit():
            return np.asarray(fn(variables, jnp.asarray(x)))
    return np.asarray(jax.jit(fn)(variables, jnp.asarray(x)))


def _port(model, x):
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1).numpy()


def test_flownet_sd_matches_reference(variables):
    """Quarter-resolution flow at 64x64, float32: 1e-4 of its magnitude
    (the same convolutions summed in another order)."""
    sub = {"params": variables["params"]["flownets_d"]}
    x = _pairs(1)
    want = _jax(jflownet.FlowNetSD(dtype=jnp.float32), sub, x)
    got = _port(load_flownet(tflownet.FlowNetSD(), sub).eval(), x)
    assert got.shape == want.shape == (2, HW // 4, HW // 4, 2)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_flownet_fusion_matches_reference(variables):
    """The fusion net on an 11-channel full-resolution input: flow0 at
    64x64 within 1e-4 of its magnitude."""
    sub = {"params": variables["params"]["flownetfusion"]}
    x = np.random.default_rng(2).normal(0, 0.5, (2, HW, HW, 11)).astype(
        np.float32)
    want = _jax(jflownet.FlowNetFusion(dtype=jnp.float32), sub, x)
    got = _port(load_flownet(tflownet.FlowNetFusion(), sub), x)
    assert got.shape == want.shape == (2, HW, HW, 2)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("variant", ["flownet2", "flownet2_cs",
                                     "flownet2_css"])
def test_cascade_matches_reference(variables, variant):
    """The full-resolution flow of each cascade at 64x64, float32 glue:
    1e-4 of its magnitude. The cascade feeds each stage's flow through the
    warp into the next net, so differences of summation order compound
    (observed up to 2e-5)."""
    cfg = FlowConfig(variant=variant, dtype="float32")
    v = _subset(variables, CASCADE_NETS[variant]) \
        if variant in CASCADE_NETS else variables
    x = _pairs(3)
    want = _jax(jflownet.get_flow_net(cfg), v, x)
    got = _port(load_flownet2(tflownet.get_flow_net(cfg), v), x)
    assert got.shape == want.shape == (2, HW, HW, 2)
    assert tflownet.flow_output_is_full_res(variant)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_flownet2_bfloat16_glue_matches_reference(variables):
    """glue_dtype bfloat16 (float32 nets): the port rounds each glue
    operation to bf16 as the reference's code is written, which is what
    the JAX model computes op by op (``jax.disable_jit``): mean end-point
    error within 0.5% and max within 5% of the mean flow magnitude
    (observed 0.07% and 1.2%: a float32 difference of the upsampling can
    flip a bf16 rounding). The jitted JAX model lets XLA keep float32
    between bf16 casts; against it the port stays inside the bound the
    reference sets between its own bf16 and float32 glue
    (tests/test_flownet2_stack.py: 5% mean, 50% max; observed 0.5%,
    2.8%)."""
    cfg = FlowConfig(variant="flownet2", dtype="float32",
                     glue_dtype="bfloat16")
    x = _pairs(4)
    jm = jflownet.get_flow_net(cfg)
    tm = load_flownet2(tflownet.get_flow_net(cfg), variables)
    assert tm.glue_dtype == torch.bfloat16
    got = _port(tm, x)
    for jit, mean_tol, max_tol in ((False, 0.005, 0.05), (True, 0.05, 0.5)):
        want = _jax(jm, variables, x, jit=jit)
        epe = np.sqrt(((got - want) ** 2).sum(-1))
        scale = np.sqrt((want ** 2).sum(-1)).mean()
        assert scale > 0.05
        assert epe.mean() <= mean_tol * scale, (jit, epe.mean(), scale)
        assert epe.max() <= max_tol * scale, (jit, epe.max(), scale)


def test_cascades_warp_through_resample2d(monkeypatch):
    """FlowNet2 warps four times per forward (two stage inputs, two
    brightness errors), CS once and CSS twice, each through the port's
    resample2d dispatch (the warp kernel on a CUDA tensor)."""
    calls = []
    real = tflownet.resample2d_nchw

    def counting(img, flow):
        calls.append(tuple(img.shape))
        return real(img, flow)

    monkeypatch.setattr(tflownet, "resample2d_nchw", counting)
    x = torch.from_numpy(_pairs(5, n=1)).permute(0, 3, 1, 2)
    for variant, warps in (("flownet2", 4), ("flownet2_cs", 1),
                           ("flownet2_css", 2)):
        calls.clear()
        with torch.no_grad():
            tflownet.get_flow_net(FlowConfig(variant=variant,
                                             dtype="float32"))(x)
        assert calls == [(1, 3, HW, HW)] * warps, variant


def test_cascade_modules_carry_the_lineage_names(variables):
    """The sub-nets carry the reference's names, the S stages take 12
    channels and the fusion 11, and FlowNet2 has the JAX model's 162.5 M
    parameters."""
    net = tflownet.get_flow_net(FlowConfig(variant="flownet2"),
                                device="meta")
    assert [n for n, _ in net.named_children()] == [
        "flownetc", "flownets_1", "flownets_2", "flownets_d",
        "flownetfusion"]
    assert net.flownets_1.conv1[0].in_channels == 12
    assert net.flownetfusion.conv0[0].in_channels == 11
    assert net.flownets_d.inter_conv5[0].in_channels == 1026
    want = sum(int(np.prod(leaf.shape))
               for leaf in jax.tree_util.tree_leaves(variables))
    assert sum(p.numel() for p in net.parameters()) == want
    assert round(want / 1e6, 1) == 162.5


# ---------------------------------------------------- ClipTracker + FlowNet2

P = 3
FRAME_HW = (60, 64)   # not a multiple of 64: both resize branches run


def _clip_cfg():
    cfg = Config(model=ModelConfig(num_layers=18, image_size=(64, 48),
                                   heatmap_size=(16, 12), dtype="float32"),
                 flow=FlowConfig(variant="flownet2", dtype="float32",
                                 use_pallas_corr=False,
                                 use_pallas_warp=False))
    return replace(cfg, track=replace(cfg.track, max_persons=P,
                                      max_recovered=2, pose_score_thre=-1.0,
                                      track_oks_thre=0.1))


def _clip(t0, f, drop_at=None, seed=0):
    """Two persons on a textured background moving 1 px per frame, in
    60x64 frames; the second person's detection is dropped at global
    frame ``drop_at``."""
    rng = np.random.default_rng(seed)
    base = np.random.default_rng(98).uniform(0, 255, (*FRAME_HW, 3))
    frames = np.stack([np.clip(base + rng.normal(0, 3, base.shape), 0, 255)
                       for _ in range(f)]).astype(np.float32)
    boxes, scores = [], []
    for i in range(f):
        t = t0 + i
        b, s = [[8 + t, 10, 20, 30], [36, 10 + t, 18, 28]], [0.9, 0.8]
        if t == drop_at:
            b, s = b[:1], s[:1]
        boxes.append(b)
        scores.append(s)
    return (frames, *pad_detections(boxes, scores, P))


def test_clip_tracker_with_flownet2_matches_reference(variables):
    """Two chained 3-frame clips of 60x64 frames through R18 pose and the
    FlowNet2 cascade, float32, with a dropped detection in the second:
    the frames grow to the 64x64 net size, the fused full-resolution flow
    shrinks back through the antialiased resize. ids and valid equal; joints
    within 1e-3 px (observed 2e-5), maxvals and scores within 1e-5
    relative."""
    cfg = _clip_cfg()
    jpose = jax_pose_net(cfg.model)
    pv = _random_variables(jpose, (1, 64, 48, 3), 0)
    ref = JaxClipTracker(cfg, jpose, pv, jflownet.get_flow_net(cfg.flow),
                         variables)
    port = ClipTracker(cfg, load_pose_resnet(get_pose_net(cfg.model), pv),
                       load_flownet2(tflownet.get_flow_net(cfg.flow),
                                     variables), device="cpu")
    c1, c2 = _clip(0, 3), _clip(2, 3, drop_at=3, seed=1)
    want1, wseed = ref.track_clip(*c1, return_seed=True)
    want2 = ref.track_clip(*c2, seed=wseed, frame_offset=2)
    got1, gseed = port.track_clip(*c1, return_seed=True)
    got2 = port.track_clip(*c2, seed=gseed, frame_offset=2)
    for got, want in ((got1, want1), (got2, want2)):
        np.testing.assert_array_equal(got["ids"], want["ids"])
        np.testing.assert_array_equal(got["valid"], want["valid"])
        np.testing.assert_allclose(got["joints"], want["joints"], rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(got["maxvals"], want["maxvals"],
                                   rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5,
                                   atol=1e-9)
    assert got2["valid"][:, P:].any(), "the drop should be recovered"


def test_reverse_flownet2_matches_reference(variables):
    """The port's FlowNet2 tree-to-state-dict converter gives the
    reference's names and values, bitwise, for the full stack and the CSS
    subset."""
    from flowtrack_tpu.utils import torch_convert as ref
    from flowtrack_tpu_torch.utils import convert

    for v in (variables, _subset(variables, CASCADE_NETS["flownet2_css"])):
        got, want = convert.reverse_flownet2(v), ref.reverse_flownet2(v)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)
