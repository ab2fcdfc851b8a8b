"""The port's flow training against the JAX package, on the CPU: K2's and
the warp's autograd Functions against ``jax.vjp`` of the reference's XLA
versions (the VJPs its Pallas routes use) and ``gradcheck``, the FlowNets'
train mode, and ``flow_train_step`` for FlowNetS, FlowNetC (md 4) and the
FlowNet2-CS cascade against the reference's, on the same numpy inputs and
weights.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowtrack_tpu.config import Config as RefConfig
from flowtrack_tpu.config import FlowConfig, TrainConfig
from flowtrack_tpu.engine import flow_train as ref_flow_train
from flowtrack_tpu.engine.train import create_train_state as ref_state
from flowtrack_tpu.models.flownet import get_flow_net as jax_flow_net
from flowtrack_tpu.ops.correlation import correlation_xla
from flowtrack_tpu.ops.warp import resample2d as jax_resample2d
from flowtrack_tpu_torch.config import Config
from flowtrack_tpu_torch.engine.flow_train import flow_train_step
from flowtrack_tpu_torch.engine.loss import epe, multiscale_epe
from flowtrack_tpu_torch.engine.train import create_train_state
from flowtrack_tpu_torch.models.flownet import get_flow_net
from flowtrack_tpu_torch.ops import correlation as tcorr
from flowtrack_tpu_torch.ops import warp as twarp
from flowtrack_tpu_torch.utils.convert import (
    load_flownet,
    load_flownet2,
    named_parameters_from_tree,
    reverse_flownet,
    reverse_flownet2,
)

# float32 VJPs summed in another order: relative to the gradient's largest
# magnitude
GRAD_F32_REL = 1e-5


def _rel_err(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        np.abs(want).max(), 1e-30)


# --- K2 --------------------------------------------------------------------

@pytest.mark.parametrize("md,s2", [(4, 1), (4, 2), (6, 3)])
def test_correlation_backward_matches_jax_vjp(md, s2):
    """df1, df2 of the Function against jax.vjp of correlation_xla at
    float32, within 1e-5 of the largest gradient."""
    rng = np.random.default_rng(md * 10 + s2)
    f1 = rng.normal(size=(2, 7, 9, 5)).astype(np.float32)
    f2 = rng.normal(size=(2, 7, 9, 5)).astype(np.float32)
    d = len(tcorr.displacement_grid(md, s2))
    g = rng.normal(size=(2, 7, 9, d * d)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: correlation_xla(a, b, md, s2),
                     jnp.asarray(f1), jnp.asarray(f2))
    want1, want2 = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    a = torch.from_numpy(f1).requires_grad_()
    b = torch.from_numpy(f2).requires_grad_()
    out = tcorr.correlation(a, b, md, s2)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    assert _rel_err(a.grad.numpy(), want1) < GRAD_F32_REL
    assert _rel_err(b.grad.numpy(), want2) < GRAD_F32_REL


def test_correlation_gradcheck_float64():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(1, 3, 5, 6))).requires_grad_()
    b = torch.from_numpy(rng.normal(size=(1, 3, 5, 6))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, y: tcorr.correlation_nchw(x, y, 2, 1), (a, b))


def test_correlation_bf16_gradients_are_bf16():
    """bf16 features give bf16 gradients (float32 sums, rounded once),
    within a bf16 rounding of the float32 backward on the same values."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.normal(size=(1, 8, 5, 6)).astype(np.float32)
                         ).to(torch.bfloat16).requires_grad_()
    b = torch.from_numpy(rng.normal(size=(1, 8, 5, 6)).astype(np.float32)
                         ).to(torch.bfloat16).requires_grad_()
    out = tcorr.correlation_nchw(a, b, 2, 1)
    assert out.dtype == torch.float32
    g = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    out.backward(g)
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    w1, w2 = tcorr.correlation_backward(a.detach().float(), b.detach().float(),
                                        g, 2, 1)
    for got, want in ((a.grad, w1), (b.grad, w2)):
        assert _rel_err(got.float().numpy(), want.numpy()) < 2.0 ** -8


# --- the warp -------------------------------------------------------------

def _edge_flow(rng, n, h, w):
    """Flows with the clamp's ties: zero on every edge pixel (x + u = 0 on
    the left column, = W-1 on the right), samples landing exactly on the
    far edges, and others far off the frame; random inside."""
    flow = rng.uniform(-2.5, 2.5, (n, h, w, 2)).astype(np.float32)
    flow[:, :, 0] = 0.0
    flow[:, 0, :] = 0.0
    flow[:, :, -1] = 0.0
    flow[:, -1, :] = 0.0
    xs = np.arange(w, dtype=np.float32)
    flow[:, 2, :, 0] = (w - 1) - xs            # lands on x = W-1
    flow[:, 3, :, 0] = -xs                     # lands on x = 0
    flow[:, 4, :, 1] = 40.0                    # far below the frame
    return flow


@pytest.mark.parametrize("hw", [(7, 9), (1, 6), (6, 1)])
def test_warp_backward_matches_jax_vjp_with_edge_ties(hw):
    """dimg and dflow of the Function against jax.vjp of the reference's
    XLA resample2d, float32, with flows on the clamp's ties (gradient 1/2
    there, as jnp.clip splits them), off the frame (0) and degenerate
    one-row and one-column fields."""
    h, w = hw
    rng = np.random.default_rng(h * 100 + w)
    img = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    flow = (_edge_flow(rng, 2, h, w) if min(h, w) > 4 else
            rng.uniform(-2.5, 2.5, (2, h, w, 2)).astype(np.float32))
    g = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    _, vjp = jax.vjp(jax_resample2d, jnp.asarray(img), jnp.asarray(flow))
    want_img, want_flow = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    a = torch.from_numpy(img).requires_grad_()
    f = torch.from_numpy(flow).requires_grad_()
    out = twarp.resample2d(a, f)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(a.grad.numpy(), want_img, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f.grad.numpy(), want_flow, rtol=1e-5, atol=1e-5)


def test_warp_tie_gradient_is_half():
    """A zero flow on the left and top edges sits on the clamp's lower
    bound: the flow's gradient there is half the unclamped one."""
    img = torch.arange(20.0).reshape(1, 1, 4, 5)
    flow = torch.zeros(1, 2, 4, 5, requires_grad=True)
    twarp.resample2d_nchw(img, flow).sum().backward()
    du, dv = flow.grad[0]
    assert du[1, 0].item() == 0.5 and du[1, 2].item() == 1.0
    assert dv[0, 1].item() == 0.5 * 5.0 and dv[2, 1].item() == 5.0


def test_warp_gradcheck_float64():
    """Flows away from the integer grid (where the bilinear weights have no
    derivative) and inside the frame."""
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.normal(size=(1, 2, 5, 6))).requires_grad_()
    flow = torch.from_numpy(rng.uniform(0.1, 0.4, (1, 2, 5, 6))
                            * rng.choice([-1.0, 1.0], (1, 2, 5, 6)))
    flow[:, 0, :, 0] = 0.3
    flow[:, 1, 0, :] = 0.3
    flow[:, 0, :, -1] = -0.3
    flow[:, 1, -1, :] = -0.3
    flow.requires_grad_()
    assert torch.autograd.gradcheck(twarp.resample2d_nchw, (img, flow))


# --- the CUDA branch carries a gradient --------------------------------------

def test_cuda_branch_outputs_carry_grad_fn(monkeypatch):
    """With the dispatch sent down the kernel branch and the kernel
    wrappers replaced by stand-ins that fill a fresh tensor with the plain
    result (as the ctypes launch does: no grad_fn of its own), a
    grad-enabled call still returns a tensor with a grad_fn, and its
    backward is the plain backward's."""
    def fill(plain):
        def stand_in(*args):
            stand_in.launches += 1
            with torch.no_grad():
                return plain(*args).detach().clone()
        stand_in.launches = 0
        return stand_in

    corr = fill(lambda a, b, md, s2: tcorr.correlation_plain(
        a.permute(0, 2, 3, 1), b.permute(0, 2, 3, 1), md, s2
    ).permute(0, 3, 1, 2))
    warp = fill(twarp.resample2d_plain)
    monkeypatch.setattr(tcorr, "_runs_kernel", lambda t: True)
    monkeypatch.setattr(tcorr, "correlation_cuda", corr)
    monkeypatch.setattr(twarp, "_runs_kernel", lambda t: True)
    monkeypatch.setattr(twarp, "resample2d_cuda", warp)
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.normal(size=(1, 4, 5, 6)).astype(np.float32)
                         ).requires_grad_()
    b = torch.from_numpy(rng.normal(size=(1, 4, 5, 6)).astype(np.float32)
                         ).requires_grad_()
    out = tcorr.correlation_nchw(a, b, 2, 1)
    assert corr.launches == 1 and out.grad_fn is not None
    out.sum().backward()
    want = tcorr.correlation_backward(a.detach(), b.detach(),
                                      torch.ones_like(out), 2, 1)
    torch.testing.assert_close(a.grad, want[0], rtol=0, atol=0)
    img = a[:, :3].detach().clone().requires_grad_()
    flow = (b[:, :2].detach() * 0.5).requires_grad_()
    out = twarp.resample2d_nchw(img, flow)
    assert warp.launches == 1 and out.grad_fn is not None
    out.sum().backward()
    want = twarp.resample2d_backward(img.detach(), flow.detach(),
                                     torch.ones_like(out))
    torch.testing.assert_close(flow.grad, want[1], rtol=0, atol=0)


# --- train mode -------------------------------------------------------------

def _jax_init(model, shape, seed):
    v = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.zeros(shape), train=False)
    return jax.tree_util.tree_map(np.asarray, v)


def test_train_mode_returns_the_pyramid():
    """FlowNetS/C/SD give (flow2, ..., flow6) in float32 in train mode and
    flow2 in eval mode; a batch-norm FlowNetS moves its running statistics
    only in train mode; a cascade in train mode keeps its sub-nets in eval
    mode and gives one full-resolution flow."""
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(2, 6, 64, 64)).astype(np.float32))
    for variant in ("flownet_s", "flownet_c", "flownet_sd"):
        net = get_flow_net(FlowConfig(variant=variant, dtype="float32",
                                      corr_max_displacement=4),
                           "cpu", torch.Generator().manual_seed(0))
        with torch.no_grad():
            flow2 = net(x)
            pyramid = net.train()(x)
        assert [tuple(f.shape[2:]) for f in pyramid] == [
            (16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
        assert all(f.dtype == torch.float32 for f in pyramid)
        torch.testing.assert_close(pyramid[0], flow2, rtol=0, atol=0)
    bn = get_flow_net(FlowConfig(batch_norm=True, dtype="float32"), "cpu",
                      torch.Generator().manual_seed(0))
    before = bn.conv1[1].running_mean.clone()
    with torch.no_grad():
        bn(x)
        assert torch.equal(bn.conv1[1].running_mean, before)
        bn.train()(x)
    assert not torch.equal(bn.conv1[1].running_mean, before)
    cascade = get_flow_net(FlowConfig(variant="flownet2_cs", batch_norm=True,
                                      dtype="float32"), "cpu",
                           torch.Generator().manual_seed(0)).train()
    assert cascade.training
    assert not any(m.training for m in cascade.modules() if m is not cascade)
    with torch.no_grad():
        assert cascade(x).shape == (2, 2, 64, 64)


# --- flow_train_step against the reference's ---------------------------------

FLOW_CASES = {
    "flownet_s": FlowConfig(variant="flownet_s", dtype="float32"),
    "flownet_c": FlowConfig(variant="flownet_c", dtype="float32",
                            corr_max_displacement=4),
    "flownet2_cs": FlowConfig(variant="flownet2_cs", dtype="float32"),
}


def _flow_pair(variant):
    cfg = FLOW_CASES[variant]
    jm = jax_flow_net(cfg)
    v = _jax_init(jm, (1, 64, 64, 6), 11)
    tm = get_flow_net(cfg, "cpu")
    load = load_flownet2 if variant.startswith("flownet2") else load_flownet
    return cfg, jm, v, load(tm, v)


@pytest.mark.parametrize("variant", sorted(FLOW_CASES))
def test_flow_train_step_matches_reference(variant):
    """One SGD step of each on the same weights and batch: the loss and the
    full-resolution EPE within rtol 1e-5, and each parameter's update
    within 1e-4 of the largest update (float32 sums in another order
    through the net's depth)."""
    cfg, jm, v, tm = _flow_pair(variant)
    rng = np.random.default_rng(12)
    x = rng.normal(0, 0.3, (2, 64, 64, 6)).astype(np.float32)
    gt = rng.normal(0, 2.0, (2, 64, 64, 2)).astype(np.float32)
    train = TrainConfig(optimizer="sgd", lr=0.01)
    ref = ref_state(jm, RefConfig(train=train), None, None, variables=v)
    ref, ref_metrics = jax.jit(ref_flow_train.flow_train_step)(
        ref, {"input": jnp.asarray(x), "flow": jnp.asarray(gt)})
    state = create_train_state(tm, Config(train=train))
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    state, metrics = flow_train_step(
        state, {"input": torch.from_numpy(x), "flow": torch.from_numpy(gt)})
    for key in ("loss", "epe"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(ref_metrics[key]), rtol=1e-5)
    reverse = reverse_flownet2 if variant.startswith("flownet2") \
        else reverse_flownet
    moved = named_parameters_from_tree(
        tm, jax.tree.map(lambda a, b: np.asarray(a) - b,
                         ref.params, v["params"]), reverse)
    scale = max(np.abs(m).max() for m in moved.values())
    assert scale > 0
    for name, p in tm.named_parameters():
        got = (p.detach() - before[name]).numpy()
        assert np.abs(got - moved[name]).max() <= 1e-4 * scale, name


def test_multiscale_epe_matches_reference():
    from flowtrack_tpu.engine.loss import multiscale_epe as ref_ms

    rng = np.random.default_rng(13)
    gt = rng.normal(0, 3, (2, 64, 64, 2)).astype(np.float32)
    pyr = [rng.normal(size=(2, 64 // 2 ** (k + 2), 64 // 2 ** (k + 2), 2))
           .astype(np.float32) for k in range(5)]
    want = float(ref_ms([jnp.asarray(p) for p in pyr], jnp.asarray(gt)))
    got = float(multiscale_epe([torch.from_numpy(p) for p in pyr],
                               torch.from_numpy(gt)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    from flowtrack_tpu.engine.loss import epe as ref_epe

    np.testing.assert_allclose(
        epe(torch.from_numpy(pyr[0]), torch.from_numpy(pyr[0][::-1].copy()),
            mean=False).numpy(),
        np.asarray(ref_epe(jnp.asarray(pyr[0]), jnp.asarray(pyr[0][::-1]),
                           mean=False)), rtol=1e-6)


def test_flow_gradients_match_jax_at_float64():
    """FlowNetS, FlowNetC (md 4) and FlowNet2-CS (md 20) gradients per parameter
    against JAX with jax_enable_x64 in a subprocess
    (tests/torch_grad_x64.py), within 1e-6 of each parameter's largest
    gradient."""
    _run_x64("flow")


def _run_x64(which):
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, str(root / "tests/torch_grad_x64.py"), which],
        cwd=root, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert f"{which} fp64 grad parity OK" in res.stdout, res.stdout

