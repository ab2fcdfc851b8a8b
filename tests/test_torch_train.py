"""The port's pose training against the JAX package, on the CPU: the loss
and the accuracy, the schedule and the optimizers against optax, batch
norm in train mode against ``BatchNormTorch``, the train step of an R18 at
64x48 against the reference's (float32 here, float64 gradients in a
subprocess), the eval step, and checkpoints both ways.
"""

from dataclasses import replace

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from flowtrack_tpu.config import Config as RefConfig
from flowtrack_tpu.config import ModelConfig as RefModelConfig
from flowtrack_tpu.config import TrainConfig as RefTrainConfig
from flowtrack_tpu.engine import checkpoint as ref_ckpt
from flowtrack_tpu.engine import loss as ref_loss
from flowtrack_tpu.engine import metrics as ref_metrics
from flowtrack_tpu.engine import train as ref_train
from flowtrack_tpu.models.layers import BatchNormTorch
from flowtrack_tpu.models.pose_resnet import get_pose_net as jax_pose_net
from flowtrack_tpu_torch.config import (COCO_FLIP_PAIRS, Config, ModelConfig,
                                        TrainConfig)
from flowtrack_tpu_torch.engine import checkpoint as ckpt
from flowtrack_tpu_torch.engine.loss import joints_mse_loss
from flowtrack_tpu_torch.engine.metrics import AverageMeter, heatmap_accuracy
from flowtrack_tpu_torch.engine.train import (
    TrainState,
    create_train_state,
    eval_step,
    make_lr_schedule,
    make_optimizer,
    train_step,
)
from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
from flowtrack_tpu_torch.utils import convert

POSE = dict(num_layers=18, image_size=(64, 48), heatmap_size=(16, 12),
            dtype="float32")


def _jax_pose(seed=0):
    jm = jax_pose_net(RefModelConfig(**POSE))
    v = jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 48, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(seed)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: rng.uniform(*((-0.2, 0.2) if p[-1].key == "mean"
                                   else (0.5, 1.5)), a.shape
                                 ).astype(np.float32), v["batch_stats"])
    return jm, v


def _port_pose(v):
    return convert.load_pose_resnet(get_pose_net(ModelConfig(**POSE)), v)


def _pose_batch(rng, n=4, hm=(16, 16)):
    return {"input": rng.normal(size=(n, 64, 48, 3)).astype(np.float32),
            "target": rng.uniform(0, 1, (n, *hm, 17)).astype(np.float32),
            "target_weight": (rng.uniform(0, 1, (n, 17)) > 0.3
                              ).astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# --- loss and metrics ---------------------------------------------------------

@pytest.mark.parametrize("weighted", [True, False])
def test_joints_mse_loss_matches_reference(weighted):
    rng = np.random.default_rng(0)
    b = _pose_batch(rng)
    pred = rng.normal(size=b["target"].shape).astype(np.float32)
    tw = b["target_weight"] if weighted else None
    want = float(ref_loss.joints_mse_loss(
        jnp.asarray(pred), jnp.asarray(b["target"]),
        None if tw is None else jnp.asarray(tw)))
    got = float(joints_mse_loss(torch.from_numpy(pred),
                                torch.from_numpy(b["target"]),
                                None if tw is None else torch.from_numpy(tw)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_heatmap_accuracy_matches_reference():
    """Peaks planted near the ground truth's (some within the 0.5 x size/10
    threshold, some not, one joint with no peak); the reference's [h, w]/10
    quirk included (a non-square map, so the quirk shows)."""
    from flowtrack_tpu.ops.heatmap import generate_target_batch

    rng = np.random.default_rng(1)
    n, k, hm = 6, 17, (16, 12)
    joints = rng.uniform(2, 40, (n, k, 2)).astype(np.float32)
    vis = np.ones((n, k), np.float32)
    vis[:, 3] = 0.0
    gt = np.array(generate_target_batch(jnp.asarray(joints), jnp.asarray(vis),
                                        hm, (64, 48), 2.0)[0])
    moved = joints + rng.normal(0, 4.0, joints.shape).astype(np.float32)
    pred = np.array(generate_target_batch(jnp.asarray(moved),
                                          jnp.asarray(np.ones_like(vis)),
                                          hm, (64, 48), 2.0)[0])
    want = ref_metrics.heatmap_accuracy(jnp.asarray(pred), jnp.asarray(gt))
    got = heatmap_accuracy(torch.from_numpy(pred), torch.from_numpy(gt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert 0.0 < float(got[0]) < 1.0 and float(got[1][3]) == -1.0


def test_average_meter_matches_reference():
    ours, theirs = AverageMeter(), ref_metrics.AverageMeter()
    for v, n in ((0.5, 2), (1.5, 1), (torch.tensor(2.0), 3)):
        ours.update(v, n)
        theirs.update(float(v), n)
    assert (ours.val, ours.sum, ours.count, ours.avg) == \
        (theirs.val, theirs.sum, theirs.count, theirs.avg)


# --- schedule and optimizers ---------------------------------------------------

def test_lr_schedule_matches_optax_at_the_boundaries():
    """x0.1 from step = boundary on (optax's piecewise_constant_schedule),
    at boundary - 1, boundary and boundary + 1 of both milestones."""
    cfg = Config(train=TrainConfig(lr_steps=(3, 5)))
    ref = ref_train.make_lr_schedule(RefConfig(
        train=RefTrainConfig(lr_steps=(3, 5))), 7)
    ours = make_lr_schedule(cfg, 7)
    for step in (0, 1, 20, 21, 22, 34, 35, 36, 100):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6)
    assert ours(20) == cfg.train.lr and ours(21) < ours(20)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizers_match_optax(name):
    """Five steps fed the same gradients, across an LR boundary (epoch 2 of
    2 steps each): each parameter within 1e-6 relative of optax's."""
    rng = np.random.default_rng(2)
    train = dict(optimizer=name, lr_steps=(1, 2), lr=0.01)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    tx, _ = ref_train.make_optimizer(RefConfig(train=RefTrainConfig(**train)),
                                     2)
    params = jax.tree.map(jnp.asarray, p0)
    opt_state = tx.init(params)
    ours = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in p0.items()}
    state = TrainState(None, *make_optimizer(
        Config(train=TrainConfig(**train)), list(ours.values()), 2))
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g),
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, p in ours.items():
            p.grad = torch.from_numpy(g[k])
        state.apply_gradients()
    for k, p in ours.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                   rtol=1e-6, atol=1e-7)


# --- batch norm in train mode --------------------------------------------------

def test_batchnorm_train_mode_matches_reference():
    """nn.BatchNorm2d in train mode is the reference's BatchNormTorch:
    two-pass batch variance in the normalisation, running variance stored
    with Bessel's correction, torch momentum 0.1 (the reference's 0.9),
    eps 1e-5; the output and both running statistics."""
    rng = np.random.default_rng(3)
    x = rng.normal(1.0, 2.0, (3, 5, 4, 6)).astype(np.float32)   # NHWC
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    mean0 = rng.normal(size=6).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}}
    want, mutated = BatchNormTorch(use_running_average=False).apply(
        v, jnp.asarray(x), mutable=["batch_stats"])
    bn = torch.nn.BatchNorm2d(6)
    assert (bn.momentum, bn.eps) == (0.1, 1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
        got = bn.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6, atol=1e-7)


# --- the pose train and eval steps ------------------------------------------------

def test_pose_train_step_matches_reference():
    """Three Adam steps of the R18 at 64x48, batch 4, float32, on the same
    weights (random batch-norm statistics) and batches: each step's loss
    within rtol 1e-5, accuracy and count equal, and after the first step
    every running statistic within 1e-5 of the reference's."""
    jm, v = _jax_pose()
    tm = _port_pose(v)
    rng = np.random.default_rng(4)
    batches = [_pose_batch(rng) for _ in range(3)]
    ref = ref_train.create_train_state(jm, RefConfig(), None, None,
                                       variables=v)
    ref_step = ref_train.make_jit_train_step(donate=False)
    state = create_train_state(tm, Config())
    for i, b in enumerate(batches):
        ref, want = ref_step(ref, {k: jnp.asarray(a) for k, a in b.items()})
        state, got = train_step(state, _torch(b))
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-5)
        assert float(got["cnt"]) == float(want["cnt"])
        np.testing.assert_allclose(float(got["acc"]), float(want["acc"]),
                                   atol=1e-6)
        if i == 0:
            stats = convert.convert_pose_resnet(tm.state_dict())["batch_stats"]
            for path, a in jax.tree_util.tree_flatten_with_path(
                    ref.batch_stats)[0]:
                node = stats
                for key in path:
                    node = node[key.key]
                np.testing.assert_allclose(node, np.asarray(a), rtol=1e-5,
                                           atol=1e-5,
                                           err_msg=jax.tree_util.keystr(path))
    assert state.step == int(ref.step) == 3


def test_pose_train_step_moves_and_keeps_float32_params():
    """A bfloat16 config trains under autocast with float32 parameters; the
    loss falls over steps on one batch and the running statistics move."""
    cfg = ModelConfig(**{**POSE, "dtype": "bfloat16"})
    tm = get_pose_net(cfg, "cpu", torch.Generator().manual_seed(0))
    state = create_train_state(tm, Config())
    b = _torch(_pose_batch(np.random.default_rng(5)))
    before = tm.bn1.running_mean.clone()
    losses = []
    for _ in range(4):
        state, m = train_step(state, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert not torch.equal(tm.bn1.running_mean, before)
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_pose_gradients_match_jax_at_float64():
    """Every parameter's gradient through the train-mode R18 within 1e-6 of
    its largest magnitude of JAX's under jax_enable_x64, in a subprocess
    (tests/torch_grad_x64.py)."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, str(root / "tests/torch_grad_x64.py"), "pose"],
        cwd=root, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "pose fp64 grad parity OK" in res.stdout, res.stdout


@pytest.mark.parametrize("flip", [True, False])
def test_eval_step_matches_reference(flip):
    jm, v = _jax_pose()
    tm = _port_pose(v)
    rng = np.random.default_rng(6)
    batch = {"input": rng.normal(size=(3, 64, 48, 3)).astype(np.float32),
             "center": rng.uniform(50, 150, (3, 2)).astype(np.float32),
             "scale": rng.uniform(0.5, 1.5, (3, 2)).astype(np.float32),
             "score": rng.uniform(0.5, 1.0, 3).astype(np.float32)}
    rc = RefConfig(model=RefModelConfig(**POSE))
    rc = replace(rc, test=replace(rc.test, flip_test=flip))
    want = ref_train.eval_step(jm, v, {k: jnp.asarray(a) for k, a in
                                       batch.items()}, rc, COCO_FLIP_PAIRS)
    got = eval_step(tm, _torch(batch), Config(test=replace(
        Config().test, flip_test=flip)), COCO_FLIP_PAIRS)
    assert not tm.training
    for key in ("maxvals", "scores"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-6)
    # joints: the same heatmap cell, or one cell apart where two peaks tie
    # within float32 noise
    np.testing.assert_allclose(got["preds"].numpy(), np.asarray(want["preds"]),
                               atol=1e-3)


# --- checkpoints ----------------------------------------------------------------

def test_checkpoint_manager_round_trip(tmp_path):
    """Save after steps, restore into a fresh state: parameters, running
    statistics, optimizer moments and the step equal; the best by score is
    tracked, the newest restored by default, the worst dropped past
    max_to_keep."""
    cfg = ModelConfig(**POSE)
    b = _torch(_pose_batch(np.random.default_rng(7)))
    state = create_train_state(
        get_pose_net(cfg, "cpu", torch.Generator().manual_seed(1)), Config())
    for _ in range(2):
        state, _ = train_step(state, b)
    mgr = ckpt.CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for epoch, perf in ((0, 0.3), (1, 0.7), (2, 0.5)):
        mgr.save(epoch, state, perf=perf)
    assert mgr.best_epoch == 1 and mgr.latest_epoch == 2
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("*.pt")) == [
        "epoch_000001.pt", "epoch_000002.pt"]
    fresh = create_train_state(get_pose_net(cfg), Config())
    fresh, epoch = ckpt.CheckpointManager(str(tmp_path / "ckpt")).restore(fresh)
    assert epoch == 2 and fresh.step == 2
    for (k, a), (_, bb) in zip(state.model.state_dict().items(),
                               fresh.model.state_dict().items()):
        torch.testing.assert_close(a, bb, rtol=0, atol=0, msg=k)
    sa, sb = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    for i, moments in sa["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(moments[key], sb["state"][i][key],
                                       rtol=0, atol=0)
    # one more step from the restored state equals one from the original
    _, m1 = train_step(state, b)
    _, m2 = train_step(fresh, b)
    assert float(m1["loss"]) == float(m2["loss"])


def test_reference_npz_loads_into_the_port(tmp_path):
    """The reference's .npz (its save_npz_variables) read by the port's
    load_npz_variables and loaded through utils/convert gives the
    reference's heatmaps."""
    jm, v = _jax_pose(3)
    ref_ckpt.save_npz_variables(str(tmp_path / "ref.npz"), v)
    tm = convert.load_pose_resnet(get_pose_net(ModelConfig(**POSE)),
                                  ckpt.load_npz_variables(
                                      str(tmp_path / "ref.npz")))
    x = np.random.default_rng(8).normal(size=(2, 64, 48, 3)).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["pose", "flownet_c", "flownet2_cs"])
def test_port_npz_loads_into_the_reference(tmp_path, kind):
    """A port model after a train step (so its running statistics and
    weights are its own) saved by save_npz_variables through the forward
    converters, read by the reference's load_npz_variables: the same tree
    structure as the reference's init and the same outputs."""
    from flowtrack_tpu.config import FlowConfig as RefFlowConfig
    from flowtrack_tpu.models.flownet import get_flow_net as jax_flow_net
    from flowtrack_tpu_torch.config import FlowConfig
    from flowtrack_tpu_torch.engine.flow_train import flow_train_step
    from flowtrack_tpu_torch.models.flownet import get_flow_net

    rng = np.random.default_rng(9)
    gen = torch.Generator().manual_seed(2)
    if kind == "pose":
        tm = get_pose_net(ModelConfig(**POSE), "cpu", gen)
        state = create_train_state(tm, Config())
        train_step(state, _torch(_pose_batch(rng)))
        tree = convert.convert_pose_resnet(tm.state_dict())
        jm, shape = jax_pose_net(RefModelConfig(**POSE)), (2, 64, 48, 3)
    else:
        fc = dict(variant=kind, dtype="float32", batch_norm=True)
        tm = get_flow_net(FlowConfig(**fc), "cpu", gen)
        state = create_train_state(tm, Config())
        flow_train_step(state, {
            "input": torch.from_numpy(rng.normal(0, .3, (2, 64, 64, 6))
                                      .astype(np.float32)),
            "flow": torch.from_numpy(rng.normal(size=(2, 64, 64, 2))
                                     .astype(np.float32))})
        tree = (convert.convert_flownet2 if kind.startswith("flownet2")
                else convert.convert_flownet_c)(tm.state_dict())
        jm, shape = jax_flow_net(RefFlowConfig(**fc)), (2, 64, 64, 6)
    ckpt.save_npz_variables(str(tmp_path / "port.npz"), tree)
    v = ref_ckpt.load_npz_variables(str(tmp_path / "port.npz"))
    init = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                          jnp.zeros(shape), train=False))
    assert jax.tree.structure(init) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(init), jax.tree.leaves(v)):
        assert a.shape == b.shape
    x = rng.normal(0, 0.3, shape).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_named_parameters_from_tree_covers_every_parameter():
    """A params-shaped tree of the reference (its init) maps onto every
    named parameter of the port, shapes equal, each value the one the
    weight converters give."""
    _, v = _jax_pose()
    tm = _port_pose(v)
    named = convert.named_parameters_from_tree(tm, v["params"])
    assert set(named) == {k for k, _ in tm.named_parameters()}
    for k, p in tm.named_parameters():
        np.testing.assert_array_equal(named[k], p.detach().numpy())
