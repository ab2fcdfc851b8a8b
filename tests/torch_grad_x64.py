"""float64 gradient parity of the port's train steps against JAX's.

    python tests/torch_grad_x64.py pose|flow

Run in a subprocess by tests/test_torch_train.py and
tests/test_torch_flow_train.py, because ``jax_enable_x64`` holds for the
whole process. The same float64 weights (the reference's init, cast) and
numpy batch go through the reference's models under ``jax.grad`` and the
port's under autograd, in train mode:

* pose: PoseResNet-18 at 64x48, batch 4, batch-statistics batch norm, the
  JointsMSELoss written out in float64; then one Adam step fed those
  gradients on both sides, optax's moments mapped onto the port's
  parameters;
* flow: FlowNetS and FlowNetC (md 4) on their (flow2..flow6) pyramids under
  the multi-scale EPE, and FlowNet2-CS (its FlowNetC at md 20, as both
  packages build it) on the full-resolution EPE, at 64x64, batch 2,
  written out in float64.

Both packages round each net's output to float32 (the reference's
``astype(jnp.float32)``, the port's ``.float()``), and the reference takes
the cost volume and the warp's coordinates in float32 at any dtype, where
the port keeps float64 ones for float64 inputs (so that ``gradcheck``
holds its Functions). Each parameter's gradient must lie within 1e-6 of its
largest magnitude (1e-5 for the cascade, whose sub-net flows are enlarged
x4 in float32 in both packages, by two formulas that round apart, before
the float64 glue); exits non-zero otherwise and prints the worst.
"""

import sys

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

REL_TOL = 1e-6
CASCADE_REL_TOL = 1e-5


def _init(model, shape, seed):
    v = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.zeros(shape), train=False)
    return jax.tree.map(lambda a: np.asarray(a, np.float64), v)


def _compare(tag, module, grads, reverse, tol=REL_TOL):
    from flowtrack_tpu_torch.utils.convert import named_parameters_from_tree

    want = named_parameters_from_tree(
        module, jax.tree.map(np.asarray, grads), reverse)
    worst = 0.0
    for name, p in module.named_parameters():
        got = p.grad.detach().numpy()
        scale = max(np.abs(want[name]).max(), 1e-30)
        err = float(np.abs(got - want[name]).max() / scale)
        worst = max(worst, err)
        assert err < tol, (tag, name, err)
    print(f"{tag}: worst relative err {worst:.3e} over {len(want)} params")


def pose():
    from flowtrack_tpu.config import ModelConfig
    from flowtrack_tpu.models.pose_resnet import get_pose_net as jax_pose
    from flowtrack_tpu_torch.config import ModelConfig as PortModelConfig
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from flowtrack_tpu_torch.utils.convert import (load_pose_resnet,
                                                   reverse_pose_resnet)

    rng = np.random.default_rng(0)
    jm = jax_pose(ModelConfig(num_layers=18, image_size=(64, 48),
                              heatmap_size=(16, 12), dtype="float64"))
    v = _init(jm, (1, 64, 48, 3), 0)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: rng.uniform(*((-0.2, 0.2) if p[-1].key == "mean"
                                   else (0.5, 1.5)), a.shape),
        v["batch_stats"])
    tm = get_pose_net(PortModelConfig(num_layers=18, image_size=(64, 48),
                                      heatmap_size=(16, 12),
                                      dtype="float32")).double()
    load_pose_resnet(tm, v)
    x = rng.normal(size=(4, 64, 48, 3))
    target = rng.uniform(0, 1, (4, 16, 16, 17))
    tw = (rng.uniform(0, 1, (4, 17)) > 0.3).astype(np.float64)

    def mse(pred, tgt, w, mean):
        p2 = pred.reshape(4, 256, 17) * w.reshape(4, 1, 17)
        t2 = tgt.reshape(4, 256, 17) * w.reshape(4, 1, 17)
        return mean(0.5 * mean((p2 - t2) ** 2, (0, 1)), None)

    def loss_fn(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]},
                          jnp.asarray(x), train=True, mutable=["batch_stats"])
        return mse(out.astype(jnp.float64), jnp.asarray(target),
                   jnp.asarray(tw), lambda a, ax: jnp.mean(a, ax))

    grads = jax.jit(jax.grad(loss_fn))(v["params"])
    tm.train()
    out = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    mse(out.double(), torch.from_numpy(target), torch.from_numpy(tw),
        lambda a, ax: a.mean(ax) if ax else a.mean()).backward()
    _compare("pose R18", tm, grads, reverse_pose_resnet)
    _adam_step("pose R18", tm, v["params"], grads, reverse_pose_resnet)
    print("pose fp64 grad parity OK")


def _adam_step(tag, module, params, grads, reverse):
    """One Adam step fed these gradients on both sides (the reference's
    make_optimizer, the port's): optax's first and second moments mapped
    onto the port's parameters, and the updated parameters, each within
    1e-6 of its largest magnitude."""
    import dataclasses

    from flowtrack_tpu.config import Config
    from flowtrack_tpu.engine.train import make_optimizer as ref_optimizer
    from flowtrack_tpu_torch.config import Config as PortConfig
    from flowtrack_tpu_torch.engine.train import TrainState, make_optimizer
    from flowtrack_tpu_torch.utils.convert import named_parameters_from_tree

    import optax

    tx, _ = ref_optimizer(Config(), 1)
    state = tx.init(params)
    updates, state = tx.update(grads, state, params)
    adam = state[0]
    want = {"exp_avg": adam.mu, "exp_avg_sq": adam.nu,
            "param": optax.apply_updates(params, updates)}
    port = TrainState(module, *make_optimizer(PortConfig(),
                                              module.parameters()))
    assert dataclasses.asdict(Config().train) == \
        dataclasses.asdict(PortConfig().train)
    port.apply_gradients()
    for key, tree in want.items():
        named = named_parameters_from_tree(
            module, jax.tree.map(np.asarray, tree), reverse)
        for name, p in module.named_parameters():
            got = (p if key == "param" else
                   port.optimizer.state[p][key]).detach().numpy()
            scale = max(np.abs(named[name]).max(), 1e-30)
            err = float(np.abs(got - named[name]).max() / scale)
            assert err < REL_TOL, (tag, key, name, err)
    print(f"{tag}: one Adam step, moments and parameters within {REL_TOL}")


def _pooled_epe64(flows, gt, mean, sqrt, div=20.0):
    total = 0.0
    for f, wt in zip(flows, (0.005, 0.01, 0.02, 0.08, 0.32)):
        n, h, w, c = f.shape
        k = gt.shape[1] // h
        pooled = mean(mean((gt / div).reshape(n, h, k, w, k, c), 4), 2)
        total = total + wt * mean(sqrt((((f - pooled) ** 2).sum(-1))), None)
    return total


def flow():
    from flowtrack_tpu.config import FlowConfig
    from flowtrack_tpu.models.flownet import get_flow_net as jax_flow
    from flowtrack_tpu_torch.models import flownet as port
    from flowtrack_tpu_torch.utils.convert import (load_flownet, load_flownet2,
                                                   reverse_flownet,
                                                   reverse_flownet2)

    rng = np.random.default_rng(1)
    x = rng.normal(0, 0.3, (2, 64, 64, 6))
    gt = rng.normal(0, 2.0, (2, 64, 64, 2))
    f64 = torch.float64
    cases = (
        ("FlowNetS", FlowConfig(variant="flownet_s", dtype="float64"),
         port.FlowNetS(dtype=f64), load_flownet, reverse_flownet),
        ("FlowNetC", FlowConfig(variant="flownet_c", dtype="float64",
                                corr_max_displacement=4),
         port.FlowNetC(max_displacement=4, dtype=f64), load_flownet,
         reverse_flownet),
        ("FlowNet2-CS", FlowConfig(variant="flownet2_cs", dtype="float64",
                                   glue_dtype="float64"),
         None, load_flownet2, reverse_flownet2),
    )
    for tag, cfg, tm, load, reverse in cases:
        jm = jax_flow(cfg)
        v = _init(jm, (1, 64, 64, 6), 2)
        if tm is None:
            tm = port.FlowNet2CSS(stages=1, dtype=f64, glue_dtype=f64)
        load(tm.double(), v)
        pyramid = cfg.variant != "flownet2_cs"

        def jax_loss(params):
            out = jm.apply({"params": params}, jnp.asarray(x), train=True)
            if pyramid:
                flows = [f.astype(jnp.float64) for f in out]
                return _pooled_epe64(flows, jnp.asarray(gt),
                                     lambda a, ax: jnp.mean(a, ax), jnp.sqrt)
            d = jnp.sqrt(((out.astype(jnp.float64) - gt) ** 2).sum(-1))
            return jnp.mean(d)

        grads = jax.jit(jax.grad(jax_loss))(v["params"])
        out = tm.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
        gt_t = torch.from_numpy(gt)
        if pyramid:
            flows = [f.double().permute(0, 2, 3, 1) for f in out]
            loss = _pooled_epe64(flows, gt_t,
                                 lambda a, ax: a.mean(ax) if ax else a.mean(),
                                 torch.sqrt)
        else:
            d = out.double().permute(0, 2, 3, 1) - gt_t
            loss = torch.sqrt((d ** 2).sum(-1)).mean()
        loss.backward()
        _compare(tag, tm, grads, reverse,
                 REL_TOL if pyramid else CASCADE_REL_TOL)
    print("flow fp64 grad parity OK")


if __name__ == "__main__":
    sys.path.insert(0, ".")
    {"pose": pose, "flow": flow}[sys.argv[1]]()
