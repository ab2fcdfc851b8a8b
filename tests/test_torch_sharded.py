"""The port's data-parallel training against the unsharded step and the JAX
package's sharded step, on the CPU.

The sharded steps run in 2 and 4 gloo ranks on the CPU, one a mesh slot
(``parallel/distributed.train_steps_on_mesh``), each rank spawned and
importing only the port; one spawn per mesh size, the two at once, serves
every case through a module fixture. Held: ``GlobalBatchNorm2d``'s output
and running statistics against ``nn.BatchNorm2d`` on the whole batch; the
sharded pose (R18 at 64x48) and flow (FlowNetC, on the reference's weights)
steps against the unsharded steps on the global batch within the
reference's 1e-6 (tests/test_sharded_eval.py:89-94), with SGD, which is
linear in the gradient (Adam's first step, about sign(grad), would turn the
reduction's float32 noise into steps of the learning rate); the sharded
steps against the reference's steps on its virtual CPU mesh within the
port's train-parity tolerances; and the train CLIs on a 2-slot mesh against
one slot with the global batch.
"""

import copy
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from flowtrack_tpu import parallel as ref_parallel
from flowtrack_tpu.config import Config as RefConfig
from flowtrack_tpu.config import ModelConfig as RefModelConfig
from flowtrack_tpu.config import TrainConfig as RefTrainConfig
from flowtrack_tpu.engine import flow_train as ref_flow_train
from flowtrack_tpu.engine import train as ref_train
from flowtrack_tpu.models.flownet import get_flow_net as ref_flow_net
from flowtrack_tpu_torch.config import Config, FlowConfig, ModelConfig, TrainConfig
from flowtrack_tpu_torch.engine.flow_train import flow_train_step
from flowtrack_tpu_torch.engine.train import create_train_state, train_step
from flowtrack_tpu_torch.models.flownet import get_flow_net
from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
from flowtrack_tpu_torch.parallel import distributed, make_mesh
from flowtrack_tpu_torch.parallel.distributed import (GlobalBatchNorm2d,
                                                      convert_global_bn,
                                                      train_steps_on_mesh)
from flowtrack_tpu_torch.utils.convert import load_flownet
from tests.test_sharded_eval import Tiny
from tests.test_torch_clip_pipeline import _random_variables

CPU = torch.device("cpu")
SGD = TrainConfig(optimizer="sgd", lr=0.01)
# R18's heatmaps at 64x48 crops are 16x16 (layer4 rounds 1.5 up to 2)
POSE_CFG = Config(model=ModelConfig(num_layers=18, image_size=(64, 48),
                                    heatmap_size=(16, 16), dtype="float32"),
                  train=SGD)
FLOW_CFG = Config(flow=FlowConfig(variant="flownet_c", dtype="float32",
                                  corr_max_displacement=4), train=SGD)
GLOBAL = 8          # the global pose batch; the flow batch is half of it


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module (and the ranks it spawns): the
    whole suite runs in six workers on the host's cores at once, and
    torch's pool of spinning threads slowed these tests a hundredfold
    there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pose_batches(rng, n=GLOBAL, hw=(64, 48), hm=(16, 16), steps=2):
    return [{"input": rng.normal(size=(n, *hw, 3)).astype(np.float32),
             "target": rng.uniform(0, 1, (n, *hm, 17)).astype(np.float32),
             "target_weight": (rng.uniform(0, 1, (n, 17)) > 0.3
                               ).astype(np.float32)} for _ in range(steps)]


def _flow_batches(rng, n=GLOBAL // 2):
    return [{"input": rng.normal(0, 0.3, (n, 64, 64, 6)).astype(np.float32),
             "flow": rng.normal(0, 2.0, (n, 64, 64, 2)).astype(np.float32)}]


def _tiny_twin():
    """The reference test's Tiny as torch layers (SAME padding of a 3x3
    stride-4 conv on 32x24 pads nothing)."""
    return nn.Sequential(nn.Conv2d(3, 8, 3, stride=4), nn.BatchNorm2d(8),
                         nn.ReLU(), nn.Conv2d(8, 17, 1))


def _load_tiny(net, params):
    conv0, bn, conv1 = params["Conv_0"], params["BatchNorm_0"], \
        params["Conv_1"]
    with torch.no_grad():
        for m, p in ((net[0], conv0), (net[3], conv1)):
            m.weight.copy_(torch.from_numpy(
                np.asarray(p["kernel"]).transpose(3, 2, 0, 1).copy()))
            m.bias.copy_(torch.from_numpy(np.array(p["bias"])))
        net[1].weight.copy_(torch.from_numpy(np.array(bn["scale"])))
        net[1].bias.copy_(torch.from_numpy(np.array(bn["bias"])))
    return net


def _unsharded(kind, model, cfg, batches):
    """The one-device steps on the global batches: (model, metrics)."""
    state = create_train_state(model, cfg)
    metrics = []
    for b in batches:
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        if kind == "pose":
            state, m = train_step(state, tb, cfg.train.use_target_weight)
        else:
            state, m = flow_train_step(state, tb)
        metrics.append({k: float(v) for k, v in m.items()})
    return model, metrics


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(21)
    gen = torch.Generator().manual_seed(3)
    bn = nn.BatchNorm2d(5)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.uniform_(-0.5, 0.5, generator=gen)
    tiny = Tiny()
    x32 = rng.normal(size=(GLOBAL, 32, 24, 3)).astype(np.float32)
    ref_cfg = RefConfig(model=RefModelConfig(image_size=(32, 24),
                                             heatmap_size=(8, 6)),
                        train=RefTrainConfig(optimizer="sgd", lr=0.01))
    ref_state = ref_train.create_train_state(tiny, ref_cfg,
                                             jax.random.PRNGKey(0),
                                             jnp.asarray(x32[:1]))
    # FlowNetC (md 4) as the reference's variables, drawn with its own
    # initializers, and the port's net loaded from them
    jflow = ref_flow_net(FLOW_CFG.flow)
    jflow_vars = _random_variables(jflow, (1, 64, 64, 6), 11)
    tflow = load_flownet(get_flow_net(FLOW_CFG.flow), jflow_vars)
    return {
        "bn": (bn, rng.normal(2.0, 3.0, (GLOBAL, 5, 6, 7)).astype(
            np.float32)),
        "pose": (get_pose_net(POSE_CFG.model, generator=gen),
                 _pose_batches(rng)),
        "flow": (tflow, jflow, jflow_vars, _flow_batches(rng)),
        "tiny": (_load_tiny(_tiny_twin(), ref_state.params), ref_state,
                 _pose_batches(rng, hw=(32, 24), hm=(8, 6), steps=1)),
    }


@pytest.fixture(scope="module")
def spawns(cases):
    """Every case's sharded run on meshes of 2 and 4 CPU slots, one spawn
    of that many gloo ranks each, both at once: {slots: {case: rank 0's
    result}}; the reference's Tiny on 2 slots only."""
    from concurrent.futures import ThreadPoolExecutor

    def jobs(n):
        out = [{"kind": "forward", "model": cases["bn"][0],
                "batches": [cases["bn"][1]]},
               {"kind": "pose", "model": cases["pose"][0], "cfg": POSE_CFG,
                "batches": cases["pose"][1]},
               {"kind": "flow", "model": cases["flow"][0], "cfg": FLOW_CFG,
                "batches": cases["flow"][3]}]
        if n == 2:
            out.append({"kind": "pose", "model": cases["tiny"][0],
                        "cfg": replace(POSE_CFG, model=ModelConfig(
                            image_size=(32, 24), heatmap_size=(8, 6))),
                        "batches": cases["tiny"][2]})
        return out

    with ThreadPoolExecutor(2) as pool:
        runs = {n: pool.submit(train_steps_on_mesh,
                               make_mesh(0, devices=[CPU] * n), jobs(n))
                for n in (2, 4)}
        return {n: dict(zip(["bn", "pose", "flow", "tiny"], r.result()))
                for n, r in runs.items()}


def _assert_states_close(got, model, atol=1e-6, rtol=1e-5):
    want = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        if v.is_floating_point():
            torch.testing.assert_close(got[k], v, atol=atol, rtol=rtol,
                                       msg=k)
        else:
            assert torch.equal(got[k], v), k


@pytest.mark.parametrize("n", [2, 4])
def test_global_batchnorm_matches_batchnorm_on_the_whole_batch(cases, spawns,
                                                                n):
    """Each rank normalises with the global batch: rank 0's part of the
    output and every rank's running statistics (unbiased variance of the
    global count, one batch tracked) equal nn.BatchNorm2d's on the whole
    batch."""
    got = spawns[n]
    bn, x = cases["bn"]
    whole = copy.deepcopy(bn).train()
    with torch.no_grad():
        y = whole(torch.from_numpy(x))
    torch.testing.assert_close(got["bn"]["output"], y[:GLOBAL // n],
                               atol=1e-5, rtol=1e-5)
    _assert_states_close(got["bn"]["state"], whole)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_pose_step_matches_unsharded(cases, spawns, n):
    """R18's sharded steps (global batch norms, averaged gradients): each
    step's loss within 1e-6 relative, accuracy and count of the global
    batch, every parameter and running statistic within 1e-6."""
    got = spawns[n]
    model, batches = cases["pose"]
    want_model, want = _unsharded("pose", copy.deepcopy(model), POSE_CFG,
                                  batches)
    for g, w in zip(got["pose"]["metrics"], want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-6)
        assert g["cnt"] == w["cnt"]
        np.testing.assert_allclose(g["acc"], w["acc"], rtol=1e-6)
    _assert_states_close(got["pose"]["state"], want_model)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_flow_step_matches_unsharded(cases, spawns, n):
    """FlowNetC's sharded step: the loss and EPE the global batch's, every
    parameter within 1e-6."""
    got = spawns[n]
    model, _, _, batches = cases["flow"]
    want_model, want = _unsharded("flow", copy.deepcopy(model), FLOW_CFG,
                                  batches)
    for g, w in zip(got["flow"]["metrics"], want):
        for key in ("loss", "epe"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-6)
    _assert_states_close(got["flow"]["state"], want_model)


def test_sharded_pose_step_matches_reference_sharded(cases, spawns):
    """The reference test's Tiny (conv, batch norm, conv) stepped by the
    reference on its 2-device mesh (batch norm over the global batch) and
    by the port in 2 ranks from the same weights: the loss within 1e-5
    relative and every parameter within 1e-5."""
    got = spawns[2]
    net, ref_state, batches = cases["tiny"]
    mesh = ref_parallel.make_mesh(2)
    batch = ref_parallel.shard_batch(mesh, batches[0])
    state = jax.device_put(ref_state, ref_parallel.replicated(mesh))
    stepped, metrics = jax.jit(ref_train.train_step, static_argnums=(2,))(
        state, batch, True)
    np.testing.assert_allclose(got["tiny"]["metrics"][0]["loss"],
                               float(metrics["loss"]), rtol=1e-5)
    want = _load_tiny(_tiny_twin(), jax.device_get(stepped.params))
    for k, v in want.state_dict().items():
        if "running" not in k and "num_batches" not in k:
            torch.testing.assert_close(got["tiny"]["state"][k], v,
                                       atol=1e-5, rtol=1e-5, msg=k)


def test_sharded_flow_step_matches_reference_sharded(cases, spawns):
    """FlowNetC (md 4) stepped by the reference's flow_train_step on a
    2-device sharded batch and by the port in 2 ranks: the loss and EPE
    within 1e-5 relative, each parameter's update within 1e-4 of the
    largest (the port's flow-step parity, tests/test_torch_flow_train.py)."""
    from flowtrack_tpu.engine.train import create_train_state as ref_state
    from flowtrack_tpu_torch.utils.convert import (named_parameters_from_tree,
                                                   reverse_flownet)

    got = spawns[2]
    tflow, jflow, v, batches = cases["flow"]
    mesh = ref_parallel.make_mesh(2)
    ref = ref_state(jflow, RefConfig(train=RefTrainConfig(optimizer="sgd",
                                                          lr=0.01)),
                    None, None, variables=v)
    ref = jax.device_put(ref, ref_parallel.replicated(mesh))
    ref, metrics = jax.jit(ref_flow_train.flow_train_step)(
        ref, ref_parallel.shard_batch(mesh, batches[0]))
    for key in ("loss", "epe"):
        np.testing.assert_allclose(got["flow"]["metrics"][0][key],
                                   float(metrics[key]), rtol=1e-5)
    moved = named_parameters_from_tree(
        tflow, jax.tree.map(lambda a, b: np.asarray(a) - b,
                            jax.device_get(ref.params), v["params"]),
        reverse_flownet)
    scale = max(np.abs(m).max() for m in moved.values())
    before = tflow.state_dict()
    for name, _ in tflow.named_parameters():
        update = (got["flow"]["state"][name] - before[name]).numpy()
        assert np.abs(update - moved[name]).max() <= 1e-4 * scale, name


def test_global_batchnorm_without_a_group_is_batchnorm():
    """Outside a process group (and in eval mode) GlobalBatchNorm2d is
    nn.BatchNorm2d bit for bit; convert_global_bn keeps every parameter
    and buffer object, and the one-device helpers do nothing."""
    gen = torch.Generator().manual_seed(0)
    model = get_pose_net(POSE_CFG.model, generator=gen)
    plain = copy.deepcopy(model)
    params = list(model.parameters())
    assert convert_global_bn(model) is model
    assert list(model.parameters()) == params
    assert sum(isinstance(m, GlobalBatchNorm2d) for m in model.modules()) \
        == sum(isinstance(m, nn.BatchNorm2d) for m in plain.modules()) > 0
    x = torch.randn(2, 3, 64, 48, generator=gen)
    for mode in (True, False):
        torch.testing.assert_close(model.train(mode)(x), plain.train(mode)(x),
                                   rtol=0, atol=0)
    torch.testing.assert_close(model.state_dict(), plain.state_dict(),
                               rtol=0, atol=0)
    assert distributed.world_size() == 1 and not distributed.is_distributed()
    distributed.average_gradients(model.parameters())
    assert distributed.all_reduce_sum(x) is x


def test_backends_and_a_failing_rank():
    """gloo on the CPU and for a repeated card, nccl across distinct cards;
    a rank that raises fails the call."""
    from flowtrack_tpu_torch.parallel import Mesh

    def mesh(*devs):
        return Mesh(np.asarray([torch.device(d) for d in devs],
                               dtype=object), ("data",))

    assert distributed.backend_for(mesh("cpu", "cpu")) == "gloo"
    assert distributed.backend_for(mesh("cuda:0", "cuda:0")) == "gloo"
    assert distributed.backend_for(mesh("cuda:0", "cuda:1")) == "nccl"
    with pytest.raises(Exception, match="invalid literal"):
        distributed.run_on_mesh(int, make_mesh(0, devices=[CPU] * 2), "x")


def test_ranks_import_neither_jax_nor_the_reference():
    """A spawned rank (here under pytest, whose process has jax) starts
    from a fresh interpreter that imports the port only."""
    probe = ("sorted(k for k in __import__('sys').modules if k.split('.')[0]"
             " in ('jax', 'jaxlib', 'flax', 'optax', 'flowtrack_tpu'))")
    assert distributed.run_on_mesh(eval, make_mesh(0, devices=[CPU] * 2),
                                   probe) == []


def test_train_cli_on_a_two_slot_mesh_matches_one_slot(tmp_path):
    """tools/train with mesh.num_devices=2 (two gloo ranks on the CPU, a
    per-device batch of 4, global batch norms) against one slot with the
    global batch of 8, SGD, one epoch: the same weights within 1e-5, the
    step count, and rank 0's checkpoint and metrics line."""
    from flowtrack_tpu_torch.tools import train
    from tests.fixtures import make_coco_fixture

    root, _, _ = make_coco_fixture(tmp_path / "coco", n_images=8)
    opts = ["model.num_layers=18", "model.image_size=64,64",
            "model.heatmap_size=16,16", "model.dtype=float32",
            "train.optimizer=sgd", "train.end_epoch=1", "train.shuffle=false",
            "test.use_gt_bbox=true", f"data.root={root}",
            "data.train_set=val2017"]

    def run(out, *extra):
        return train.main(["--out", str(tmp_path / out), "--device", "cpu",
                           *opts, *extra])

    one = run("one", "train.batch_size=8")
    two = run("two", "train.batch_size=4", "mesh.num_devices=2")
    assert one.step == two.step > 0
    torch.testing.assert_close(two.model.state_dict(),
                               one.model.state_dict(), atol=1e-5, rtol=1e-5)
    assert (tmp_path / "two" / "metrics.jsonl").read_text().count("\n") == 1
    assert list((tmp_path / "two").glob("epoch_0*"))


def test_train_flow_cli_on_a_two_slot_mesh_matches_one_slot(tmp_path):
    """tools/train_flow with mesh.num_devices=2 (--batch 2 a device) against
    one slot with --batch 4, FlowNetS float32, SGD, one epoch over four
    pairs: the same weights within 1e-5 and step count; rank 0 alone
    writes the .npz and the metrics line."""
    import shutil

    from flowtrack_tpu_torch.tools import train_flow
    from tests.test_flow_dataset import _make_triplet_corpus

    corpus = tmp_path / "chairs"
    corpus.mkdir()
    _make_triplet_corpus(corpus, n=4, hw=(64, 64), flow_val=(4.0, -2.0))

    def run(out, *extra):
        (tmp_path / out).mkdir()
        return train_flow.main([
            "--cfg", "flownet_s", "--triplets", str(corpus), "--crop", "64",
            "64", "--epochs", "1", "--device", "cpu", "--out",
            str(tmp_path / out / "flow.npz"), *extra, "flow.dtype=float32",
            "train.optimizer=sgd"])

    try:
        one = run("one", "--batch", "4")
        two = run("two", "--batch", "2", "mesh.num_devices=2")
        assert one.step == two.step == 1
        torch.testing.assert_close(two.model.state_dict(),
                                   one.model.state_dict(), atol=1e-5,
                                   rtol=1e-5)
        assert (tmp_path / "two" / "flow.npz").exists()
        assert (tmp_path / "two" / "metrics.jsonl").read_text().count(
            "\n") == 1
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
