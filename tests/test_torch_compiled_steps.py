"""The port's counterparts of the reference's compiled programs outside
the clip (``utils/graphs.py``), on the CPU: the padded per-frame engine
and the graphed train steps.

On the CPU every program runs eagerly on the padded batch that its CUDA
graph takes on the card (``chip_smoke.py``'s ``[compiled]`` phase holds
the graphs to the eager programs there). The padded ``PosePredictor`` and
``FlowTracker`` run the reference's buckets against the reference's (the
R18 64x48 / FlowNetC weights of ``tests/test_torch_tracker.py``'s
``predictors`` fixture: joints within 1e-3 px, maxvals and scores 1e-5
relative, masks and ids equal); ``nms_boxes_padded`` gives the
reference's mask; ``make_jit_train_step`` on the card's route (a stand-in
``Graph`` that runs its program at each replay) steps as ``train_step``
and as stepping by hand with the schedule, bit for bit, across a
milestone, and as the reference's ``make_jit_train_step``; a captured
step's state key follows ``optimizer.load_state_dict`` and not a copy
into the parameters; a state saved with a host rate loads back into the
card's route.
"""

import contextlib
import copy
import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowtrack_tpu.tracking import tracker as jtracker
from flowtrack_tpu_torch.config import Config, ModelConfig, TrainConfig
from flowtrack_tpu_torch.engine.loss import joints_mse_loss
from flowtrack_tpu_torch.engine.train import (TrainState, create_train_state,
                                              device_rate,
                                              make_jit_train_step,
                                              make_optimizer, train_step)
from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
from flowtrack_tpu_torch.tracking import tracker as ttracker
from flowtrack_tpu_torch.utils import convert
from flowtrack_tpu_torch.utils import graphs as graphs_mod
from flowtrack_tpu_torch.utils.graphs import GraphCache, state_key
from tests.test_torch_tracker import _nms_cases, predictors  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: the whole suite runs in six
    workers on the host's cores at once, and torch's pool of spinning
    threads slowed the train steps here fiftyfold there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frame(seed=40, hw=(60, 64)):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (*hw, 3)).astype(np.float32)


def _dets(rng, n, hw=(60, 64)):
    xy = rng.uniform(0, [hw[1] - 24, hw[0] - 30], (n, 2))
    wh = rng.uniform([12, 18], [22, 28], (n, 2))
    return (np.concatenate([xy, wh], 1).astype(np.float32),
            rng.uniform(0.3, 1.0, n).astype(np.float32))


@pytest.mark.parametrize("persons", ["one", "max_persons",
                                     "max_persons_plus_one"])
def test_padded_pose_predictor_matches_reference(predictors, persons):
    """The port's PosePredictor poses a frame's persons padded to the
    reference's bucket (a multiple of ``max_persons``, the last box
    repeated at score 0) and returns the real rows: joints within 1e-3 px,
    maxvals and scores 1e-5 relative of the reference's."""
    cfg, (jpose, _), (pose, _) = predictors
    q = cfg.track.max_persons
    p = {"one": 1, "max_persons": q, "max_persons_plus_one": q + 1}[persons]
    boxes, scores = _dets(np.random.default_rng(41), p)
    rows = []
    program = pose._program

    def spy(image, centers, scales, sc):
        rows.append((centers.shape[0], sc[p:].abs().sum().item(),
                     torch.equal(centers[p:], centers[p - 1:p].expand(
                         centers.shape[0] - p, 2))))
        return program(image, centers, scales, sc)

    pose._program = spy
    try:
        got = pose(_frame(), boxes, scores)
    finally:
        del pose._program
    assert rows == [(-(-p // q) * q, 0.0, True)]
    want = [np.asarray(x) for x in jpose(_frame(), boxes, scores)]
    assert [g.shape for g in got] == [w.shape for w in want] == [
        (p, 17, 2), (p, 17), (p,)]
    np.testing.assert_allclose(got[0], want[0], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-9)


def test_nms_boxes_padded_matches_reference():
    """nms_boxes_padded keeps the reference's mask on candidate sets padded
    to 8 with zero boxes and scores, and keeps no padded row."""
    for thresh in (0.3, 0.5):
        for boxes, scores, valid in _nms_cases():
            n, npad = len(boxes), -(-len(boxes) // 8) * 8
            bx = np.zeros((npad, 4), np.float32)
            bx[:n] = boxes
            sc = np.zeros((npad,), np.float32)
            sc[:n] = scores
            nv = np.zeros((npad,), bool)
            nv[:n] = True if valid is None else valid
            want = np.asarray(jtracker.nms_boxes_padded(
                jnp.asarray(bx), jnp.asarray(sc), jnp.asarray(nv), thresh))
            got = ttracker.nms_boxes_padded(torch.from_numpy(bx),
                                            torch.from_numpy(sc),
                                            torch.from_numpy(nv),
                                            thresh).numpy()
            np.testing.assert_array_equal(got, want)
            assert not got[~nv].any()


def test_flow_tracker_crossing_buckets_matches_reference(predictors):
    """FlowTracker over 4 frames whose candidate counts cross the
    ``max_persons`` buckets (2, 2, 4 and 1 detections, the tracks piling
    up: 3, 6 and 9 rows) against the reference's: the same tracks with
    the same ids every frame, joints within 1e-3 px, maxvals and scores
    1e-5 relative. Every
    device step ran padded to a multiple of ``max_persons``, in more than
    one bucket."""
    from flowtrack_tpu.tracking import FlowTracker as JFlowTracker
    from flowtrack_tpu_torch.tracking import FlowTracker

    cfg, (jpose, jflow), (pose, flow) = predictors
    q = cfg.track.max_persons
    rng = np.random.default_rng(42)
    base = _frame(43)
    frames = [np.clip(base + rng.normal(0, 3, base.shape), 0, 255)
              .astype(np.float32) for _ in range(4)]
    dets = [_dets(rng, n) for n in (2, 2, 4, 1)]
    want = JFlowTracker(cfg, jpose, jflow).track_sequence(frames, dets)
    got_tracker = FlowTracker(cfg, pose, flow, device="cpu")
    keys = []
    run = got_tracker._run

    def spy(key, fn, *arrays):
        keys.append((key[0], arrays[0].shape[0]))
        return run(key, fn, *arrays)

    got_tracker._run = spy
    got = got_tracker.track_sequence(frames, dets)
    for t, (g, w) in enumerate(zip(got, want)):
        assert [x.track_id for x in g] == [x.track_id for x in w], t
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.joints, b.joints, atol=1e-3, rtol=0)
            np.testing.assert_allclose(a.maxvals, b.maxvals, rtol=1e-5,
                                       atol=1e-9)
            np.testing.assert_allclose(a.score, b.score, rtol=1e-5)
    assert all(rows % q == 0 for _, rows in keys)
    for step in ("propagate", "nms", "match"):
        assert len({rows for s, rows in keys if s == step}) >= 2, (step, keys)
    assert len(got_tracker.graphs) == 0     # no graph on the CPU


POSE = ModelConfig(num_layers=18, image_size=(64, 64), heatmap_size=(16, 16),
                   dtype="float32")


def _batch(seed, n=2):
    rng = np.random.default_rng(seed)
    arrays = {"input": rng.normal(size=(n, 64, 64, 3)),
              "target": rng.uniform(0, 1, (n, 16, 16, 17)),
              "target_weight": rng.uniform(0, 1, (n, 17)) > 0.3}
    return {k: torch.from_numpy(v.astype(np.float32))
            for k, v in arrays.items()}


def _state(model, cfg, device_rate):
    """A TrainState at the schedule of 2 steps an epoch; ``device_rate``:
    its optimizer reads the rate from a tensor beside the parameters, as
    ``make_optimizer`` makes it on a card."""
    opt, sched = make_optimizer(cfg, model.parameters(), 2)
    if device_rate:
        for group in opt.param_groups:
            group["lr"] = torch.full((), group["lr"])
    return TrainState(model, opt, sched)


class FakeGraph:
    """``utils/graphs.Graph`` on the CPU: a capture records the program
    and runs none of it (a CUDA graph's capture does no device work), a
    replay fills the static inputs and runs the program on them. A program
    that does nothing but device work, as a captured one must, gives what
    its replay gives."""

    def __init__(self, fn, args, state, pool, stream, warmup=True):
        self.fn, self.inputs = fn, [a.clone() for a in args]
        if warmup:
            fn(*self.inputs)
        self.held, self.capture_ms, self.pool_bytes = list(state()), 0.0, 0

    @staticmethod
    def resources(device):
        return None, None

    @staticmethod
    def warming(stream, device):
        return contextlib.nullcontext()

    def run(self, args):
        for buf, a in zip(self.inputs, args):
            buf.copy_(a)
        return self.fn(*self.inputs)


@pytest.fixture
def card_route(monkeypatch):
    """Every GraphCache takes the card's route on CPU tensors, through
    FakeGraph: a train step's first call per geometry eager, then a
    capture, then replays."""
    monkeypatch.setattr(GraphCache, "on_card", staticmethod(lambda t: True))
    monkeypatch.setattr(graphs_mod, "Graph", FakeGraph)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_jit_train_step_across_a_milestone(optimizer, card_route):
    """make_jit_train_step on the card's route (FakeGraph: the first call
    an eager step, the capture, then replays with the schedule's rate
    written before each and the step counted after) over four steps of R18
    (64x64, batch 2) with a milestone at step 2 (epoch 1 of 2 steps): the
    parameters, the running statistics and the losses equal, bit for bit,
    train_step's and those of stepping by hand (forward, loss, backward,
    the schedule's rate into the param groups, the optimizer's step), with
    the rate in a tensor beside the parameters as on a card, and after
    each step the tensor holds the rate of the step taken. A host rate is
    refused at the capture: a replay would keep the capture's."""
    cfg = Config(train=TrainConfig(optimizer=optimizer, lr=0.01,
                                   lr_steps=(1,), lr_factor=0.1))
    base = get_pose_net(POSE, "cpu", torch.Generator().manual_seed(3))
    batches = [_batch(50 + i) for i in range(4)]
    runs = {}
    for name in ("jit", "eager", "hand"):
        state = _state(copy.deepcopy(base), cfg, True)
        step = make_jit_train_step()
        losses, rates = [], []
        for b in batches:
            if name == "jit":
                state, m = step(state, b)
                loss = m["loss"]
            elif name == "eager":
                state, m = train_step(state, b)
                loss = m["loss"]
            else:
                model = state.model.train()
                x = b["input"].permute(0, 3, 1, 2).contiguous()
                hm = model(x).permute(0, 2, 3, 1)
                loss = joints_mse_loss(hm, b["target"], b["target_weight"])
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                state.optimizer.param_groups[0]["lr"].fill_(
                    state.schedule(state.step))
                state.optimizer.step()
                state.step += 1
            losses.append(float(loss.detach()))
            rates.append(float(state.optimizer.param_groups[0]["lr"]))
        assert state.step == 4
        if name == "jit":
            assert len(step.graphs) == 1
        runs[name] = (state.model.state_dict(), losses, rates)
    assert runs["jit"][2] == runs["hand"][2] == (
        [np.float32(0.01)] * 2 + [np.float32(0.001)] * 2)
    for a, b in (("jit", "eager"), ("jit", "hand")):
        assert runs[a][1] == runs[b][1], (a, b)
        for k, v in runs[a][0].items():
            torch.testing.assert_close(v, runs[b][0][k], rtol=0, atol=0,
                                       msg=f"{a} {b} {k}")
    state = _state(copy.deepcopy(base), cfg, False)
    with pytest.raises(RuntimeError, match="rate"):
        make_jit_train_step()(state, batches[0])


def test_graphed_train_step_matches_reference_across_a_milestone(card_route):
    """make_jit_train_step on the card's route (FakeGraph) against the
    reference's make_jit_train_step, on tests/test_torch_train.py's R18 at
    64x48 (batch 4; the reference's initializers drawn in numpy,
    ``_random_variables``, random batch-norm statistics): Adam at 1e-3,
    four steps with the milestone at step 2 (x0.1). The step counts equal,
    the rate the schedule's after each step, each loss within 1e-5
    relative (that file's tolerance), and the parameters after the last
    step within 1% of the reference's update (the norm of the difference
    over the norm of what the four reference steps moved them; 0.04% read
    here): a rate kept at its first value past the milestone moves them
    tens of percent apart."""
    from flowtrack_tpu.config import Config as RefConfig
    from flowtrack_tpu.config import ModelConfig as RefModelConfig
    from flowtrack_tpu.config import TrainConfig as RefTrainConfig
    from flowtrack_tpu.engine import train as ref_train
    from flowtrack_tpu.models.pose_resnet import get_pose_net as jax_pose_net
    from tests.test_torch_clip_pipeline import _random_variables
    from tests.test_torch_train import POSE as TRAIN_POSE
    from tests.test_torch_train import _port_pose, _pose_batch

    jm = jax_pose_net(RefModelConfig(**TRAIN_POSE))
    v0 = jax.tree_util.tree_map(np.asarray,
                                _random_variables(jm, (1, 64, 48, 3), 0))
    rng = np.random.default_rng(0)
    v0["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: rng.uniform(*((-0.2, 0.2) if p[-1].key == "mean"
                                   else (0.5, 1.5)), a.shape
                                 ).astype(np.float32), v0["batch_stats"])
    ref = ref_train.create_train_state(
        jm, RefConfig(train=RefTrainConfig(lr_steps=(1,))), None, None,
        steps_per_epoch=2, variables=v0)
    ref_step = ref_train.make_jit_train_step(donate=False)
    state = _state(_port_pose(v0), Config(train=TrainConfig(lr_steps=(1,))),
                   True)
    step = make_jit_train_step()
    rng = np.random.default_rng(7)
    for i in range(4):
        b = _pose_batch(rng)
        ref, want = ref_step(ref, {k: jnp.asarray(a) for k, a in b.items()})
        state, got = step(state, {k: torch.from_numpy(a)
                                  for k, a in b.items()})
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-5)
        assert float(state.optimizer.param_groups[0]["lr"]) == np.float32(
            1e-3 if i < 2 else 1e-4)
    assert state.step == int(ref.step) == 4
    got = convert.convert_pose_resnet(state.model.state_dict())["params"]
    leaves = zip(*(map(np.asarray, jax.tree_util.tree_leaves(t))
                   for t in (got, ref.params, v0["params"])))
    apart = moved = 0.0
    for g, r, r0 in leaves:
        apart += ((g - r) ** 2).sum()
        moved += ((r - r0) ** 2).sum()
    assert moved > 0 and apart <= 0.01 ** 2 * moved, (apart, moved)


def test_train_state_key_follows_the_optimizer_state():
    """What a captured step reads (``TrainState.tensors``, keyed by
    ``state_key``): the key stays after the parameters are loaded in place
    (``load_state_dict``, ``copy_``) and changes after
    ``optimizer.load_state_dict`` of a saved state (new moment tensors, a
    resume) and after the model moves; a GraphCache runs CPU tensors
    eagerly and captures nothing."""
    cfg = Config()
    state = create_train_state(
        get_pose_net(POSE, "cpu", torch.Generator().manual_seed(4)), cfg)
    state, _ = train_step(state, _batch(60))
    k0 = state_key(state.tensors())
    assert any(t is state.optimizer.state[p]["exp_avg"]
               for p in state.model.parameters() for t in state.tensors())
    state.model.load_state_dict(copy.deepcopy(state.model.state_dict()))
    with torch.no_grad():
        for p in state.model.parameters():
            p.copy_(p * 0.5)
    assert state_key(state.tensors()) == k0
    state.optimizer.load_state_dict(
        copy.deepcopy(state.optimizer.state_dict()))
    k1 = state_key(state.tensors())
    assert k1 != k0
    state.model.to(torch.float64)
    assert state_key(state.tensors()) != k1

    cache = GraphCache()
    x = torch.arange(4.0)
    assert torch.equal(cache.run("k", lambda a: a * 2, [x]), x * 2)
    assert len(cache) == 0


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_device_rate_after_loading_a_host_rate(optimizer):
    """The card's route for an optimizer (``device_rate``, which
    make_optimizer applies on a card and again after each
    ``load_state_dict``) survives loading a state saved on the CPU: the
    saved float rate becomes a tensor beside the parameters holding it,
    Adam ``capturable`` with its step counts float32 beside the
    parameters, SGD ``fused``; the tensors change, so a captured step's
    state key does."""
    cfg = Config(train=TrainConfig(optimizer=optimizer, lr=0.01,
                                   lr_steps=(1,)))
    saved = create_train_state(
        get_pose_net(POSE, "cpu", torch.Generator().manual_seed(6)), cfg, 1)
    saved, _ = train_step(saved, _batch(61))
    saved, _ = train_step(saved, _batch(62))
    sd = copy.deepcopy(saved.optimizer.state_dict())
    assert sd["param_groups"][0]["lr"] == pytest.approx(0.001)
    state = create_train_state(copy.deepcopy(saved.model), cfg, 1)
    opt = state.optimizer
    device_rate(opt)        # as make_optimizer does for parameters on a card
    opt.register_load_state_dict_post_hook(device_rate)
    key = state_key(state.tensors())
    opt.load_state_dict(sd)
    assert state_key(state.tensors()) != key
    for group in opt.param_groups:
        lr = group["lr"]
        assert isinstance(lr, torch.Tensor) and lr.dtype == torch.float32
        assert float(lr) == np.float32(0.001)
        assert lr.device == group["params"][0].device
        if optimizer == "adam":
            assert group["capturable"]
            steps = [opt.state[p]["step"] for p in group["params"]]
            assert all(t.dtype == torch.float32 and float(t) == 2
                       for t in steps)
        else:
            assert group["fused"]


def test_kept_is_one_cache_a_net_while_it_lives():
    """``utils/graphs.kept`` (the validations' graphs kept across calls):
    one object a (net, key), the same on the next call, another for
    another key or net, dropped with its net."""
    a, b = torch.nn.Linear(2, 2), torch.nn.Linear(2, 2)
    cache = graphs_mod.kept(a, "validate", GraphCache)
    assert graphs_mod.kept(a, "validate", GraphCache) is cache
    assert graphs_mod.kept(a, "eval", GraphCache) is not cache
    assert graphs_mod.kept(b, "validate", GraphCache) is not cache
    owners = len(graphs_mod._KEPT)
    del a
    gc.collect()
    assert len(graphs_mod._KEPT) == owners - 1
