"""The port's training end to end on the CPU: the train-to-eval closed loop
of tests/test_train_to_eval_loop.py through the port's ``tools/train``
CLI, ``--resume``, the PoseTrack fine-tune of tests/test_train_cli.py, and
``model.remat`` (each residual block recomputed in the backward), which
must change no number: the forward, every gradient and the batch norms'
buffers stay bit for bit those of the run without it.
"""

import argparse
import json
import os
import shutil
from dataclasses import replace

import numpy as np
import pytest
import torch

from flowtrack_tpu_torch.config import ModelConfig
from flowtrack_tpu_torch.engine.checkpoint import save_npz_variables
from flowtrack_tpu_torch.engine.loss import joints_mse_loss
from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
from flowtrack_tpu_torch.tools import train
from flowtrack_tpu_torch.utils.convert import convert_pose_resnet
from tests.fixtures import make_coco_fixture, make_posetrack_fixture

SMALL = ["model.num_layers=18", "model.image_size=64,64",
         "model.heatmap_size=16,16", "model.dtype=float32",
         "train.print_freq=1", "test.batch_size=1", "test.use_gt_bbox=true"]


def init_npz(path, seed=0):
    """A seeded R18 at 64x64, written as the JAX package's .npz tree."""
    net = get_pose_net(ModelConfig(num_layers=18, image_size=(64, 64),
                                   heatmap_size=(16, 16), dtype="float32"),
                       generator=torch.Generator().manual_seed(seed))
    save_npz_variables(str(path), convert_pose_resnet(net.state_dict()))
    return net


def metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_remat_changes_no_number():
    """R18 at 32x32 in train mode, float32: with and without remat the
    heatmaps and every gradient are equal bit for bit, and so are the batch
    norms' running statistics and ``num_batches_tracked`` after the step:
    the recomputation in the backward does not update them a second time."""
    cfg = ModelConfig(num_layers=18, image_size=(32, 32),
                      heatmap_size=(8, 8), dtype="float32")
    base = get_pose_net(cfg, generator=torch.Generator().manual_seed(0))
    remat = get_pose_net(replace(cfg, remat=True))
    remat.load_state_dict(base.state_dict())
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (2, 3, 32, 32)).astype(np.float32))
    tgt = torch.from_numpy(rng.uniform(0, 1, (2, 8, 8, 17))
                           .astype(np.float32))
    runs = []
    for net in (base, remat):
        out = net.train()(x)
        joints_mse_loss(out.permute(0, 2, 3, 1), tgt).backward()
        runs.append((out.detach(),
                     {k: p.grad for k, p in net.named_parameters()},
                     dict(net.named_buffers())))
    (out0, g0, b0), (out1, g1, b1) = runs
    torch.testing.assert_close(out1, out0, rtol=0, atol=0)
    assert g0.keys() == g1.keys() == dict(base.named_parameters()).keys()
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0, msg=k)
    for k in b0:
        torch.testing.assert_close(b1[k], b0[k], rtol=0, atol=0, msg=k)
    assert int(remat.layer1[0].bn1.num_batches_tracked) == 1
    # in eval mode, or without gradients, nothing is checkpointed
    with torch.no_grad():
        torch.testing.assert_close(remat.eval()(x), base.eval()(x),
                                   rtol=0, atol=0)


def test_training_lifts_ap(tmp_path):
    """tests/test_train_to_eval_loop.py through the port's train CLI: R18
    at 64x64, 8 persons, batch 8, lr 2e-3, augmentation and flip test off,
    the ground-truth boxes, 60 epochs. AP after (the last epoch's
    val_perf) > max(0.3, AP before + 0.25), AP before from run_validation
    on the CLI's starting weights."""
    root, _, _ = make_coco_fixture(tmp_path / "coco", n_images=4, persons=2)
    opts = ["model.num_layers=18", "model.image_size=64,64",
            "model.heatmap_size=16,16", "model.sigma=1.5",
            "model.dtype=float32", "train.batch_size=8", "train.lr=2e-3",
            "train.flip_prob=0", "train.rot_factor=0", "train.scale_factor=0",
            "train.end_epoch=60", "train.print_freq=100", "test.batch_size=8",
            "test.use_gt_bbox=true", "test.flip_test=false",
            f"data.root={root}", "data.train_set=val2017",
            "data.test_set=val2017"]
    cfg = train.apply_overrides(train.get_config("coco_res50_256x192"), opts)
    start = train.initial_model(argparse.Namespace(
        init_weights=None, imagenet_backbone=None), cfg)
    ap_before = train.run_validation(cfg, start, device="cpu")["AP"]
    out = tmp_path / "ckpt"
    train.main(["--cfg", "coco_res50_256x192", "--out", str(out),
                "--device", "cpu", *opts])
    lines = metrics(out)
    assert len(lines) == 60
    ap_after = lines[-1]["val_perf"]
    assert ap_after > max(0.3, ap_before + 0.25), \
        (ap_before, ap_after, lines[-1]["train_loss"])
    shutil.rmtree(out)  # checkpoints of 0.2 GB each


def test_resume_continues_at_the_next_epoch(tmp_path, monkeypatch):
    """``--resume`` with a later end epoch takes the newest checkpoint's
    weights, optimizer and step and runs only the epochs after it."""
    root, _, _ = make_coco_fixture(tmp_path / "coco")
    init_npz(tmp_path / "init.npz")
    out = tmp_path / "resume"

    def args(*extra):
        return ["--cfg", "coco_res50_256x192", "--out", str(out), "--device",
                "cpu", "--init-weights", str(tmp_path / "init.npz"), *extra,
                *SMALL, "train.batch_size=8", f"data.root={root}",
                "data.train_set=val2017"]

    train.main(args("train.end_epoch=1"))
    saved = torch.load(out / "epoch_000000.pt", weights_only=True)
    seen = {}

    class Spy(train.CheckpointManager):
        def restore(self, state, epoch=None):
            state, epoch = super().restore(state, epoch)
            seen["step"], seen["epoch"] = state.step, epoch
            seen["conv1"] = state.model.conv1.weight.detach().clone()
            return state, epoch

    monkeypatch.setattr(train, "CheckpointManager", Spy)
    state = train.main(args("--resume", "train.end_epoch=2"))
    assert (seen["epoch"], seen["step"], state.step) == (0, 1, 2)
    torch.testing.assert_close(seen["conv1"], saved["model"]["conv1.weight"],
                               rtol=0, atol=0)
    lines = metrics(out)
    assert [line["step"] for line in lines] == [0, 1]
    assert lines[1]["lr"] == pytest.approx(1e-3)
    shutil.rmtree(out)


def test_posetrack_finetune(tmp_path, monkeypatch):
    """The FlowTrack recipe, as tests/test_train_cli.py has it: weights in
    the JAX package's .npz as --init-weights reach the train state, one
    epoch of PoseTrack frames, a checkpoint."""
    root, _ = make_posetrack_fixture(tmp_path / "pt", n_videos=1,
                                     n_frames=4)
    init = init_npz(tmp_path / "init.npz", seed=3)
    seen = {}
    orig = train.create_train_state

    def spy(model, cfg, steps_per_epoch=1):
        seen["conv1"] = model.conv1.weight.detach().clone()
        return orig(model, cfg, steps_per_epoch)

    monkeypatch.setattr(train, "create_train_state", spy)
    out = tmp_path / "ckpt"
    state = train.main([
        "--cfg", "flowtrack_posetrack", "--out", str(out), "--device", "cpu",
        "--init-weights", str(tmp_path / "init.npz"), *SMALL,
        "train.batch_size=8", "train.end_epoch=1", f"data.root={root}",
        "data.train_set=val", "data.test_set=val"])
    torch.testing.assert_close(seen["conv1"], init.conv1.weight, rtol=0,
                               atol=0)
    assert state.step == 1
    assert os.path.exists(out / "epoch_000000.pt")
    (line,) = metrics(out)
    assert np.isfinite(line["train_loss"]) and np.isfinite(line["val_perf"])
    shutil.rmtree(out)
