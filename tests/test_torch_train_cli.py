"""The port's ``tools/train`` against the JAX package's ``tools/train`` on
the synthetic COCO set of tests/test_train_cli.py, R18 at 64x64 in
float32, from the same ``.npz`` start (``--init-weights``).

The reference runs on the 8-device CPU mesh of tests/conftest.py and
multiplies ``train.batch_size`` by the mesh's size; the port runs on one
device. So the reference is given ``train.batch_size=1`` and the port
``train.batch_size=8``: both take one step of the same 8 samples an epoch.
Also: the refusal of ``--device cuda`` without a card.
tests/test_torch_train_loop.py has the port's own runs (``--resume``, the
PoseTrack fine-tune, the closed loop).
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowtrack_tpu import config as ref_config
from flowtrack_tpu.engine.checkpoint import save_npz_variables as ref_save_npz
from flowtrack_tpu.models.pose_resnet import get_pose_net as ref_get_pose_net
from flowtrack_tpu_torch.tools import train
from tests.fixtures import make_coco_fixture
from tests.test_torch_clip_pipeline import _random_variables
from tools import train as ref_train

SMALL = ["model.num_layers=18", "model.image_size=64,64",
         "model.heatmap_size=16,16", "model.dtype=float32",
         "train.print_freq=1", "test.batch_size=1", "test.use_gt_bbox=true"]
EPOCHS = 2
# train_loss, relative: epoch 0 is the loss of the shared start (read
# equal), epoch 1 follows one Adam step from gradients summed in other
# orders by XLA and the CPU convs (read 6.1e-7)
LOSS_RTOL = {0: 1e-6, 1: 1e-5}


def init_npz(path):
    """The reference's R18 at 64x64, its variables drawn with the
    reference's initializers (``_random_variables``), as an .npz."""
    net = ref_get_pose_net(ref_config.ModelConfig(
        num_layers=18, image_size=(64, 64), heatmap_size=(16, 16),
        dtype="float32"))
    ref_save_npz(str(path), _random_variables(net, (1, 64, 64, 3), 0))


def metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """The COCO set, the shared start and the reference CLI's run of
    EPOCHS epochs (its metrics.jsonl lines)."""
    tmp = tmp_path_factory.mktemp("train_cli")
    root, _, _ = make_coco_fixture(tmp / "coco")
    init_npz(tmp / "init.npz")
    opts = SMALL + [f"data.root={root}", "data.train_set=val2017",
                    f"train.end_epoch={EPOCHS}"]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(sys, "argv", [
            "train.py", "--compile-cache=", "--cfg", "coco_res50_256x192",
            "--out", str(tmp / "ref"), "--init-weights",
            str(tmp / "init.npz"), "train.batch_size=1", *opts])
        ref_train.main()
    finally:
        mp.undo()
    yield {"tmp": tmp, "root": root, "opts": opts,
           "ref": metrics(tmp / "ref")}
    shutil.rmtree(tmp, ignore_errors=True)  # checkpoints of 0.2 GB each


def port_args(coco, out, *extra):
    return ["--cfg", "coco_res50_256x192", "--out", str(out), "--device",
            "cpu", "--init-weights", str(coco["tmp"] / "init.npz"),
            "train.batch_size=8", *coco["opts"], *extra]


def test_train_matches_reference(coco):
    """Per epoch: train_loss within LOSS_RTOL, the same lr from the
    schedule, train_acc, val_perf and best_perf within 1e-6, the
    reference's keys, and a checkpoint of each epoch."""
    out = coco["tmp"] / "port"
    state = train.main(port_args(coco, out))
    got, want = metrics(out), coco["ref"]
    assert len(got) == len(want) == EPOCHS
    for epoch, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w) == {"step", "time", "train_loss",
                                    "train_acc", "val_perf", "best_perf",
                                    "lr"}
        assert g["step"] == w["step"] == epoch
        assert np.isfinite(g["train_loss"])
        assert g["train_loss"] == pytest.approx(w["train_loss"],
                                                rel=LOSS_RTOL[epoch])
        # the reference's lr is a float32
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-7)
        for k in ("train_acc", "val_perf", "best_perf"):
            assert g[k] == pytest.approx(w[k], abs=1e-6), k
    assert state.step == EPOCHS
    assert sorted(p for p in os.listdir(out) if p.startswith("epoch_")) == \
        [f"epoch_{e:06d}.pt" for e in range(EPOCHS)]


def test_train_clis_refuse_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    from flowtrack_tpu_torch.tools import train_flow

    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--out", str(tmp_path / "a"), "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_flow.main(["--out", str(tmp_path / "b.npz"), "--device",
                         "cuda"])
