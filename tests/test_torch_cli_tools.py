"""The port's ``tools/demo``, ``tools/test`` and ``tools/eval_flow`` CLIs
against the JAX package's on the CPU, on the setups of
tests/test_demo_cli.py, tests/test_pipeline_tools.py::
test_validation_pipeline_runs and tests/test_zoo_flow_cli.py::
test_eval_flow_cli, with the same ``.npz`` weights: the same printed json,
scores, keypoints and flows within the tolerances stated; and every port
CLI raises on ``--device cuda`` without a card.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowtrack_tpu import config as ref_config
from flowtrack_tpu.engine.checkpoint import (load_npz_variables,
                                             save_npz_variables as ref_save_npz)
from flowtrack_tpu.eval.flow_eval import read_flo, write_flo
from flowtrack_tpu.models.flownet import get_flow_net as ref_get_flow_net
from flowtrack_tpu.models.pose_resnet import get_pose_net as ref_get_pose_net
from flowtrack_tpu_torch.data.pose_dataset import load_image
from flowtrack_tpu_torch.tools import demo, eval_flow, test, track, track_video
from tests.fixtures import make_coco_fixture, save_image
from tools import demo as ref_demo
from tools import eval_flow as ref_eval_flow
from tools import test as ref_test


def init_npz(path, net, shape, key):
    """The reference's initialised variables of ``net`` as an .npz."""
    ref_save_npz(str(path), jax.jit(net.init, static_argnames="train")(
        jax.random.PRNGKey(key), jnp.zeros(shape), train=False))


def last_json(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def run_reference(main, name, argv):
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(sys, "argv", [name, "--compile-cache=", *argv])
        return last_json(main)
    finally:
        mp.undo()


# --- demo ----------------------------------------------------------------------------

def test_demo_matches_reference(tmp_path):
    """R50 at 64x64 on one 120x160 image with two boxes, bare and as
    scored detections, every joint kept (``in_vis_thre`` 0): the same
    persons, rescored scores within 1e-5 relative, the drawn images nearly
    equal."""
    init_npz(tmp_path / "w.npz", ref_get_pose_net(ref_config.ModelConfig(
        num_layers=50, image_size=(64, 64), heatmap_size=(16, 16),
        dtype="float32")), (1, 64, 64, 3), 0)
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (120, 160, 3)).astype(np.uint8)
    save_image(str(tmp_path / "img.png"), img)
    (tmp_path / "boxes.json").write_text(
        json.dumps([[30, 30, 40, 60], [90, 20, 40, 70]]))
    (tmp_path / "dets.json").write_text(json.dumps(
        [{"bbox": [30, 30, 40, 60], "score": 0.8},
         {"bbox": [90, 20, 40, 70], "score": 0.6}]))
    outs = {}
    for boxes in ("boxes", "dets"):
        args = lambda out: [  # noqa: E731
            "--weights", str(tmp_path / "w.npz"),
            "--image", str(tmp_path / "img.png"),
            "--boxes", str(tmp_path / f"{boxes}.json"), "--out", out,
            "--cfg", "coco_res50_256x192", "model.image_size=64,64",
            "model.heatmap_size=16,16", "model.dtype=float32",
            "test.in_vis_thre=0.0"]
        ref_out = str(tmp_path / f"ref_{boxes}.png")
        port_out = str(tmp_path / f"port_{boxes}.png")
        want = run_reference(ref_demo.main, "demo.py", args(ref_out))
        got = last_json(demo.main, args(port_out) + ["--device", "cpu"])
        assert got["persons"] == want["persons"] == 2
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5,
                                   atol=0)
        assert min(got["scores"]) > 0
        assert got["out"] == port_out
        a, b = load_image(port_out), load_image(ref_out)
        assert a.shape == b.shape == (120, 160, 3)
        # joints within 1e-3 px round to the same pixel but at a tie
        assert (a != b).any(axis=-1).mean() < 0.01
        outs[boxes] = got["scores"]
    assert outs["boxes"] != outs["dets"]


# --- test (validation) -------------------------------------------------------------------

def test_validation_matches_reference(tmp_path, capsys):
    """tools/test on the synthetic COCO set with R18 at 64x64, detections
    and batches of 2: the AP table within 1e-6 and printed alike, the
    results json's keypoints within 1e-3 px, the debug dump."""
    root, _, det = make_coco_fixture(tmp_path / "coco")
    npz = tmp_path / "pose.npz"
    init_npz(npz, ref_get_pose_net(ref_config.ModelConfig(
        num_layers=18, image_size=(64, 64), heatmap_size=(16, 16),
        dtype="float32")), (1, 64, 64, 3), 0)
    opts = ["model.num_layers=18", "model.image_size=64,64",
            "model.heatmap_size=16,16", "model.dtype=float32",
            "test.batch_size=2", f"test.bbox_file={det}", f"data.root={root}"]

    cfg = ref_config.apply_overrides(
        ref_config.get_config("coco_res50_256x192"), opts)
    want = ref_test.run_validation(
        cfg, ref_get_pose_net(cfg.model),
        jax.tree.map(jnp.asarray, load_npz_variables(str(npz))),
        output_dir=str(tmp_path / "ref"), debug_dir=str(tmp_path / "ref_dbg"))
    ref_text = capsys.readouterr().out

    got = test.main(["--weights", str(npz), "--out", str(tmp_path / "port"),
                     "--debug-dir", str(tmp_path / "port_dbg"),
                     "--device", "cpu", *opts])
    text = capsys.readouterr().out
    assert got.keys() == want.keys() and len(got) == 10
    for k in want:
        assert np.isfinite(got[k])
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    summary = [line for line in text.splitlines() if "Average" in line]
    assert summary == [line for line in ref_text.splitlines()
                       if "Average" in line] and len(summary) == 10

    name = "keypoints_val2017_results.json"
    with open(tmp_path / "port" / name) as f:
        results = json.load(f)
    with open(tmp_path / "ref" / name) as f:
        ref_results = json.load(f)
    assert len(results) == len(ref_results) > 0
    for a, b in zip(results, ref_results):
        assert a["image_id"] == b["image_id"]
        np.testing.assert_allclose(a["keypoints"], b["keypoints"], rtol=0,
                                   atol=1e-3)
        assert a["score"] == pytest.approx(b["score"], abs=1e-6)
    # the first batch's debug dump: the port's batch is test.batch_size
    # (one device), the reference's that times its mesh's devices
    dumped = sorted(os.listdir(tmp_path / "port_dbg"))
    assert dumped == ["coco_0_hm.png", "coco_0_pred.png", "coco_1_hm.png",
                      "coco_1_pred.png"]
    for f in dumped:
        a = load_image(str(tmp_path / "port_dbg" / f)).astype(int)
        b = load_image(str(tmp_path / "ref_dbg" / f)).astype(int)
        assert a.shape == b.shape
        if f.endswith("_hm.png"):   # heatmaps within rounding of 255 levels
            assert np.abs(a - b).max() <= 1, f


def test_validation_loads_a_torch_state_dict(tmp_path):
    """--weights given a torch state dict (lineage names, wrapped and with
    DataParallel's prefixes, without num_batches_tracked) gives the same
    table as the .npz it came from."""
    from flowtrack_tpu_torch.tools.common import pose_net

    root, _, det = make_coco_fixture(tmp_path / "coco", n_images=2)
    npz = tmp_path / "pose.npz"
    init_npz(npz, ref_get_pose_net(ref_config.ModelConfig(
        num_layers=18, image_size=(64, 64), heatmap_size=(16, 16),
        dtype="float32")), (1, 64, 64, 3), 3)
    opts = ["model.num_layers=18", "model.image_size=64,64",
            "model.heatmap_size=16,16", "model.dtype=float32",
            f"test.bbox_file={det}", f"data.root={root}"]
    from flowtrack_tpu_torch.config import apply_overrides, get_config

    cfg = apply_overrides(get_config("coco_res50_256x192"), opts)
    sd = {f"module.{k}": v for k, v in pose_net(cfg, str(npz))
          .state_dict().items() if not k.endswith("num_batches_tracked")}
    torch.save({"state_dict": sd}, tmp_path / "pose.pth")
    tables = [test.main(["--weights", str(w), "--out", str(tmp_path / o),
                         "--device", "cpu", *opts])
              for w, o in ((npz, "a"), (tmp_path / "pose.pth", "b"))]
    assert tables[0] == tables[1]
    torch.save({"extra.weight": torch.zeros(1), **sd}, tmp_path / "bad.pth")
    with pytest.raises(KeyError, match="unexpected"):
        pose_net(cfg, str(tmp_path / "bad.pth"))


# --- eval_flow ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["flownet_s", "flownet_c"])
def test_eval_flow_matches_reference(tmp_path, variant):
    """3 frames of 64x64 and 2 zero .flo files: the same EPE statistics
    (within 1e-5 relative), then pure inference with --save-flo --render:
    the same files, the flows within 1e-3 px."""
    frames, flo = tmp_path / "frames", tmp_path / "flo"
    frames.mkdir()
    flo.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        save_image(str(frames / f"{i:03d}.png"),
                   rng.integers(0, 255, (64, 64, 3)).astype(np.uint8))
    for i in range(2):
        write_flo(str(flo / f"{i:03d}.flo"), np.zeros((64, 64, 2),
                                                      np.float32))
    npz = tmp_path / "w.npz"
    init_npz(npz, ref_get_flow_net(ref_config.FlowConfig(
        variant=variant, dtype="float32")), (1, 64, 64, 6), 0)
    base = ["--weights", str(npz), "--frames", str(frames),
            "--cfg", variant, "flow.dtype=float32"]

    want = run_reference(ref_eval_flow.main, "eval_flow.py",
                         base + ["--gt-flow", str(flo)])
    got = last_json(eval_flow.main, base + ["--gt-flow", str(flo),
                                            "--device", "cpu"])
    assert got.keys() == want.keys() and got["n_frames"] == 2
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k

    want = run_reference(ref_eval_flow.main, "eval_flow.py", base + [
        "--save-flo", str(tmp_path / "ref"), "--render"])
    got = last_json(eval_flow.main, base + [
        "--save-flo", str(tmp_path / "port"), "--render", "--device", "cpu"])
    assert got["pairs"] == want["pairs"] == 2 and "epe" not in got
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 4
    for name in names:
        if name.endswith(".flo"):
            a = read_flo(str(tmp_path / "port" / name))
            assert a.shape == (64, 64, 2) and np.isfinite(a).all()
            np.testing.assert_allclose(a, read_flo(str(tmp_path / "ref" /
                                                       name)),
                                       rtol=0, atol=1e-3)


# --- no card ---------------------------------------------------------------------------

@pytest.mark.parametrize("cli", ["test", "track", "track_video", "demo",
                                 "eval_flow"])
def test_every_cli_defaults_to_cuda_and_raises_without_it(cli, tmp_path):
    """``--device`` defaults to cuda: with no card each CLI raises before
    it runs anything on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    from flowtrack_tpu_torch.engine.checkpoint import save_npz_variables
    from flowtrack_tpu_torch.models.flownet import get_flow_net
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from flowtrack_tpu_torch.config import FlowConfig, ModelConfig
    from flowtrack_tpu_torch.utils.convert import (convert_flownet_s,
                                                   convert_pose_resnet)
    from tests.fixtures import make_posetrack_fixture

    small = ["model.num_layers=18", "model.image_size=64,64",
             "model.heatmap_size=16,16"]
    save_npz_variables(str(tmp_path / "p.npz"), convert_pose_resnet(
        get_pose_net(ModelConfig(num_layers=18)).state_dict()))
    save_npz_variables(str(tmp_path / "f.npz"), convert_flownet_s(
        get_flow_net(FlowConfig()).state_dict()))
    save_image(str(tmp_path / "0.png"), np.zeros((32, 32, 3), np.uint8))
    save_image(str(tmp_path / "1.png"), np.zeros((32, 32, 3), np.uint8))
    (tmp_path / "boxes.json").write_text("[[4, 4, 10, 20]]")
    (tmp_path / "dets.json").write_text(
        json.dumps([[{"bbox": [4, 4, 10, 20]}]] * 2))
    weights = ["--pose-weights", str(tmp_path / "p.npz"),
               "--flow-weights", str(tmp_path / "f.npz")]
    if cli == "test":
        root, _, det = make_coco_fixture(tmp_path / "coco", n_images=1)
        main, args = test.main, ["--weights", str(tmp_path / "p.npz"),
                                 f"data.root={root}",
                                 f"test.bbox_file={det}", *small]
    elif cli == "track":
        root, _ = make_posetrack_fixture(tmp_path / "pt", n_videos=1,
                                         n_frames=2)
        main, args = track.main, [*weights, "--out", str(tmp_path / "o"),
                                  f"data.root={root}", "data.test_set=val",
                                  *small]
    elif cli == "track_video":
        main, args = track_video.main, [
            *weights, "--video", str(tmp_path), "--detections",
            str(tmp_path / "dets.json"), "--clip-len", "2", *small]
    elif cli == "demo":
        main, args = demo.main, ["--weights", str(tmp_path / "p.npz"),
                                 "--image", str(tmp_path / "0.png"),
                                 "--boxes", str(tmp_path / "boxes.json"),
                                 *small]
    else:
        main, args = eval_flow.main, ["--weights", str(tmp_path / "f.npz"),
                                      "--frames", str(tmp_path),
                                      "--save-flo", str(tmp_path / "flo")]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(args)
    assert not (tmp_path / "o").exists() and not (tmp_path / "flo").exists()
