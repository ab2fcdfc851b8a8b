"""The port's ``tools/track_video`` CLI on the CPU: one stream against the
JAX package's ``tools/track_video.py`` on the same frames, detections and
``.npz`` weights (R18 at 64x64, FlowNetS; tests/test_track_video_cli.py's
setup), with its renders; then the port's two-stream run (the streams as
lanes of one batched run, ``serving.MultiStreamTracker``) held to the
port's one-stream runs, as the reference's own test holds the reference.
"""

import contextlib
import io
import json
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from flowtrack_tpu import config as ref_config
from flowtrack_tpu.engine.checkpoint import save_npz_variables as ref_save_npz
from flowtrack_tpu.models.flownet import FlowNetS as RefFlowNetS
from flowtrack_tpu.models.pose_resnet import get_pose_net as ref_get_pose_net
from flowtrack_tpu_torch.data.pose_dataset import load_image
from flowtrack_tpu_torch.tools import track_video
from tests.fixtures import save_image
from tools import track_video as ref_track_video

OPTS = ["model.num_layers=18", "model.image_size=64,64",
        "model.heatmap_size=16,16", "model.dtype=float32",
        "flow.dtype=float32", "track.pose_score_thre=0.0"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tv_cli")
    rng = np.random.default_rng(0)
    vids = {}
    for vi, name in enumerate(("vid_a", "vid_b")):
        d = tmp / name
        d.mkdir()
        dets = []
        for t in range(5):
            img = rng.uniform(0, 120, (96, 128, 3)).astype(np.uint8)
            save_image(str(d / f"{t:04d}.png"), img)
            x = 20 + 8 * vi + 5 * t
            dets.append([{"bbox": [x, 30, 30, 40], "score": 0.9}])
        with open(tmp / f"{name}.json", "w") as f:
            json.dump(dets, f)
        vids[name] = (str(d), str(tmp / f"{name}.json"))
    pose = ref_get_pose_net(ref_config.ModelConfig(
        num_layers=18, image_size=(64, 64), heatmap_size=(16, 16),
        dtype="float32"))
    ref_save_npz(str(tmp / "pose.npz"), jax.jit(
        pose.init, static_argnames="train")(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    flow = RefFlowNetS(dtype=jnp.float32)
    ref_save_npz(str(tmp / "flow.npz"), jax.jit(
        flow.init, static_argnames="train")(
            jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 6)), train=False))
    return tmp, vids


def argv(tmp, out, videos, detections, *extra):
    return ["--pose-weights", str(tmp / "pose.npz"),
            "--flow-weights", str(tmp / "flow.npz"),
            "--video", *videos, "--detections", *detections,
            "--out", str(tmp / out), "--clip-len", "3", *extra, *OPTS]


def run_port(tmp, out, videos, detections, *extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        track_video.main(argv(tmp, out, videos, detections, *extra,
                              "--device", "cpu"))
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def tracks(path):
    with open(path / "tracks.json") as f:
        return json.load(f)


def assert_same_tracks(got, want, atol):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["frame"] == w["frame"] and g["track_id"] == w["track_id"]
        np.testing.assert_allclose(g["keypoints"], w["keypoints"], rtol=0,
                                   atol=atol)
        assert g["score"] == pytest.approx(w["score"], abs=atol)


def test_one_stream_matches_reference(setup, monkeypatch):
    """One video: the printed counts equal, tracks.json's ids equal and
    joints within 1e-3 px, a render of every frame."""
    tmp, vids = setup
    va, da = vids["vid_a"]
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", [
        "track_video.py", "--compile-cache=",
        *argv(tmp, "ref_a", [va], [da], "--render")])
    with contextlib.redirect_stdout(buf):
        ref_track_video.main()
    want = json.loads(buf.getvalue().strip().splitlines()[-1])
    got = run_port(tmp, "port_a", [va], [da], "--render")
    assert got == want
    assert_same_tracks(tracks(tmp / "port_a"), tracks(tmp / "ref_a"), 1e-3)
    names = sorted(p.name for p in (tmp / "ref_a").glob("*.png"))
    assert len(names) == 5
    assert names == sorted(p.name for p in (tmp / "port_a").glob("*.png"))
    for name in names:
        assert load_image(str(tmp / "port_a" / name)).shape == (96, 128, 3)


def test_two_streams_match_the_port_alone(setup):
    """Two videos through one batched run a step give each video's
    one-stream tracks.json (the reference's own test, on the port)."""
    tmp, vids = setup
    (va, da), (vb, db) = vids["vid_a"], vids["vid_b"]
    singles = {name: run_port(tmp, f"single_{name}", [v], [d])
               for name, (v, d) in vids.items()}
    multi = run_port(tmp, "multi", [va, vb], [da, db])
    assert multi == {"streams": 2, "instances": sum(
        s["instances"] for s in singles.values())}
    for name in vids:
        assert_same_tracks(tracks(tmp / "multi" / name),
                           tracks(tmp / f"single_{name}"), 1e-4)
