"""The port's vis and logging modules against the JAX package's, on the
CPU: drawn skeletons, heatmap grids, flow colors, written images and debug
dumps byte for byte; the jsonl metrics line for line; the log format."""

import json
import logging

import numpy as np
import pytest

from flowtrack_tpu.utils import logging as ref_logging
from flowtrack_tpu.utils import vis as ref_vis
from flowtrack_tpu_torch.data.pose_dataset import load_image
from flowtrack_tpu_torch.utils import logging as port_logging
from flowtrack_tpu_torch.utils import vis


@pytest.mark.parametrize("with_conf", [False, True])
def test_draw_skeleton_matches_reference(with_conf):
    """Poses partly off the image, with and without confidences under the
    threshold, several track ids: the same pixels."""
    rng = np.random.default_rng(0)
    for track_id in range(4):
        img = rng.integers(0, 255, (90, 120, 3), np.uint8)
        joints = rng.uniform(-10, 130, (17, 2))
        conf = rng.uniform(0, 1, 17) if with_conf else None
        got = vis.draw_skeleton(img.copy(), joints, conf, 0.3, track_id)
        want = ref_vis.draw_skeleton(img.copy(), joints, conf, 0.3, track_id)
        np.testing.assert_array_equal(got, want)
        assert (got != img).any()


def test_heatmaps_to_grid_matches_reference():
    rng = np.random.default_rng(1)
    for k, cols in ((17, 5), (16, 4), (3, 5)):
        hm = rng.uniform(0, 1, (16, 12, k)).astype(np.float32)
        hm[..., 0] = 0.25   # a flat map
        got, want = vis.heatmaps_to_grid(hm, cols), \
            ref_vis.heatmaps_to_grid(hm, cols)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_flow", [None, 2.0, 50.0])
def test_flow_to_color_matches_reference(max_flow):
    rng = np.random.default_rng(2)
    flow = rng.normal(0, 4, (24, 32, 2)).astype(np.float32)
    flow[0, 0] = 0.0
    np.testing.assert_array_equal(vis.flow_to_color(flow, max_flow),
                                  ref_vis.flow_to_color(flow, max_flow))
    np.testing.assert_array_equal(vis._WHEEL, ref_vis._WHEEL)


def test_save_image_matches_reference(tmp_path):
    """Color and grayscale images written by both read back equal, and
    equal to what was written."""
    rng = np.random.default_rng(3)
    for name, img in (("rgb", rng.integers(0, 255, (20, 30, 3), np.uint8)),
                      ("gray", rng.integers(0, 255, (20, 30), np.uint8))):
        vis.save_image(str(tmp_path / f"port_{name}.png"), img)
        ref_vis.save_image(str(tmp_path / f"ref_{name}.png"), img)
        got = np.asarray(load_image(str(tmp_path / f"port_{name}.png")))
        want = np.asarray(load_image(str(tmp_path / f"ref_{name}.png")))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, img if img.ndim == 3 else np.repeat(img[..., None], 3, -1))


def test_save_debug_images_matches_reference(tmp_path):
    """The validate loop's debug dump: the same files, the same pixels."""
    rng = np.random.default_rng(4)
    crops = rng.normal(0, 1, (3, 32, 24, 3)).astype(np.float32)
    hms = rng.uniform(0, 1, (3, 8, 6, 17)).astype(np.float32)
    vis.save_debug_images(crops, hms, str(tmp_path / "port"), limit=2)
    ref_vis.save_debug_images(crops, hms, str(tmp_path / "ref"), limit=2)
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 4
    for name in names:
        np.testing.assert_array_equal(load_image(str(tmp_path / "port" / name)),
                                      load_image(str(tmp_path / "ref" / name)))


def test_metrics_writer_matches_reference(tmp_path, monkeypatch):
    """The same jsonl lines at the same clock; appends across writers."""
    monkeypatch.setattr("time.time", lambda: 1234.5)
    for mod, name in ((port_logging, "port"), (ref_logging, "ref")):
        for start in (1, 3):
            w = mod.MetricsWriter(str(tmp_path / name / "m.jsonl"))
            w.write(start, loss=np.float32(0.5), acc=0.9)
            w.write(start + 1, loss=0.25)
            w.close()
    got = (tmp_path / "port" / "m.jsonl").read_text()
    assert got == (tmp_path / "ref" / "m.jsonl").read_text()
    lines = [json.loads(line) for line in got.splitlines()]
    assert [r["step"] for r in lines] == [1, 2, 3, 4]
    assert lines[0] == {"step": 1, "time": 1234.5, "loss": 0.5, "acc": 0.9}


def test_metrics_writer_tensorboard_mirror(tmp_path):
    """With a TensorBoard directory the jsonl is the same; the mirror is
    torch's SummaryWriter where it imports, and nothing otherwise."""
    w = port_logging.MetricsWriter(str(tmp_path / "m.jsonl"),
                                   tensorboard_dir=str(tmp_path / "tb"))
    w.write(1, loss=0.5)
    w.close()
    assert json.loads((tmp_path / "m.jsonl").read_text())["loss"] == 0.5
    try:
        from torch.utils.tensorboard import SummaryWriter  # noqa: F401
    except Exception:
        assert w._tb is None
    else:
        assert any((tmp_path / "tb").iterdir())


def test_setup_logging_format_matches_reference(tmp_path):
    """The same handlers and format; the log file gets the records."""
    records = {}
    for mod, name in ((port_logging, "port"), (ref_logging, "ref")):
        mod.setup_logging(str(tmp_path / name / "run.log"))
        root = logging.getLogger()
        records[name] = [(type(h).__name__, h.formatter._fmt)
                         for h in root.handlers]
        logging.getLogger("flowtrack.test").info("hello %d", 3)
        for h in root.handlers:
            h.flush()
        assert "flowtrack.test INFO: hello 3" in \
            (tmp_path / name / "run.log").read_text()
    assert records["port"] == records["ref"]
    logging.basicConfig(handlers=[logging.NullHandler()], force=True)
