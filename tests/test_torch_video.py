"""The port's video utilities against the JAX reference's, on the CPU.

``clip_spans``, ``pad_tail_clip``, ``stitch_ids``, the lazy frame readers
and ``track_video_clips``, the last on the random PoseResNet-18 (64x48) +
FlowNetC models of tests/test_torch_clip_pipeline.py with a chained ragged
tail and a detection dropped at a clip boundary: ids and valid equal,
joints within 1e-3 px, maxvals and scores within 1e-5 relative.
"""

import numpy as np
import pytest

from flowtrack_tpu.utils import video as jvideo
from flowtrack_tpu_torch.utils import video as tvideo
from tests.fixtures import save_image
from tests.test_torch_clip_pipeline import P, trackers  # noqa: F401


@pytest.mark.parametrize("n,clip_len", [(10, 4), (11, 4), (3, 4), (4, 4),
                                        (9, 2), (1, 1), (2, 2), (40, 16)])
def test_clip_spans_match_reference(n, clip_len):
    assert tvideo.clip_spans(n, clip_len) == jvideo.clip_spans(n, clip_len)


def test_clip_spans_rejects_degenerate_clip_len():
    for clip_len in (1, 0):
        with pytest.raises(ValueError):
            tvideo.clip_spans(3, clip_len)


@pytest.mark.parametrize("real", [2, 4, 5])
def test_pad_tail_clip_matches_reference(real):
    """A tail of ``real`` frames padded to 4: replicated last frame, empty
    detections, the frame_valid mask and the real count; a full clip
    passes through with no mask."""
    rng = np.random.default_rng(40)
    window = rng.integers(0, 256, (real, 6, 8, 3), np.uint8)
    boxes = [[[1, 2, 3, 4]] * (t % 2 + 1) for t in range(real)]
    scores = [[0.9] * (t % 2 + 1) for t in range(real)]
    got = tvideo.pad_tail_clip(window, boxes, scores, 4)
    want = jvideo.pad_tail_clip(window, boxes, scores, 4)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[2] == want[2] and got[4] == want[4]
    if want[3] is None:
        assert got[3] is None
    else:
        np.testing.assert_array_equal(got[3], want[3])


def test_stitch_ids_matches_reference():
    rng = np.random.default_rng(41)
    poses = rng.uniform(0, 100, (4, 17, 2))
    prev_ids, nxt_ids = [5, 9, 11, 2], [0, 1, 2, 3]
    moved = poses[[2, 0, 3, 1]] + rng.normal(0, 0.5, (4, 17, 2))
    moved[3] += 60                               # no longer matches
    for nxt in (poses[[2, 0, 1]], moved, poses[:0]):
        got = tvideo.stitch_ids(poses, prev_ids, nxt, nxt_ids)
        assert got == jvideo.stitch_ids(poses, prev_ids, nxt, nxt_ids)
    assert tvideo.stitch_ids(poses, prev_ids, poses[[2, 0, 1]],
                             nxt_ids) == {0: 11, 1: 5, 2: 9}


def _video(n, drop_at):
    """Two persons moving 1 px a frame on a textured 64x64 background; the
    second one's detection dropped at global frame ``drop_at``."""
    rng = np.random.default_rng(42)
    base = np.random.default_rng(99).uniform(0, 255, (64, 64, 3))
    frames = np.stack([np.clip(base + rng.normal(0, 3, base.shape), 0, 255)
                       for _ in range(n)]).astype(np.float32)
    boxes, scores = [], []
    for t in range(n):
        b, s = [[8 + t, 10, 20, 30], [36, 12 + t, 18, 28]], [0.9, 0.8]
        if t == drop_at:
            b, s = b[:1], s[:1]
        boxes.append(b)
        scores.append(s)
    return frames, boxes, scores


def _assert_frames_equal(got, want):
    assert len(got) == len(want)
    for t, (g, w) in enumerate(zip(got, want)):
        assert [x["track_id"] for x in g] == [x["track_id"] for x in w], t
        for a, b in zip(g, w):
            np.testing.assert_allclose(a["joints"], b["joints"], atol=1e-3,
                                       rtol=0)
            np.testing.assert_allclose(a["maxvals"], b["maxvals"], rtol=1e-5,
                                       atol=1e-9)
            np.testing.assert_allclose(a["score"], b["score"], rtol=1e-5)


def test_track_video_clips_matches_reference(trackers):  # noqa: F811
    """9 frames in clips of 4: spans [0..3], [3..6], [6..8] (a tail padded
    to 4 frames), the second person missed at frame 3, the boundary frame
    clips 1 and 2 share; then 6 frames in one clip padded to 8."""
    ref, port = trackers
    frames, boxes, scores = _video(9, drop_at=3)
    want = jvideo.track_video_clips(ref, frames, boxes, scores, clip_len=4,
                                    max_persons=P)
    got = tvideo.track_video_clips(port, frames, boxes, scores, clip_len=4,
                                   max_persons=P)
    _assert_frames_equal(got, want)
    assert all(len(fr) >= 1 for fr in got)
    assert len({x["track_id"] for fr in got for x in fr}) < 9 * 2
    want = jvideo.track_video_clips(ref, frames[:6], boxes, scores,
                                    clip_len=8, max_persons=P)
    got = tvideo.track_video_clips(port, frames[:6], boxes, scores,
                                   clip_len=8, max_persons=P)
    _assert_frames_equal(got, want)


def test_lazy_frame_sequence_and_frame_paths(tmp_path):
    """LazyFrameSequence loads only the frames indexed, with the port's own
    load_image by default (equal to the reference's); frame_paths and
    iter_video_frames read a frame directory in name order."""
    from flowtrack_tpu.data.pose_dataset import load_image as j_load_image
    from flowtrack_tpu_torch.data.pose_dataset import load_image

    rng = np.random.default_rng(43)
    paths = []
    for i in range(4):
        p = str(tmp_path / f"{i:03d}.png")
        save_image(p, rng.integers(0, 255, (8, 10, 3)).astype(np.uint8))
        paths.append(p)
    (tmp_path / "notes.txt").write_text("not a frame")
    assert tvideo.frame_paths(str(tmp_path)) == jvideo.frame_paths(
        str(tmp_path)) == paths
    assert tvideo.IMG_EXTS == jvideo.IMG_EXTS
    calls = []

    def loader(p):
        calls.append(p)
        return load_image(p)

    seq = tvideo.LazyFrameSequence(paths, loader=loader)
    assert len(seq) == 4
    win = seq[[1, 2]]
    assert win.shape == (2, 8, 10, 3) and calls == [paths[1], paths[2]]
    np.testing.assert_array_equal(seq[1], win[0])
    default = tvideo.LazyFrameSequence(paths)
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(default[i], j_load_image(p))
    frames = list(tvideo.iter_video_frames(str(tmp_path)))
    np.testing.assert_array_equal(np.stack(frames), default[[0, 1, 2, 3]])


def test_sequential_video_frames_with_a_fake_capture():
    """SequentialVideoFrames over a cv2.VideoCapture stand-in: each frame
    decoded once per forward pass, the overlap frame from the cache, BGR
    turned into RGB, a jump back restarts the pass, no frame count raises,
    an overcounting header freezes the last decodable frame."""
    decode_log = []

    class FakeCap:
        """frame i = constant BGR value i, blue marked 200 + i."""

        def __init__(self, path, n=10):
            self._i, self._n = 0, n

        def isOpened(self):
            return True

        def get(self, prop):
            return self._n

        def read(self):
            if self._i >= self._n:
                return False, None
            decode_log.append(self._i)
            frame = np.full((4, 4, 3), self._i, np.uint8)
            frame[..., 0] = 200 + self._i
            self._i += 1
            return True, frame

        def release(self):
            pass

    seq = tvideo.SequentialVideoFrames("fake.mp4", cache_frames=2,
                                       capture_factory=FakeCap)
    assert len(seq) == 10
    w0 = seq[list(range(0, 4))]
    w1 = seq[list(range(3, 7))]
    assert int(w0[1, 0, 0, 2]) == 201 and int(w0[1, 0, 0, 0]) == 1
    np.testing.assert_array_equal(w1[0], w0[3])
    assert decode_log == list(range(7))
    decode_log.clear()
    for t in range(10):
        assert int(seq[t][0, 0, 1]) == t
    assert decode_log == list(range(10))
    with pytest.raises(IndexError):
        seq[10]

    class NoCount(FakeCap):
        def get(self, prop):
            return 0

    with pytest.raises(ValueError):
        tvideo.SequentialVideoFrames("fake.mp4", capture_factory=NoCount)

    class OverCount(FakeCap):
        def read(self):
            if self._i >= 6:
                return False, None
            return super().read()

    decode_log.clear()
    seq = tvideo.SequentialVideoFrames("fake.mp4", cache_frames=2,
                                       capture_factory=OverCount)
    w = seq[list(range(4, 10))]
    np.testing.assert_array_equal(w[2], w[1])
    np.testing.assert_array_equal(w[5], w[1])
    assert int(w[1][0, 0, 1]) == 5 and decode_log == list(range(6))
