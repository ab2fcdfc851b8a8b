"""The traffic is a function of the seed, and its padding is the
tracker's."""

import json

import numpy as np
import torch

from conftest import ROOT


def small(**kw):
    tr = json.load(open(ROOT / "portbench" / "traffic" / "offline-crowd.json"))
    tr.update(frame_hw=[96, 128], video_frames=7, videos=2,
              box_width=[20, 40], persons=[2, 5], texture_cell=8, **kw)
    return tr


def test_the_same_seed_gives_the_same_pool():
    from portbench import video

    a = video.make_videos(small(), 2 ** 31 + 11, torch.device("cpu"))
    b = video.make_videos(small(), 2 ** 31 + 11, torch.device("cpu"))
    c = video.make_videos(small(), 2 ** 31 + 12, torch.device("cpu"))
    for x, y in zip(a, b):
        assert np.array_equal(x.frames, y.frames)
        for bx, by, sx, sy in zip(x.boxes, y.boxes, x.scores, y.scores):
            assert np.array_equal(bx, by) and np.array_equal(sx, sy)
    assert not np.array_equal(a[0].frames, c[0].frames)


def test_detections_move_at_constant_velocity_and_some_are_missed():
    from portbench import video

    tr = small(miss_rate=0.0)
    v = video.make_videos(tr, 5, torch.device("cpu"))[0]
    assert all(len(b) == len(v.boxes[0]) for b in v.boxes)
    lo, hi = tr["persons"]
    assert lo <= len(v.boxes[0]) <= hi
    # each person keeps its size and score; its step is constant
    first = {float(s): b for b, s in zip(v.boxes[0], v.scores[0])}
    second = {float(s): b for b, s in zip(v.boxes[1], v.scores[1])}
    third = {float(s): b for b, s in zip(v.boxes[2], v.scores[2])}
    for s, b in first.items():
        assert np.allclose(second[s][2:], b[2:])
        assert np.allclose(third[s][:2] - second[s][:2], second[s][:2] - b[:2],
                           atol=1e-4)
    missed = video.make_videos(small(miss_rate=0.5), 5, torch.device("cpu"))
    assert sum(map(len, missed[0].boxes)) < sum(map(len, v.boxes))


def test_padding_is_the_trackers():
    from flowtrack_tpu_torch.tracking.clip_pipeline import pad_detections
    from portbench import video

    v = video.make_videos(small(), 9, torch.device("cpu"))[1]
    got = video.padded(v, 3)
    want = pad_detections(v.boxes, v.scores, 3)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
