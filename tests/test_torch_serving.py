"""The port's serving classes against the JAX reference, on the CPU.

The unsharded scenarios of tests/test_serving.py, run through the port's
``MultiStreamTracker`` / ``StreamingClipTracker`` on the stub models of
tests/test_torch_clip_scenarios.py and held to the reference's
``track_video_clips`` (and ``MultiStreamTracker``) with its stub models on
the same inputs: every emitted frame's tracks in the same order with the
same ids, joints within 1e-3 px, maxvals and scores within 1e-5 relative.
Each test also keeps the reference test's own assertions (exactly-once
emission, the pipelined step's lag, latency accounting, submit
validation). The last tests hold the program's tracing
(``utils/profiling``) on the same stubs: off it records nothing and
changes no output; on, the same tracks, the stage stamps, the spans and
the pose counters against a hand count.
"""

import functools

import numpy as np
import torch
import pytest

from flowtrack_tpu.serving import MultiStreamTracker as JMultiStreamTracker
from flowtrack_tpu.tracking.clip_pipeline import ClipTracker as JClipTracker
from flowtrack_tpu.utils.video import track_video_clips as j_track_video_clips
from flowtrack_tpu_torch.serving import MultiStreamTracker, StreamingClipTracker
from flowtrack_tpu_torch.tracking.clip_pipeline import (ClipTracker,
                                                        pad_detections)
from flowtrack_tpu_torch.utils import graphs as graphs_mod
from flowtrack_tpu_torch.utils import profiling
from flowtrack_tpu_torch.utils.graphs import GraphCache
from tests.test_clip_pipeline import StubFlow, StubPose, make_cfg
from tests.test_serving import CLIP, H, W, scenario_a, scenario_b
from tests.test_torch_clip_scenarios import StubFlowTorch, StubPoseTorch


@functools.lru_cache(maxsize=None)
def ref_tracker():
    return JClipTracker(make_cfg(), StubPose(), {}, StubFlow(), {})


@functools.lru_cache(maxsize=None)
def port_tracker():
    return ClipTracker(make_cfg(), StubPoseTorch(), StubFlowTorch(),
                       device="cpu")


def reference_stream(frames, boxes, scores, clip_len=CLIP):
    return j_track_video_clips(ref_tracker(), frames, boxes, scores,
                               clip_len=clip_len)


def assert_frames_equal(got, want):
    """Per frame: the same tracks in the same order with the same ids;
    joints 1e-3 px, maxvals and score 1e-5 relative."""
    assert len(got) == len(want)
    for t, (g, w) in enumerate(zip(got, want)):
        assert g is not None, t
        assert [x["track_id"] for x in g] == [x["track_id"] for x in w], t
        for a, b in zip(g, w):
            np.testing.assert_allclose(a["joints"], b["joints"], atol=1e-3,
                                       rtol=0)
            np.testing.assert_allclose(a["maxvals"], b["maxvals"], rtol=1e-5,
                                       atol=1e-9)
            np.testing.assert_allclose(a["score"], b["score"], rtol=1e-5)


def collect(emitted, lengths):
    """(stream, first frame, tracks) emissions -> per-stream frame lists;
    every frame emitted exactly once."""
    got = {sid: [None] * n for sid, n in lengths.items()}
    for sid, first, tracks in emitted:
        for i, fr in enumerate(tracks):
            assert got[sid][first + i] is None, (sid, first + i)
            got[sid][first + i] = fr
    return got


@pytest.mark.parametrize("n", [10, 11])
def test_multistream_matches_per_stream_reference(n):
    """Two streams batched (A leads B by 2 frames), clips of 4, with and
    without a ragged tail: each stream equals the reference's
    track_video_clips on it alone; A's person, undetected at the boundary
    frame 3, keeps one global id."""
    fa, ba, sa = scenario_a(n)
    fb, bb, sb = scenario_b(n)
    mst = MultiStreamTracker(port_tracker(), clip_len=CLIP, batch_streams=2)
    emitted = []
    for t in range(n + 2):
        if t < n:
            mst.submit("A", fa[t], ba[t], sa[t])
        if 2 <= t < n + 2:
            mst.submit("B", fb[t - 2], bb[t - 2], sb[t - 2])
        emitted += mst.step()
    emitted += mst.flush()
    got = collect(emitted, {"A": n, "B": n})
    assert_frames_equal(got["A"], reference_stream(fa, ba, sa))
    assert_frames_equal(got["B"], reference_stream(fb, bb, sb))
    assert len({tr["track_id"] for fr in got["A"] for tr in fr}) == 1


def _run_both_streams(tracker_cls, tracker, n, depth):
    fa, ba, sa = scenario_a(n)
    fb, bb, sb = scenario_b(n)
    mst = tracker_cls(tracker, clip_len=CLIP, batch_streams=2,
                      pipeline_depth=depth)
    emitted = []
    for t in range(n):
        mst.submit("A", fa[t], ba[t], sa[t])
        mst.submit("B", fb[t], bb[t], sb[t])
        emitted += mst.step()
    emitted += mst.flush()
    assert mst.latency_stats()["count"] == 2 * n
    return collect(emitted, {"A": n, "B": n})


@pytest.mark.parametrize("n", [10, 11])
def test_pipelined_serving_matches_unpipelined(n):
    """pipeline_depth 1 changes when emissions surface, never what they
    are: equal to depth 0, and each depth equal to the reference's
    MultiStreamTracker at that depth."""
    want = {d: _run_both_streams(JMultiStreamTracker, ref_tracker(), n, d)
            for d in (0, 1)}
    got = {d: _run_both_streams(MultiStreamTracker, port_tracker(), n, d)
           for d in (0, 1)}
    for sid in ("A", "B"):
        assert_frames_equal(got[1][sid], got[0][sid])
        for d in (0, 1):
            assert_frames_equal(got[d][sid], want[d][sid])


def test_pipelined_step_defers_one_batch():
    """With depth 1 the first ready batch's emissions surface on the next
    dispatch (t = 2*CLIP - 2), not when it became ready (t = CLIP - 1);
    the flush emits the rest, equal to the reference's stream."""
    n = 2 * CLIP
    fa, ba, sa = scenario_a(n)
    mst = MultiStreamTracker(port_tracker(), clip_len=CLIP, batch_streams=1,
                             pipeline_depth=1)
    seen_at, emitted = {}, []
    for t in range(n):
        mst.submit("A", fa[t], ba[t], sa[t])
        for item in mst.step():
            seen_at[item[1]] = t
            emitted.append(item)
    assert seen_at.get(0) == 2 * CLIP - 2, seen_at
    left = mst.flush()
    assert sum(len(tr) for _, _, tr in left) == n - CLIP
    got = collect(emitted + left, {"A": n})
    assert_frames_equal(got["A"], reference_stream(fa, ba, sa))


def test_latency_stats_cover_every_emitted_frame():
    """One latency sample per emitted frame, through batched steps, the
    overlap frame's dedup and the ragged flush tail; ordered percentiles;
    reset_latency_stats restarts the window and keeps the buffered frames'
    submit stamps."""
    n = 11
    fa, ba, sa = scenario_a(n)
    fb, bb, sb = scenario_b(n)
    mst = MultiStreamTracker(port_tracker(), clip_len=CLIP, batch_streams=2)
    assert mst.latency_stats() == {"count": 0}
    emitted = []
    for t in range(n):
        mst.submit("A", fa[t], ba[t], sa[t])
        mst.submit("B", fb[t], bb[t], sb[t])
        emitted += mst.step()
    assert mst.latency_stats()["count"] == sum(len(tr) for _, _, tr in emitted)
    emitted += mst.flush()
    assert sum(len(tr) for _, _, tr in emitted) == 2 * n
    stats = mst.latency_stats()
    assert stats["count"] == 2 * n
    assert 0.0 < stats["p50_ms"] <= stats["p90_ms"] <= stats["p99_ms"] \
        <= stats["max_ms"]

    mst2 = MultiStreamTracker(port_tracker(), clip_len=CLIP, batch_streams=2)
    for t in range(CLIP):
        mst2.submit("A", fa[t], ba[t], sa[t])
        mst2.submit("B", fb[t], bb[t], sb[t])
        mst2.step()
    assert mst2.latency_stats()["count"] == 2 * CLIP
    mst2.reset_latency_stats()
    assert mst2.latency_stats() == {"count": 0}
    for t in range(CLIP, 2 * CLIP - 1):
        mst2.submit("A", fa[t], ba[t], sa[t])
        mst2.submit("B", fb[t], bb[t], sb[t])
        mst2.step()
    assert mst2.latency_stats()["count"] == 2 * (CLIP - 1)


def test_single_ready_stream_with_force():
    """One ready stream of four waits without force; a forced step runs it
    alone and the flush ends it, equal to the reference's stream."""
    n = 6
    fa, ba, sa = scenario_b(n)
    mst = MultiStreamTracker(port_tracker(), clip_len=CLIP, batch_streams=4)
    for t in range(n):
        mst.submit("solo", fa[t], ba[t], sa[t])
        assert mst.step() == []
    out = mst.step(force=True)
    out += mst.flush()
    got = collect(out, {"solo": n})
    assert_frames_equal(got["solo"], reference_stream(fa, ba, sa))


def test_backlog_flush_chains_full_clips():
    """Everything submitted up front and only flush() called: the backlog
    goes through clip-shaped runs, streams of unequal length each equal
    the reference's run on them."""
    data = {"A": scenario_a(10), "B": scenario_b(17)}
    mst = MultiStreamTracker(port_tracker(), clip_len=CLIP, batch_streams=2)
    for sid, (f, b, s) in data.items():
        for t in range(len(f)):
            mst.submit(sid, f[t], b[t], s[t])
    got = collect(mst.flush(), {sid: len(d[0]) for sid, d in data.items()})
    for sid, d in data.items():
        assert_frames_equal(got[sid], reference_stream(*d))


def test_submit_validates_at_the_boundary():
    """submit() rejects malformed input naming the stream, with the
    reference's messages, and buffers nothing of it."""
    mst = MultiStreamTracker(port_tracker(), clip_len=CLIP, batch_streams=2)
    ref = JMultiStreamTracker(ref_tracker(), clip_len=CLIP, batch_streams=2)
    frame = np.zeros((H, W, 3), np.float32)
    bad = [("B", np.zeros((H, W), np.float32), [], []),
           ("B", np.zeros((H, W, 4), np.float32), [], []),
           ("B", np.zeros((H // 2, W, 3), np.float32), [], []),
           ("A", np.zeros((H, W, 3), np.uint8), [], []),
           ("A", frame, [[1, 2, 3, 4], [5, 6, 7, 8]], [0.9]),
           ("A", frame, [[1, 2, 3]], [0.9])]
    for tracker in (mst, ref):
        tracker.submit("A", frame, [[1, 2, 3, 4]], [0.9])
    for args in bad:
        with pytest.raises(ValueError) as got:
            mst.submit(*args)
        with pytest.raises(ValueError) as want:
            ref.submit(*args)
        assert str(got.value) == str(want.value)
        assert repr(args[0]) in str(got.value)
    assert len(mst._frames["A"]) == 1 and "B" not in mst._frames


def test_streaming_clip_len_2_matches_reference():
    """StreamingClipTracker: the first step emits nothing, the second
    frames 0 and 1, every later step exactly the frame it submitted; the
    whole sequence equals the reference's track_video_clips at clip_len 2;
    flush has nothing left; one latency sample per frame."""
    n = 9
    fa, ba, sa = scenario_b(n)
    st = StreamingClipTracker(port_tracker())
    got = [None] * n
    for t in range(n):
        emitted = st.step(fa[t], ba[t], sa[t])
        assert [idx for idx, _ in emitted] == (
            [] if t == 0 else [0, 1] if t == 1 else [t]), t
        for idx, fr in emitted:
            assert got[idx] is None
            got[idx] = fr
    assert st.flush() == []
    assert st.latency_stats()["count"] == n
    assert_frames_equal(got, reference_stream(fa, ba, sa, clip_len=2))
    st.reset_latency_stats()
    assert st.latency_stats() == {"count": 0}


def test_streaming_single_frame_flush():
    """A stream that only ever saw one frame emits it at flush, equal to
    the reference's run of that frame."""
    fa, ba, sa = scenario_b(2)
    st = StreamingClipTracker(port_tracker())
    assert st.step(fa[0], ba[0], sa[0]) == []
    out = st.flush()
    assert [idx for idx, _ in out] == [0] and len(out[0][1]) >= 1
    assert_frames_equal([out[0][1]],
                        reference_stream(fa[:1], ba[:1], sa[:1], clip_len=2))


def _two_streams(tracker, n=7):
    """Streams A and B of ``n`` frames, batched in two-lane 4-frame clips
    (7 frames: two clips each, the second with its overlap frame
    skipped), at pipeline depth 0; the emissions in order."""
    fa, ba, sa = scenario_a(n)
    fb, bb, sb = scenario_b(n)
    mst = MultiStreamTracker(tracker, clip_len=CLIP, batch_streams=2)
    emitted = []
    for t in range(n):
        mst.submit("A", fa[t], ba[t], sa[t])
        mst.submit("B", fb[t], bb[t], sb[t])
        emitted += mst.step()
    return emitted + mst.flush()


def _grown(before):
    after = profiling.snapshot()
    return {k: {"total_s": v["total_s"] - before.get(k, {}).get("total_s", 0),
                "count": v["count"] - before.get(k, {}).get("count", 0)}
            for k, v in after.items() if v != before.get(k)}


def _one_batch(tracker):
    fa, ba, sa = scenario_a(CLIP)
    fb, bb, sb = scenario_b(CLIP)
    dets = [pad_detections(b, s, tracker.max_persons)
            for b, s in ((ba, sa), (bb, sb))]
    return tracker.prepare_lanes(np.stack([fa, fb]),
                                 *(np.stack(x) for x in zip(*dets)))


@pytest.fixture
def tracing():
    profiling.enable()
    yield
    profiling.disable()


def test_tracing_off_records_nothing_and_keeps_six_outputs(monkeypatch):
    """With tracing off a serving run enters no span of the program and
    records nothing, and the clip program returns its six outputs."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(profiling, "record_function", refuse)
    tracker = port_tracker()
    before = profiling.snapshot()
    assert sum(len(fr) for _, _, tr in _two_streams(tracker) for fr in tr)
    assert len(tracker.run_prepared_lanes(_one_batch(tracker))) == 6
    assert profiling.snapshot() == before


def test_tracing_on_gives_the_same_tracks_and_counts_the_work(tracing):
    """Tracing on: the emissions equal tracing off's bit for bit; the
    clip returns its seven stamps in order, whose stages add up to end
    minus start; the serving spans nest; the pose counters equal a hand
    count of the planted detections (A: 6 reported and the 1 recovered at
    its missed frame 3; B: 12) against every row both pose passes ran (2
    batches of 2 lanes x 4 frames x 4 slots plus 4 recovered a lane,
    no flip test); the new frames are 4 + 3 a lane."""
    tracker = port_tracker()
    profiling.disable()
    off = _two_streams(tracker)
    profiling.enable()
    before = profiling.snapshot()
    on = _two_streams(tracker)
    grown = _grown(before)
    assert [(s, f, len(tr)) for s, f, tr in on] == \
        [(s, f, len(tr)) for s, f, tr in off]
    for (_, _, a), (_, _, b) in zip(off, on):
        for fa, fb in zip(a, b):
            assert [x["track_id"] for x in fa] == [x["track_id"] for x in fb]
            for x, y in zip(fa, fb):
                assert np.array_equal(x["joints"], y["joints"])
                assert np.array_equal(x["maxvals"], y["maxvals"])
                assert x["score"] == y["score"]
    emitted = sum(len(fr) for _, _, tr in on for fr in tr)
    assert emitted == 19
    assert grown["pose.useful"]["count"] == 19
    assert grown["pose.forwards"]["count"] == 2 * (2 * 4 * 4 + 2 * 4) == 80
    assert grown["device.frames"]["count"] == 2 * (4 + 3)
    for name in ("serving.dispatch", "serving.fetch", "serving.stack",
                 "serving.emit", "clip.host_lanes", "clip.put_lanes",
                 "clip.replay"):
        assert grown[name]["count"] == 2, name
    inner = sum(grown[k]["total_s"] for k in (
        "serving.stack", "clip.host_lanes", "clip.put_lanes", "clip.replay"))
    assert grown["serving.dispatch"]["total_s"] >= inner
    assert grown["serving.fetch"]["total_s"] >= (
        grown["clip.to_host"]["total_s"] + grown["serving.emit"]["total_s"])

    out = tracker.run_prepared_lanes(_one_batch(tracker))
    assert len(out) == 7
    stamps = out[6].numpy()
    assert stamps.shape == (7,) and (np.diff(stamps) >= 0).all()
    stages = tracker.stage_seconds(out)
    assert list(stages) == list(ClipTracker.STAGES)
    assert sum(stages.values()) == pytest.approx(
        (stamps[-1] - stamps[0]) / 1e9)


class _RecordedGraph:
    """``Graph`` on the CPU: the capture records the program, a replay
    runs it on the filled inputs."""

    def __init__(self, fn, args, state, pool, stream, warmup=True):
        self.fn, self.inputs = fn, [a.clone() for a in args]

    @staticmethod
    def resources(device):
        return None, None

    def run(self, args):
        for buf, a in zip(self.inputs, args):
            buf.copy_(a)
        return self.fn(*self.inputs)


def test_the_switch_is_part_of_the_graph_key(monkeypatch):
    """On the card's route (a recording stand-in for the graph) turning
    tracing on captures a second graph, whose replays return the stamps,
    and turning it off replays the first again."""
    monkeypatch.setattr(GraphCache, "on_card", staticmethod(lambda t: True))
    monkeypatch.setattr(graphs_mod, "Graph", _RecordedGraph)
    tracker = ClipTracker(port_tracker().cfg, StubPoseTorch(),
                          StubFlowTorch(), device="cpu")
    args = _one_batch(tracker)
    off_key = tracker.graph_key(args, None)
    want = tracker.run_prepared_lanes(args)
    profiling.enable()
    try:
        on_key = tracker.graph_key(args, None)
        traced = tracker.run_prepared_lanes(args)
    finally:
        profiling.disable()
    again = tracker.run_prepared_lanes(args)
    assert off_key != on_key and set(tracker.graphs) == {off_key, on_key}
    assert (len(want), len(traced), len(again)) == (6, 7, 6)
    for a, b in zip(want[:5], traced[:5]):
        assert torch.equal(a, b)
