"""Multi-stream serving: N independent video streams, one batched clip run.

Port of ``flowtrack_tpu/serving.py``: ``tracks_of_frame`` (serving.py:42),
``StreamingClipTracker`` (:55) and ``MultiStreamTracker`` (:107), over the
port's ``ClipTracker``, whose batched ``run_prepared_lanes`` takes one ready
clip of each stream as a lane: flow, crops (one K1 launch per pose pass)
and pose run once for all lanes, and the scans carry the lanes in each
step. With ``sharding`` the lanes of a step split over a mesh of devices
(``ClipTracker.run_sharded_lanes``), the multi-device serving layout.

Usage:
    mst = MultiStreamTracker(tracker, clip_len=64, batch_streams=6)
    mst.submit(sid, frame, boxes, scores)   # per stream, per frame
    for sid, frame_idx, tracks in mst.step():   # when >=1 clip is ready
        ...
    ... mst.flush()                          # ragged tails at shutdown

Semantics are those of ``utils/video.track_video_clips`` run on each stream
alone: consecutive clips of one stream overlap by one frame and the
stream's live-track state (poses, global ids, miss ages, next-id counter)
carries across its own clips as a device-resident seed, so ids survive clip
boundaries, including a person occluded exactly at one. Streams share
nothing: ids are per stream.

With ``sharding=parallel.batch_sharding(mesh)`` a step whose lane count
divides the mesh runs each slot's lanes on its device's replica of the
tracker, every slot dispatched before any is fetched; a forced partial
step that does not divide runs on the mesh's first device, as the
reference's does (serving.py:278-284). A stream's seed stays on the device
its lane last ran on and is copied device to device when a later step
places the stream elsewhere.

Tracing (``utils/profiling``): a dispatch runs in the span
``serving.dispatch`` (the lanes stacked and padded in ``serving.stack``,
then the tracker's ``clip.host_lanes``, ``clip.put_lanes`` and
``clip.replay``), a fetch in ``serving.fetch`` (``clip.to_host``, then the
emissions built in ``serving.emit``). Each fetch counts the pose rows the
batch ran (``pose.forwards``) and those that held a reported person
(``pose.useful``: each lane's detections and valid recovered slots from its
first new frame on, as many times as the flip test poses them), and, with
stamps, adds each stage's device seconds (``device.clip.<stage>``) and the
new frames (``device.frames``).
"""

from __future__ import annotations

import time
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np

from flowtrack_tpu_torch.parallel.mesh import NamedSharding
from flowtrack_tpu_torch.tracking.clip_pipeline import (ClipTracker,
                                                        pad_detections,
                                                        pose_slots,
                                                        slot_device, seed_to)
from flowtrack_tpu_torch.utils import profiling
from flowtrack_tpu_torch.utils.video import pad_tail_clip


def tracks_of_frame(out: Dict[str, np.ndarray], t: int) -> List[dict]:
    """track_clip output dict -> the per-frame track list emitted to users
    (same shape as utils/video.track_video_clips results)."""
    items = []
    for s in range(out["valid"].shape[1]):
        if out["valid"][t, s]:
            items.append({"track_id": int(out["ids"][t, s]),
                          "joints": out["joints"][t, s],
                          "maxvals": out["maxvals"][t, s],
                          "score": float(out["scores"][t, s])})
    return items


class StreamingClipTracker:
    """Lowest-latency single-stream serving: one clip run per frame (the
    whole-clip program at clip_len=2: flow on the new pair, pose and match,
    the track state carried on the device by the clip seed) and one fetch.

    Semantics equal ``utils/video.track_video_clips`` at clip_len=2.

    Usage:
        st = StreamingClipTracker(tracker)
        for frame, boxes, scores in source:
            for frame_idx, tracks in st.step(frame, boxes, scores):
                ...
        ... st.flush()   # the first frame if only one was ever submitted

    The first step emits nothing (the 2-frame clip is filling) and the
    second emits frames 0 and 1 together; every later step emits
    exactly the frame it submitted — zero frame lag after warmup."""

    def __init__(self, tracker: ClipTracker):
        self._mst = MultiStreamTracker(tracker, clip_len=2,
                                       batch_streams=1)

    def step(self, frame: np.ndarray, boxes, scores):
        """Submit one frame; returns [(frame_index, tracks), ...] for
        every frame emitted by this call (see class docstring for the
        warmup pattern). ``tracks`` is the per-frame list of dicts of
        ``tracks_of_frame``."""
        self._mst.submit(0, frame, boxes, scores)
        out = []
        for _sid, first, tracks in self._mst.step(force=True):
            out.extend((first + i, fr) for i, fr in enumerate(tracks))
        return out

    def flush(self):
        """Emit anything still buffered (only possible if a single frame
        was ever submitted); drops stream state."""
        return [(first + i, fr)
                for _sid, first, tracks in self._mst.flush()
                for i, fr in enumerate(tracks)]

    def latency_stats(self) -> dict:
        return self._mst.latency_stats()

    def reset_latency_stats(self) -> None:
        return self._mst.reset_latency_stats()


class MultiStreamTracker:
    """Batch independent streams' ready clips into one ClipTracker run.

    ``batch_streams`` ready clips run per batched call (fewer only when
    ``step(force=True)`` drains a partial set: keep ``force`` for shutdown
    and latency escapes). ``sharding`` (``parallel.batch_sharding(mesh)``)
    splits the clip axis across a mesh, the multi-device serving layout."""

    def __init__(self, tracker: ClipTracker, clip_len: int = 64,
                 batch_streams: int = 4,
                 sharding: Optional[NamedSharding] = None,
                 pipeline_depth: int = 0):
        if clip_len < 2:
            raise ValueError("clip_len must be >= 2 (1-frame clip overlap)")
        self.tracker = tracker
        self.clip_len = clip_len
        self.batch_streams = batch_streams
        self.sharding = sharding
        # pipeline_depth=1: step() DISPATCHES the current ready batch
        # (CUDA work is asynchronous) and returns the PREVIOUS batch's
        # emissions — host-side clip prep + H2D of batch t+1 overlap the
        # device compute of batch t instead of serializing behind its
        # readback. Stream state (buffers, device seeds, emitted
        # counters) advances at dispatch, so chaining is unaffected;
        # emissions surface one step later (flush/drain fetch the rest).
        # 0 = synchronous (dispatch + fetch in the same step).
        self.pipeline_depth = pipeline_depth
        self._pending: List[tuple] = []   # dispatched, not yet fetched
        self.max_persons = tracker.max_persons
        # per-stream state
        self._frames: Dict[Hashable, list] = {}   # buffered (frame, b, s)
        self._seed: Dict[Hashable, tuple] = {}    # device seed tuple
        self._emitted: Dict[Hashable, int] = {}   # frames emitted so far
        self._frame_spec: Optional[tuple] = None  # (shape, dtype) of record
        # submit->emit latency: one perf_counter per buffered frame, popped
        # in emission order (every frame is emitted exactly once per
        # stream, so the deque head is always the next frame to emit)
        self._submit_ts: Dict[Hashable, list] = {}
        self._latencies_ms: List[float] = []

    # -- ingestion ---------------------------------------------------------

    def submit(self, stream_id: Hashable, frame: np.ndarray,
               boxes, scores) -> None:
        """Buffer one frame + its detections for a stream. ``boxes``:
        (P, 4) xywh (possibly empty); ``scores``: (P,).

        Every frame of every stream must share one (H, W, 3) shape and
        dtype: clips from different streams are stacked into ONE batched
        device program, so a mismatch is rejected HERE with the offending
        stream named, not frames later inside clip assembly."""
        frame = np.asarray(frame)
        if frame.ndim != 3 or frame.shape[-1] != 3:
            raise ValueError(
                f"stream {stream_id!r}: frame must be (H, W, 3), got shape "
                f"{frame.shape}")
        spec = (frame.shape, frame.dtype)
        if self._frame_spec is None:
            self._frame_spec = spec
        elif spec != self._frame_spec:
            raise ValueError(
                f"stream {stream_id!r}: frame shape/dtype {frame.shape}/"
                f"{frame.dtype} does not match this tracker's established "
                f"{self._frame_spec[0]}/{self._frame_spec[1]} — all streams "
                f"batch into one device program and must agree")
        boxes = list(boxes)
        scores = list(scores)
        if len(boxes) != len(scores):
            raise ValueError(
                f"stream {stream_id!r}: {len(boxes)} boxes vs "
                f"{len(scores)} scores")
        for b in boxes:
            if len(b) != 4:
                raise ValueError(
                    f"stream {stream_id!r}: each box must be xywh "
                    f"length-4, got {b!r}")
        self._frames.setdefault(stream_id, []).append(
            (frame, boxes, scores))
        self._emitted.setdefault(stream_id, 0)
        self._seed.setdefault(stream_id, None)
        self._submit_ts.setdefault(stream_id, []).append(time.perf_counter())

    def ready(self) -> List[Hashable]:
        """Streams with a clip ready: clip_len buffered frames. A later
        clip's frame 0 is the previous clip's last frame, kept in the
        buffer (the 1-frame overlap of utils/video.clip_spans)."""
        return [sid for sid, buf in self._frames.items()
                if len(buf) >= self.clip_len]

    # -- device step -------------------------------------------------------

    def _first_global(self, sid) -> int:
        """Global frame index of the stream's next clip's frame 0 (the
        keyframe cadence): the overlap frame once a clip has run."""
        return self._emitted[sid] - (1 if self._seed[sid] is not None else 0)

    def _record_latency(self, sid, n_emitted: int) -> None:
        """Pop the n oldest submit timestamps of this stream (the frames
        just emitted, in submission order) and record submit->emit wall
        latencies. Called AFTER the host fetch, so the device step + the
        readback are inside the measured interval."""
        now = time.perf_counter()
        ts = self._submit_ts.get(sid, [])
        self._latencies_ms.extend(
            (now - t) * 1e3 for t in ts[:n_emitted])
        del ts[:n_emitted]

    def latency_stats(self) -> dict:
        """Submit->emit latency (ms) over every frame emitted since the
        last reset_latency_stats(): waiting buffered for the clip to fill
        + the batched device step + host readback."""
        a = np.asarray(self._latencies_ms, np.float64)
        if a.size == 0:
            return {"count": 0}
        return {"count": int(a.size),
                "p50_ms": round(float(np.percentile(a, 50)), 2),
                "p90_ms": round(float(np.percentile(a, 90)), 2),
                "p99_ms": round(float(np.percentile(a, 99)), 2),
                "max_ms": round(float(a.max()), 2),
                "mean_ms": round(float(a.mean()), 2)}

    def reset_latency_stats(self) -> None:
        """Drop recorded latencies (e.g. after a warm-up clip, whose
        one-off set-up would otherwise dominate every percentile).
        Pending submit timestamps are kept: buffered frames still in
        flight measure their true wait."""
        self._latencies_ms.clear()

    def _advance(self, sid) -> Tuple[int, int]:
        """Advance the stream past a just-DISPATCHED clip (buffer trim +
        emitted counter), so the next dispatch prepares the right frames
        even while this clip's results are still computing. Returns
        (start_global, skip) for the eventual fetch."""
        skip = 1 if self._emitted[sid] > 0 else 0
        start_global = self._emitted[sid]
        self._emitted[sid] += self.clip_len - skip
        # keep the clip's LAST frame as the next clip's overlap frame 0
        self._frames[sid] = self._frames[sid][self.clip_len - 1:]
        return start_global, skip

    def _dispatch(self, sids) -> list:
        """Queue one batched run of these streams' ready clips, a lane each
        (asynchronous on a CUDA device): the lanes' frames stacked on the
        host and copied once per device. With ``sharding`` and a lane count
        that divides the mesh, each slot's lanes run on its device
        (``ClipTracker.run_sharded_lanes``); otherwise all run on the
        tracker's device, or on the mesh's first. Updates the device-side
        seeds and the stream state; returns the pending entry for _fetch:
        one (device outputs, lane metas, the lanes' posed detections) per
        device group; the last is None unless tracing records."""
        with profiling.span("serving.dispatch"):
            with profiling.span("serving.stack"):
                bufs = [self._frames[sid][:self.clip_len] for sid in sids]
                frames = np.stack([f for buf in bufs for f, _, _ in buf])
                dets = [pad_detections([b for _, b, _ in buf],
                                       [s for _, _, s in buf],
                                       self.max_persons) for buf in bufs]
                host = (frames.reshape(len(sids), self.clip_len,
                                       *frames.shape[1:]),
                        *(np.stack(x) for x in zip(*dets)))
            offsets = [self._first_global(sid) for sid in sids]
            seeds = [self._seed[sid] for sid in sids]
            if (self.sharding is not None
                    and len(sids) % self.sharding.mesh.size == 0):
                parts = self.tracker.run_sharded_lanes(
                    self.sharding, *host, seeds=seeds, frame_offsets=offsets)
            else:
                tracker = self.tracker if self.sharding is None else \
                    self.tracker.replica(slot_device(self.sharding.mesh, {}))
                args = tracker.prepare_lanes(*host, frame_offsets=offsets)
                parts = [(slice(0, len(sids)), tracker.run_prepared_lanes(
                    args, [seed_to(s, tracker.device) for s in seeds]))]
            # the detections the pose pass reports, for the fetch's count
            posed = (self.tracker.keyframe_valid(host[3], offsets)
                     if profiling.recording() else None)
            entry = []
            for lanes, out_dev in parts:
                metas = []
                for lane, sid in enumerate(sids[lanes]):
                    # per-lane seed slices stay on the lane's device
                    self._seed[sid] = tuple(leaf[lane] for leaf in out_dev[5])
                    metas.append((sid, lane) + self._advance(sid))
                # and the rows the group's pose passes ran, at its bucket
                entry.append((out_dev, metas, None if posed is None else (
                    posed[lanes], self.tracker.pose_rows(
                        len(metas), self.clip_len,
                        pose_slots(host[1][lanes], self.max_persons)))))
        return entry

    def _fetch(self, entry) -> list:
        """Copy a dispatched batch to the host and build its emissions: one
        copy per output tensor of each device group, then numpy slices per
        lane."""
        results = []
        with profiling.span("serving.fetch"):
            for out_dev, metas, posed in entry:
                host = self.tracker.to_host(out_dev)
                stages = self.tracker.stage_seconds(out_dev)
                with profiling.span("serving.emit"):
                    for sid, lane, start, skip in metas:
                        out = {k: v[lane] for k, v in host.items()}
                        tracks = [tracks_of_frame(out, t)
                                  for t in range(skip, out["valid"].shape[0])]
                        self._record_latency(sid, len(tracks))
                        results.append((sid, start, tracks))
                self._count(host, metas, posed, stages)
        return results

    def _count(self, host, metas, posed, stages) -> None:
        """A fetched batch's pose rows, run and useful, and its stages'
        device seconds and new frames (the module docstring's counters).
        ``posed``: the batch's reported detections (C, F, P) and the rows
        its pose passes ran, or None."""
        f = host["valid"].shape[1]
        if posed is not None:
            posed, rows = posed
            p = self.max_persons
            flips = 2 if self.tracker.cfg.test.flip_test else 1
            useful = sum(int(posed[lane, skip:].sum())
                         + int(host["valid"][lane, skip:, p:].sum())
                         for _, lane, _, skip in metas)
            profiling.count("pose.forwards", rows)
            profiling.count("pose.useful", flips * useful)
        if stages is not None:
            for name, seconds in stages.items():
                profiling.add(f"device.clip.{name}", seconds)
            profiling.count("device.frames",
                            sum(f - skip for _, _, _, skip in metas))

    def step(self, force: bool = False):
        """Track up to ``batch_streams`` ready clips in one device call.

        Returns a list of (stream_id, first_frame_index, per_frame_tracks)
        emissions. With ``pipeline_depth=0`` these are this step's clips
        ([] if nothing was ready, or when fewer than batch_streams
        streams are ready and ``force`` is off); with ``pipeline_depth=1``
        the dispatched batch's emissions surface on the NEXT step (or at
        flush/drain) while its device call overlaps this step's prep."""
        sids = self.ready()
        if sids and (len(sids) >= self.batch_streams or force):
            self._pending.append(self._dispatch(sids[:self.batch_streams]))
        results = []
        keep = 0 if force else self.pipeline_depth
        while len(self._pending) > keep:
            results += self._fetch(self._pending.pop(0))
        return results

    def drain(self):
        """Shutdown helper: batched forced steps while full clips remain,
        then flush() the ragged tails. Returns all emissions."""
        results = []
        while True:
            r = self.step(force=True)
            if not r:
                break
            results += r
        return results + self.flush()

    def flush(self):
        """Drain every stream: first any backlog of FULL clips (chained
        through the clip shape: an oversized one-off clip would change the
        recovery budget's semantics), then the
        true ragged tail (padded clip, exact ragged semantics via
        frame_valid + budget_frames), then drop the stream's state.
        Returns the same (stream_id, first_frame_index, tracks) list."""
        results = []
        while self._pending:   # surface anything still in the pipeline
            results += self._fetch(self._pending.pop(0))
        for sid in list(self._frames):
            while len(self._frames[sid]) >= self.clip_len:
                results += self._fetch(self._dispatch([sid]))
            buf = self._frames[sid]
            skip = 1 if self._emitted[sid] > 0 else 0
            if len(buf) <= skip:       # only the overlap frame left
                del self._frames[sid], self._seed[sid], self._emitted[sid]
                self._submit_ts.pop(sid, None)
                continue
            frames = np.stack([np.asarray(f) for f, _, _ in buf])
            frames, boxes, scores, fv, real = pad_tail_clip(
                frames, [b for _, b, _ in buf], [s for _, _, s in buf],
                self.clip_len)
            db, dsc, dv = pad_detections(boxes, scores, self.max_persons)
            args = self.tracker.prepare(frames, db, dsc, dv, fv,
                                        frame_offset=self._first_global(sid))
            out_dev = self.tracker.run_prepared(
                args, budget_frames=real if real < self.clip_len else None,
                seed=seed_to(self._seed[sid], self.tracker.device))
            out = self.tracker.to_host(out_dev)
            tracks = [tracks_of_frame(out, t) for t in range(skip, real)]
            self._record_latency(sid, len(tracks))
            results.append((sid, self._emitted[sid], tracks))
            del self._frames[sid], self._seed[sid], self._emitted[sid]
            self._submit_ts.pop(sid, None)
        return results
