"""Video/frame-sequence IO + clip batching with cross-clip ID continuity.

Port of ``flowtrack_tpu/utils/video.py``, numpy and host code as in the
reference, over the port's ClipTracker. Frames are grouped into
fixed-length clips (one clip shape for every clip of a video) and
consecutive clips OVERLAP by one frame. Track ids stay globally
consistent by carrying the previous clip's final live-track state — poses,
GLOBAL ids, scores, miss ages and the next-id counter — as the next clip's
device-side seed (ClipTracker "Cross-clip continuity"): the id scan and the
detector-miss recovery both start from the seed, so a person occluded or
undetected exactly at the boundary frame keeps one global id through the
normal flow-propagated recovery slots, matching the reference's continuous
per-frame loop.

``stitch_ids`` (OKS-matching only the shared overlap frame's poses) is the
older, weaker host-side mechanism, kept for callers that track clips
independently; ``track_video_clips`` no longer needs it.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional

import numpy as np

from flowtrack_tpu_torch.data.pose_dataset import load_image
from flowtrack_tpu_torch.ops.oks import oks_iou_np
from flowtrack_tpu_torch.tracking.clip_pipeline import pad_detections

# the frame-image extensions of a frame directory
IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm")


def iter_video_frames(path: str) -> Iterator[np.ndarray]:
    """RGB frames from a video file (cv2) or a directory of images."""
    if os.path.isdir(path):
        for p in frame_paths(path):
            yield load_image(p)
        return
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    finally:
        cap.release()


class LazyFrameSequence:
    """Sequence-of-frames view that loads images on demand instead of
    materializing the whole video in host RAM. track_video_clips only
    ever needs the current clip window (plus its one-clip lookahead), so
    long/high-res sequences track in O(clip_len) host memory. Supports
    the two accesses track_video_clips performs: ``len()`` and
    fancy-indexing with a list of frame indices (returns a stacked
    (n, H, W, 3) array)."""

    def __init__(self, paths, loader=None):
        self._paths = list(paths)
        self._loader = loader or load_image

    def __len__(self):
        return len(self._paths)

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return self._loader(self._paths[idx])
        return np.stack([self._loader(self._paths[i]) for i in idx])


class SequentialVideoFrames:
    """Lazy frame access over a video FILE (cv2.VideoCapture is
    forward-decode-only). track_video_clips requests monotonically
    advancing clip windows with a 1-frame overlap and the render loop
    replays frames in order, so each forward pass decodes every frame
    once; a small trailing cache serves the overlap re-read, and an
    index behind the cache transparently reopens the file and decodes
    forward again (one extra pass, host memory stays O(cache)).

    Raises ValueError when the container's frame-count metadata is
    unusable (some codecs report 0) — callers fall back to eager
    loading; ``capture_factory`` exists for that check and for tests.

    CAP_PROP_FRAME_COUNT is approximate for some containers: when the
    header OVERCOUNTS, indices past the last decodable frame return a
    freeze of that frame (with one warning) instead of killing a
    long tracking run mid-way; an undercount drops trailing frames
    (unknowable up front — use a frame directory for exact counts)."""

    def __init__(self, path: str, cache_frames: int = 4,
                 capture_factory=None):
        if capture_factory is None:
            import cv2

            capture_factory = cv2.VideoCapture
        self._factory = capture_factory
        self._path = path
        self._cap = capture_factory(path)
        if not self._cap.isOpened():
            raise FileNotFoundError(path)
        import cv2

        self._n = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if self._n <= 0:
            self._cap.release()
            raise ValueError(f"{path}: no usable frame-count metadata; "
                             "load the video eagerly instead")
        self._next = 0          # index the next cap.read() yields
        self._cache: dict = {}  # trailing window of decoded frames
        self._keep = max(1, cache_frames)

    def __len__(self):
        return self._n

    def _frame(self, idx):
        idx = int(idx)
        if not 0 <= idx < self._n:
            raise IndexError(idx)
        if idx in self._cache:
            return self._cache[idx]
        if idx < self._next:  # behind the cache: restart the decode pass
            self._cap.release()
            self._cap = self._factory(self._path)
            self._next = 0
            self._cache.clear()
        import cv2

        while self._next <= idx:
            ok, frame = self._cap.read()
            if not ok:
                # container header overcounted (approximate metadata):
                # freeze the last decodable frame rather than crash
                last = self._next - 1
                if last < 0 or last not in self._cache:
                    raise IOError(f"{self._path}: decode failed at frame "
                                  f"{self._next}/{self._n}")
                import logging

                logging.getLogger("flowtrack.video").warning(
                    "%s: only %d of %d header-reported frames decode; "
                    "freezing the last frame for the remainder",
                    self._path, self._next, self._n)
                while self._next <= idx:
                    self._cache[self._next] = self._cache[last]
                    self._next += 1
                break
            self._cache[self._next] = cv2.cvtColor(frame,
                                                   cv2.COLOR_BGR2RGB)
            self._next += 1
            for old in [k for k in self._cache
                        if k <= self._next - 1 - self._keep]:
                del self._cache[old]
        return self._cache[idx]

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return self._frame(idx)
        return np.stack([self._frame(i) for i in idx])


def frame_paths(directory: str) -> List[str]:
    """Sorted image paths in a frame directory (iter_video_frames's
    directory convention, exposed for lazy access)."""
    return [os.path.join(directory, name)
            for name in sorted(os.listdir(directory))
            if name.lower().endswith(IMG_EXTS)]


def clip_spans(n_frames: int, clip_len: int) -> List[range]:
    """Overlapping spans: [0..L), [L-1..2L-1), ... (1-frame overlap so the
    flow chain and id stitching cross every boundary)."""
    if n_frames > clip_len and clip_len < 2:
        # with a 1-frame overlap, clip_len == 1 never advances (the next
        # start equals the previous) — an infinite loop, not a clip plan
        raise ValueError(f"clip_len must be >= 2 for multi-frame "
                         f"sequences, got {clip_len}")
    if n_frames <= clip_len:
        return [range(0, n_frames)]
    spans = []
    start = 0
    while start < n_frames - 1:
        end = min(start + clip_len, n_frames)
        spans.append(range(start, end))
        if end == n_frames:
            break
        start = end - 1
    return spans


def stitch_ids(prev_last_poses, prev_last_ids, next_first_poses,
               next_first_ids, oks_thresh: float = 0.8):
    """Map the next clip's ids onto the previous clip's id space by matching
    the SHARED overlap frame's poses. Returns {next_id: global_id}."""
    mapping = {}
    if len(prev_last_poses) == 0 or len(next_first_poses) == 0:
        return mapping
    prev = np.asarray(prev_last_poses, np.float64)
    nxt = np.asarray(next_first_poses, np.float64)

    def flat(p):
        k = p.shape[0]
        out = np.zeros(3 * k)
        out[0::3] = p[:, 0]
        out[1::3] = p[:, 1]
        out[2::3] = 1.0
        return out

    def area(p):
        wh = p.max(0) - p.min(0)
        return float(max(wh[0] * wh[1], 1.0))

    sim = np.zeros((len(prev), len(nxt)))
    for i in range(len(prev)):
        sim[i] = oks_iou_np(flat(prev[i]), [flat(q) for q in nxt],
                            area(prev[i]), [area(q) for q in nxt])
    s = sim.copy()
    while True:
        i, j = np.unravel_index(np.argmax(s), s.shape)
        if s[i, j] < oks_thresh:
            break
        mapping[int(next_first_ids[j])] = int(prev_last_ids[i])
        s[i, :] = -1
        s[:, j] = -1
    return mapping


def pad_tail_clip(window: np.ndarray, boxes: list, scores: list,
                  clip_len: int):
    """Pad a ragged tail clip to the fixed clip shape (single source of
    truth for the recipe — track_video_clips AND serving.flush use it):
    padded frames replicate the last real frame and carry no valid
    detections; the returned frame_valid masks them out of recovery and
    ``real`` pins budget_frames/seed extraction to the REAL count, so a
    padded run matches an unpadded trace exactly.

    Returns (window, boxes, scores, frame_valid_or_None, real)."""
    real = len(window)
    if real >= clip_len:
        return window, boxes, scores, None, real
    pad = clip_len - real
    window = np.concatenate([window, np.repeat(window[-1:], pad, axis=0)])
    boxes = list(boxes) + [[]] * pad
    scores = list(scores) + [[]] * pad
    return window, boxes, scores, np.arange(clip_len) < real, real


def track_video_clips(tracker, frames: np.ndarray, det_boxes, det_scores,
                      clip_len: int = 16,
                      max_persons: Optional[int] = None):
    """Run a ClipTracker over an arbitrary-length frame sequence.

    frames: (N, H, W, 3); det_boxes/det_scores: per-frame lists (ragged).
    Returns per-frame lists of dicts {track_id, joints (K, 2), maxvals,
    score} with globally stitched ids."""
    max_persons = max_persons or tracker.cfg.track.max_persons
    n = len(frames)
    results: List[List[dict]] = [None] * n

    # one-clip dispatch lag: while the device computes clip i, the host
    # prepares and queues the copy and compute of clip i+1 (CUDA work is
    # asynchronous; clip i+1's seed is clip i's device-resident seed_out,
    # so the dependency stays in the device's queue) before it waits for
    # clip i's results.
    def dispatch(span, seed):
        idx = list(span)
        boxes = [det_boxes[i] for i in idx]
        scores = [det_scores[i] for i in idx]
        # ragged tail clips pad to the fixed clip shape, so every clip of
        # the video has one shape; see pad_tail_clip
        window, boxes, scores, frame_valid, real = pad_tail_clip(
            np.asarray(frames[idx]), boxes, scores, clip_len)
        db, dsc, dv = pad_detections(boxes, scores, max_persons)
        return idx, tracker.run_prepared(
            tracker.prepare(window, db, dsc, dv, frame_valid=frame_valid,
                            frame_offset=idx[0]),
            budget_frames=real if real < clip_len else None, seed=seed)

    spans = clip_spans(n, clip_len)
    pending = dispatch(spans[0], None)
    first = True
    for next_span in list(spans[1:]) + [None]:
        idx, device_out = pending
        if next_span is not None:
            pending = dispatch(next_span, device_out[5])
        out = tracker.to_host(device_out)

        # ids are already GLOBAL (seeded device scans); frame 0 of every
        # non-first clip is the previous clip's last frame — its results
        # were already emitted there
        start_t = 0 if first else 1
        first = False
        for tt in range(start_t, len(idx)):
            fi = idx[tt]
            poses = []
            # candidate slots = detector slots + flow-recovery slots
            for p in range(out["valid"].shape[1]):
                if not out["valid"][tt, p]:
                    continue
                poses.append({
                    "track_id": int(out["ids"][tt, p]),
                    "joints": out["joints"][tt, p],
                    "maxvals": out["maxvals"][tt, p],
                    "score": float(out["scores"][tt, p]),
                })
            results[fi] = poses

    for i in range(n):
        if results[i] is None:
            results[i] = []
    return results
