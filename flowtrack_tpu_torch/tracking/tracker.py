"""FlowTrack tracker: detect + flow-propagate -> unified NMS -> pose ->
greedy OKS matching -> track ids.

Port of ``flowtrack_tpu/tracking/tracker.py``: the tensor primitives
``propagate_poses`` (tracker.py:44), ``boxes_from_poses`` (:51),
``greedy_match`` (:69), ``propagate_and_boxes`` (:110),
``nms_boxes_padded`` (:120), ``match_propagated`` (:130) and ``match_step``
(:143), the streaming per-frame ``FlowTracker`` (:170) with its ``Track``
records, and ``tracks_to_posetrack_json`` (:329).

The primitives take leading batch dimensions (one per clip lane) and never
sync with the host: the greedy loop has a static trip count and keeps its
state in tensors. As in the reference, the streaming tracker pads its track
and candidate counts to ``max_persons`` multiples, with ``valid`` masks
(padding is order-safe: invalid entries read -inf), and runs each of its
three device steps (propagate and boxes, NMS, match) as one program per
bucket: on the card a CUDA graph (``utils/graphs.py``), the counterpart of
the reference's ``jax.jit``, on the CPU eagerly on the same padded
tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Callable, List, Optional

import numpy as np
import torch

from flowtrack_tpu_torch.config import Config
from flowtrack_tpu_torch.ops.nms import greedy_nms_from_matrix, iou_matrix
from flowtrack_tpu_torch.ops.oks import oks_matrix, pose_area
from flowtrack_tpu_torch.ops.warp import flow_gather
from flowtrack_tpu_torch.pipeline import model_device
from flowtrack_tpu_torch.utils.graphs import GraphCache


def propagate_poses(joints, flow):
    """joints (*B, M, K, 2) image coords; flow (*B, H, W, 2) -> joints
    moved by the flow sampled at each joint (bilinear, edge-clamped)."""
    return joints + flow_gather(flow, joints)


def boxes_from_poses(joints, expand: float = 0.15, conf=None,
                     conf_thre: float = 0.0):
    """(..., K, 2) -> (..., 4) xyxy boxes around the joints (those whose
    ``conf`` (..., K) exceeds ``conf_thre`` when given), grown by
    ``expand`` of the box size on each side."""
    if conf is None:
        mins, maxs = joints.amin(dim=-2), joints.amax(dim=-2)
    else:
        ok = (conf > conf_thre)[..., None]
        big = torch.full((), 1e9, dtype=joints.dtype, device=joints.device)
        mins = torch.where(ok, joints, big).amin(dim=-2)
        maxs = torch.where(ok, joints, -big).amax(dim=-2)
    wh = (maxs - mins).clamp(min=0.0)
    return torch.cat([mins - wh * expand, maxs + wh * expand], dim=-1)


def greedy_match(sim, thr: float, row_valid=None, col_valid=None):
    """Greedy global-max assignment. sim (*B, M, N) track-to-candidate
    similarity -> (*B, N) int32 row assigned to each column, -1 if none.

    min(M, N) rounds: take the first maximum (row-major, as ``argmax``
    does), assign it if it exceeds ``thr`` and strike its row and column;
    once nothing exceeds ``thr`` every entry is struck. Invalid rows and
    columns read -inf, so padding never changes the order."""
    *batch, m, n = sim.shape
    neg = float("-inf")
    s = sim.float()
    if row_valid is not None:
        s = torch.where(row_valid[..., :, None], s, neg)
    if col_valid is not None:
        s = torch.where(col_valid[..., None, :], s, neg)
    rows = torch.arange(m, device=sim.device)
    cols = torch.arange(n, device=sim.device)
    assign = torch.full((*batch, n), -1, dtype=torch.int32, device=sim.device)
    for _ in range(min(m, n)):
        flat = s.reshape(*batch, m * n)
        idx = flat.argmax(-1, keepdim=True)
        i, j = idx // n, idx % n
        ok = flat.amax(-1, keepdim=True) > thr   # the value at idx, no sync
        assign = torch.where((cols == j) & ok, i.to(torch.int32), assign)
        kill = (rows == i)[..., :, None] | (cols == j)[..., None, :]
        s = torch.where(ok[..., None] & ~kill, s, neg)
    return assign


def propagate_and_boxes(track_joints, flow, expand: float):
    """The streaming tracker's device step: track poses (M, K, 2) moved
    through the flow (H, W, 2), and their expanded xyxy boxes (M, 4)."""
    prop = propagate_poses(track_joints, flow)
    return prop, boxes_from_poses(prop, expand)


def nms_boxes_padded(xyxy, scores, valid, thresh: float):
    """Greedy IoU NMS over a padded candidate set: xyxy (N, 4), scores
    (N,), valid (N,) -> keep (N,) bool. Padding is greedy-order-safe:
    invalid entries read -inf, are never kept and never suppress."""
    return greedy_nms_from_matrix(iou_matrix(xyxy, xyxy), scores, thresh,
                                  valid)


def match_propagated(prop_joints, track_valid, cand_joints, cand_valid,
                     track_thr: float = 0.5):
    """Greedy OKS assignment of already propagated tracks (M, K, 2) to
    candidates (N, K, 2) -> (N,) int32 row index or -1."""
    sim = oks_matrix(prop_joints, pose_area(prop_joints), cand_joints,
                     pose_area(cand_joints))
    return greedy_match(sim, track_thr, track_valid, cand_valid)


def match_step(track_joints, track_valid, cand_joints, cand_valid, flow,
               track_thr: float = 0.5):
    """Propagate tracks (M, K, 2) through the flow (H, W, 2), then assign
    candidates (N, K, 2) greedily by OKS -> (assign (N,) int32 row or -1,
    propagated (M, K, 2))."""
    prop = propagate_poses(track_joints, flow)
    return match_propagated(prop, track_valid, cand_joints, cand_valid,
                            track_thr), prop


def _numpy(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _round_up(v, m):
    return -(-v // m) * m


@dataclass
class Track:
    track_id: int
    joints: np.ndarray          # (K, 2) image coords
    maxvals: np.ndarray         # (K,)
    score: float
    last_frame: int


@dataclass
class FlowTracker:
    """Sequential per-frame tracker (state: the previous frame's tracks and
    image).

    ``pose_fn(image, boxes (B, 4) xywh, scores (B,))`` -> joints (B, K, 2),
    maxvals (B, K), rescored (B,), numpy or tensors (typically
    ``pipeline.PosePredictor``). ``flow_fn(prev_image, image)`` -> the
    (H, W, 2) full-resolution flow, numpy or a tensor (typically
    ``pipeline.FlowPredictor``), or None for the flow-free ablation (the
    paper's baseline: detector boxes only, greedy OKS matching on
    unpropagated poses). Propagation, NMS and matching run on ``device``,
    padded to ``track.max_persons`` buckets, one graph a step and bucket
    on the card (``graphs``); 'cuda' without a CUDA device raises."""

    cfg: Config
    pose_fn: Callable
    flow_fn: Optional[Callable] = None
    device: str = "cuda"
    tracks: List[Track] = field(default_factory=list)
    next_id: int = 0
    _prev_image: Optional[np.ndarray] = None
    _frame: int = 0
    graphs: GraphCache = field(default_factory=GraphCache, repr=False)

    def __post_init__(self):
        self.device = model_device(self.device)

    def reset(self):
        self.tracks = []
        self.next_id = 0
        self._prev_image = None
        self._frame = 0

    def _run(self, key, fn, *arrays):
        """``fn`` on the arrays put on the device: the graph of ``key`` on
        the card."""
        args = [torch.as_tensor(a, device=self.device) for a in arrays]
        return self.graphs.run(key, fn, args)

    @torch.inference_mode()
    def step(self, image: np.ndarray, det_boxes: np.ndarray,
             det_scores: np.ndarray) -> List[Track]:
        """Process one frame. det_boxes: (D, 4) xywh; det_scores: (D,).
        Returns the updated live track list (also kept as state)."""
        tcfg = self.cfg.track
        q = tcfg.max_persons
        k = self.cfg.model.num_joints
        flow = None
        if self.flow_fn is not None and self._prev_image is not None \
                and self.tracks:
            flow = torch.as_tensor(self.flow_fn(self._prev_image, image),
                                   dtype=torch.float32, device=self.device)

        # --- propagated boxes of the surviving tracks, the track count
        # padded to a max_persons bucket
        prop_boxes_xywh = np.zeros((0, 4), np.float32)
        prop_scores = np.zeros((0,), np.float32)
        if self.tracks and flow is not None:
            m = len(self.tracks)
            tj = np.zeros((_round_up(m, q), k, 2), np.float32)
            tj[:m] = np.stack([t.joints for t in self.tracks])
            prop, pb = self._run(
                ("propagate", tj.shape, flow.shape, tcfg.box_expand),
                partial(propagate_and_boxes, expand=tcfg.box_expand),
                tj, flow)
            prop, pb = prop.cpu().numpy()[:m], pb.cpu().numpy()[:m]
            prop_boxes_xywh = np.concatenate(
                [pb[:, :2], pb[:, 2:] - pb[:, :2]], axis=1)
            prop_scores = np.array([t.score for t in self.tracks], np.float32)

        # --- unified suppression over detections and propagated boxes, the
        # candidate count padded to a bucket
        det_boxes = np.asarray(det_boxes, np.float32).reshape(-1, 4)
        det_scores = np.asarray(det_scores, np.float32).reshape(-1)
        boxes = np.concatenate([det_boxes, prop_boxes_xywh], axis=0)
        scores = np.concatenate([det_scores, prop_scores], axis=0)
        good = (boxes[:, 2] > 1) & (boxes[:, 3] > 1)
        boxes, scores = boxes[good], scores[good]
        if len(boxes) and tcfg.box_nms_thre < 1.0:
            n = len(boxes)
            npad = _round_up(n, q)
            bx = np.zeros((npad, 4), np.float32)
            bx[:n] = np.concatenate(
                [boxes[:, :2], boxes[:, :2] + boxes[:, 2:]], axis=1)
            sc = np.zeros((npad,), np.float32)
            sc[:n] = scores
            nv = np.zeros((npad,), bool)
            nv[:n] = True
            keep = self._run(
                ("nms", npad, tcfg.box_nms_thre),
                partial(nms_boxes_padded, thresh=tcfg.box_nms_thre),
                bx, sc, nv).cpu().numpy()[:n]
            boxes, scores = boxes[keep], scores[keep]

        # --- pose on the union
        if len(boxes):
            joints, maxvals, rescored = (
                _numpy(a) for a in self.pose_fn(image, boxes, scores))
            ok = rescored >= tcfg.pose_score_thre
            joints, maxvals, rescored = joints[ok], maxvals[ok], rescored[ok]
        else:
            joints = np.zeros((0, k, 2), np.float32)
            maxvals = np.zeros((0, k), np.float32)
            rescored = np.zeros((0,), np.float32)

        # --- greedy OKS id assignment against the propagated tracks (the
        # tracks as they are in the flow-free ablation), both sides padded
        # to pmax, a max_persons multiple
        assign = np.full((len(joints),), -1, np.int32)
        if len(self.tracks) and len(joints):
            if flow is None:
                prop = np.stack([t.joints for t in self.tracks])
            pmax = _round_up(max(q, len(self.tracks), len(joints)), q)
            tj = np.zeros((pmax, k, 2), np.float32)
            tj[:len(prop)] = prop
            tv = np.zeros((pmax,), bool)
            tv[:len(self.tracks)] = True
            cj = np.zeros((pmax, k, 2), np.float32)
            cj[:len(joints)] = joints
            cv = np.zeros((pmax,), bool)
            cv[:len(joints)] = True
            assign = self._run(
                ("match", pmax, tcfg.track_oks_thre),
                partial(match_propagated, track_thr=tcfg.track_oks_thre),
                tj, tv, cj, cv).cpu().numpy()[:len(joints)]

        new_tracks: List[Track] = []
        for j in range(len(joints)):
            if assign[j] >= 0:
                tid = self.tracks[assign[j]].track_id
            else:
                tid = self.next_id
                self.next_id += 1
            new_tracks.append(Track(tid, joints[j], maxvals[j],
                                    float(rescored[j]), self._frame))
        self.tracks = new_tracks
        self._prev_image = image
        self._frame += 1
        return new_tracks

    def track_sequence(self, frames, detections) -> List[List[Track]]:
        """frames: iterable of RGB images; detections: per-frame
        (boxes (D, 4) xywh, scores (D,)). Returns per-frame track lists.

        With ``track.keyframe_interval`` = k > 1, detections are consumed
        only on every k-th frame; in between, tracks ride on the
        flow-propagated boxes alone (the paper's keyframe variant)."""
        self.reset()
        k = max(1, self.cfg.track.keyframe_interval)
        out = []
        for t, (img, (boxes, scores)) in enumerate(zip(frames, detections)):
            if t % k != 0:
                boxes = np.zeros((0, 4), np.float32)
                scores = np.zeros((0,), np.float32)
            out.append(list(self.step(img, boxes, scores)))
        return out


def tracks_to_posetrack_json(per_frame_tracks, image_ids):
    """Tracker output -> PoseTrack-format annotations."""
    annotations = []
    for image_id, tracks in zip(image_ids, per_frame_tracks):
        for t in tracks:
            kp = []
            for (x, y), v in zip(t.joints, t.maxvals):
                kp += [float(x), float(y), float(v)]
            annotations.append({
                "image_id": int(image_id),
                "track_id": int(t.track_id),
                "keypoints": kp,
                "scores": [float(v) for v in t.maxvals],
                "score": float(t.score),
                "category_id": 1,
            })
    return annotations
