"""Whole-clip tracking pipeline on the GPU, one clip or a batch of clip
lanes.

Port of ``flowtrack_tpu/tracking/clip_pipeline.py``: ``_box_xyxy_to_center_
scale`` (:106), ``_chunked_apply`` (:121), ``_assign_ids`` (:138),
``ClipTracker`` (:152) with ``track_clips`` (:540) and the vmapped clip
program ``_clips_fn`` (:445), and ``pad_detections`` (:613). The
reference's module docstring describes the algorithm; in short, per clip of
F frames with P detector slots:

  1. FlowNet on all F-1 frame pairs in one batched call;
  2. one crop launch (kernel K1) for the first Pb detector slots of every
     frame (``pose_slots``: the smallest of 8, 16, 32, ... above the
     batch's last occupied slot, at most P), pose with the flip-test double
     batch, flip merge, decode and rescore; the padded slots past Pb take
     the poses of slot Pb-1, whose zero box they share;
  3. detector-miss recovery: a per-frame scan greedy-OKS-matches the
     flow-propagated tracks against the candidates and emits a box for
     every unmatched track (``track.max_recovered`` slots per frame, at
     most ``track.max_miss_age`` misses in a row); the clip-wide top
     ``ceil(F * track.recover_budget)`` boxes by score are cropped in one
     launch and posed in one batch, then scattered back to their slots;
  4. the greedy-OKS id scan over the P + R candidate slots, seeded with the
     previous clip's final track state (the clips overlap by one frame).

Every clip runs with a leading lane axis C: independent clips (streams) of
one shape share each call. Flow takes the C*(F-1) in-lane pairs in one
call, K1 makes all C*F*Pb crops of a pose pass in one launch, and the two
per-frame scans carry the C lanes in each step, so their launches per
lane-frame fall by C. The recovery budget and its top-k are per lane; no
pair, match or id crosses lanes. One clip is the case C = 1.

``_clip`` is the clip program: PyTorch ops on one stream, the per-frame
scans of stages 3 and 4 a Python loop of small tensor ops. It never syncs
with the host and takes no data from it (no ``.item()``, no branch on a
device value, no tensor made from host data), and ``real_frames`` is a
device int32 scalar, as the reference's traced argument is. So on a CUDA
device ``run_prepared_lanes`` replays it as one CUDA graph, the
counterpart of the reference's ``jax.jit(clip_fn)`` (:441) and its vmapped
``_clips_fn`` (:445): one ``utils/graphs.Graph`` per geometry (lanes,
frames, the first pose pass's bucket Pb, frame size, the frames' dtype,
padded or not), captured at first use into the tracker's one memory pool
(``GraphCache``), and captured again after the nets' tensors changed (a net
moved, loaded or replaced).
On the CPU ``_clip`` runs eagerly; the eager ``_clip`` is the graph's
plain version. Each stage runs in a ``torch.profiler.record_function``
range named ``clip.<stage>``, which a profile of the eager ``_clip`` shows
(a replayed graph has no host ranges). With tracing on
(``utils/profiling.enable``) ``_clip`` also stamps the device's clock at its
start, after each stage and at its end, into a buffer it returns as a
seventh output, so each replay's stage times come back with its outputs
(``stage_seconds``); off, it captures no stamp and returns six.

Over a mesh of devices (``parallel/mesh.py``): ``track_clips(sharding=)``
splits the lanes into one group per mesh slot, each run by this tracker's
``replica`` on the slot's device (its own nets, graphs and pool), every
group dispatched before any is fetched, as the reference's clips axis
sharded over its chips (:540); ``track_clip(frame_sharding=)`` splits one
clip's frames (``run_frame_sharded``: stages 1 and 2 on each device's
chunk, stages 3 and 4 on the first device), and a 2-D ``("clip",
"frame")`` sharding of ``track_clips`` does both.

Differences from the reference: ``real_frames`` is shared by every lane;
the frame-sharded route runs eagerly (no graph).
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from flowtrack_tpu_torch.config import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    PIXEL_STD,
    Config,
)
from flowtrack_tpu_torch.models.flownet import (
    postprocess_flow,
    preprocess_pair,
    resize_bilinear,
)
from flowtrack_tpu_torch.models.layers import torch_dtype
from flowtrack_tpu_torch.ops.crop import crop_frames
from flowtrack_tpu_torch.ops.decode import get_final_preds, rescore
from flowtrack_tpu_torch.ops.nms import iou_matrix
from flowtrack_tpu_torch.ops.oks import oks_matrix, pose_area
from flowtrack_tpu_torch.parallel.mesh import (NamedSharding, normal_device,
                                               pad_to_multiple, part)
from flowtrack_tpu_torch.pipeline import (
    batched_box_to_center_scale,
    flip_test_heatmaps,
    model_device,
)
from flowtrack_tpu_torch.tracking.tracker import (
    boxes_from_poses,
    greedy_match,
    propagate_poses,
)
from flowtrack_tpu_torch.utils import profiling
from flowtrack_tpu_torch.utils.graphs import GraphCache, net_state, state_key


def _box_xyxy_to_center_scale(boxes, aspect_ratio: float,
                              scale_padding: float = 1.25):
    """Tensor twin of pipeline.batched_box_to_center_scale for xyxy boxes
    (..., 4) -> centers, scales (..., 2). The divisions are by tensors on
    the boxes' device: by a Python scalar a CUDA tensor is multiplied by
    the rounded reciprocal (0.75 and 200 have no exact one)."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=1e-3)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=1e-3)
    centers = torch.stack([boxes[..., 0] + w * 0.5, boxes[..., 1] + h * 0.5],
                          -1)
    wide = w > aspect_ratio * h
    h = torch.where(wide, w / w.new_full((), aspect_ratio), h)
    w = torch.where(~wide & (w < aspect_ratio * h), h * aspect_ratio, w)
    scales = torch.stack([w, h], dim=-1)
    scales = scales / scales.new_full((), PIXEL_STD) * scale_padding
    return centers, scales


def _chunked_apply(fn, x, chunk: int):
    """``fn`` (batch-elementwise) over ``x`` in chunks of ``chunk`` leading
    items, to cap peak activation memory; the same result as one call.
    chunk <= 0 or chunk >= len(x) is one call."""
    if chunk <= 0 or x.shape[0] <= chunk:
        return fn(x)
    return torch.cat([fn(part) for part in x.split(chunk)], dim=0)


def _assign_ids(assign, cand_valid, track_ids, next_id):
    """assign (C, P) row or -1 -> (ids (C, P) int32, next ids (C,)):
    matched candidates inherit the track's id, valid unmatched ones get
    fresh consecutive ids from their lane's ``next_id``, the rest -1."""
    matched = assign >= 0
    inherited = track_ids.gather(-1, assign.clamp(min=0).long())
    new_mask = ~matched & cand_valid
    ranks = torch.cumsum(new_mask.to(torch.int32), -1, dtype=torch.int32) - 1
    ids = torch.where(matched, inherited,
                      torch.where(new_mask, next_id[..., None] + ranks,
                                  torch.full_like(ranks, -1)))
    return ids, next_id + new_mask.sum(-1, dtype=torch.int32)


def _top_k(x, k: int):
    """Top ``k`` along the last axis, ties to the lower index
    (jax.lax.top_k's order, which torch.topk does not promise)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x, idx):
    """x (C, N, ...) at idx (C, G) along axis 1 -> (C, G, ...)."""
    idx = idx.reshape(*idx.shape, *(1,) * (x.dim() - 2))
    return x.gather(1, idx.expand(*idx.shape[:2], *x.shape[2:]))


def recovery_rank_limit(real_frames, f: int, r: int, recover_budget: float):
    """The recovery budget of ``real_frames`` real frames of a clip padded
    to ``f``: min(f * r, max(r, ceil(float32(real) * float32(budget)))) as
    a device int32 scalar, from the device int32 scalar ``real_frames``
    (the reference's traced arithmetic, clip_pipeline.py:297)."""
    real = real_frames.float()
    eff = torch.ceil(real * real.new_full((), recover_budget))
    return eff.clamp(min=r, max=f * r).to(torch.int32)


def real_frames_scalar(budget_frames: int, f: int, device):
    """The real frame count ``budget_frames`` (an int in 1..f) of a padded
    clip as the clip program's ``real_frames``: a device int32 scalar,
    filled on the device (no copy from the host)."""
    if not 1 <= budget_frames <= f:
        raise ValueError(f"real_frames must be in 1..{f}, got "
                         f"{budget_frames}")
    return torch.full((), budget_frames, dtype=torch.int32, device=device)


# the smallest bucket of the first pose pass's slots a frame; the buckets
# double from it up to ``max_persons``
POSE_BUCKET = 8


def pose_slots(det_boxes: np.ndarray, max_persons: int) -> int:
    """The detector slots a frame that the first pose pass runs for the
    boxes (..., P, 4) of a batch, P = ``max_persons``: the smallest of
    POSE_BUCKET, twice it, four times it, ... that lies above the last slot
    holding a box other than the zero box in any frame, or P where that
    bucket is not below P. So every slot from it on holds the zero box,
    which every frame crops alike; an invalid slot with a real box counts
    as occupied."""
    occupied = np.flatnonzero(np.any(
        np.reshape(det_boxes, (-1, max_persons, 4)) != 0, axis=(0, 2)))
    used = int(occupied[-1]) + 1 if occupied.size else 0
    slots = POSE_BUCKET
    while slots <= used:
        slots *= 2
    return min(slots, max_persons)


class ClipTracker:
    """Batched-clip FlowTrack on one device. All frames share one (H, W).

    ``pose_model``: (M, 3, h, w) crops -> (M, K, h/4, w/4) float32
    heatmaps (the port's PoseResNet). ``flow_model``: (N, 6, H, W) pairs ->
    the quarter-resolution flow / div_flow (N, 2, H/4, W/4) of FlowNetS/C/SD,
    or, when ``flow_output_is_full_res(cfg.flow.variant)``, the
    full-resolution flow in pixels (N, 2, H, W) of the FlowNet2 cascades.
    Both are put on ``device`` in eval mode."""

    # the intervals between the clip program's seven stamps, in order: its
    # four stages (the recovery's scan and pose pass apart) and the next
    # clip's seed
    STAGES = ("flow", "pose", "recovery_scan", "recovery_pose", "id_scan",
              "seed")

    def __init__(self, cfg: Config, pose_model, flow_model,
                 max_persons: Optional[int] = None, device="cuda"):
        device = model_device(device)
        self.cfg = cfg
        self.device = device
        self.max_persons = max_persons or cfg.track.max_persons
        self.img_hw = tuple(cfg.model.image_size)
        self.aspect_ratio = self.img_hw[1] / self.img_hw[0]
        self.crop_dtype = torch_dtype(cfg.model.dtype)
        tcfg = cfg.track
        self.recover = tcfg.clip_recover and tcfg.max_recovered > 0
        self.num_slots = self.max_persons + (tcfg.max_recovered
                                             if self.recover else 0)
        self.num_joints = cfg.model.num_joints
        self.pose_model = pose_model.to(device).eval()
        self.flow_model = flow_model.to(device).eval()
        # the CUDA graphs of the clip program, by geometry, all captured
        # while the nets held the same tensors, into one memory pool
        self.graphs = GraphCache()
        # the trackers of other devices of a mesh (``replica``), built
        # while the nets held the tensors ``_replica_key`` names
        self._replicas: dict = {}
        self._replica_key = None

    def replica(self, device) -> "ClipTracker":
        """This tracker on ``device``: itself on its own device, else a
        tracker of copies of its nets there, built at first use (and again
        after the nets' tensors changed), with its own graphs and pool."""
        device = normal_device(device)
        if device == normal_device(self.device):
            return self
        key = state_key(net_state(self.pose_model, self.flow_model))
        if key != self._replica_key:
            self._replicas.clear()
            self._replica_key = key
        rep = self._replicas.get(device)
        if rep is None:
            rep = self._replicas[device] = ClipTracker(
                self.cfg, copy.deepcopy(self.pose_model),
                copy.deepcopy(self.flow_model), self.max_persons, device)
        return rep

    # ---- stage 2 building blocks
    def _pose_heatmaps(self, crops):
        """(M, h, w, 3) crops -> flip-merged heatmaps (M, h/4, w/4, K)."""
        return flip_test_heatmaps(self.pose_model, crops,
                                  self.cfg.test.flip_test,
                                  self.cfg.test.shift_heatmap)

    def _poses(self, crops, centers, scales):
        """crops (N, h, w, 3) -> preds (N, K, 2), maxvals (N, K)."""
        hm = _chunked_apply(self._pose_heatmaps, crops,
                            self.cfg.track.pose_chunk)
        return get_final_preds(
            hm, centers, scales, post_process=self.cfg.test.post_process,
            blur_kernel=self.cfg.test.blur_kernel)

    def _pose_on_crops(self, crops, centers, scales, det_scores):
        """crops (N, h, w, 3) -> preds (N, K, 2), maxvals (N, K), scores (N,)."""
        preds, maxvals = self._poses(crops, centers, scales)
        return preds, maxvals, rescore(det_scores, maxvals,
                                       self.cfg.test.in_vis_thre)

    def _crop(self, frames, frame_idx, centers, scales):
        return crop_frames(frames, frame_idx, centers, scales, self.img_hw,
                           IMAGENET_MEAN, IMAGENET_STD,
                           out_dtype=self.crop_dtype)

    # ---- stage 3: detector-miss recovery
    def recovery_budget(self, f: int) -> int:
        """The recovered boxes a lane of an ``f``-frame clip poses (the
        second pose pass's rows per lane)."""
        r, share = self.cfg.track.max_recovered, self.cfg.track.recover_budget
        return min(f * r, max(r, int(np.ceil(f * share))))

    def pose_rows(self, c: int, f: int, slots: int) -> int:
        """The crops both pose passes of ``c`` lanes of ``f`` frames run
        through the pose net, the flip test's second half included: the
        first pass's ``slots`` a frame (``pose_slots``), padded or not, and
        each lane's recovery budget."""
        rows = c * f * slots
        if self.recover:
            rows += c * self.recovery_budget(f)
        return rows * (2 if self.cfg.test.flip_test else 1)

    def _recovery_pass(self, frames, preds, valid, scores, det_boxes, flows,
                       frame_valid, real_frames, seed, stamps=None):
        """Emit flow-propagated boxes for OKS-unmatched tracks, pose each
        lane's clip-wide top-budget boxes (one crop launch and one pose
        batch for all lanes), scatter them back to the (C, F, R) recovery
        slots. ``frames`` is (C*F, H, W, 3); ``seed`` = (joints, valid,
        scores, ages) over the P + R slots at frame 0; frame 0's step
        propagates by identity and does not age the seed (the previous clip
        counted that frame)."""
        tcfg = self.cfg.track
        dev = preds.device
        c, f, p = valid.shape
        r = tcfg.max_recovered
        t_slots = p + r
        budget = self.recovery_budget(f)
        neg = float("-inf")
        slot_ids = torch.arange(t_slots, device=dev)
        zero_ages = torch.zeros((c, p), dtype=torch.int32, device=dev)
        thr = tcfg.track_oks_thre

        def gen_core(carry, dj, dv, ds, dbox, prop, fv_t, inc_t):
            _, tv, ts, ta = carry
            sim = oks_matrix(prop, pose_area(prop), dj, pose_area(dj))
            assign = greedy_match(sim, thr, tv, dv)
            row_matched = ((assign[:, None, :] == slot_ids[:, None])
                           & (assign >= 0)[:, None, :]).any(-1)
            miss = tv & ~row_matched & (ta < tcfg.max_miss_age)
            top_s, top_i = _top_k(torch.where(miss, ts, neg), r)
            rec_v = torch.isfinite(top_s) & fv_t[:, None]
            rec_j = _take(prop, top_i)
            rec_s = ts.gather(1, top_i)
            rec_a = ta.gather(1, top_i) + inc_t
            rec_box = boxes_from_poses(rec_j, tcfg.box_expand)
            if tcfg.box_nms_thre < 1.0:
                iou = iou_matrix(rec_box, dbox)
                rec_v = rec_v & ~((iou > tcfg.box_nms_thre)
                                  & dv[:, None, :]).any(-1)
            carry = (torch.cat([dj, rec_j], 1), torch.cat([dv, rec_v], 1),
                     torch.cat([ds, rec_s], 1), torch.cat([zero_ages, rec_a], 1))
            return carry, (rec_box, rec_v, rec_s, rec_a)

        with record_function("clip.recovery_scan"):
            carry, out0 = gen_core(seed, preds[:, 0], valid[:, 0],
                                   scores[:, 0], det_boxes[:, 0], seed[0],
                                   frame_valid[:, 0], 0)
            outs = [out0]
            for t in range(1, f):
                prop = propagate_poses(carry[0], flows[:, t - 1])
                carry, out_t = gen_core(carry, preds[:, t], valid[:, t],
                                        scores[:, t], det_boxes[:, t], prop,
                                        frame_valid[:, t], 1)
                outs.append(out_t)
            rec_box, rec_v, rec_s, rec_ages = (torch.stack(x, 1)
                                               for x in zip(*outs))
        profiling.stamp(stamps, 3)

        # each lane's clip-wide budgeted selection -> one crop launch, one
        # pose batch for all lanes
        with record_function("clip.recovery_pose"):
            k = preds.shape[3]
            flat_s = torch.where(rec_v.reshape(c, -1),
                                 rec_s.reshape(c, -1).float(), neg)
            g_s, g_idx = _top_k(flat_s, budget)
            sel_valid = torch.isfinite(g_s)
            if real_frames is not None:
                # the budget of the real frame count; top-k is sorted, so a
                # rank mask reproduces the unpadded run's smaller selection
                eff = recovery_rank_limit(real_frames, f, r,
                                          tcfg.recover_budget)
                sel_valid = sel_valid & (torch.arange(budget, device=dev)
                                         < eff)
            sel_box = _take(rec_box.reshape(c, f * r, 4), g_idx)
            sel_score = rec_s.reshape(c, -1).gather(1, g_idx)
            sel_c, sel_sc = _box_xyxy_to_center_scale(sel_box,
                                                      self.aspect_ratio)
            lane0 = torch.arange(c, device=dev)[:, None] * f
            crops = self._crop(frames, (lane0 + g_idx // r).reshape(-1),
                               sel_c.reshape(-1, 2), sel_sc.reshape(-1, 2))
            preds2, maxvals2, scores2 = self._pose_on_crops(
                crops, sel_c.reshape(-1, 2), sel_sc.reshape(-1, 2),
                sel_score.reshape(-1))
            preds2 = preds2.reshape(c, budget, k, 2)
            maxvals2 = maxvals2.reshape(c, budget, k)
            scores2 = scores2.reshape(c, budget)
            valid2 = sel_valid & (scores2 >= tcfg.pose_score_thre)

        # invalid selections write zeros, so padded and unpadded runs give
        # identical arrays, not only identical valid masks
        def scatter(values, dtype):
            out = torch.zeros((c, f * r, *values.shape[2:]), dtype=dtype,
                              device=dev)
            idx = g_idx.reshape(*g_idx.shape, *(1,) * (values.dim() - 2))
            return out.scatter(1, idx.expand(values.shape), values.to(dtype))

        sv = sel_valid
        rec_preds = scatter(torch.where(sv[..., None, None], preds2, 0.0),
                            torch.float32)
        rec_maxvals = scatter(torch.where(sv[..., None], maxvals2, 0.0),
                              torch.float32)
        rec_scores = scatter(torch.where(sv, scores2, 0.0), torch.float32)
        rec_valid = scatter(valid2, torch.bool)
        return (rec_preds.reshape(c, f, r, k, 2),
                rec_maxvals.reshape(c, f, r, k), rec_scores.reshape(c, f, r),
                rec_valid.reshape(c, f, r), rec_ages)

    # ---- the clip program
    def _flows(self, frames):
        """Stage 1: (C, F, H, W, 3) frames -> (C, F-1, H, W, 2) flow of each
        lane's pairs, all in one batch. FlowNet needs /64 sizes, so the flow
        branch resizes the frames up to the net size, and postprocess_flow
        brings the flow back to (H, W) with its components rescaled: a
        quarter-resolution output is taken times div_flow at 4x its size
        first, a full-resolution one (the FlowNet2 cascades) as it is,
        shrunk by the antialiased resize."""
        cfg = self.cfg
        c, f, h, w = frames.shape[:4]
        net_hw = (-(-h // 64) * 64, -(-w // 64) * 64)
        flat = frames.reshape(c * f, h, w, 3)
        flow_in = (flat if net_hw == (h, w)
                   else resize_bilinear(flat.float(), net_hw))
        flow_in = flow_in.reshape(c, f, *net_hw, 3)
        pairs = preprocess_pair(flow_in[:, :-1].reshape(-1, *net_hw, 3),
                                flow_in[:, 1:].reshape(-1, *net_hw, 3),
                                cfg.flow.rgb_max)
        flow_q = _chunked_apply(
            lambda x: self.flow_model(x.permute(0, 3, 1, 2)),
            pairs, cfg.track.flow_chunk).permute(0, 2, 3, 1)
        flows = postprocess_flow(flow_q, cfg.flow.variant, (h, w),
                                 cfg.flow.div_flow)
        return flows.reshape(c, f - 1, h, w, 2)

    def _flow_pass(self, frames):
        """Stage 1 with its profiler range: (C, F, H, W, 3) frames -> the
        (C, F-1, H, W, 2) flows of each lane's pairs, none for one frame."""
        c, f, h, w = frames.shape[:4]
        with record_function("clip.flow"):
            return self._flows(frames) if f > 1 else torch.zeros(
                (c, 0, h, w, 2), device=frames.device)

    def _pose_pass(self, frames, centers, scales, det_scores, det_valid):
        """Stage 2: pose on the first Pb detector slots of every frame, one
        crop launch. frames (C, F, H, W, 3), centers and scales (C, F, Pb,
        2), det_scores and det_valid (C, F, P) -> preds (C, F, P, K, 2),
        maxvals (C, F, P, K), scores and valid (C, F, P). Where Pb < P
        (``pose_slots``), slots Pb-1 to P-1 all hold the zero box, so slots
        Pb to P-1 take slot Pb-1's crop's preds and maxvals: what posing
        them would give."""
        c, f, h, w, _ = frames.shape
        pb, p = centers.shape[2], det_valid.shape[2]
        frames = frames.reshape(c * f, h, w, 3)
        with record_function("clip.pose"):
            frame_idx = torch.arange(c * f, device=frames.device)[
                :, None].expand(c * f, pb).reshape(-1)
            centers_flat = centers.reshape(-1, 2)
            scales_flat = scales.reshape(-1, 2)
            crops = self._crop(frames, frame_idx, centers_flat, scales_flat)
            preds, maxvals = self._poses(crops, centers_flat, scales_flat)
            k = preds.shape[1]
            preds = preds.reshape(c, f, pb, k, 2)
            maxvals = maxvals.reshape(c, f, pb, k)
            if pb < p:
                preds = torch.cat([preds, preds[:, :, -1:].expand(
                    c, f, p - pb, k, 2)], 2)
                maxvals = torch.cat([maxvals, maxvals[:, :, -1:].expand(
                    c, f, p - pb, k)], 2)
            scores = rescore(det_scores.reshape(-1), maxvals.reshape(-1, k),
                             self.cfg.test.in_vis_thre).reshape(c, f, p)
        valid = det_valid & (scores >= self.cfg.track.pose_score_thre)
        return preds, maxvals, scores, valid

    def _clip(self, frames, centers, scales, det_scores, det_valid,
              det_boxes, frame_valid, seed_joints, seed_valid, seed_scores,
              seed_ages, seed_ids, next_id0, real_frames=None):
        """The clip program. Every tensor argument carries the leading lane
        axis C; ``real_frames`` (None for a full clip) is the real frame
        count of clips padded with invalid frames, a device int32
        scalar."""
        c, f, h, w, _ = frames.shape
        stamps = profiling.stamps(len(self.STAGES) + 1, frames.device)
        profiling.stamp(stamps, 0)
        # 1. flow on all pairs of all lanes, one call
        flows = self._flow_pass(frames)
        profiling.stamp(stamps, 1)
        # 2. pose on all detector persons of all frames: one crop launch
        pose = self._pose_pass(frames, centers, scales, det_scores,
                               det_valid)
        profiling.stamp(stamps, 2)
        out = self._track(frames.reshape(c * f, h, w, 3), flows, *pose,
                          det_boxes, frame_valid, seed_joints, seed_valid,
                          seed_scores, seed_ages, seed_ids, next_id0,
                          real_frames, stamps)
        return out if stamps is None else (*out, stamps)

    def _track(self, frames, flows, preds, maxvals, scores, valid, det_boxes,
               frame_valid, seed_joints, seed_valid, seed_scores, seed_ages,
               seed_ids, next_id0, real_frames=None, stamps=None):
        """Stages 3 and 4 on the flows and the pose pass of C lanes of F
        frames (``frames`` (C*F, H, W, 3)): the recovery scan and its
        budgeted pose pass, then the id scan; -> ``_clip``'s six outputs.
        ``stamps``: the clip's stamp buffer (3 to 6 are written here), or
        None."""
        tcfg = self.cfg.track
        c, f, p = valid.shape
        dev = frames.device

        # 3. detector-miss recovery (second, budgeted pose pass)
        ages = torch.zeros((c, f, p), dtype=torch.int32, device=dev)
        if self.recover:
            rec_seed = (seed_joints, seed_valid, seed_scores.float(),
                        seed_ages.to(torch.int32))
            rec_preds, rec_maxvals, rec_scores, rec_valid, rec_ages = \
                self._recovery_pass(frames, preds, valid, scores, det_boxes,
                                    flows, frame_valid, real_frames, rec_seed,
                                    stamps)
            preds = torch.cat([preds, rec_preds], dim=2)
            maxvals = torch.cat([maxvals, rec_maxvals], dim=2)
            scores = torch.cat([scores, rec_scores], dim=2)
            valid = torch.cat([valid, rec_valid], dim=2)
            ages = torch.cat([ages, rec_ages], dim=2)
        else:
            profiling.stamp(stamps, 3)
        profiling.stamp(stamps, 4)

        # 4. the id chain; frame 0 matches the seed by identity propagation
        thr = tcfg.track_oks_thre
        with record_function("clip.id_scan"):
            sim0 = oks_matrix(seed_joints, pose_area(seed_joints),
                              preds[:, 0], pose_area(preds[:, 0]))
            assign0 = greedy_match(sim0, thr, seed_valid, valid[:, 0])
            ids, nid = _assign_ids(assign0, valid[:, 0],
                                   seed_ids.to(torch.int32).clamp(min=0),
                                   next_id0.to(torch.int32))
            all_ids = [ids]
            for t in range(1, f):
                prop = propagate_poses(preds[:, t - 1], flows[:, t - 1])
                sim = oks_matrix(prop, pose_area(prop), preds[:, t],
                                 pose_area(preds[:, t]))
                assign = greedy_match(sim, thr, valid[:, t - 1], valid[:, t])
                ids, nid = _assign_ids(assign, valid[:, t], ids.clamp(min=0),
                                       nid)
                all_ids.append(ids)
            all_ids = torch.stack(all_ids, 1)
        profiling.stamp(stamps, 5)
        # the next clip's seed: the last REAL frame's live tracks, gathered
        # at the device scalar real_frames - 1 for a padded clip
        if real_frames is None:
            def at_last(x):
                return x[:, f - 1]
        else:
            last = (real_frames.long() - 1).clamp(0, f - 1).reshape(1)

            def at_last(x):
                return x.index_select(1, last).squeeze(1)
        seed_valid_out = at_last(valid)
        seed_out = (at_last(preds), seed_valid_out, at_last(scores),
                    at_last(ages),
                    torch.where(seed_valid_out, at_last(all_ids), 0), nid)
        profiling.stamp(stamps, 6)
        return preds, maxvals, scores, all_ids, valid, seed_out

    def empty_seed(self):
        """No live tracks, next global id 0: (joints (T, K, 2), valid (T,),
        scores (T,), ages (T,), ids (T,), next_id ()) over T slots."""
        t, k, dev = self.num_slots, self.num_joints, self.device
        return (torch.zeros((t, k, 2), device=dev),
                torch.zeros((t,), dtype=torch.bool, device=dev),
                torch.zeros((t,), device=dev),
                torch.zeros((t,), dtype=torch.int32, device=dev),
                torch.zeros((t,), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))

    def prepare_lanes(self, frames: np.ndarray, det_boxes: np.ndarray,
                      det_scores: np.ndarray, det_valid: np.ndarray,
                      frame_valid: Optional[np.ndarray] = None,
                      frame_offsets: Optional[Sequence[int]] = None,
                      slots: Optional[int] = None):
        """Host prep of C clips of one shape and one copy to the device per
        tensor: frames (C, F, H, W, 3), det_boxes (C, F, P, 4) xywh,
        det_scores and det_valid (C, F, P), frame_valid (C, F) -> the
        argument tuple of run_prepared_lanes, each tensor with a leading C.
        ``frame_offsets[i]`` is lane i's first global frame index, so
        keyframe masking follows each video's cadence. ``slots``: the first
        pose pass's slots a frame (``host_lanes``)."""
        return self.put_lanes(self.host_lanes(
            frames, det_boxes, det_scores, det_valid, frame_valid,
            frame_offsets, slots))

    def put_lanes(self, host_args):
        """``host_lanes``' arrays -> run_prepared_lanes' tensors on this
        tracker's device, one copy per tensor."""
        dtypes = (None, None, None, torch.float32, torch.bool, None,
                  torch.bool)
        with profiling.span("clip.put_lanes"):
            return tuple(torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                         device=self.device)
                         for a, dt in zip(host_args, dtypes))

    def keyframe_valid(self, det_valid: np.ndarray,
                       frame_offsets: Optional[Sequence[int]] = None):
        """(C, F, P) ``det_valid`` with the detections of frames off the
        keyframe cadence (``track.keyframe_interval``, counted from each
        lane's first global frame ``frame_offsets[i]``) dropped."""
        k = max(1, self.cfg.track.keyframe_interval)
        if k == 1:
            return det_valid
        c, f = np.shape(det_valid)[:2]
        offsets = np.asarray(frame_offsets if frame_offsets is not None
                             else [0] * c)
        return det_valid & ((np.arange(f) + offsets[:, None])[..., None] % k
                            == 0)

    def host_lanes(self, frames: np.ndarray, det_boxes: np.ndarray,
                   det_scores: np.ndarray, det_valid: np.ndarray,
                   frame_valid: Optional[np.ndarray] = None,
                   frame_offsets: Optional[Sequence[int]] = None,
                   slots: Optional[int] = None):
        """``prepare_lanes``' host half: its seven arguments as numpy
        arrays (frames, centers, scales, det_scores, det_valid, xyxy boxes,
        frame_valid), each with the leading lane axis; centers and scales
        of the first pose pass's ``slots`` a frame, the others of all P.
        ``slots`` None takes the boxes' bucket (``pose_slots``, counted as
        ``pose.bucket.<slots>``); an exported program, whose shapes are
        fixed, takes P (``aot.clip_arg_specs``)."""
        with profiling.span("clip.host_lanes"):
            c, f, p = det_scores.shape
            need = pose_slots(det_boxes, p)
            if slots is None:
                slots = need
                profiling.count(f"pose.bucket.{slots}")
            elif not (slots == p or need <= slots < p):
                raise ValueError(f"{slots} pose slots a frame: the boxes "
                                 f"need {need} to {p}")
            if frame_valid is None:
                frame_valid = np.ones((c, f), bool)
            det_valid = self.keyframe_valid(det_valid, frame_offsets)
            centers = np.zeros((c * f, p, 2), np.float32)
            scales = np.full((c * f, p, 2), 1e-3, np.float32)
            boxes_xyxy = np.zeros((c * f, p, 4), np.float32)
            for t, boxes in enumerate(np.reshape(det_boxes, (c * f, p, 4))):
                # clamp only w/h: padded zero boxes would give zero scale
                boxes_t = np.concatenate(
                    [boxes[:, :2], np.maximum(boxes[:, 2:], 1e-3)], axis=1)
                centers[t], scales[t] = batched_box_to_center_scale(
                    boxes_t, self.aspect_ratio)
                boxes_xyxy[t] = np.concatenate(
                    [boxes_t[:, :2], boxes_t[:, :2] + boxes_t[:, 2:]], axis=1)
            return (frames, centers.reshape(c, f, p, 2)[:, :, :slots],
                    scales.reshape(c, f, p, 2)[:, :, :slots], det_scores,
                    det_valid, boxes_xyxy.reshape(c, f, p, 4), frame_valid)

    def prepare(self, frames: np.ndarray, det_boxes: np.ndarray,
                det_scores: np.ndarray, det_valid: np.ndarray,
                frame_valid: Optional[np.ndarray] = None,
                frame_offset: int = 0, slots: Optional[int] = None):
        """``prepare_lanes`` of one clip (frames (F, H, W, 3), det_boxes
        (F, P, 4), ...), without the lane axis: the argument tuple of
        run_prepared."""
        lanes = self.prepare_lanes(
            np.asarray(frames)[None], np.asarray(det_boxes)[None],
            np.asarray(det_scores)[None], np.asarray(det_valid)[None],
            None if frame_valid is None else np.asarray(frame_valid)[None],
            [frame_offset], slots)
        return tuple(x[0] for x in lanes)

    def graph_key(self, device_args, budget_frames) -> tuple:
        """The geometry of a run: lanes C, frames F, frame H and W, the
        first pose pass's slots a frame (its bucket), the frames' dtype,
        whether the clips are padded, and whether tracing stamps the
        stages."""
        frames = device_args[0]
        return (*frames.shape[:4], device_args[1].shape[2], frames.dtype,
                budget_frames is not None, profiling.enabled())

    @torch.inference_mode()
    def run_prepared_lanes(self, device_args, seeds: Optional[Sequence] = None,
                           budget_frames: Optional[int] = None):
        """Track C prepared clips of one shape (``prepare_lanes``' tuple) in
        one batched run, lane i seeded by ``seeds[i]`` (None: the empty
        seed; ``seeds`` None: every lane empty). ``budget_frames``: the real
        frame count (1..F) of clips padded with invalid frames, for every
        lane. On a CUDA device the run replays the geometry's graph
        (captured at first use, and again after the nets' tensors changed),
        elsewhere it runs ``_clip`` eagerly. Returns device tensors (preds,
        maxvals, scores, ids, valid, seed_out), each with a leading C, that
        no later run overwrites; ``tuple(leaf[i] for leaf in seed_out)``
        seeds lane i's next (one-frame-overlapping) clip. With tracing on,
        the run's stamps follow as a seventh (``stage_seconds``)."""
        with profiling.span("clip.replay"):
            empty = self.empty_seed()
            seeds = [empty if s is None else s
                     for s in (seeds or [None] * device_args[0].shape[0])]
            seed = [torch.stack(leaves) for leaves in zip(*seeds)]
            args = (*device_args, *seed)
            real = None if budget_frames is None else real_frames_scalar(
                budget_frames, device_args[0].shape[1], self.device)
            if real is None:
                clip = self._clip
            else:
                args = (*args, real)

                def clip(*a):
                    return self._clip(*a[:-1], real_frames=a[-1])
            return self.graphs.run(
                self.graph_key(device_args, budget_frames), clip, args,
                lambda: net_state(self.pose_model, self.flow_model))

    def run_prepared(self, device_args, budget_frames: Optional[int] = None,
                     seed=None):
        """Track a prepared clip (``prepare``'s tuple): ``run_prepared_lanes``
        with one lane, without the lane axis in its result."""
        out = self.run_prepared_lanes([x[None] for x in device_args], [seed],
                                      budget_frames)
        return (*(x[0] for x in out[:5]), tuple(s[0] for s in out[5]))

    @staticmethod
    def to_host(device_out):
        """Device result -> dict of numpy arrays (ids -1 where invalid), one
        copy to the host per output tensor; any leading lane axis stays.
        The seed and any stamps are left on the device."""
        with profiling.span("clip.to_host"):
            preds, maxvals, scores, ids, valid = device_out[:5]
            valid = valid.cpu().numpy()
            return {"joints": preds.cpu().numpy(),
                    "maxvals": maxvals.cpu().numpy(),
                    "scores": scores.cpu().numpy(),
                    "ids": np.where(valid, ids.cpu().numpy(), -1),
                    "valid": valid}

    @classmethod
    def stage_seconds(cls, device_out) -> Optional[dict]:
        """The device seconds of each of ``STAGES`` in a run with tracing on
        (the differences of its stamps, fetched to the host), or None for a
        run without stamps."""
        if len(device_out) <= 6:
            return None
        with profiling.span("clip.to_host"):
            ns = device_out[6].cpu().numpy()
        return dict(zip(cls.STAGES, np.diff(ns) / 1e9))

    def track_clips(self, frames: np.ndarray, det_boxes: np.ndarray,
                    det_scores: np.ndarray, det_valid: np.ndarray,
                    sharding: Optional[NamedSharding] = None):
        """Independent clips in one batched run: frames (C, F, H, W, 3),
        det_boxes (C, F, P, 4) xywh, det_scores and det_valid (C, F, P);
        every lane starts from the empty seed. Returns the track_clip dict
        with a leading C.

        ``sharding`` (``parallel.batch_sharding(mesh)``) splits the clip
        axis over the mesh, pure data parallelism with no collective: each
        slot's lanes run on that device's replica (``run_sharded_lanes``).
        A 2-D ``NamedSharding(mesh, ("clip", "frame"))`` also splits each
        group's frames over the second axis (``run_frame_sharded``)."""
        if sharding is None:
            return self.to_host(self.run_prepared_lanes(self.prepare_lanes(
                frames, det_boxes, det_scores, det_valid)))
        hosts = [self.to_host(out) for _, out in self.run_sharded_lanes(
            sharding, frames, det_boxes, det_scores, det_valid)]
        return {k: np.concatenate([h[k] for h in hosts]) for k in hosts[0]}

    def run_sharded_lanes(self, sharding: NamedSharding, frames, det_boxes,
                          det_scores, det_valid, seeds=None,
                          frame_offsets=None) -> list:
        """C clips' host arrays (``prepare_lanes``' arguments) split on the
        lane axis by ``sharding.spec[0]``'s mesh axis into equal groups,
        each prepared and dispatched on its slot's device (this tracker's
        ``replica`` there) before any is fetched; with a second entry in
        the spec, each group's frames split over that axis
        (``run_frame_sharded``). Lane i is seeded by ``seeds[i]`` (moved to
        its group's device). Returns one (lanes slice, device result) per
        group, in lane order."""
        mesh = sharding.mesh
        c = np.shape(det_scores)[0]
        groups = sharding.parts(0)
        if c % groups:
            raise ValueError(f"{c} clips do not divide into the {groups} "
                             f"slots of mesh axis {sharding.spec[0]!r}")
        frame_axis = sharding.spec[1] if len(sharding.spec) > 1 else None
        seeds = list(seeds) if seeds is not None else [None] * c
        offsets = (list(frame_offsets) if frame_offsets is not None
                   else [0] * c)
        results = []
        for g in range(groups):
            lanes = slice(g * (c // groups), (g + 1) * (c // groups))
            where = ({sharding.spec[0]: g} if sharding.spec[0] is not None
                     else {})
            args = tuple(part(np.asarray(a), g, groups)
                         for a in (frames, det_boxes, det_scores, det_valid))
            if frame_axis is None:
                rep = self.replica(slot_device(mesh, where))
                out = rep.run_prepared_lanes(
                    rep.prepare_lanes(*args, frame_offsets=offsets[lanes]),
                    [seed_to(s, rep.device) for s in seeds[lanes]])
            else:
                devices = [slot_device(mesh, {**where, frame_axis: j})
                           for j in range(mesh.shape[frame_axis])]
                out = self.run_frame_sharded(
                    devices, *args, seeds=seeds[lanes],
                    frame_offsets=offsets[lanes])
            results.append((lanes, out))
        return results

    @torch.inference_mode()
    def run_frame_sharded(self, devices, frames, det_boxes, det_scores,
                          det_valid, seeds=None, frame_offsets=None):
        """C clips (host arrays, ``prepare_lanes``' arguments) with their
        frame axis split over ``devices``: the clip padded with invalid
        frames to a multiple of len(devices) (the recovery budget stays at
        the real frame count), stage 1 on each device's chunk of frames
        plus the next chunk's first (its last pair), stage 2 on each
        chunk's detections, every device dispatched before any is joined;
        the flows and the pose pass are then gathered on the first device,
        where the recovery scan, its budgeted pose pass and the id scan run
        (``_track``). Returns ``run_prepared_lanes``' device result, sliced
        back to the real frames, on the first device. Runs eagerly."""
        n = len(devices)
        f = np.shape(det_scores)[1]
        padded = [pad_to_multiple(np.asarray(a), n, axis=1)[0]
                  for a in (frames, det_boxes, det_scores, det_valid)]
        fv = pad_to_multiple(np.ones(np.shape(det_scores)[:2], bool), n,
                             axis=1)[0]
        host = self.host_lanes(*padded, fv, frame_offsets)
        fp = fv.shape[1]
        chunk = fp // n
        main = self.replica(devices[0])
        flows, poses = [], []
        for j, dev in enumerate(devices):
            rep = self.replica(dev)
            lo, hi = j * chunk, (j + 1) * chunk
            # the chunk's frames and the next chunk's first, if any
            part = rep.put_lanes((host[0][:, lo:hi + 1],
                                  *(a[:, lo:hi] for a in host[1:])))
            flows.append(rep._flow_pass(part[0]))
            poses.append(rep._pose_pass(part[0][:, :chunk], *part[1:5]))
        d0 = main.device

        def join(parts):
            return torch.cat([t.to(d0) for t in parts], 1)

        frames_all, _, _, _, _, boxes_all, fv_all = main.put_lanes(host)
        c = frames_all.shape[0]
        empty = main.empty_seed()
        seeds = [empty if s is None else seed_to(s, d0)
                 for s in (seeds or [None] * c)]
        seed = [torch.stack(leaves) for leaves in zip(*seeds)]
        real = (None if fp == f
                else real_frames_scalar(f, fp, d0))
        out = main._track(frames_all.reshape(c * fp, *frames_all.shape[2:]),
                          join(flows), *(join(x) for x in zip(*poses)),
                          boxes_all, fv_all, *seed, real_frames=real)
        return (*(x[:, :f] for x in out[:5]), out[5])

    def track_clip(self, frames: np.ndarray, det_boxes: np.ndarray,
                   det_scores: np.ndarray, det_valid: np.ndarray,
                   frame_sharding: Optional[NamedSharding] = None, seed=None,
                   frame_offset: int = 0, return_seed: bool = False):
        """frames (F, H, W, 3) uint8 or float32; det_boxes (F, P, 4) xywh
        (padded); det_scores, det_valid (F, P). Returns numpy arrays over
        T = P + max_recovered slots: joints (F, T, K, 2), maxvals (F, T, K),
        scores (F, T), ids (F, T) (-1 = invalid), valid (F, T). With
        ``return_seed``, also the device seed for the next clip, whose
        ``frame_offset`` is its first global frame index.

        ``frame_sharding`` (``parallel.batch_sharding(mesh)``) splits this
        one clip's frames over the mesh (``run_frame_sharded``); the result
        is the unsharded one's, the seed on the mesh's first device."""
        if frame_sharding is not None:
            # one lane whose frame axis (axis 1) the mesh axis splits
            (_, device_out), = self.run_sharded_lanes(
                NamedSharding(frame_sharding.mesh,
                              (None, frame_sharding.spec[0])),
                *(np.asarray(a)[None] for a in (
                    frames, det_boxes, det_scores, det_valid)),
                seeds=[seed], frame_offsets=[frame_offset])
            device_out = (*(x[0] for x in device_out[:5]),
                          tuple(s[0] for s in device_out[5]))
        else:
            args = self.prepare(frames, det_boxes, det_scores, det_valid,
                                frame_offset=frame_offset)
            device_out = self.run_prepared(args, seed=seed)
        out = self.to_host(device_out)
        return (out, device_out[5]) if return_seed else out


def slot_device(mesh, where: dict) -> torch.device:
    """The device of the mesh slot at the given axis indices (0 on the
    axes not given)."""
    return mesh.devices[tuple(where.get(a, 0) for a in mesh.axis_names)]


def seed_to(seed, device):
    """A lane's seed (or None) with its leaves on ``device``: a copy
    between devices where it lives on another (no host round trip)."""
    return None if seed is None else tuple(leaf.to(device) for leaf in seed)


def pad_detections(per_frame_boxes, per_frame_scores, max_persons: int):
    """Ragged per-frame detections -> (F, P, 4), (F, P), (F, P) padded,
    keeping the highest-scoring ``max_persons`` of a frame."""
    f = len(per_frame_boxes)
    boxes = np.zeros((f, max_persons, 4), np.float32)
    scores = np.zeros((f, max_persons), np.float32)
    valid = np.zeros((f, max_persons), bool)
    for t in range(f):
        b = np.asarray(per_frame_boxes[t], np.float32).reshape(-1, 4)
        s = np.asarray(per_frame_scores[t], np.float32).reshape(-1)
        n = min(len(b), max_persons)
        if len(b) > max_persons:
            order = np.argsort(-s)[:max_persons]
            b, s = b[order], s[order]
        boxes[t, :n] = b[:n]
        scores[t, :n] = s[:n]
        valid[t, :n] = True
    return boxes, scores, valid
