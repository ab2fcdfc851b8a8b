"""The comparison that decides ``correct``: a candidate's tracks of whole
videos held to the plain reference (``reference/``), clip by clip.

The candidate is what the timed path reported (or, for the control, the
reference in a lower precision). The reference computes in float32 from
the same frames, detections and weights, and follows the candidate's own
state where the tracker's decisions depend on it:

* Detections (stage 2 after stage 1's frames: crop, pose with the flip
  test, decode, rescore). Each detection is posed by the reference. A
  joint is judged by the reference's heatmap: ``det_joint_gap`` is the
  widest distance, in units of that heatmap's standard deviation, by
  which the heatmap at the candidate's joint lies below its peak (the
  argmax of a random net's heatmap changes on rounding; the gap does not
  grow with it). ``det_maxval_err`` is the widest difference of the
  peak values in the same unit, ``det_score_err`` the widest relative
  difference of the rescored scores, ``det_valid_miss`` the count of
  detections kept or dropped against the reference's score.
* Recovery (stages 1 and 3). Each recovery slot the candidate reports
  names its track by its score (the slot's score is the track's carried
  score rescored by the slot's peaks): a detection of the last
  ``max_miss_age`` frames, or the clip's seed. The reference moves that
  track's joints to the slot's frame by its own flow and boxes them. The
  slot's joints lie on the quarter-cell grid of the crop the candidate
  posed, which fixes that crop up to whole quarter cells; of the crops on
  that grid within ``SEARCH`` quarter cells of the reference's box, the
  one whose reference heatmaps the slot's joints fit best is taken for
  the candidate's. ``rec_shift_share``, the share of slots whose crop is
  a quarter cell or more away from the reference's box, judges stage 1's
  flow and the propagation; ``rec_joint_gap`` and ``rec_maxval_err``
  judge the pose of the crop as for a detection. ``rec_unlocated`` counts slots
  whose joints lie on no grid near the reference's box, and
  ``rec_unexplained`` slots whose score comes from no track.
  ``rec_disp_mean`` is the mean distance, in quarter cells (the wider
  axis), from the reference's crop to the candidate's: the grid's offset
  from the reference's origin plus the whole quarter cells the search
  chose, so it reads how far the flow moved the crops, not only whether
  it did. ``rec_far_share`` is the share of slots whose crop lies at the
  search's edge or on no grid near the reference's box.
  Which tracks the scan recovers turns on OKS and IoU thresholds that two
  roundings of one flow can flip, so the reference's own scan over the
  candidate's detections only counts them: ``rec_count_err`` is the
  relative difference of a video's recovered poses between the two.
* Ids (stage 4). Each frame's ids must follow from a greedy OKS
  assignment of the previous frame's candidate poses, moved by the
  reference's flow, to this frame's: fresh ids in slot order from the
  next free id, inherited ones from the matched pose. ``track_gap`` is
  the widest amount, in OKS, by which the candidate's assignment departs
  from the greedy order on the reference's similarities (1 where the ids
  follow from no assignment).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import ops
from portbench.reference.clip import ClipReference, next_seed

# a detection whose reference score lies this close to pose_score_thre may
# be kept on one side and dropped on the other
AMBIGUOUS = 0.01
NUMBERS = ("det_joint_gap", "det_maxval_err", "det_score_err",
           "det_valid_miss", "rec_shift_share",
           "rec_joint_gap", "rec_maxval_err", "rec_unlocated",
           "rec_unexplained", "rec_count_err", "track_gap",
           "rec_disp_mean", "rec_far_share")
# quarter cells searched each way around the reference's box, each axis;
# the relative range of the step searched around the box's; recovered
# slots posed at once
SEARCH, SCALE_RANGE, SLOT_BLOCK = 2, 0.03, 32


def _gaps(hm, cells):
    """(M, K) heatmap peak minus the heatmap at ``cells``, over each map's
    standard deviation; and the deviations."""
    m, k, h, w = hm.shape
    flat = hm.reshape(m, k, h * w)
    peak = flat.amax(-1)
    sd = flat.std(-1).clamp(min=1e-12)
    at = flat.gather(-1, (cells[..., 1] * w + cells[..., 0])[..., None])[..., 0]
    return (peak - at) / sd, sd


class Readings:
    """The widest value of each compared number over the videos judged."""

    def __init__(self):
        self.values = {name: 0.0 for name in NUMBERS}
        self.info = {"videos": 0, "clips": 0, "detections": 0,
                     "rec_compared": 0, "rec_shifted": 0, "rec_far": 0,
                     "rec_disp_sum": 0.0, "track_frames": 0}

    def worst(self, name, value):
        self.values[name] = max(self.values[name], float(value))

    def add(self, name, count):
        self.values[name] += count


def track_gap(sim, thr, row_valid, col_valid, assign) -> float:
    """How far an assignment (col -> row or -1) departs from the greedy
    one on ``sim``: the assignment is replayed round by round in the
    greedy's order; where the greedy's best pair is not the assignment's,
    the assignment's pair that takes its row or column must be within the
    returned distance of it, and a pair the assignment matched must lie
    that close to the threshold at least."""
    s = np.where(row_valid[:, None] & col_valid[None, :], sim, -np.inf)
    pairs = {(int(assign[j]), j) for j in range(len(assign)) if assign[j] >= 0}
    gap = 0.0
    while True:
        i, j = divmod(int(np.argmax(s)), s.shape[1])
        best = s[i, j]
        if not np.isfinite(best) or best <= thr:
            for r, c in pairs:
                gap = max(gap, thr - s[r, c] if np.isfinite(s[r, c]) else 1.0)
            return gap
        if (i, j) in pairs:
            pairs.discard((i, j))
            s[i, :], s[:, j] = -np.inf, -np.inf
            continue
        rival = [(s[r, c], r, c) for r, c in pairs if r == i or c == j]
        if rival:
            v, r, c = max(rival)
            gap = max(gap, best - v if np.isfinite(v) else 1.0)
            pairs.discard((r, c))
            s[r, :], s[:, c] = -np.inf, -np.inf
        else:
            gap = max(gap, best - thr)
            s[i, :], s[:, j] = -np.inf, -np.inf


@torch.no_grad()
def judge_video(ref: ClipReference, video_frames, boxes, det_scores,
                det_valid, clips: list, clip_len: int,
                readings: Readings) -> None:
    """Hold one video's clips (``clips``: the candidate's reported outputs
    per clip, each array (clip_len, P + R, ...)) to the reference.
    ``video_frames`` (N, H, W, 3) uint8 and the padded detections are the
    video's, as the tracker was given them."""
    cfg = ref.cfg
    tc, thr = cfg["track"], cfg["track"]["pose_score_thre"]
    dev = ref.device
    p = det_valid.shape[1]
    seed = ref.empty_seed()
    counts = [0, 0]     # recovered poses: the candidate's, the reference's
    readings.info["videos"] += 1
    for k, cand in enumerate(clips):
        lo = k * (clip_len - 1)
        sl = slice(lo, lo + clip_len)
        frames = torch.as_tensor(video_frames[sl], device=dev)
        bx, sc, dv = boxes[sl], det_scores[sl], det_valid[sl]
        readings.info["clips"] += 1
        flows = ref.flows(frames)
        centers, scales = ops.center_scale(bx, ref.aspect)

        # stage 2: every detection of the clip
        tt, pp = np.nonzero(dv)
        c_t = torch.as_tensor(centers[tt, pp], device=dev)
        s_t = torch.as_tensor(scales[tt, pp], device=dev)
        _, mv, rsc, hm = ref.pose(frames, torch.as_tensor(tt, device=dev),
                                  c_t, s_t,
                                  torch.as_tensor(sc[tt, pp], device=dev))
        cj = torch.as_tensor(cand["joints"][tt, pp], device=dev)
        gap, sd = _gaps(hm, ops.heatmap_cell(cj, c_t, s_t, hm.shape[2:]))
        cmv = torch.as_tensor(cand["maxvals"][tt, pp], device=dev)
        csc = torch.as_tensor(cand["scores"][tt, pp], device=dev)
        if len(tt):
            readings.worst("det_joint_gap", gap.max())
            readings.worst("det_maxval_err", ((cmv - mv).abs() / sd).max())
            readings.worst("det_score_err",
                           ((csc - rsc).abs() / rsc.abs().clamp(
                               min=1e-12)).max())
        readings.info["detections"] += len(tt)
        keep = np.zeros_like(dv)
        keep[tt, pp] = (rsc >= thr).cpu().numpy()
        close = np.zeros_like(dv)
        close[tt, pp] = ((rsc - thr).abs() < AMBIGUOUS).cpu().numpy()
        readings.add("det_valid_miss",
                     int(((cand["valid"][:, :p] != keep) & ~close).sum()))

        # stage 3: each recovered pose from the track it claims, and how
        # many the scan recovers from the candidate's detections
        xyxy = np.concatenate([bx[..., :2],
                               bx[..., :2] + np.maximum(bx[..., 2:], 1e-3)], -1)
        det = [torch.as_tensor(cand[k][:, :p], device=dev)
               for k in ("joints", "valid", "scores")]
        rec = ref.recovery(frames, *det,
                           torch.as_tensor(xyxy, dtype=torch.float32,
                                           device=dev), flows,
                           (seed["joints"], seed["valid"], seed["scores"],
                            seed["ages"]))
        counts[0] += int(cand["valid"][:, p:].sum())
        counts[1] += int(rec["valid"].sum())
        _recovered_poses(ref, frames, flows, cand, seed, p, readings)

        # stage 4 on the candidate's poses
        ids, valid = cand["ids"], cand["valid"]
        prev_j, prev_v, prev_ids = seed["joints"], seed["valid"].cpu().numpy(), \
            seed["ids"]
        nid = seed["next_id"]
        for t in range(clip_len):
            pj = torch.as_tensor(cand["joints"][t], device=dev)
            prop = prev_j if t == 0 else ops.propagate(prev_j, flows[t - 1])
            sim = ops.oks(prop, pj).double().cpu().numpy()
            v = valid[t]
            assign = np.full(len(v), -1, np.int64)
            fresh = []
            owner = {int(prev_ids[i]): i for i in np.nonzero(prev_v)[0]}
            for j in np.nonzero(v)[0]:
                if int(ids[t, j]) in owner:
                    assign[j] = owner[int(ids[t, j])]
                else:
                    fresh.append(int(ids[t, j]))
            if fresh != list(range(nid, nid + len(fresh))) or len(
                    set(assign[assign >= 0])) != int((assign >= 0).sum()):
                readings.worst("track_gap", 1.0)
            nid += len(fresh)
            readings.worst("track_gap", track_gap(
                sim, tc["track_oks_thre"], prev_v, v, assign))
            readings.info["track_frames"] += 1
            prev_j, prev_v, prev_ids = pj, v, np.where(v, ids[t], 0)
        ages = torch.cat([torch.zeros(p, dtype=torch.int64, device=dev),
                          rec["ages"][-1]])
        seed = next_seed(cand, ages, nid, dev)
    readings.worst("rec_count_err", abs(counts[0] - counts[1])
                   / max(counts[1], 1))


def _grid_of(joints, centers, scales, hm_hw, steps: int = 2001):
    """The quarter-cell grid on which decoded ``joints`` (M, K, 2) lie,
    found near an estimated crop (``centers``, ``scales``, (M, 2)): the
    decode puts each joint at ``u n + t`` with ``u`` a quarter of the
    crop's heatmap cell in pixels and ``n`` a whole number. ``u`` is the
    step within ``SCALE_RANGE`` of the estimate's under which every
    joint's offset from the first is a whole number of steps (searched,
    then fitted by least squares with ``n`` rounded under the estimate's
    origin); ``t`` lies within half a step of the estimate's. Returns
    ``u`` (M,), ``t`` (M, 2) and each fit's worst residual in pixels
    (large where no grid near the estimate holds these joints). Joints
    that share one grid point leave ``u`` at the search's best."""
    h, w = hm_hw
    j = joints.double()
    m, k = j.shape[:2]
    u0 = scales[:, 0].double() * ops.PIXEL_STD / w / 4
    t0 = torch.stack([centers[:, 0].double() - 2 * u0 * w,
                      centers[:, 1].double() - 2 * u0 * h], -1)
    rel = torch.linspace(1 - SCALE_RANGE, 1 + SCALE_RANGE, steps,
                         dtype=torch.float64, device=j.device)
    d = (j - j[:, :1]).reshape(m, 1, 2 * k)
    u = torch.empty_like(u0)
    for lo in range(0, m, 64):
        cand = u0[lo:lo + 64, None] * rel                       # (b, S)
        fit = torch.cos(2 * math.pi * d[lo:lo + 64] / cand[..., None]).mean(-1)
        # a flat fit (one grid point for every joint) keeps the estimate
        fit = fit - 1e-9 * (rel - 1).abs()
        u[lo:lo + 64] = cand.gather(1, fit.argmax(1, keepdim=True))[:, 0]
    n = torch.round((j - t0[:, None]) / u[:, None, None])
    a = torch.zeros((m, 2 * k + 1, 3), dtype=torch.float64, device=j.device)
    a[:, :k, 0], a[:, k:2 * k, 0] = n[..., 0], n[..., 1]
    a[:, :k, 1], a[:, k:2 * k, 2] = 1.0, 1.0
    b = torch.cat([j[..., 0], j[..., 1], torch.zeros((m, 1), dtype=torch.float64,
                                                       device=j.device)], 1)
    # a light tie to the searched step, which only a grid point shared by
    # every joint leaves in charge
    a[:, 2 * k, 0] = 1e-3
    b[:, 2 * k] = 1e-3 * u
    sol = torch.linalg.lstsq(a.cpu(), b.cpu()[..., None]).solution.to(j.device)
    resid = (a[:, :2 * k] @ sol - b[:, :2 * k, None]).abs().amax((1, 2))
    return sol[:, 0, 0], sol[:, 1:, 0], resid


def _recovered_poses(ref, frames, flows, cand, seed, p, readings):
    """Each recovery slot the candidate reports. Its track is a detection
    (or the seed's track) whose carried score the slot's rescored score
    comes from, within ``max_miss_age`` frames before; the reference moves
    the track's joints to the slot's frame by its own flow and boxes them.
    The slot's joints give the grid of the crop the candidate posed, up to
    a whole quarter cell (``_grid_of``); the reference poses the crops of
    that grid within ``SEARCH`` quarter cells of its own box each way, and
    the crop whose heatmaps the slot's joints fit best is the candidate's.
    A person whose crops were alike in two frames has the same score in
    both, so every track whose score fits is tried and the nearest grid
    kept."""
    tc = ref.cfg["track"]
    thr = ref.cfg["test"]["in_vis_thre"]
    dev = ref.device
    h, w = ref.hm_hw
    ages = tc["max_miss_age"]
    seed_valid = seed["valid"].cpu().numpy()
    slot_of, boxes = [], []
    slots = list(zip(*np.nonzero(cand["valid"][:, p:])))
    for n, (t, r) in enumerate(slots):
        mv = torch.as_tensor(cand["maxvals"][t, p + r], device=dev)
        score = float(cand["scores"][t, p + r])
        sources = [(cand["scores"][f, j], f, cand["joints"][f, j])
                   for f in range(max(0, t - ages), t)
                   for j in np.nonzero(cand["valid"][f, :p])[0]]
        if t <= ages:
            sources += [(float(seed["scores"][j]), 0,
                         seed["joints"][j].cpu().numpy())
                        for j in np.nonzero(seed_valid)[0]]
        fits = []
        if sources:
            est = ops.rescore(torch.tensor([s for s, _, _ in sources],
                                           device=dev), mv[None], thr)
            fits = np.nonzero(((est - score).abs() <= 1e-4 * max(
                abs(score), 1e-6)).cpu().numpy())[0]
        if not len(fits):
            readings.add("rec_unexplained", 1)
            continue
        for i in fits:
            joints = torch.as_tensor(sources[i][2], device=dev)
            for f in range(sources[i][1], t):
                joints = ops.propagate(joints, flows[f])
            boxes.append(ops.boxes_from_poses(joints, tc["box_expand"]))
            slot_of.append(n)
    if not boxes:
        return
    slot_of = np.asarray(slot_of)
    at = tuple(np.asarray([(slots[n][0], p + slots[n][1])
                           for n in slot_of]).T)
    centers, scales = ops.center_scale_xyxy(torch.stack(boxes), ref.aspect)
    cj = torch.as_tensor(cand["joints"][at], device=dev)
    u, t0, resid = _grid_of(cj, centers, scales, ref.hm_hw)
    # the reference's crop: its origin, and its width in pixels
    size = scales[:, 0].double() * ops.PIXEL_STD
    hw = torch.tensor([w, h], dtype=torch.float64, device=dev)
    t_ref = centers.double() - size[:, None] / w * hw / 2
    located = (resid < 1e-2).cpu().numpy()
    apart = ((t0 - t_ref).abs().amax(-1) / size).cpu().numpy()
    rows = []
    for n in np.unique(slot_of):
        mine = np.nonzero((slot_of == n) & located)[0]
        if len(mine):
            rows.append(mine[np.argmin(apart[mine])])
        else:
            readings.add("rec_unlocated", 1)
    _far_share(readings)
    if not rows:
        return
    rows = torch.as_tensor(np.asarray(rows), device=dev)
    shifts = torch.arange(-SEARCH, SEARCH + 1, device=dev, dtype=torch.float64)
    shifts = torch.cartesian_prod(shifts, shifts)               # (S, 2)
    ns = shifts.shape[0]
    best_gap, best_mv, best_k = [], [], []
    for lo in range(0, len(rows), SLOT_BLOCK):
        k = rows[lo:lo + SLOT_BLOCK]
        b = len(k)
        uk = u[k][:, None, None]
        c = (t0[k][:, None] + shifts[None] * uk + 2 * uk * hw
             ).reshape(-1, 2).float()
        s = (4 * uk * hw / ops.PIXEL_STD).expand(b, ns, 2).reshape(-1, 2
                                                                   ).float()
        ti = torch.as_tensor(at[0], device=dev)[k].repeat_interleave(ns)
        _, mv, _, hm = ref.pose(frames, ti, c, s,
                                torch.ones(len(ti), device=dev))
        gap, sd = _gaps(hm, ops.heatmap_cell(cj[k].repeat_interleave(ns, 0),
                                             c, s, (h, w)))
        g, i = gap.amax(-1).reshape(b, ns).min(1)
        pick = torch.arange(b, device=dev) * ns + i
        cmv = torch.as_tensor(cand["maxvals"][at], device=dev)[k]
        best_gap.append(g)
        best_mv.append(((cmv - mv[pick]).abs() / sd[pick]).amax(-1))
        best_k.append(shifts[i])
    best_k = torch.cat(best_k)
    # the candidate's crop origin is t0 + k u: its distance from the
    # reference's in quarter cells, on the wider axis
    disp = ((t0[rows] - t_ref[rows]) / u[rows, None] + best_k
            ).abs().amax(-1)
    readings.worst("rec_joint_gap", torch.cat(best_gap).max())
    readings.worst("rec_maxval_err", torch.cat(best_mv).max())
    readings.info["rec_compared"] += len(rows)
    readings.info["rec_shifted"] += int((best_k != 0).any(-1).sum())
    readings.info["rec_far"] += int((best_k.abs() >= SEARCH).any(-1).sum())
    readings.info["rec_disp_sum"] += float(disp.sum())
    readings.values["rec_shift_share"] = (readings.info["rec_shifted"]
                                          / readings.info["rec_compared"])
    readings.values["rec_disp_mean"] = (readings.info["rec_disp_sum"]
                                        / readings.info["rec_compared"])
    _far_share(readings)


def _far_share(readings):
    """Slots at the search's edge or unlocated, over all located or not."""
    far = readings.info["rec_far"] + readings.values["rec_unlocated"]
    slots = readings.info["rec_compared"] + readings.values["rec_unlocated"]
    readings.values["rec_far_share"] = far / slots if slots else 0.0
