"""The reference clip program: FlowTrack's whole-clip tracking of one video
lane, in plain PyTorch and numpy.

Per clip of F frames with P detector slots and R recovery slots:

1. flow on the F - 1 consecutive pairs;
2. a crop, the pose net with the flip test, the decode and the rescore for
   each detection; a detection is kept if its score reaches
   ``pose_score_thre``;
3. detector-miss recovery: a per-frame scan greedy-OKS-matches the
   flow-propagated tracks to the detections; up to R unmatched tracks
   (fewer than ``max_miss_age`` misses in a row, highest score first)
   give a box around their propagated joints, dropped if it overlaps a
   detection by more than ``box_nms_thre``; the clip's best
   ``ceil(F * recover_budget)`` boxes by score are posed as in 2;
4. ids: each frame's poses greedy-OKS-matched to the previous frame's,
   propagated by the flow; a match inherits the id, the others take fresh
   ids in slot order. The clip starts from the previous clip's last frame
   (the clips overlap by one frame).

``recovery`` is shared by the control (which runs this whole program, in
a lower precision) and by the check, which feeds it the candidate's own
detections (``check.py``). Nothing here imports the program or JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import ops

# crops and frame pairs a call of the nets takes, so that a clip's
# reference fits beside nothing else on the card
CROP_BLOCK, PAIR_BLOCK = 128, 2


class ClipReference:
    """One lane of the clip program over ``pose_net`` and ``flow_net``
    (float32 reference nets, or the control's rounded ones). ``cfg`` is the
    configuration file's ``model``, ``flow``, ``test`` and ``track``
    sections."""

    def __init__(self, cfg: dict, pose_net, flow_net, device):
        test, track = cfg["test"], cfg["track"]
        if not (test["flip_test"] and test["shift_heatmap"]
                and test["post_process"] and test["blur_kernel"] <= 1
                and track["keyframe_interval"] <= 1 and track["clip_recover"]
                and track["max_recovered"] > 0):
            raise ValueError("the reference runs the flip test with its "
                             "shift, the quarter-pixel decode without blur, "
                             "a detection every frame and the recovery")
        self.cfg = cfg
        self.pose_net = pose_net
        self.flow_net = flow_net
        self.device = device
        h, w = cfg["model"]["image_size"]
        self.crop_hw = (h, w)
        self.aspect = w / h
        self.k = cfg["model"]["num_joints"]
        self.full_res = cfg["flow"]["variant"] == "flownet2"
        # the heatmaps' size as the net gives it (a quarter of the crop,
        # rounded up through the backbone's strides)
        with torch.no_grad():
            self.hm_hw = tuple(pose_net(torch.zeros(
                (1, 3, h, w), device=device)).shape[2:])

    # ---- stages 1 and 2
    @torch.no_grad()
    def flows(self, frames):
        """(F, H, W, 3) uint8 on the device -> (F - 1, H, W, 2) pixels."""
        fc = self.cfg["flow"]
        out = []
        for lo in range(0, frames.shape[0] - 1, PAIR_BLOCK):
            hi = min(lo + PAIR_BLOCK, frames.shape[0] - 1)
            x = ops.flow_input(frames[lo:hi], frames[lo + 1:hi + 1],
                               fc["rgb_max"])
            out.append(ops.flow_output(self.flow_net(x), self.full_res,
                                       frames.shape[1:3], fc["div_flow"]))
        return torch.cat(out)

    @torch.no_grad()
    def pose(self, frames, frame_idx, centers, scales, box_scores):
        """Crops of ``frames[frame_idx]`` at (centers, scales) -> joints
        (M, K, 2), maxvals (M, K), scores (M,), flip-merged heatmaps
        (M, K, h/4, w/4)."""
        m = frame_idx.shape[0]
        hm = []
        for lo in range(0, m, CROP_BLOCK):
            sl = slice(lo, lo + CROP_BLOCK)
            crops = ops.crop(frames, frame_idx[sl], centers[sl], scales[sl],
                             self.crop_hw)
            hm.append(ops.flip_heatmaps(self.pose_net, crops))
        hm = torch.cat(hm) if hm else torch.zeros((0, self.k, *self.hm_hw),
                                                  device=self.device)
        joints, maxvals = ops.decode(hm, centers, scales)
        scores = ops.rescore(box_scores, maxvals,
                             self.cfg["test"]["in_vis_thre"])
        return joints, maxvals, scores, hm

    # ---- stage 3
    @torch.no_grad()
    def recovery(self, frames, preds, valid, scores, det_xyxy, flows, seed):
        """The recovery scan and its budgeted pose pass on the detections
        of one clip: preds (F, P, K, 2), valid and scores (F, P), det_xyxy
        (F, P, 4) on the device; ``seed`` the tracks at frame 0 (joints,
        valid, scores, ages over P + R slots). Returns a dict of the R
        recovery slots of each frame (preds, maxvals, scores, valid) and
        the scan's ages (F, R)."""
        tc = self.cfg["track"]
        f, p = valid.shape
        r = tc["max_recovered"]
        dev = preds.device
        tj, tv, ts, ta = seed
        boxes, rv, rs, ra = [], [], [], []
        zero_ages = torch.zeros(p, dtype=torch.int64, device=dev)
        for t in range(f):
            prop = tj if t == 0 else ops.propagate(tj, flows[t - 1])
            inc = 0 if t == 0 else 1
            sim = ops.oks(prop, preds[t]).double().cpu().numpy()
            assign = ops.greedy(sim, tc["track_oks_thre"], tv.cpu().numpy(),
                                valid[t].cpu().numpy())
            matched = np.zeros(tv.shape[0], bool)
            matched[assign[assign >= 0]] = True
            miss = (tv.cpu().numpy() & ~matched
                    & (ta.cpu().numpy() < tc["max_miss_age"]))
            key = np.where(miss, ts.cpu().numpy(), -np.inf).astype(np.float32)
            top = np.argsort(-key, kind="stable")[:r]
            top_t = torch.as_tensor(top, device=dev)
            v = torch.as_tensor(np.isfinite(key[top]), device=dev)
            rj = prop[top_t]
            box = ops.boxes_from_poses(rj, tc["box_expand"])
            if tc["box_nms_thre"] < 1.0:
                io = ops.iou(box, det_xyxy[t])
                v = v & ~((io > tc["box_nms_thre"]) & valid[t][None]).any(-1)
            rs_t, ra_t = ts[top_t], ta[top_t] + inc
            boxes.append(box)
            rv.append(v)
            rs.append(rs_t)
            ra.append(ra_t)
            tj = torch.cat([preds[t], rj])
            tv = torch.cat([valid[t], v])
            ts = torch.cat([scores[t], rs_t])
            ta = torch.cat([zero_ages, ra_t])
        boxes, rv, rs, ra = (torch.stack(x) for x in (boxes, rv, rs, ra))

        # the clip's budget of recovered boxes, best score first
        budget = min(f * r, max(r, math.ceil(f * tc["recover_budget"])))
        key = torch.where(rv.reshape(-1), rs.reshape(-1),
                          float("-inf")).cpu().numpy()
        sel = np.argsort(-key, kind="stable")[:budget]
        sel = sel[np.isfinite(key[sel])]
        sel_t = torch.as_tensor(sel, device=dev)
        centers, scales = ops.center_scale_xyxy(boxes.reshape(-1, 4)[sel_t],
                                                self.aspect)
        joints, maxvals, sc, _ = self.pose(
            frames, torch.as_tensor(sel // r, device=dev), centers, scales,
            rs.reshape(-1)[sel_t])
        ok = sc >= tc["pose_score_thre"]
        out = {"preds": torch.zeros((f * r, self.k, 2), device=dev),
               "maxvals": torch.zeros((f * r, self.k), device=dev),
               "scores": torch.zeros(f * r, device=dev),
               "valid": torch.zeros(f * r, dtype=torch.bool, device=dev)}
        out["preds"][sel_t] = joints
        out["maxvals"][sel_t] = maxvals
        out["scores"][sel_t] = sc
        out["valid"][sel_t] = ok
        out = {k: v.reshape(f, r, *v.shape[1:]) for k, v in out.items()}
        out["ages"] = ra
        return out

    # ---- stage 4
    def ids(self, preds, valid, flows, seed_joints, seed_valid, seed_ids,
            next_id: int):
        """The id scan: (F, T) int ids (-1 where not valid) and the next
        fresh id."""
        thr = self.cfg["track"]["track_oks_thre"]
        f, t_slots = valid.shape
        out = np.full((f, t_slots), -1, np.int64)
        prev_j, prev_v, prev_ids = seed_joints, seed_valid, seed_ids
        for t in range(f):
            prop = prev_j if t == 0 else ops.propagate(prev_j, flows[t - 1])
            sim = ops.oks(prop, preds[t]).double().cpu().numpy()
            v = valid[t].cpu().numpy()
            assign = ops.greedy(sim, thr, prev_v, v)
            for j in range(t_slots):
                if assign[j] >= 0:
                    out[t, j] = prev_ids[assign[j]]
                elif v[j]:
                    out[t, j] = next_id
                    next_id += 1
            prev_j, prev_v, prev_ids = preds[t], v, out[t]
        return out, next_id

    def empty_seed(self):
        t = self.cfg["track"]["max_persons"] + self.cfg["track"]["max_recovered"]
        dev = self.device
        return {"joints": torch.zeros((t, self.k, 2), device=dev),
                "valid": torch.zeros(t, dtype=torch.bool, device=dev),
                "scores": torch.zeros(t, device=dev),
                "ages": torch.zeros(t, dtype=torch.int64, device=dev),
                "ids": np.zeros(t, np.int64), "next_id": 0}

    @torch.no_grad()
    def run_clip(self, frames, boxes_xywh, det_scores, det_valid, seed):
        """The whole clip program on one clip: frames (F, H, W, 3) uint8 on
        the device, padded detections (F, P, ...) numpy, the seed dict.
        Returns the outputs as the program reports them (numpy joints,
        maxvals, scores, ids, valid over P + R slots) and the next seed."""
        tc = self.cfg["track"]
        dev = self.device
        f, p = det_valid.shape
        flows = self.flows(frames)
        centers, scales = ops.center_scale(boxes_xywh, self.aspect)
        preds = torch.zeros((f, p, self.k, 2), device=dev)
        maxvals = torch.zeros((f, p, self.k), device=dev)
        scores = torch.zeros((f, p), device=dev)
        tt, pp = np.nonzero(det_valid)
        if len(tt):
            j, mv, sc, _ = self.pose(
                frames, torch.as_tensor(tt, device=dev),
                torch.as_tensor(centers[tt, pp], device=dev),
                torch.as_tensor(scales[tt, pp], device=dev),
                torch.as_tensor(det_scores[tt, pp], device=dev))
            preds[tt, pp], maxvals[tt, pp], scores[tt, pp] = j, mv, sc
        valid = torch.as_tensor(det_valid, device=dev) & (
            scores >= tc["pose_score_thre"])
        xyxy = torch.as_tensor(np.concatenate(
            [boxes_xywh[..., :2], boxes_xywh[..., :2]
             + np.maximum(boxes_xywh[..., 2:], 1e-3)], -1), dtype=torch.float32,
            device=dev)
        rec = self.recovery(frames, preds, valid, scores, xyxy, flows,
                            (seed["joints"], seed["valid"], seed["scores"],
                             seed["ages"]))
        preds = torch.cat([preds, rec["preds"]], 1)
        maxvals = torch.cat([maxvals, rec["maxvals"]], 1)
        scores = torch.cat([scores, rec["scores"]], 1)
        valid = torch.cat([valid, rec["valid"]], 1)
        ids, next_id = self.ids(preds, valid, flows, seed["joints"],
                                seed["valid"].cpu().numpy(), seed["ids"],
                                seed["next_id"])
        vnp = valid.cpu().numpy()
        out = {"joints": preds.cpu().numpy(), "maxvals": maxvals.cpu().numpy(),
               "scores": scores.cpu().numpy(), "ids": ids, "valid": vnp}
        ages = torch.cat([torch.zeros(p, dtype=torch.int64, device=dev),
                          rec["ages"][-1]])
        return out, next_seed(out, ages, next_id, dev)


def next_seed(out, ages, next_id, device):
    """The seed of a lane's next clip from a clip's reported outputs at its
    last frame, the recovery scan's ages there and the next fresh id."""
    v = out["valid"][-1]
    return {"joints": torch.as_tensor(out["joints"][-1], device=device),
            "valid": torch.as_tensor(v, device=device),
            "scores": torch.as_tensor(out["scores"][-1], device=device),
            "ages": ages,
            "ids": np.where(v, out["ids"][-1], 0), "next_id": next_id}
