"""Tracking primitives on tensors: propagate, box, greedy match.

Port of ``flowtrack_tpu/tracking/tracker.py``: ``propagate_poses``
(tracker.py:44), ``boxes_from_poses`` (:51) and ``greedy_match`` (:69). The
streaming ``FlowTracker`` is not ported yet.

Nothing here syncs with the host: the greedy loop has a static trip count
and keeps its state in tensors, so a clip's scans only queue device work.
"""

from __future__ import annotations

import torch

from flowtrack_tpu_torch.ops.warp import flow_gather


def propagate_poses(joints, flow):
    """joints (M, K, 2) image coords; flow (H, W, 2) -> joints moved by the
    flow sampled at each joint (bilinear, edge-clamped)."""
    return joints + flow_gather(flow, joints)


def boxes_from_poses(joints, expand: float = 0.15):
    """(M, K, 2) -> (M, 4) xyxy boxes around the joints, grown by
    ``expand`` of the box size on each side."""
    mins = joints.amin(dim=-2)
    maxs = joints.amax(dim=-2)
    wh = (maxs - mins).clamp(min=0.0)
    return torch.cat([mins - wh * expand, maxs + wh * expand], dim=-1)


def greedy_match(sim, thr: float, row_valid=None, col_valid=None):
    """Greedy global-max assignment. sim (M, N) track-to-candidate
    similarity -> (N,) int32 row assigned to each column, -1 if none.

    min(M, N) rounds: take the first maximum (row-major, as ``argmax``
    does), assign it if it exceeds ``thr`` and strike its row and column;
    once nothing exceeds ``thr`` every entry is struck. Invalid rows and
    columns read -inf, so padding never changes the order."""
    m, n = sim.shape
    neg = float("-inf")
    s = sim.float()
    if row_valid is not None:
        s = torch.where(row_valid[:, None], s, neg)
    if col_valid is not None:
        s = torch.where(col_valid[None, :], s, neg)
    rows = torch.arange(m, device=sim.device)
    cols = torch.arange(n, device=sim.device)
    assign = torch.full((n,), -1, dtype=torch.int32, device=sim.device)
    for _ in range(min(m, n)):
        flat = s.reshape(-1)
        idx = flat.argmax()
        i, j = idx // n, idx % n
        ok = flat.amax() > thr     # the value at idx, read without a sync
        assign = torch.where((cols == j) & ok, i.to(torch.int32), assign)
        kill = (rows == i)[:, None] | (cols == j)[None, :]
        s = torch.where(ok & ~kill, s, neg)
    return assign
