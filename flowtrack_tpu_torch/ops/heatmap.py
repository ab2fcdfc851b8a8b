"""Flip-test merge of heatmaps.

Port of ``flowtrack_tpu/ops/heatmap.py``: ``flip_back`` (heatmap.py:107) and
``merge_flip_test`` (:125). Heatmaps keep the reference's NHWK layout (any
strides; the tracker passes channel-last views of the model's NCHW output).
The GT heatmap synthesis is training code and not ported yet.
"""

from __future__ import annotations

import torch


def flip_back(heatmaps, flip_pairs):
    """Mirror W, then swap each (left, right) joint channel pair. NHWK."""
    k = heatmaps.shape[-1]
    perm = list(range(k))
    for a, b in flip_pairs:
        perm[a], perm[b] = b, a
    index = torch.tensor(perm, device=heatmaps.device)
    return heatmaps.flip(2).index_select(-1, index)


def merge_flip_test(heatmaps, heatmaps_flipped, flip_pairs, shift=True):
    """Average the direct heatmaps with the flipped-back ones; ``shift``
    moves the flipped-back maps one pixel right first (the reference's
    ``output_flipped[..., 1:] = output_flipped[..., :-1]``)."""
    hf = flip_back(heatmaps_flipped, flip_pairs)
    if shift:
        hf = torch.cat([hf[:, :, :1], hf[:, :, :-1]], dim=2)
    return (heatmaps + hf) * 0.5
