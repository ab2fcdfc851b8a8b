"""Evaluate a pose model on COCO, PoseTrack or MPII.

Port of ``tools/test.py``: ``build_val_dataset`` (:37), ``run_validation``
(:59) and ``main`` (:126), with the same arguments but the XLA compile
cache's, and ``--device`` (default ``cuda``). The validate loop on one
device: batches copied ahead to the device, the pose net on the inputs and
their mirror images with the flip merge, decode and rescoring there
(``engine/train.eval_step``); then, on the host, OKS-NMS and COCO AP (or
PCKh for MPII) with the port's evaluators.

    python3 -m flowtrack_tpu_torch.tools.test --weights pose.npz \\
        data.root=data/coco [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from dataclasses import replace

import numpy as np
import torch

from flowtrack_tpu_torch.config import (
    COCO_FLIP_PAIRS,
    MPII_FLIP_PAIRS,
    apply_overrides,
    get_config,
)
from flowtrack_tpu_torch.data import (BatchLoader, COCODataset, MPIIDataset,
                                      PoseTrackDataset)
from flowtrack_tpu_torch.data.loader import device_prefetch
from flowtrack_tpu_torch.engine.train import eval_step, pose_forward_fn
from flowtrack_tpu_torch.pipeline import model_device
from flowtrack_tpu_torch.tools.common import add_device_arg, pose_net
from flowtrack_tpu_torch.utils.logging import setup_logging
from flowtrack_tpu_torch.utils.vis import save_debug_images

log = logging.getLogger("flowtrack.test")


def build_val_dataset(cfg):
    """The validation dataset for cfg.data.dataset (mpii PCKh / posetrack
    with the GT boxes when no detection file is configured / coco)."""
    if cfg.data.dataset == "mpii":
        return MPIIDataset(cfg, cfg.data.root, "valid", is_train=False)
    if cfg.data.dataset == "posetrack":
        if not cfg.test.bbox_file and not cfg.test.use_gt_bbox:
            cfg = replace(cfg, test=replace(cfg.test, use_gt_bbox=True))
        return PoseTrackDataset(cfg, cfg.data.root, cfg.data.test_set,
                                is_train=False)
    return COCODataset(cfg, cfg.data.root, cfg.data.test_set,
                       is_train=False,
                       bbox_file=cfg.test.bbox_file or None)


def run_validation(cfg, model, output_dir=None, dataset=None,
                   debug_dir=None, device="cuda"):
    """Returns the eval stats dict (AP table for COCO, PCKh for MPII).
    ``model``: the PoseResNet with its weights, moved to ``device`` and put
    in eval mode. ``debug_dir``: the first batch's crops with predicted
    skeletons and per-joint heatmap grids (``vis.save_debug_images``)."""
    if dataset is None:
        dataset = build_val_dataset(cfg)
    flip_pairs = (MPII_FLIP_PAIRS if cfg.data.dataset == "mpii"
                  else COCO_FLIP_PAIRS)
    device = model_device(device)
    model = model.to(device).eval()
    loader = BatchLoader(dataset, cfg.test.batch_size, pad_to_batch=True)

    all_preds, all_maxvals, all_scores, all_ids = [], [], [], []
    dumped = False
    with torch.inference_mode():
        for batch in device_prefetch(loader, device):
            n = batch["n_valid"]
            out = eval_step(model, batch, cfg, flip_pairs)
            if debug_dir and not dumped:
                hm = pose_forward_fn(model, cfg.test.flip_test, flip_pairs,
                                     cfg.test.shift_heatmap)(batch["input"])
                save_debug_images(batch["input"][:n].float().cpu().numpy(),
                                  hm[:n].float().cpu().numpy(), debug_dir,
                                  prefix=cfg.data.dataset)
                dumped = True
            all_preds.append(out["preds"][:n].cpu().numpy())
            all_maxvals.append(out["maxvals"][:n].cpu().numpy())
            all_scores.append(out["scores"][:n].cpu().numpy())
            all_ids.append(batch["image_id"][:n].cpu().numpy())

    preds = np.concatenate(all_preds)
    maxvals = np.concatenate(all_maxvals)
    scores = np.concatenate(all_scores)
    ids = np.concatenate(all_ids)

    if cfg.data.dataset == "mpii":
        stats = dataset.evaluate(preds)
        log.info("PCKh@0.5: %s", stats)
        return stats
    stats, _ = dataset.evaluate(preds, maxvals, scores, ids,
                                output_dir=output_dir)
    dataset.print_eval(stats)
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default="coco_res50_256x192")
    ap.add_argument("--weights", required=True,
                    help=".npz variables of the JAX package or a torch "
                         ".pth state dict")
    ap.add_argument("--out", default="output/eval")
    ap.add_argument("--debug-dir", default=None,
                    help="dump first-batch debug images (crops with "
                         "predicted skeletons + heatmap grids)")
    add_device_arg(ap)
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)
    setup_logging()

    cfg = apply_overrides(get_config(args.cfg), args.opts)
    model = pose_net(cfg, args.weights)
    return run_validation(cfg, model, output_dir=args.out,
                          debug_dir=args.debug_dir, device=args.device)


if __name__ == "__main__":
    main()
