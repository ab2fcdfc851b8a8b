"""Evaluate a pose model on COCO, PoseTrack or MPII.

Port of ``tools/test.py``: ``build_val_dataset`` (:37), ``run_validation``
(:59) and ``main`` (:126), with the same arguments but the XLA compile
cache's, and ``--device`` (default ``cuda``). The validate loop over a
mesh of devices (``mesh.*``: by default every card, or the one device
asked for): batches of ``test.batch_size`` times the mesh's size, each
slot's part copied ahead to its device, where a replica of the pose net
runs the inputs and their mirror images with the flip merge, decode and
rescoring (``engine/train.eval_step``: on a card one CUDA graph a replica
and batch shape, ``make_jit_eval_step``, kept for the net's next
validation), every slot dispatched before the
results are gathered in order; then, on the host, OKS-NMS and COCO AP (or
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
from flowtrack_tpu_torch.engine.train import (make_jit_eval_step,
                                              pose_forward_fn)
from flowtrack_tpu_torch.parallel import batch_sharding, mesh_for, replicas
from flowtrack_tpu_torch.tools.common import add_device_arg, pose_net
from flowtrack_tpu_torch.utils.graphs import kept
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
                   debug_dir=None, device="cuda", mesh=None):
    """Returns the eval stats dict (AP table for COCO, PCKh for MPII).
    ``model``: the PoseResNet with its weights, put in eval mode and
    replicated on the mesh's devices (``mesh`` None:
    ``mesh_for(device, cfg.mesh.num_devices, cfg.mesh.data_axis)``).
    ``debug_dir``: the first batch's crops with predicted skeletons and
    per-joint heatmap grids (``vis.save_debug_images``)."""
    if dataset is None:
        dataset = build_val_dataset(cfg)
    flip_pairs = (MPII_FLIP_PAIRS if cfg.data.dataset == "mpii"
                  else COCO_FLIP_PAIRS)
    if mesh is None:
        mesh = mesh_for(device, cfg.mesh.num_devices, cfg.mesh.data_axis)
    models = [m.eval() for m in replicas(mesh, model.to(mesh.flat()[0]))]
    steps = [kept(m, ("eval", cfg.test, tuple(map(tuple, flip_pairs))),
                  lambda: make_jit_eval_step(cfg, flip_pairs))
             for m in models]
    loader = BatchLoader(dataset, cfg.test.batch_size * mesh.size,
                         pad_to_batch=True)

    all_preds, all_maxvals, all_scores, all_ids = [], [], [], []
    dumped = False
    with torch.inference_mode():
        for slots in device_prefetch(loader,
                                     sharding=batch_sharding(mesh)):
            n = slots[0]["n_valid"]
            # every slot dispatched before any result is fetched
            outs = [step(m, b) for step, m, b in zip(steps, models, slots)]
            if debug_dir and not dumped:
                fwd = pose_forward_fn(models[0], cfg.test.flip_test,
                                      flip_pairs, cfg.test.shift_heatmap)
                inputs = torch.cat([b["input"].cpu() for b in slots])
                hm = torch.cat([fwd(b["input"]).cpu() for b in slots])
                save_debug_images(inputs[:n].float().numpy(),
                                  hm[:n].float().numpy(), debug_dir,
                                  prefix=cfg.data.dataset)
                dumped = True

            def gathered(key):
                return torch.cat([o[key].cpu() for o in outs])[:n].numpy()

            all_preds.append(gathered("preds"))
            all_maxvals.append(gathered("maxvals"))
            all_scores.append(gathered("scores"))
            all_ids.append(torch.cat([b["image_id"].cpu()
                                      for b in slots])[:n].numpy())

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
