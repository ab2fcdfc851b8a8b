"""Train or fine-tune a FlowNet on an optical-flow corpus.

Port of ``tools/train_flow.py`` (``main`` :45), with the same arguments but
the XLA compile cache's, and ``--device`` (default ``cuda``). One device,
so ``--batch`` is the whole batch (the reference's is per device). Each
epoch: ``data/flow_dataset.flow_batches`` over a FlyingChairs-style
(``--triplets``) or Sintel-style (``--frames`` + ``--gt-flow``) corpus,
random crops to the /64 ``--crop`` and flips, shuffled with the epoch as
the seed, the short last batch filled by repeats; on the device
``models/flownet.preprocess_pair`` and ``engine/flow_train.
flow_train_step`` (FlowNetC's cost volume is the correlation kernel, the
FlowNet2 variants' warps the resample2d kernel). With ``--val-triplets``
or ``--val-frames`` + ``--val-gt-flow``: the per-sample EPE of the
centre-cropped validation pairs at full resolution, the repeats of a short
batch left out. ``--ckpt-dir``: a checkpoint each epoch, the best by the
lowest EPE (validation's, else training's), and ``--resume``. The trained
weights go to ``--out`` as the JAX package's ``.npz`` tree, which both
packages' ``eval_flow`` and the tracking pipelines read.

    python3 -m flowtrack_tpu_torch.tools.train_flow --cfg flownet_c \\
        --triplets chairs/ --crop 320 448 --batch 8 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import torch

from flowtrack_tpu_torch.config import apply_overrides, get_config
from flowtrack_tpu_torch.data.flow_dataset import FlowPairDataset, flow_batches
from flowtrack_tpu_torch.engine.checkpoint import (CheckpointManager,
                                                   save_npz_variables)
from flowtrack_tpu_torch.engine.flow_train import flow_train_step
from flowtrack_tpu_torch.engine.metrics import AverageMeter
from flowtrack_tpu_torch.engine.train import create_train_state
from flowtrack_tpu_torch.models.flownet import (get_flow_net, postprocess_flow,
                                                preprocess_pair)
from flowtrack_tpu_torch.pipeline import model_device
from flowtrack_tpu_torch.tools.common import add_device_arg
from flowtrack_tpu_torch.utils.convert import FLOW_CONVERTERS
from flowtrack_tpu_torch.utils.logging import MetricsWriter, setup_logging

log = logging.getLogger("flowtrack.train_flow")


def flow_tree(model, variant: str) -> dict:
    """The flow net's weights as the JAX package's variable tree."""
    return FLOW_CONVERTERS[variant].convert(model.state_dict())


def _on(b, device):
    return [torch.as_tensor(b[k]).to(device, non_blocking=True)
            for k in ("im1", "im2", "flow")]


@torch.no_grad()
def validate(model, val_ds, cfg, crop, batch, device) -> float:
    """Mean per-sample EPE (px) of the net in eval mode over ``val_ds``."""
    fcfg = cfg.flow
    meter = AverageMeter()
    model.eval()
    for b in flow_batches(val_ds, batch, shuffle=False, drop_last=False):
        im1, im2, flow = _on(b, device)
        pred = model(preprocess_pair(im1, im2, fcfg.rgb_max)
                     .permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        up = postprocess_flow(pred, fcfg.variant, crop, fcfg.div_flow)
        err = torch.sqrt(((up - flow) ** 2).sum(-1))
        epe = err.sum((1, 2)) / err.new_tensor(err.shape[1] * err.shape[2])
        real = epe[:b["n_real"]].cpu()
        meter.update(float(real.mean()), n=len(real))
    return meter.avg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default="flownet_s")
    ap.add_argument("--triplets", default=None,
                    help="FlyingChairs-style *_img1/_img2/_flow.flo dir")
    ap.add_argument("--frames", default=None,
                    help="Sintel-style ordered frames dir")
    ap.add_argument("--gt-flow", default=None,
                    help="Sintel-style per-pair .flo dir")
    ap.add_argument("--crop", type=int, nargs=2, default=(320, 448),
                    metavar=("H", "W"),
                    help="static /64-divisible train crop")
    ap.add_argument("--batch", type=int, default=8,
                    help="batch on the one device")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--out", default="flownet_trained.npz")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint dir: per-epoch save, best tracked by "
                         "val EPE (or train EPE without a val set); "
                         "enables --resume")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--val-triplets", default=None,
                    help="validation FlyingChairs-style dir")
    ap.add_argument("--val-frames", default=None,
                    help="validation Sintel-style frames dir")
    ap.add_argument("--val-gt-flow", default=None,
                    help="validation per-pair .flo dir")
    ap.add_argument("--tensorboard", default=None, metavar="DIR",
                    help="also mirror scalars to a TensorBoard event dir")
    add_device_arg(ap)
    ap.add_argument("opts", nargs="*", help="dotted overrides k=v")
    args = ap.parse_args(argv)
    setup_logging()

    cfg = apply_overrides(get_config(args.cfg), args.opts)
    device = model_device(args.device)
    metrics = MetricsWriter(
        os.path.join(args.ckpt_dir or
                     os.path.dirname(os.path.abspath(args.out)) or ".",
                     "metrics.jsonl"),
        tensorboard_dir=args.tensorboard)
    ch, cw = args.crop
    if ch % 64 or cw % 64:
        raise SystemExit("--crop must be /64-divisible (FlowNet encoders)")
    ds = FlowPairDataset(root=args.triplets, frames_dir=args.frames,
                         flow_dir=args.gt_flow, crop_size=(ch, cw),
                         is_train=True)
    log.info("flow corpus: %d pairs, crop %dx%d, batch %d", len(ds), ch, cw,
             args.batch)

    model = get_flow_net(cfg.flow,
                         generator=torch.Generator().manual_seed(0))
    model = model.to(device)
    # the lr milestones (train.lr_steps) are epochs: the schedule counts
    # them in steps of this corpus
    steps_per_epoch = max(1, -(-len(ds) // args.batch))
    state = create_train_state(model, cfg, steps_per_epoch)
    div_flow, rgb_max = cfg.flow.div_flow, cfg.flow.rgb_max

    val_ds = None
    if args.val_triplets or args.val_frames:
        val_ds = FlowPairDataset(root=args.val_triplets,
                                 frames_dir=args.val_frames,
                                 flow_dir=args.val_gt_flow,
                                 crop_size=(ch, cw), is_train=False)
        log.info("val corpus: %d pairs (center crop %dx%d)",
                 len(val_ds), ch, cw)

    mgr = None
    start_epoch = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        if args.resume:
            state, epoch = mgr.restore(state)
            start_epoch = epoch + 1
            log.info("resumed from epoch %d", epoch)

    meter = AverageMeter()
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        meter.reset()
        for b in flow_batches(ds, args.batch, shuffle=True, seed=epoch,
                              drop_last=False):
            im1, im2, fl = _on(b, device)
            batch = {"input": preprocess_pair(im1, im2, rgb_max),
                     "flow": fl}
            state, m = flow_train_step(state, batch, div_flow=div_flow)
            meter.update(float(m["epe"]), n=len(b["im1"]))
        line = {"epoch": epoch, "epe": round(meter.avg, 4),
                "seconds": round(time.time() - t0, 1)}
        if val_ds is not None:
            line["val_epe"] = round(validate(model, val_ds, cfg, (ch, cw),
                                             args.batch, device), 4)
        log.info(json.dumps(line))
        metrics.write(epoch, **{k: v for k, v in line.items()
                                if k != "epoch"})
        if mgr is not None:
            # the best is the LOWEST epe; CheckpointManager keeps the max
            mgr.save(epoch, state, perf=-line.get("val_epe", line["epe"]))
    metrics.close()

    save_npz_variables(args.out, flow_tree(model, cfg.flow.variant))
    log.info("saved %s", args.out)
    return state


if __name__ == "__main__":
    main()
