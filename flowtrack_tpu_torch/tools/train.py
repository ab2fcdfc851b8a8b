"""Train PoseResNet: the epoch loop with validation, checkpoints and resume.

Port of ``tools/train.py`` (``make_dataset`` :39, ``initial_variables``
:57, ``main`` :87), with the same arguments but the XLA compile cache's,
and ``--device`` (default ``cuda``). As in the reference, the batch is
``train.batch_size`` a device of the mesh (``mesh.*``: by default every
card, or the one device asked for; ``mesh.num_devices=n`` repeats an
explicit device), so the global batch is that times the mesh's size. A
mesh of more than one slot runs the epoch loop in one process a slot
(``parallel/distributed.run_on_mesh``): each rank reads its part of every
global batch, its batch norms normalise with the global batch
(``convert_global_bn``) and the gradients are averaged before each step;
rank 0 alone validates, checkpoints and writes the metrics.
Each epoch: ``BatchLoader`` (shuffled with ``train.seed``, the short last
batch dropped) copied ahead to the device, ``engine/train.
make_jit_train_step``'s step (``train_step``, Adam with the milestone
schedule: on a card one CUDA graph per batch geometry, eagerly on the CPU
and under a process group), the reference's log line; then
validation through ``tools/test.run_validation`` on the dataset built once
(``build_val_dataset``; absent validation data is logged and scores 0),
``CheckpointManager.save`` with the score, and one line of
``metrics.jsonl`` (train_loss, train_acc, val_perf, best_perf, and the lr
the schedule gives at the step reached).

Starting weights: seeded random (``train.seed``), ``--init-weights`` (a
full pose net: the JAX package's ``.npz`` or a torch ``.pth``, the COCO to
PoseTrack fine-tune), or ``--imagenet-backbone`` (a torchvision ResNet
``.pth``, or its ``.npz`` from ``tools/export_weights.py --kind
backbone_imagenet``) under a random head. ``--resume`` continues from the
newest checkpoint in the output directory (on a mesh every rank restores
it and rank 0's state is broadcast).

    python3 -m flowtrack_tpu_torch.tools.train --cfg coco_res50_256x192 \\
        data.root=data/coco [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import torch

from flowtrack_tpu_torch.config import apply_overrides, get_config
from flowtrack_tpu_torch.data import (BatchLoader, COCODataset, MPIIDataset,
                                      PoseTrackDataset)
from flowtrack_tpu_torch.data.loader import device_prefetch
from flowtrack_tpu_torch.engine.checkpoint import (CheckpointManager,
                                                   load_npz_variables)
from flowtrack_tpu_torch.engine.metrics import AverageMeter
from flowtrack_tpu_torch.engine.train import (create_train_state,
                                              make_jit_train_step)
from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
from flowtrack_tpu_torch.parallel import distributed, make_mesh, mesh_for
from flowtrack_tpu_torch.pipeline import model_device
from flowtrack_tpu_torch.tools.common import add_device_arg, pose_net
from flowtrack_tpu_torch.tools.test import build_val_dataset, run_validation
from flowtrack_tpu_torch.utils.convert import (init_backbone_from_imagenet,
                                               load_backbone_tree,
                                               load_torch_file)
from flowtrack_tpu_torch.utils.logging import MetricsWriter, setup_logging

log = logging.getLogger("flowtrack.train")


def make_dataset(cfg, is_train):
    if cfg.data.dataset == "coco":
        return COCODataset(cfg, cfg.data.root,
                           cfg.data.train_set if is_train else
                           cfg.data.test_set, is_train=is_train)
    if cfg.data.dataset == "mpii":
        return MPIIDataset(cfg, cfg.data.root,
                           "train" if is_train else "valid",
                           is_train=is_train)
    if cfg.data.dataset == "posetrack":
        # the FlowTrack recipe: fine-tune the COCO-trained pose model on
        # PoseTrack frames (warm start through --init-weights)
        return PoseTrackDataset(cfg, cfg.data.root,
                                cfg.data.train_set if is_train else
                                cfg.data.test_set, is_train=is_train)
    raise KeyError(cfg.data.dataset)


def initial_model(args, cfg):
    """cfg.model's PoseResNet on the CPU: --init-weights (every tensor), or
    seeded random weights (``train.seed``) with --imagenet-backbone's over
    the backbone (the head stays random)."""
    if args.init_weights:
        return pose_net(cfg, args.init_weights)
    model = get_pose_net(cfg.model,
                         generator=torch.Generator().manual_seed(cfg.train.seed))
    if args.imagenet_backbone:
        if args.imagenet_backbone.endswith(".npz"):
            return load_backbone_tree(
                model, load_npz_variables(args.imagenet_backbone))
        return init_backbone_from_imagenet(
            model, load_torch_file(args.imagenet_backbone))
    return model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default="coco_res50_256x192")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out", default=None, help="checkpoint dir override")
    ap.add_argument("--init-weights", default=None,
                    help="warm-start full pose weights (the JAX package's "
                         ".npz or a torch .pth) — the COCO->PoseTrack "
                         "fine-tune path")
    ap.add_argument("--imagenet-backbone", default=None,
                    help="torchvision ResNet .pth (or converted .npz): "
                         "ImageNet backbone init, head stays random")
    ap.add_argument("--tensorboard", default=None, metavar="DIR",
                    help="also mirror scalars to a TensorBoard event dir")
    add_device_arg(ap)
    ap.add_argument("opts", nargs="*", help="dotted overrides k=v")
    args = ap.parse_args(argv)
    setup_logging()

    cfg = apply_overrides(get_config(args.cfg), args.opts)
    mesh = mesh_for(model_device(args.device), cfg.mesh.num_devices,
                    cfg.mesh.data_axis)
    log.info("mesh: %s", mesh)
    if mesh.size == 1:
        return train_epochs(args, cfg, model_device(args.device))
    # one rank a slot; rank 0's final state comes back to this process
    out = distributed.run_on_mesh(train_epochs, mesh, args, cfg)
    state = create_train_state(initial_model(args, cfg), cfg,
                               out["steps_per_epoch"])
    state.model.load_state_dict(out["model"])
    state.optimizer.load_state_dict(out["optimizer"])
    state.step = out["step"]
    return state


def train_epochs(args, cfg, device=None):
    """The epoch loop on ``device`` (in a rank of a mesh: the rank's
    device, its share of each global batch). Returns the TrainState; a rank
    returns its model's and optimizer's state dicts on the CPU, its step
    and the steps an epoch."""
    ranks = distributed.world_size()
    rank0 = distributed.rank() == 0
    if device is None:
        device = distributed.rank_device()
    ckpt_dir = args.out or cfg.train.checkpoint_dir
    mwriter = MetricsWriter(os.path.join(ckpt_dir, "metrics.jsonl"),
                            tensorboard_dir=args.tensorboard) if rank0 \
        else None

    train_ds = make_dataset(cfg, is_train=True)
    loader = BatchLoader(train_ds, cfg.train.batch_size * ranks,
                         shuffle=cfg.train.shuffle, drop_last=True,
                         seed=cfg.train.seed,
                         shard=(distributed.rank(), ranks))
    steps_per_epoch = max(len(loader), 1)

    model = initial_model(args, cfg).to(device)
    if ranks > 1:
        distributed.convert_global_bn(model)
    state = create_train_state(model, cfg, steps_per_epoch)

    mgr = CheckpointManager(ckpt_dir)
    start_epoch = 0
    best = 0.0
    if args.resume:
        state, epoch = mgr.restore(state)
        distributed.broadcast_state(state)
        start_epoch = epoch + 1
        log.info("resumed from epoch %d", epoch)

    step_fn = make_jit_train_step(cfg.train.use_target_weight)

    val_ds = None
    for epoch in range(start_epoch, cfg.train.end_epoch):
        losses, accs, btime = AverageMeter(), AverageMeter(), AverageMeter()
        t0 = time.time()
        for i, batch in enumerate(device_prefetch(loader, device)):
            state, metrics = step_fn(state, batch)
            losses.update(float(metrics["loss"]), len(batch["input"]) * ranks)
            accs.update(float(metrics["acc"]))
            btime.update(time.time() - t0)
            t0 = time.time()
            if i % cfg.train.print_freq == 0 and rank0:
                log.info("epoch %d [%d/%d] loss %.5f (%.5f) acc %.3f "
                         "(%.3f) %.3fs/b", epoch, i, steps_per_epoch,
                         losses.val, losses.avg, accs.val, accs.avg,
                         btime.avg)
        if not rank0:
            # rank 0 validates and saves before the next epoch starts
            distributed.barrier()
            continue

        perf = 0.0
        try:
            # absent validation data lands in the except below, not a crash
            if val_ds is None:
                val_ds = build_val_dataset(cfg)
            stats = run_validation(cfg, model, dataset=val_ds,
                                   device=device,
                                   mesh=make_mesh(0, devices=[device])
                                   if ranks > 1 else None)
            perf = stats.get("AP", stats.get("Mean", 0.0))
        except Exception as e:  # validation data may be absent
            log.warning("validation skipped: %s", e)
        best = max(best, perf)
        mgr.save(epoch, state, perf=perf)
        # the optimizer's own schedule at the step reached
        lr = state.schedule(state.step)
        mwriter.write(epoch, train_loss=losses.avg, train_acc=accs.avg,
                      val_perf=perf, best_perf=best, lr=lr)
        log.info("epoch %d done: loss %.5f perf %.4f (best %.4f)",
                 epoch, losses.avg, perf, best)
        distributed.barrier()
    if mwriter is not None:
        mwriter.close()
    if ranks == 1:
        return state
    return {"model": distributed.to_cpu(model.state_dict()),
            "optimizer": distributed.to_cpu(state.optimizer.state_dict()),
            "step": state.step, "steps_per_epoch": steps_per_epoch}


if __name__ == "__main__":
    main()
