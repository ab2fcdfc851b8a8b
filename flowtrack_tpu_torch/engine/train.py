"""The pose train and eval steps, the optimizer and its schedule.

Port of ``flowtrack_tpu/engine/train.py``:

* ``make_lr_schedule`` and ``make_optimizer`` (:41-55): Adam (or SGD with
  momentum 0.9) at ``cfg.train.lr``, times ``lr_factor`` from each of the
  ``lr_steps`` epochs on, counted in steps as ``optax.
  piecewise_constant_schedule`` counts them: step ``boundary`` is the
  first at the lower rate;
* ``TrainState`` and ``create_train_state`` (:32-75): the model, its
  optimizer, the schedule and the step count, the step a host int;
* ``train_step`` (:78-102): the forward in train mode (batch statistics,
  running statistics updated as torch's BatchNorm2d does, which is the
  reference's ``BatchNormTorch``), JointsMSELoss, the backward, the
  optimizer's step at the step's rate, and the accuracy on the device, with
  no host sync. Under a process group of more than one rank (one a mesh
  slot, ``parallel/distributed.py``) it is the reference's step on a
  sharded batch: the gradients are averaged across the ranks before the
  optimizer's step, and the loss, accuracy and count returned are the
  global batch's (batch norms see the global batch when converted by
  ``convert_global_bn``);
* ``pose_forward_fn``, ``pose_forward_args_fn`` and ``eval_step``
  (:105-144): the flip test as one double-batch forward
  (``pipeline.flip_test_heatmaps``), the decode and the rescoring on the
  device (``ops/decode.py``).

Batches keep the reference's layouts: inputs (N, H, W, 3), targets
(N, h, w, K); the model takes and gives NCHW.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from flowtrack_tpu_torch.config import Config
from flowtrack_tpu_torch.engine.loss import joints_mse_loss
from flowtrack_tpu_torch.engine.metrics import (accuracy_from_counts,
                                                heatmap_accuracy, joint_counts)
from flowtrack_tpu_torch.ops.decode import get_final_preds, rescore
from flowtrack_tpu_torch.parallel.distributed import (all_reduce_mean,
                                                      all_reduce_sum,
                                                      average_gradients,
                                                      is_distributed)
from flowtrack_tpu_torch.pipeline import flip_test_heatmaps


def make_lr_schedule(cfg: Config, steps_per_epoch: int) -> Callable[[int], float]:
    """step -> learning rate: ``lr`` times ``lr_factor`` for each epoch
    boundary in ``lr_steps`` at or below the step's epoch."""
    boundaries = sorted({int(e) * steps_per_epoch for e in cfg.train.lr_steps})
    lr, factor = cfg.train.lr, cfg.train.lr_factor

    def schedule(step: int) -> float:
        return lr * factor ** sum(step >= b for b in boundaries)

    return schedule


def make_optimizer(cfg: Config, params, steps_per_epoch: int = 1):
    """-> (optimizer over ``params`` at the schedule's first rate,
    schedule)."""
    sched = make_lr_schedule(cfg, steps_per_epoch)
    if cfg.train.optimizer == "adam":
        return torch.optim.Adam(params, lr=sched(0)), sched
    if cfg.train.optimizer == "sgd":
        return torch.optim.SGD(params, lr=sched(0), momentum=0.9), sched
    raise KeyError(cfg.train.optimizer)


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0

    def apply_gradients(self):
        """The optimizer's step at the schedule's rate for this step."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, cfg: Config,
                       steps_per_epoch: int = 1) -> TrainState:
    opt, sched = make_optimizer(cfg, model.parameters(), steps_per_epoch)
    return TrainState(model, opt, sched)


def train_step(state: TrainState, batch, use_target_weight: bool = True):
    """One step on ``batch`` {input (N, H, W, 3) normalised, target
    (N, h, w, K), target_weight (N, K)}, tensors on the model's device.
    Updates ``state`` in place; returns it and {loss, acc, cnt}, tensors on
    the device. Under a process group ``batch`` is this rank's equal shard
    of the global batch (module docstring)."""
    model = state.model.train()
    out = model(batch["input"].permute(0, 3, 1, 2).contiguous())
    hm = out.permute(0, 2, 3, 1)
    tw = batch["target_weight"] if use_target_weight else None
    loss = joints_mse_loss(hm, batch["target"], tw)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if is_distributed():
        average_gradients(model.parameters())
    state.apply_gradients()
    with torch.no_grad():
        if not is_distributed():
            acc, _, cnt = heatmap_accuracy(hm.detach(), batch["target"])
            return state, {"loss": loss.detach(), "acc": acc, "cnt": cnt}
        # the global batch's: the mean of equal shards' losses, and the
        # accuracy of the right and visible joints summed over the shards
        counts = all_reduce_sum(torch.stack(joint_counts(hm.detach(),
                                                         batch["target"])))
        acc, _, cnt = accuracy_from_counts(counts[0], counts[1])
    return state, {"loss": all_reduce_mean(loss), "acc": acc, "cnt": cnt}


def pose_forward_args_fn(flip_test: bool, flip_pairs,
                         shift_heatmap: bool = True):
    """-> fwd(model, x): (N, H, W, 3) inputs -> (N, h, w, K) heatmaps; with
    ``flip_test`` one forward of the inputs and their mirror images, the
    two merged (``pipeline.flip_test_heatmaps``). The model runs in
    whatever mode it is in."""
    return lambda model, x: flip_test_heatmaps(model, x, flip_test,
                                               shift_heatmap, flip_pairs)


def pose_forward_fn(model, flip_test: bool, flip_pairs,
                    shift_heatmap: bool = True):
    """``pose_forward_args_fn`` with the model bound: -> fwd(x)."""
    fwd = pose_forward_args_fn(flip_test, flip_pairs, shift_heatmap)
    return lambda x: fwd(model, x)


@torch.no_grad()
def eval_step(model, batch, cfg: Config, flip_pairs):
    """The validation body on the device: the model in eval mode, the
    forward (flip-merged), decode, rescoring -> {preds (N, K, 2) image
    coordinates, maxvals (N, K), scores (N,)}."""
    fwd = pose_forward_fn(model.eval(), cfg.test.flip_test, flip_pairs,
                          cfg.test.shift_heatmap)
    hm = fwd(batch["input"])
    preds, maxvals = get_final_preds(hm, batch["center"], batch["scale"],
                                     post_process=cfg.test.post_process,
                                     blur_kernel=cfg.test.blur_kernel)
    scores = rescore(batch["score"], maxvals, cfg.test.in_vis_thre)
    return {"preds": preds, "maxvals": maxvals, "scores": scores}
