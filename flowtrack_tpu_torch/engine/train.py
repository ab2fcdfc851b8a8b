"""The pose train and eval steps, the optimizer and its schedule.

Port of ``flowtrack_tpu/engine/train.py``:

* ``make_lr_schedule`` and ``make_optimizer`` (:41-55): Adam (or SGD with
  momentum 0.9) at ``cfg.train.lr``, times ``lr_factor`` from each of the
  ``lr_steps`` epochs on, counted in steps as ``optax.
  piecewise_constant_schedule`` counts them: step ``boundary`` is the
  first at the lower rate. On a CUDA device the rate is a device tensor
  that the optimizer reads (Adam ``capturable``, SGD ``fused``), so that
  a replayed step takes the rate written before it;
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
  device (``ops/decode.py``);
* ``make_jit_train_step`` (:147), the reference's donated ``jax.jit`` of
  the step, and ``graphed_step``, the same for any step function (the flow
  CLI's), and ``make_jit_eval_step``, the validation CLI's jitted
  evaluation: on a CUDA device one CUDA graph per batch geometry
  (``utils/graphs.py``); on the CPU, and for a train step under a process
  group, the eager step.

Batches keep the reference's layouts: inputs (N, H, W, 3), targets
(N, h, w, K); the model takes and gives NCHW.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Sequence

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
from flowtrack_tpu_torch.utils.graphs import GraphCache, net_state


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
    schedule). On a CUDA device the optimizer takes the card's route
    (``device_rate``), also after each ``load_state_dict``; on the CPU the
    rate is a Python float."""
    params = list(params)
    sched = make_lr_schedule(cfg, steps_per_epoch)
    if cfg.train.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=sched(0))
    elif cfg.train.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=sched(0), momentum=0.9)
    else:
        raise KeyError(cfg.train.optimizer)
    if params and params[0].is_cuda:
        device_rate(opt)
        opt.register_load_state_dict_post_hook(device_rate)
    return opt, sched


def device_rate(optimizer) -> None:
    """The card's route for ``optimizer``: each group's rate a float32
    tensor on its parameters' device, which ``TrainState.set_rate`` fills
    in place and a captured step reads by address; Adam ``capturable``
    (its step counts on the device too), SGD ``fused`` (the unfused SGD
    reads a tensor rate back to the host, a sync that a capture refuses).
    ``make_optimizer`` runs it again after each ``load_state_dict``: a
    state saved on the CPU, or before the rate moved to the device, loads
    a float rate (which a capture would freeze into its graph), the flags
    off and Adam's step counts on the host."""
    for group in optimizer.param_groups:
        device = group["params"][0].device
        group["lr"] = torch.full((), float(group["lr"]), device=device)
        if isinstance(optimizer, torch.optim.Adam):
            group["capturable"] = True
            for p in group["params"]:
                st = optimizer.state.get(p, {})
                if "step" in st:
                    st["step"] = st["step"].to(device, torch.float32)
        else:
            group["fused"] = True


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0

    def set_rate(self):
        """The schedule's rate for this step into every parameter group: a
        device rate is filled in place (a captured step reads it by
        address), a host rate replaced."""
        rate = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(rate)
            else:
                group["lr"] = rate

    def apply_gradients(self):
        """The optimizer's step at the schedule's rate for this step."""
        self.set_rate()
        self.optimizer.step()
        self.step += 1

    def tensors(self) -> list:
        """What a captured step reads beside its batch: the model's
        parameters and buffers, the optimizer's state and rates."""
        state = net_state(self.model)
        for group in self.optimizer.param_groups:
            state.append(group["lr"])
            for p in group["params"]:
                state += [v for v in self.optimizer.state.get(p, {}).values()
                          if isinstance(v, torch.Tensor)]
        return state


@dataclass
class _Update:
    """A train state as a captured step sees it: ``apply_gradients`` is
    the optimizer's step alone; the rate and the step count are host work
    that ``graphed_step`` does around each replay."""
    model: nn.Module
    optimizer: torch.optim.Optimizer

    def apply_gradients(self):
        self.optimizer.step()


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


def graphed_step(step_fn, keys: Sequence[str]):
    """``step_fn(state, batch) -> (state, metrics)``, which updates
    ``state`` in place and reads ``batch``'s ``keys``, as one program per
    batch geometry: on a CUDA device its CUDA graph (forward, loss,
    backward, the optimizer's step), replayed after copying the batch into
    its static inputs and the schedule's rate into the optimizer's device
    rate, the step counted after it. A geometry's first call is an eager
    step on the capture's stream, which is also its warm-up; the capture
    then steps nothing. The graphs (the step's ``graphs``, a
    ``GraphCache``) are captured again when the state's tensors change
    (``TrainState.tensors``: a model loaded into new tensors,
    ``optimizer.load_state_dict`` on a resume). A capture with a rate that
    is not a device tensor raises. On the CPU, and under a process group
    (gloo's all-reduce cannot be captured, and a captured nccl step is not
    ported), the step runs eagerly."""
    graphs = GraphCache()

    def step(state, batch):
        args = [batch[k] for k in keys]
        if is_distributed() or not graphs.on_card(args[0]):
            return step_fn(state, batch)
        key = tuple((k, a.shape, a.dtype) for k, a in zip(keys, args))
        graph = graphs.lookup(key, state.tensors)
        if graph is None:
            with graphs.warming(args[0].device):
                out = step_fn(state, batch)
            if not all(isinstance(g["lr"], torch.Tensor) and
                       g["lr"].device == g["params"][0].device
                       for g in state.optimizer.param_groups):
                raise RuntimeError("a captured step reads its rate from a "
                                   "tensor on the parameters' device "
                                   "(make_optimizer, device_rate)")
            update = _Update(state.model, state.optimizer)
            graph = graphs.capture(
                key, lambda *inputs: step_fn(update,
                                             dict(zip(keys, inputs)))[1],
                args, state.tensors, warmup=False)
            # the capture left the gradients in the graph's pool
            graph.held += [p.grad for p in state.model.parameters()
                           if p.grad is not None]
            return out
        state.set_rate()
        metrics = graph.run(args)
        state.step += 1
        return state, metrics

    step.graphs = graphs
    return step


def make_jit_train_step(use_target_weight: bool = True, donate: bool = True):
    """The reference's ``make_jit_train_step``: ``train_step`` as
    ``graphed_step`` (one CUDA graph per batch geometry on the card). The
    port updates the state in place whatever ``donate`` says, as
    ``train_step`` does; the argument is kept for the reference's
    signature."""
    del donate
    keys = ("input", "target") + (("target_weight",) if use_target_weight
                                  else ())
    return graphed_step(partial(train_step,
                                use_target_weight=use_target_weight), keys)


def make_jit_eval_step(cfg: Config, flip_pairs):
    """-> ``step(model, batch)``: ``eval_step`` as one CUDA graph per batch
    shape on the card (eagerly on the CPU), the validation CLI's jitted
    step. Its graphs read one model's tensors: one such step a model."""
    graphs = GraphCache()
    keys = ("input", "center", "scale", "score")

    def step(model, batch):
        args = [batch[k] for k in keys]
        model.eval()
        return graphs.run(
            tuple(a.shape for a in args),
            lambda *a: eval_step(model, dict(zip(keys, a)), cfg, flip_pairs),
            args, lambda: net_state(model))

    return step
