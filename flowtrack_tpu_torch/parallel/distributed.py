"""Data-parallel training over a mesh: one process a mesh slot.

PyTorch's counterpart of what GSPMD inserts into the reference's train
step (``tools/train.py:118-124``): the reference runs the unsharded step on
a batch sharded over its mesh, so its batch norms normalise with the
global batch's statistics and its gradient is the global batch's mean.
Independent per-device forwards in one process cannot give every shard the
global statistics at every batch norm, so training runs one
``torch.distributed`` rank per slot:

* ``run_on_mesh(fn, mesh, *args)`` spawns the ranks (the ``spawn`` start
  method: a fork would copy the parent's threads), each with its slot's
  device current, over ``gloo`` on the CPU or where the mesh repeats a card
  (NCCL refuses two ranks on one GPU) and ``nccl`` across distinct cards,
  and returns rank 0's result; a rank that raises fails the call;
* ``GlobalBatchNorm2d``: in train mode the batch statistics of the global
  batch, from two all-reduces (the sums and the count, then the squared
  deviations from the global mean) through a differentiable all-reduce
  whose backward is an all-reduce too; the running statistics updated as
  ``nn.BatchNorm2d`` updates them, the unbiased variance with the global
  count. In eval mode, or with no process group, it is ``nn.BatchNorm2d``.
  ``convert_global_bn`` turns a model's batch norms into it in place;
* ``average_gradients``: one all-reduce of every gradient, divided by the
  world size; ``all_reduce_mean``; ``broadcast_state`` (rank 0's model
  and optimizer state to every rank, for ``--resume``).

``engine/train.train_step`` and ``engine/flow_train.flow_train_step`` call
these when a process group of more than one rank is up; with none they are
the one-device steps. Every function a rank runs lives in this package, so
no rank imports jax. ``train_steps_on_mesh`` runs steps of either kind on
a mesh from host batches, the sharded train step that the tests and the
smoke hold against the unsharded one.
"""

from __future__ import annotations

import os
import socket
import tempfile
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch import nn

from flowtrack_tpu_torch.parallel.mesh import Mesh, part

_RANK_DEVICE: Optional[torch.device] = None


def world_size() -> int:
    """Ranks in the process group; 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def is_distributed() -> bool:
    return world_size() > 1


def rank() -> int:
    return dist.get_rank() if world_size() > 1 else 0


def rank_device() -> torch.device:
    """The device of this rank's mesh slot (the CPU outside a rank)."""
    return _RANK_DEVICE or torch.device("cpu")


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if is_distributed():
        dist.barrier()


def backend_for(mesh: Mesh) -> str:
    """``nccl`` for a mesh of distinct CUDA devices, else ``gloo``."""
    devices = mesh.flat()
    if (all(d.type == "cuda" for d in devices)
            and len(set(devices)) == len(devices)):
        return "nccl"
    return "gloo"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(index, devices, backend, port, tmp, threads):
    global _RANK_DEVICE
    _RANK_DEVICE = devices[index]
    if _RANK_DEVICE.type == "cuda":
        torch.cuda.set_device(_RANK_DEVICE)
    torch.set_num_threads(threads)
    fn, args = torch.load(os.path.join(tmp, "call.pt"), weights_only=False)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=len(devices), rank=index)
    try:
        result = fn(*args)
        if index == 0:
            torch.save(result, os.path.join(tmp, "rank0.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_on_mesh(fn, mesh: Mesh, *args):
    """``fn(*args)`` in one spawned process per mesh slot, rank i with slot
    i's device current (``rank_device()``) and a process group of all of
    them; returns rank 0's result. ``fn`` and ``args`` go to the ranks, and
    the result comes back, through files, so that every rank holds its own
    copy of each tensor (process arguments would share CPU tensors' memory
    between the ranks). The ranks share this process's intra-op threads.
    A rank that raises ends the others and raises here."""
    devices = mesh.flat()
    threads = max(1, torch.get_num_threads() // len(devices))
    with tempfile.TemporaryDirectory() as tmp:
        torch.save((fn, args), os.path.join(tmp, "call.pt"))
        mp.start_processes(
            _rank_main, args=(devices, backend_for(mesh), _free_port(), tmp,
                              threads),
            nprocs=len(devices), join=True, start_method="spawn")
        return torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward of a sum is the sum of the
    gradients over the ranks."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x):
    """``x`` summed over the ranks, differentiably; ``x`` itself with no
    process group."""
    return _AllReduceSum.apply(x) if is_distributed() else x


@torch.no_grad()
def all_reduce_mean(x):
    """The mean of ``x`` over the ranks (a metric; not differentiable)."""
    if not is_distributed():
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x / x.new_full((), world_size())


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode statistics are the global
    batch's over every rank of the process group (module docstring)."""

    def forward(self, x):
        if not (self.training and is_distributed()):
            return super().forward(x)
        dims = (0, 2, 3)
        xf = x.float()
        local = torch.cat([xf.sum(dims),
                           xf.new_full((1,), x.numel() // x.shape[1])])
        total = all_reduce_sum(local)
        count = total[-1]
        mean = total[:-1] / count
        centred = xf - mean[None, :, None, None]
        var = all_reduce_sum(centred.square().sum(dims)) / count
        y = centred * torch.rsqrt(var + self.eps)[None, :, None, None]
        if self.affine:
            y = y * self.weight[None, :, None, None] \
                + self.bias[None, :, None, None]
        if self.track_running_stats:
            self._update_running(mean.detach(), var.detach(), count.detach())
        return y.to(x.dtype)

    @torch.no_grad()
    def _update_running(self, mean, var, count):
        """``nn.BatchNorm2d``'s update: momentum (or the cumulative mean
        when it is None), the unbiased variance of the global count."""
        factor = 0.0 if self.momentum is None else self.momentum
        if self.num_batches_tracked is not None:
            self.num_batches_tracked.add_(1)
            if self.momentum is None:
                factor = 1.0 / float(self.num_batches_tracked)
        unbiased = var * count / (count - 1).clamp(min=1)
        self.running_mean.mul_(1 - factor).add_(factor * mean)
        self.running_var.mul_(1 - factor).add_(factor * unbiased)


def convert_global_bn(module: nn.Module) -> nn.Module:
    """Every ``nn.BatchNorm2d`` of ``module`` made a ``GlobalBatchNorm2d``
    in place (the same parameters and buffers, so an optimizer built on
    them stays valid); returns ``module``."""
    for m in module.modules():
        if type(m) is nn.BatchNorm2d:
            m.__class__ = GlobalBatchNorm2d
    return module


@torch.no_grad()
def average_gradients(params) -> None:
    """Each gradient replaced by its mean over the ranks: one all-reduce of
    all of them, flattened."""
    if not is_distributed():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= world_size()
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()


@torch.no_grad()
def broadcast_state(state) -> None:
    """Rank 0's model parameters and buffers, optimizer state and step
    count onto every rank (a ``TrainState``, in place; every rank holds
    the same structure, e.g. each restored the same checkpoint)."""
    if not is_distributed():
        return
    tensors = list(state.model.state_dict().values())
    for group in state.optimizer.state.values():
        tensors += [v for _, v in sorted(group.items())
                    if isinstance(v, torch.Tensor)]
    for t in tensors:
        dist.broadcast(t, 0)
    step = [state.step]
    dist.broadcast_object_list(step, 0)
    state.step = step[0]


def to_cpu(tree):
    """Every tensor of a nest of dicts and lists copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


def _shard(batch: dict, dev) -> dict:
    """This rank's equal part of a host batch's arrays, on ``dev``."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        out[k] = v if v.dim() == 0 else part(v, rank(), world_size()).to(dev)
    return out


def _train_steps_rank(jobs):
    from flowtrack_tpu_torch.engine.flow_train import flow_train_step
    from flowtrack_tpu_torch.engine.train import (create_train_state,
                                                  train_step)
    from flowtrack_tpu_torch.models.layers import apply_precision_policy
    from flowtrack_tpu_torch.ops import correlation, crop, warp

    counters = {"crop_resize_normalize": crop.crop_frames_cuda,
                "correlation": correlation.correlation_cuda,
                "resample2d": warp.resample2d_cuda}
    dev = rank_device()
    results = []
    for job in jobs:
        apply_precision_policy(torch.float32)
        for fn in counters.values():
            fn.launches = 0
        model = convert_global_bn(job["model"].to(dev))
        result = {}
        if job["kind"] == "forward":
            model.train()
            with torch.no_grad():
                out = model(_shard({"x": job["batches"][0]}, dev)["x"])
            result["output"] = out.cpu()
        else:
            state = create_train_state(model, job["cfg"])
            result["metrics"] = []
            for batch in job["batches"]:
                if job["kind"] == "pose":
                    state, m = train_step(state, _shard(batch, dev),
                                          job["cfg"].train.use_target_weight)
                else:
                    state, m = flow_train_step(state, _shard(batch, dev),
                                               job.get("div_flow", 20.0))
                result["metrics"].append({k: float(v) for k, v in m.items()})
        result["state"] = to_cpu(model.state_dict())
        result["launches"] = {k: fn.launches for k, fn in counters.items()}
        results.append(result)
    return results


def train_steps_on_mesh(mesh: Mesh, jobs: list) -> list:
    """The sharded train step, one rank a mesh slot: for each job (a dict:
    ``kind`` "pose" (``train_step``), "flow" (``flow_train_step``) or
    "forward" (one train-mode forward, no step); ``model``, a module;
    ``cfg``, its Config; ``batches``, host batches of the global batch,
    split equally over the ranks; ``div_flow``) the model's batch norms
    made global, its train state built and the steps taken. Returns rank
    0's results, one per job: {"state": the model's state dict on the CPU,
    "metrics": per step the step's floats (the global batch's), or
    "output": rank 0's part of the forward's output; "launches": the port's
    kernels launched by rank 0 in the job, by name}. float32 runs without
    TF32."""
    return run_on_mesh(_train_steps_rank, mesh, jobs)
