"""The FlowNet train step.

Port of ``flowtrack_tpu/engine/flow_train.py`` (:25-61), on the pose
engine's ``TrainState``. FlowNetS / C / SD return the (flow2, ..., flow6)
pyramid in train mode and train on the multi-scale EPE; the FlowNet2
cascades return one full-resolution flow in pixels and train on its EPE
(their sub-nets keep their inference normalisation). The step's metric is
the full-resolution EPE: for the pyramid, flow2 times ``div_flow``
enlarged by ``models/flownet.resize_bilinear``, which has held
``jax.image.resize``'s weights since the flow nets were ported. Under a
process group of more than one rank (``parallel/distributed.py``) the
gradients are averaged across the ranks before the optimizer's step, and
the loss and EPE returned are the means over the equal shards: the global
batch's.
"""

from __future__ import annotations

import torch

from flowtrack_tpu_torch.engine.loss import epe, multiscale_epe
from flowtrack_tpu_torch.engine.train import TrainState
from flowtrack_tpu_torch.models.flownet import resize_bilinear
from flowtrack_tpu_torch.parallel.distributed import (all_reduce_mean,
                                                      average_gradients,
                                                      is_distributed)


def flow_train_step(state: TrainState, batch, div_flow: float = 20.0):
    """One step on ``batch`` {input (N, H, W, 6) preprocessed pairs
    (``preprocess_pair``), flow (N, H, W, 2) ground truth}, tensors on the
    model's device. Updates ``state`` in place; returns it and {loss, epe},
    tensors on the device, with no host sync."""
    model = state.model.train()
    gt = batch["flow"]
    out = model(batch["input"].permute(0, 3, 1, 2).contiguous())
    if isinstance(out, (tuple, list)):
        flows = [f.permute(0, 2, 3, 1) for f in out]
        loss = multiscale_epe(flows, gt, div_flow=div_flow)
        with torch.no_grad():
            flow_full = resize_bilinear(flows[0] * div_flow,
                                        (gt.shape[1], gt.shape[2]))
    else:
        flow_full = out.permute(0, 2, 3, 1)
        loss = epe(flow_full, gt)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if is_distributed():
        average_gradients(model.parameters())
    state.apply_gradients()
    with torch.no_grad():
        metric = epe(flow_full.detach(), gt)
    return state, {"loss": all_reduce_mean(loss.detach()),
                   "epe": all_reduce_mean(metric)}
