"""What every reference net of the benchmark keeps to, and the layers its
control rounds.

A configuration file's ``reference`` section names one module of this
directory for each net, ``{"pose": <module>, "flow": <module>}``, and the
harness finds it by that name (``spec.reference``). A new pose or flow
architecture is a new module here and a configuration that names it; the
harness keeps no table of architectures. A module holds the float32 net in
plain PyTorch, written from its published description, imports nothing of
the program or JAX, and exposes ``build(config, device)``: the net of the
configuration dict in eval mode on ``device``. Parameter names and module
order are the lineage's, the names of the program's own net, so that
``weights.make_state`` draws the same tensors in the same order for both
and one state dict loads into both sides.

* Pose: ``forward(crops)``, (N, 3, h, w) normalised crops at the
  configuration's ``model.image_size`` -> (N, K, h', w') heatmaps.
  ``counts.pose_flops`` counts one such forward.
* Flow: ``forward(prev, nxt)``, two (N, H, W, 3) uint8 frame batches ->
  (N, H, W, 2) float32 flow from ``prev`` to ``nxt`` in pixels of those
  frames: the family's own input grid, normalisation and output scaling
  live behind it. ``core(x)`` is the net from its own input to its own
  output, the operations that count; the module also exposes
  ``net_input(config, frame_hw)``, the shape of one pair as ``core`` takes
  it, and ``uncounted_flops(config, frame_hw)``, the operations of one
  pair that ``FlopCounterMode`` does not see (``counts.flow_flops``).
* Control: every operand that the fp8 control rounds goes through
  ``QConv2d``, ``QConvTranspose2d`` or a ``corr_quant`` attribute of the net
  or of one of its modules (identity by default), which ``set_quant``
  reaches: a convolution's input and weight, a cost volume's two feature
  maps. A new family keeps to this, or its control computes in float32.

Float32 throughout: the caller turns TF32 off.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn


def identity(x):
    return x


class QConv2d(nn.Conv2d):
    quant = staticmethod(identity)

    def forward(self, x):
        return F.conv2d(self.quant(x), self.quant(self.weight), self.bias,
                        self.stride, self.padding, self.dilation, self.groups)


class QConvTranspose2d(nn.ConvTranspose2d):
    quant = staticmethod(identity)

    def forward(self, x):
        return F.conv_transpose2d(self.quant(x), self.quant(self.weight),
                                  self.bias, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


def set_quant(net: nn.Module, quant) -> nn.Module:
    """Round every operand of ``net`` that the control contract names with
    ``quant``: each ``QConv2d``'s and ``QConvTranspose2d``'s, and each
    ``corr_quant`` of ``net`` and its modules."""
    for m in net.modules():
        if isinstance(m, (QConv2d, QConvTranspose2d)):
            m.quant = quant
        if hasattr(m, "corr_quant"):
            m.corr_quant = quant
    return net
