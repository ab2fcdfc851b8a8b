"""int8 post-training quantization (W8A8) of PoseResNet, and the exact
BatchNorm fold it starts from.

Port of ``flowtrack_tpu/models/quantize.py``, the whole module:

* ``QuantConv`` (quantize.py:37): a conv(+bias) holding either a float
  ``weight`` or, prequantized, int8 ``wq`` with a float32 per-output-channel
  ``w_scale``; a float32 ``bias``; the activation absmax ``amax``, a float32
  scalar buffer, 0 at construction. Its four modes: calibrate (:101) records
  ``max|x|`` and runs float; float (:107), the "folded" baseline, runs the
  conv in ``compute_dtype`` and adds the bias in float32 to the output rounded
  to that dtype; int8 (:114) quantizes the input per tensor and the weight per
  output channel, ``clip(round(v / scale), -127, 127)`` with ``scale = max|v|
  / 127``, multiplies in int8 with int32 sums (``ops/int8_conv.py``) and
  returns ``y * (a_scale * w_scale) + bias``; prequantized (:79) does the
  same with the stored int8 weight. ``mixed`` (:61) keeps int8 only where
  ``not transpose and (k == 1 or cin <= 64)``, the reference's rule.
* ``_QBlock`` (:126): bottleneck and basic blocks, BN folded away.
* ``PoseResNetQ`` (:163): the stem, max pool, stages, the quantized deconv
  head, and the float32 final conv (TF32 off, as ``_precision_for(float32)``
  asks). NCHW crops in (cast to float32), (M, K, h/4, w/4) float32 heatmaps
  out: a drop-in ``pose_model`` for ``ClipTracker``. It is inference-only:
  it starts in eval mode and train mode raises, which is all that
  ``QuantPoseAdapter`` (:322) adds to the reference's model, so the port
  has no adapter.
* ``_fold`` (:225) and ``fold_pose_resnet`` (:239): ``fold_bn`` and
  ``fold_pose_resnet`` below, which read the port's own ``PoseResNet``.
* ``prequantize_params`` (:289): the reference's float32 numpy recipe on the
  CPU, so ``wq`` and ``w_scale`` equal the reference's bit for bit.
* ``make_quant_variables`` (:313): loads a folded tree into a
  ``PoseResNetQ`` with every ``amax`` 0.
* ``calibrate`` (:359): runs batches in calibrate mode, filling ``amax``.
* ``quantize_pose_model`` (:335): the float PoseResNet -> the quantized
  module on its device, in eval mode.

The folded tree is the reference's, in its layouts, so the two folds
compare entry by entry and ``ops/fused_resnet.py`` takes either:

    {"conv1": {"kernel", "bias"},                       # stem, HWIO
     "layer{L}_{B}": {"conv1", "conv2", "conv3"[, "downsample_conv"]},
     "deconv{i}": {"kernel", "bias"},                    # flipped HWIO
     "final_kernel": HWIO, "final_bias": (K,)}

Every tensor of it is float32 on the CPU; ``prequantize_params`` turns each
``{kernel, bias}`` node into ``{wq, w_scale, bias}``. ``PoseResNetQ`` takes
both through ``utils/convert.load_quant_pose``, which also loads the
reference's own quantized variables. Its module names are the reference's
(``conv1``, ``layer1_0.conv1``, ``deconv0``, ``final_kernel``).

Divisions by a constant divide by a tensor on the values' device: by a
Python scalar a CUDA tensor is multiplied by the rounded reciprocal.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flowtrack_tpu_torch.config import ModelConfig
from flowtrack_tpu_torch.models.layers import apply_precision_policy
from flowtrack_tpu_torch.models.pose_resnet import RESNET_SPECS
from flowtrack_tpu_torch.ops.int8_conv import int8_conv2d
from flowtrack_tpu_torch.utils.convert import load_quant_pose

_BN_EPS = 1e-5  # the reference folds with this eps, whatever the module's
_Q = 127.0


def _per_channel(v, dim: int = 1):
    """A per-channel vector shaped to broadcast along ``dim`` of a 4-d
    tensor (1: an NCHW output's channels)."""
    shape = [1, 1, 1, 1]
    shape[dim] = -1
    return v.view(shape)


def quantize_weight(weight, transpose: bool = False):
    """Symmetric per-output-channel int8: (wq, w_scale) with ``w_scale =
    max(max|W|, 1e-12) / 127`` over the non-output dims ((1, 2, 3) for a
    Conv2d weight, (0, 2, 3) for a ConvTranspose2d one) and ``wq =
    clip(round(W / w_scale), -127, 127)``."""
    out_dim = 1 if transpose else 0
    dims = tuple(d for d in range(4) if d != out_dim)
    w_scale = (weight.abs().amax(dim=dims).clamp_min(1e-12)
               / weight.new_full((), _Q))
    wq = torch.round(weight / _per_channel(w_scale, out_dim)).clamp_(-127,
                                                                     127)
    return wq.to(torch.int8), w_scale


class QuantConv(nn.Module):
    """Conv(+bias) with optional int8 W8A8 execution (module docstring).
    ``forward(x, calibrate=False, quantized=True)`` on NCHW float input."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 strides: int = 1, padding: int = 0, transpose: bool = False,
                 mixed: bool = False, prequantized: bool = False,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        k = kernel_size
        self.kernel_size, self.strides, self.padding = k, strides, padding
        self.transpose, self.mixed = transpose, mixed
        self.prequantized, self.compute_dtype = prequantized, compute_dtype
        shape = ((in_features, features, k, k) if transpose
                 else (features, in_features, k, k))
        if prequantized:
            self.register_buffer("wq", torch.zeros(shape, dtype=torch.int8,
                                                   device=device))
            self.register_buffer("w_scale", torch.ones(features,
                                                       device=device))
        else:
            self.weight = nn.Parameter(torch.zeros(shape, device=device),
                                       requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features, device=device),
                                 requires_grad=False)
        self.register_buffer("amax", torch.zeros((), device=device))

    def _conv(self, x, w):
        conv = F.conv_transpose2d if self.transpose else F.conv2d
        return conv(x, w, stride=self.strides, padding=self.padding)

    def _int8(self, x, wq, w_scale):
        a_scale = self.amax.clamp_min(1e-6) / self.amax.new_full((), _Q)
        xq = torch.round(x.float() / a_scale).clamp_(-127, 127)
        y = int8_conv2d(xq.to(torch.int8), wq, self.strides, self.padding,
                        self.transpose)
        # int32 * float32 converts, then multiplies: y.astype(f32) * scale
        return y * _per_channel(a_scale * w_scale) + _per_channel(self.bias)

    def forward(self, x, calibrate: bool = False, quantized: bool = True):
        if self.mixed and quantized:
            quantized = (not self.transpose) and (self.kernel_size == 1
                                                  or x.shape[1] <= 64)
        if self.prequantized:
            if calibrate or not quantized:
                raise ValueError("prequantized QuantConv is "
                                 "int8-inference-only")
            return self._int8(x, self.wq, self.w_scale)
        if calibrate:
            self.amax.copy_(torch.maximum(self.amax, x.abs().amax()))
            quantized = False
        if not quantized:
            dt = self.compute_dtype
            y = self._conv(x.to(dt), self.weight.to(dt))
            return y.float() + _per_channel(self.bias)
        return self._int8(x, *quantize_weight(self.weight, self.transpose))


class _QBlock(nn.Module):
    """Bottleneck/basic residual block, BN pre-folded."""

    def __init__(self, block: str, in_features: int, features: int,
                 strides: int = 1, downsample: bool = False, **mk):
        super().__init__()
        self.bottleneck = block == "bottleneck"
        if self.bottleneck:
            self.conv1 = QuantConv(in_features, features, 1, 1, 0, **mk)
            self.conv2 = QuantConv(features, features, 3, strides, 1, **mk)
            self.conv3 = QuantConv(features, 4 * features, 1, 1, 0, **mk)
            out_f = 4 * features
        else:
            self.conv1 = QuantConv(in_features, features, 3, strides, 1, **mk)
            self.conv2 = QuantConv(features, features, 3, 1, 1, **mk)
            out_f = features
        self.downsample_conv = (QuantConv(in_features, out_f, 1, strides, 0,
                                          **mk) if downsample else None)

    def forward(self, x, calibrate=False, quantized=True):
        kw = dict(calibrate=calibrate, quantized=quantized)
        y = F.relu(self.conv1(x, **kw))
        y = self.conv2(y, **kw)
        if self.bottleneck:
            y = self.conv3(F.relu(y), **kw)
        residual = (x if self.downsample_conv is None
                    else self.downsample_conv(x, **kw))
        return F.relu(y + residual)


class PoseResNetQ(nn.Module):
    """int8-inference PoseResNet (BN folded away), the topology and conv
    names of ``PoseResNet`` in the reference's naming. ``forward(x,
    calibrate=False, quantized=True)``: (M, 3, h, w) crops of any float dtype
    -> (M, K, h/4, w/4) float32 heatmaps. Starts in eval mode; train mode
    raises."""

    def __init__(self, cfg: ModelConfig, mixed: bool = False,
                 prequantized: bool = False, compute_dtype=torch.float32,
                 device=None):
        super().__init__()
        apply_precision_policy(torch.float32)  # the float32 final conv
        mk = dict(mixed=mixed, prequantized=prequantized,
                  compute_dtype=compute_dtype, device=device)
        block, stages = RESNET_SPECS[cfg.num_layers]
        expansion = 4 if block == "bottleneck" else 1
        self.conv1 = QuantConv(3, 64, 7, 2, 3, **mk)
        self.block_names = []
        in_features = 64
        for stage, num_blocks in enumerate(stages):
            features = 64 * 2 ** stage
            strides = 1 if stage == 0 else 2
            for b in range(num_blocks):
                down = b == 0 and (strides != 1
                                   or in_features != features * expansion)
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, _QBlock(
                    block, in_features, features, strides if b == 0 else 1,
                    down, **mk))
                self.block_names.append(name)
                in_features = features * expansion
        self.num_deconv = cfg.num_deconv_layers
        for i in range(cfg.num_deconv_layers):
            k = cfg.num_deconv_kernels[i]
            filters = cfg.num_deconv_filters[i]
            self.add_module(f"deconv{i}", QuantConv(
                in_features, filters, k, 2, (k - 2) // 2, transpose=True,
                **mk))
            in_features = filters
        k = cfg.final_conv_kernel
        self.final_kernel = nn.Parameter(torch.zeros(
            cfg.num_joints, in_features, k, k, device=device),
            requires_grad=False)
        self.final_bias = nn.Parameter(torch.zeros(cfg.num_joints,
                                                   device=device),
                                       requires_grad=False)
        self.eval()

    def forward(self, x, calibrate: bool = False, quantized: bool = True):
        if self.training:
            raise RuntimeError("the quantized pose model is inference-only")
        kw = dict(calibrate=calibrate, quantized=quantized)
        x = F.relu(self.conv1(x.float(), **kw))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x, **kw)
        for i in range(self.num_deconv):
            x = F.relu(getattr(self, f"deconv{i}")(x, **kw))
        pad = (self.final_kernel.shape[-1] - 1) // 2
        y = F.conv2d(x, self.final_kernel, padding=pad)
        return y + _per_channel(self.final_bias)


# ---------------------------------------------------------------------------
# Float -> folded conversion, prequantization, calibration
# ---------------------------------------------------------------------------


def fold_bn(weight, bn: nn.BatchNorm2d, transpose_bias=None, out_dim: int = 0):
    """A convolution weight (torch layout) and the batch norm after it ->
    (folded weight, bias), both float32: in float64,
    ``inv = gamma / sqrt(var + 1e-5)`` scales the output channels (dim
    ``out_dim``: 0 for Conv2d, 1 for ConvTranspose2d) and
    ``bias = beta - mean * inv (+ transpose_bias * inv)``."""
    f64 = torch.float64
    gamma = bn.weight.detach().cpu().to(f64)
    beta = bn.bias.detach().cpu().to(f64)
    mean = bn.running_mean.detach().cpu().to(f64)
    var = bn.running_var.detach().cpu().to(f64)
    inv = gamma / torch.sqrt(var + _BN_EPS)
    shape = [1] * weight.dim()
    shape[out_dim] = -1
    w = weight.detach().cpu().to(f64) * inv.view(shape)
    b = beta - mean * inv
    if transpose_bias is not None:
        b = b + transpose_bias.detach().cpu().to(f64) * inv
    return w.float(), b.float()


def _hwio(w):
    """Conv2d weight (Cout, Cin, kH, kW) -> the reference's HWIO."""
    return w.permute(2, 3, 1, 0).contiguous()


def _deconv_hwio(w):
    """ConvTranspose2d weight (Cin, Cout, kH, kW) -> the reference's
    spatially flipped HWIO (torch_convert.deconv_kernel)."""
    return w.permute(2, 3, 0, 1).flip(0, 1).contiguous()


def _node(kernel, bias):
    return {"kernel": kernel, "bias": bias}


@torch.no_grad()
def fold_pose_resnet(model: nn.Module) -> dict:
    """The port's PoseResNet (bottleneck or basic blocks) -> the reference's
    BN-folded tree (module docstring)."""
    out = {"conv1": _node(*_fold_conv(model.conv1, model.bn1))}
    for stage in range(1, 5):
        for b, blk in enumerate(getattr(model, f"layer{stage}")):
            node = {}
            for ci in (1, 2, 3):
                conv = getattr(blk, f"conv{ci}", None)
                if conv is not None:
                    node[f"conv{ci}"] = _node(
                        *_fold_conv(conv, getattr(blk, f"bn{ci}")))
            if blk.downsample is not None:
                node["downsample_conv"] = _node(
                    *_fold_conv(blk.downsample[0], blk.downsample[1]))
            out[f"layer{stage}_{b}"] = node
    head = list(model.deconv_layers)
    for i in range(len(head) // 3):
        deconv, bn = head[3 * i], head[3 * i + 1]
        w, b = fold_bn(deconv.weight, bn, transpose_bias=deconv.bias,
                       out_dim=1)
        out[f"deconv{i}"] = _node(_deconv_hwio(w), b)
    final = model.final_layer
    out["final_kernel"] = _hwio(final.weight.detach().cpu().float())
    out["final_bias"] = (final.bias.detach().cpu().float()
                         if final.bias is not None
                         else torch.zeros(final.out_channels))
    return out


def _fold_conv(conv: nn.Conv2d, bn: nn.BatchNorm2d):
    w, b = fold_bn(conv.weight, bn)
    return _hwio(w), b


def prequantize_params(folded_params: dict) -> dict:
    """Folded tree -> prequantized tree: every {kernel, bias} node becomes
    {wq int8, w_scale float32 per output channel, bias}, by the reference's
    float32 numpy recipe (max over the HWIO kernel's axes 0-2), which
    ``quantize_weight`` computes at run time. The float head is untouched."""
    out = {}
    for k, v in folded_params.items():
        if isinstance(v, dict) and set(v) == {"kernel", "bias"}:
            kern = np.asarray(v["kernel"], np.float32)
            ws = np.maximum(np.abs(kern).max(axis=(0, 1, 2)),
                            1e-12) / 127.0
            wq = np.clip(np.round(kern / ws), -127, 127).astype(np.int8)
            out[k] = {"wq": torch.from_numpy(wq),
                      "w_scale": torch.from_numpy(ws),
                      "bias": v["bias"]}
        elif isinstance(v, dict):
            out[k] = prequantize_params(v)
        else:
            out[k] = v  # final_kernel / final_bias
    return out


def make_quant_variables(model: PoseResNetQ, folded_params: dict):
    """Load a folded (or prequantized) tree into ``model`` with every
    activation scale 0; returns ``model``."""
    return load_quant_pose(model, {"params": folded_params})


@torch.no_grad()
def calibrate(model: PoseResNetQ, batches):
    """Run representative NCHW batches in calibrate mode, accumulating each
    conv's input absmax into its ``amax``; returns ``model``."""
    device = model.conv1.amax.device
    for x in batches:
        model(torch.as_tensor(x).to(device), calibrate=True)
    return model


@torch.no_grad()
def quantize_pose_model(float_model: nn.Module, cfg: ModelConfig,
                        calib_batches, mixed: bool = False,
                        prequantized: bool = False,
                        compute_dtype=torch.float32) -> PoseResNetQ:
    """One-call PTQ: the port's float PoseResNet -> ``PoseResNetQ`` on its
    device, in eval mode, calibrated on ``calib_batches`` (NCHW).

    mixed=True: int8 only where the reference's rule keeps it (1x1 convs
    and <= 64-channel inputs), the rest in ``compute_dtype``.
    prequantized=True (full int8 only): weights stored int8 at conversion,
    no per-call weight quantization."""
    if prequantized and mixed:
        raise ValueError("prequantized supports the full-int8 mode only")
    device = next(float_model.parameters()).device
    folded = fold_pose_resnet(float_model)
    qmodel = PoseResNetQ(cfg, mixed=mixed, compute_dtype=compute_dtype,
                         device=device)
    calibrate(make_quant_variables(qmodel, folded), calib_batches)
    if not prequantized:
        return qmodel
    pmodel = PoseResNetQ(cfg, prequantized=True, compute_dtype=compute_dtype,
                         device=device)
    make_quant_variables(pmodel, prequantize_params(folded))
    for name, amax in qmodel.named_buffers():
        if name.endswith("amax"):
            pmodel.get_buffer(name).copy_(amax)
    return pmodel
