"""Carry weights between the reference package's trees and the port's
modules, both ways.

The reference's variables (numpy trees of ``{"params", "batch_stats"}``, as
``flax`` init or an ``.npz`` checkpoint gives them) become lineage-named
state dicts and load with ``strict=True``, so a missing or extra name fails.
The tree-to-state-dict functions are the port of the reverse half of
``flowtrack_tpu/utils/torch_convert.py`` (torch_convert.py:329-448), numpy
only; ``tests/test_torch_models.py`` and ``tests/test_torch_flownet2.py``
pin them to the reference's. The other way, ``convert_pose_resnet`` and the
``convert_flownet_*`` functions are the port's copy of its forward half
(torch_convert.py:69-326): a port state dict (``num_batches_tracked``
ignored) -> the reference's tree, which the reference loads.
``named_parameters_from_tree`` maps a tree shaped like ``params`` (the
reference's gradients, Adam moments) onto the port's parameter names.
The ImageNet init (torch_convert.py:27, :122-185): ``load_torch_file``,
``convert_resnet_backbone``, ``overlay_variables``, ``overlay_backbone``
and ``init_backbone_from_imagenet`` as the reference has them, the last
also loading a torchvision state dict straight into the port's module
(whose names are torchvision's); ``load_backbone_tree`` loads a converted
backbone tree.

Layouts: the reference's conv kernels are HWIO, torch's Conv2d weights
(Cout, Cin, kH, kW); its deconv kernels are spatially flipped HWIO (an
input-dilated conv), torch's ConvTranspose2d weights (Cin, Cout, kH, kW).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch
from torch import nn


def conv_kernel_to_torch(w) -> np.ndarray:
    """HWIO -> torch Conv2d (Cout, Cin, kH, kW)."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def deconv_kernel_to_torch(w) -> np.ndarray:
    """The reference's flipped-HWIO deconv kernel -> torch ConvTranspose2d
    (Cin, Cout, kH, kW): unflip both spatial axes, then transpose."""
    w = np.asarray(w)[::-1, ::-1]
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1)))


def _bn_to_torch(sd: dict, torch_prefix: str, pnode: dict, snode: dict):
    sd[torch_prefix + ".weight"] = np.asarray(pnode["scale"])
    sd[torch_prefix + ".bias"] = np.asarray(pnode["bias"])
    sd[torch_prefix + ".running_mean"] = np.asarray(snode["mean"])
    sd[torch_prefix + ".running_var"] = np.asarray(snode["var"])
    # torch's BatchNorm2d tracks this buffer; 0 is its fresh value
    sd[torch_prefix + ".num_batches_tracked"] = np.asarray(0, np.int64)


def _reverse_backbone(variables: dict) -> Dict[str, np.ndarray]:
    """The ``backbone`` subtrees of ``variables`` -> torch state dict
    entries (conv1, bn1, layerL.B.*)."""
    bb = variables["params"]["backbone"]
    bbs = variables.get("batch_stats", {}).get("backbone", {})
    sd: Dict[str, np.ndarray] = {}
    sd["conv1.weight"] = conv_kernel_to_torch(bb["conv1"]["kernel"])
    _bn_to_torch(sd, "bn1", bb["bn1"], bbs["bn1"])
    blk_re = re.compile(r"^layer(\d+)_(\d+)$")
    for name in sorted(bb):
        m = blk_re.match(name)
        if not m:
            continue
        tp = f"layer{m.group(1)}.{m.group(2)}"
        blk, blks = bb[name], bbs[name]
        for ci in (1, 2, 3):
            if f"conv{ci}" not in blk:
                continue
            sd[f"{tp}.conv{ci}.weight"] = conv_kernel_to_torch(
                blk[f"conv{ci}"]["kernel"])
            _bn_to_torch(sd, f"{tp}.bn{ci}", blk[f"bn{ci}"], blks[f"bn{ci}"])
        if "downsample_conv" in blk:
            sd[f"{tp}.downsample.0.weight"] = conv_kernel_to_torch(
                blk["downsample_conv"]["kernel"])
            _bn_to_torch(sd, f"{tp}.downsample.1", blk["downsample_bn"],
                         blks["downsample_bn"])
    return sd


def reverse_pose_resnet(variables: dict) -> Dict[str, np.ndarray]:
    """PoseResNet variables -> torch state dict (lineage naming:
    conv1/bn1/layerL.B.*/deconv_layers.{3i}/final_layer)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = _reverse_backbone(variables)
    i = 0
    while f"deconv{i}" in params:
        node = params[f"deconv{i}"]
        sd[f"deconv_layers.{3 * i}.weight"] = deconv_kernel_to_torch(
            node["kernel"])
        if "bias" in node:
            sd[f"deconv_layers.{3 * i}.bias"] = np.asarray(node["bias"])
        _bn_to_torch(sd, f"deconv_layers.{3 * i + 1}",
                     params[f"deconv_bn{i}"], stats[f"deconv_bn{i}"])
        i += 1
    sd["final_layer.weight"] = conv_kernel_to_torch(params["final"]["kernel"])
    if "bias" in params["final"]:
        sd["final_layer.bias"] = np.asarray(params["final"]["bias"])
    return sd


def _reverse_flownet_layer(sd: dict, name: str, node: dict, bn_stats,
                           prefix: str):
    if name.startswith("upsampled_flow"):
        sd[f"{prefix}{name}.weight"] = deconv_kernel_to_torch(node["kernel"])
        bkey = f"{prefix}{name}.bias"
    elif name.startswith("predict_flow"):
        sd[f"{prefix}{name}.weight"] = conv_kernel_to_torch(node["kernel"])
        bkey = f"{prefix}{name}.bias"
    elif name.startswith("deconv"):
        node = node["deconv"]
        sd[f"{prefix}{name}.0.weight"] = deconv_kernel_to_torch(node["kernel"])
        bkey = f"{prefix}{name}.0.bias"
    else:  # a conv with an optional batch norm, Sequential-wrapped
        inner = node["conv"]
        sd[f"{prefix}{name}.0.weight"] = conv_kernel_to_torch(inner["kernel"])
        if "bn" in node:
            _bn_to_torch(sd, f"{prefix}{name}.1", node["bn"], bn_stats)
        node, bkey = inner, f"{prefix}{name}.0.bias"
    if "bias" in node:
        sd[bkey] = np.asarray(node["bias"])


def _reverse_flownet_module(variables: dict, prefix: str = ""):
    sd: Dict[str, np.ndarray] = {}

    def walk(pnode, snode):
        for name in sorted(pnode):
            if name == "trunk":
                walk(pnode[name], snode.get(name, {}))
                continue
            bn_stats = snode.get(name, {}).get("bn")
            _reverse_flownet_layer(sd, name, pnode[name], bn_stats, prefix)

    walk(variables["params"], variables.get("batch_stats", {}))
    return sd


def reverse_flownet(variables: dict) -> Dict[str, np.ndarray]:
    """FlowNetS / C / SD / Fusion variables -> torch state dict (the shared
    trunk's nesting flattened back to top-level lineage names)."""
    return _reverse_flownet_module(variables)


def reverse_flownet2(variables: dict) -> Dict[str, np.ndarray]:
    """FlowNet2(-CS / -CSS) variables -> torch state dict with per-subnet
    ``flownetc.`` / ``flownets_1.`` ... prefixes."""
    sd: Dict[str, np.ndarray] = {}
    stats = variables.get("batch_stats", {})
    for sub in variables["params"]:
        sd.update(_reverse_flownet_module(
            {"params": variables["params"][sub],
             "batch_stats": stats.get(sub, {})}, prefix=f"{sub}."))
    return sd


def _f32(v) -> np.ndarray:
    """A tensor or a numpy array (float32 or bfloat16) as float32 numpy;
    bfloat16 values are exact in float32."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().numpy()
    return np.asarray(v, np.float32)


def fused_state_dict(variables: dict) -> dict:
    """A fused inference tree (the reference's ``prepare_fused_variables``,
    as numpy, or ``ops/fused_resnet.prepare_fused_variables``) ->
    ``FusedPoseResNet``'s state dict. Every entry of the tree becomes one
    entry, so a strict load fails on a missing or an extra tensor."""
    sd = {"stem.kernel": conv_kernel_to_torch(_f32(variables["stem"]["kernel"])),
          "stem.bias": _f32(variables["stem"]["bias"])}
    for s, blocks in enumerate(variables["stages"]):
        for b, blk in enumerate(blocks):
            for k, v in blk.items():
                sd[f"stages.{s}.{b}.{k}"] = _f32(v)
    for name, d in variables["head"].items():
        i = int(name.removeprefix("deconv"))
        sd[f"head.{i}.kernel"] = deconv_kernel_to_torch(_f32(d["kernel"]))
        sd[f"head.{i}.bias"] = _f32(d["bias"])
    sd["final.kernel"] = conv_kernel_to_torch(_f32(variables["final"]["kernel"]))
    sd["final.bias"] = _f32(variables["final"]["bias"])
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}


def _load(module: nn.Module, sd) -> nn.Module:
    state = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    module.load_state_dict(state, strict=True)
    return module


def load_lineage_state_dict(module: nn.Module, sd) -> nn.Module:
    """A state dict in the lineage's names (tensors or numpy arrays,
    ``module.`` prefixes allowed) -> ``module`` (in place). Every tensor
    must match a name of the module, and every name be given but a
    ``num_batches_tracked`` (older torch has none)."""
    sd = {k.removeprefix("module."): torch.as_tensor(v) for k, v in sd.items()}
    missing, unexpected = module.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"missing {missing}, unexpected {unexpected}")
    return module


def load_pose_resnet(module: nn.Module, variables) -> nn.Module:
    """Reference PoseResNet variables -> the port's PoseResNet (in place)."""
    return _load(module, reverse_pose_resnet(variables))


def load_flownet(module: nn.Module, variables) -> nn.Module:
    """Reference FlowNetS / C / SD / Fusion variables -> the port's model."""
    return _load(module, reverse_flownet(variables))


def load_flownet2(module: nn.Module, variables) -> nn.Module:
    """Reference FlowNet2 variables -> the port's FlowNet2, or, given the
    subset of sub-nets they hold (``flownetc``, ``flownets_1`` and for CSS
    ``flownets_2``), its FlowNet2-CS / CSS."""
    return _load(module, reverse_flownet2(variables))


def load_fused_pose(module: nn.Module, fused_variables) -> nn.Module:
    """The reference's fused inference tree (``ops/fused_resnet.py::
    prepare_fused_variables``, as numpy) -> the port's FusedPoseResNet (in
    place). A missing or an extra tensor fails."""
    module.load_state_dict(fused_state_dict(fused_variables), strict=True)
    return module


# ---------------------------------------------------------------------------
# The other way: port state dicts -> the reference's trees
# ---------------------------------------------------------------------------

def state_dict_to_numpy(sd) -> Dict[str, np.ndarray]:
    """A state dict as numpy copies (a later in-place update of a tensor
    does not reach them)."""
    return {k: (v.detach().cpu().numpy().copy() if isinstance(v, torch.Tensor)
                else np.array(v)) for k, v in sd.items()}


def conv_kernel(w) -> np.ndarray:
    """torch Conv2d (Cout, Cin, kH, kW) -> HWIO."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def deconv_kernel(w) -> np.ndarray:
    """torch ConvTranspose2d (Cin, Cout, kH, kW) -> the reference's flipped
    HWIO deconv kernel."""
    return np.transpose(np.asarray(w), (2, 3, 0, 1))[::-1, ::-1].copy()


def _set(tree: dict, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(value)


def _bn(params, stats, path, prefix, sd):
    _set(params, path + ("scale",), sd[prefix + ".weight"])
    _set(params, path + ("bias",), sd[prefix + ".bias"])
    _set(stats, path + ("mean",), sd[prefix + ".running_mean"])
    _set(stats, path + ("var",), sd[prefix + ".running_var"])


def _convert_backbone(sd, params: dict, stats: dict) -> None:
    """conv1, bn1 and layerL.B.* of a numpy state dict -> the ``backbone``
    subtrees of ``params`` and ``stats``; other keys are not read."""
    b = ("backbone",)
    _set(params, b + ("conv1", "kernel"), conv_kernel(sd["conv1.weight"]))
    _bn(params, stats, b + ("bn1",), "bn1", sd)
    layer_re = re.compile(r"^layer(\d+)\.(\d+)\.")
    blocks = sorted({tuple(map(int, m.groups())) for m in
                     map(layer_re.match, sd) if m})
    for li, bi in blocks:
        blk, tp = b + (f"layer{li}_{bi}",), f"layer{li}.{bi}"
        for ci in (1, 2, 3):
            if f"{tp}.conv{ci}.weight" not in sd:
                continue
            _set(params, blk + (f"conv{ci}", "kernel"),
                 conv_kernel(sd[f"{tp}.conv{ci}.weight"]))
            _bn(params, stats, blk + (f"bn{ci}",), f"{tp}.bn{ci}", sd)
        if f"{tp}.downsample.0.weight" in sd:
            _set(params, blk + ("downsample_conv", "kernel"),
                 conv_kernel(sd[f"{tp}.downsample.0.weight"]))
            _bn(params, stats, blk + ("downsample_bn",),
                f"{tp}.downsample.1", sd)


def convert_pose_resnet(sd, num_deconv_layers: int = 3) -> dict:
    """PoseResNet state dict -> the reference's {"params", "batch_stats"}."""
    sd = state_dict_to_numpy(sd)
    params: dict = {}
    stats: dict = {}
    _convert_backbone(sd, params, stats)
    for i in range(num_deconv_layers):
        _set(params, (f"deconv{i}", "kernel"),
             deconv_kernel(sd[f"deconv_layers.{3 * i}.weight"]))
        if f"deconv_layers.{3 * i}.bias" in sd:
            _set(params, (f"deconv{i}", "bias"),
                 sd[f"deconv_layers.{3 * i}.bias"])
        _bn(params, stats, (f"deconv_bn{i}",), f"deconv_layers.{3 * i + 1}",
            sd)
    _set(params, ("final", "kernel"), conv_kernel(sd["final_layer.weight"]))
    if "final_layer.bias" in sd:
        _set(params, ("final", "bias"), sd["final_layer.bias"])
    return {"params": params, "batch_stats": stats}


# the layers of FlowNetS / C's shared refinement trunk, which the reference
# nests under "trunk"
_TRUNK_NAMES = frozenset(
    [f"predict_flow{i}" for i in range(2, 7)]
    + [f"deconv{i}" for i in range(2, 6)]
    + [f"upsampled_flow{i}_to_{i - 1}" for i in range(3, 7)])


def _convert_flownet_module(sd, prefix="", trunk_names=_TRUNK_NAMES):
    params: dict = {}
    stats: dict = {}
    names = {k[len(prefix):].split(".")[0] for k in sd if k.startswith(prefix)}
    for name in sorted(names):
        scope = ("trunk",) if name in trunk_names else ()
        key = next(c for c in (f"{prefix}{name}.0", f"{prefix}{name}")
                   if f"{c}.weight" in sd)
        w = sd[f"{key}.weight"]
        if name.startswith("upsampled_flow"):
            path, kernel = scope + (name,), deconv_kernel(w)
        elif name.startswith("predict_flow"):
            path, kernel = scope + (name,), conv_kernel(w)
        elif name.startswith("deconv"):
            path, kernel = scope + (name, "deconv"), deconv_kernel(w)
        else:  # a conv with an optional batch norm
            path, kernel = scope + (name, "conv"), conv_kernel(w)
        _set(params, path + ("kernel",), kernel)
        if f"{key}.bias" in sd:
            _set(params, path + ("bias",), sd[f"{key}.bias"])
        if f"{prefix}{name}.1.running_mean" in sd:
            _bn(params, stats, scope + (name, "bn"), f"{prefix}{name}.1", sd)
    return params, stats


def _flownet_tree(params, stats) -> dict:
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def convert_flownet_s(sd) -> dict:
    """FlowNetS or FlowNetC state dict -> the reference's tree."""
    return _flownet_tree(*_convert_flownet_module(state_dict_to_numpy(sd)))


convert_flownet_c = convert_flownet_s


def convert_flownet_sd(sd) -> dict:
    """FlowNetSD or FlowNetFusion state dict (no shared trunk) -> the
    reference's tree."""
    return _flownet_tree(*_convert_flownet_module(
        state_dict_to_numpy(sd), trunk_names=frozenset()))


convert_flownet_fusion = convert_flownet_sd

_FLOWNET2_SUBNETS = {"flownetc": _TRUNK_NAMES, "flownets_1": _TRUNK_NAMES,
                     "flownets_2": _TRUNK_NAMES, "flownets_d": frozenset(),
                     "flownetfusion": frozenset()}


def convert_flownet2(sd) -> dict:
    """FlowNet2 (or FlowNet2-CS / CSS) state dict -> the reference's tree,
    one subtree a sub-net."""
    sd = state_dict_to_numpy(sd)
    params: dict = {}
    stats: dict = {}
    for sub, trunk in _FLOWNET2_SUBNETS.items():
        p, s = _convert_flownet_module(sd, f"{sub}.", trunk)
        if p:
            params[sub] = p
        if s:
            stats[sub] = s
    return _flownet_tree(params, stats)


# FlowNet2-CS / CSS state dicts hold a subset of the sub-nets, which
# convert_flownet2 skips when absent
convert_flownet2_cs = convert_flownet2
convert_flownet2_css = convert_flownet2


class FlowConverter(NamedTuple):
    """A flow variant's weight converters: ``convert``, the port's state
    dict -> the reference's tree; ``reverse``, the tree -> a state dict."""
    convert: Callable
    reverse: Callable


# FlowConfig.variant -> its converters: train_flow, export_weights, the zoo
# and the CLIs' weight loading all look a variant up here
FLOW_CONVERTERS = {
    "flownet_s": FlowConverter(convert_flownet_s, reverse_flownet),
    "flownet_c": FlowConverter(convert_flownet_c, reverse_flownet),
    "flownet_sd": FlowConverter(convert_flownet_sd, reverse_flownet),
    "flownet2": FlowConverter(convert_flownet2, reverse_flownet2),
    "flownet2_cs": FlowConverter(convert_flownet2_cs, reverse_flownet2),
    "flownet2_css": FlowConverter(convert_flownet2_css, reverse_flownet2),
}


def load_flow_tree(module: nn.Module, variables, variant: str) -> nn.Module:
    """Reference variables of flow ``variant`` -> the port's flow net of
    that variant (in place)."""
    return _load(module, FLOW_CONVERTERS[variant].reverse(variables))


# ---------------------------------------------------------------------------
# ImageNet backbone init (torch_convert.py:27, :122-185)
# ---------------------------------------------------------------------------

def load_torch_file(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint (a state dict, optionally wrapped in
    ``{"state_dict": ...}`` and with ``module.`` prefixes) -> {name: numpy
    copy}."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return state_dict_to_numpy({k.removeprefix("module."): v
                                for k, v in sd.items()})


def convert_resnet_backbone(sd) -> dict:
    """A torchvision-named ResNet state dict (conv1, bn1, layerL.B.*; fc
    ignored) -> the reference's ``backbone`` params and batch_stats
    subtrees."""
    params: dict = {}
    stats: dict = {}
    _convert_backbone(state_dict_to_numpy(sd), params, stats)
    return {"params": params, "batch_stats": stats}


def overlay_variables(dst: dict, src: dict) -> dict:
    """``dst`` with every leaf that the (partial) tree ``src`` holds
    replaced by ``src``'s."""
    out = dict(dst)
    for k, v in src.items():
        out[k] = overlay_variables(dst[k], v) if isinstance(v, dict) else v
    return out


def overlay_backbone(variables: dict, conv: dict) -> dict:
    """A converted backbone tree (``convert_resnet_backbone``'s, or its
    .npz) over full PoseResNet variables; the head keeps its values."""
    out = dict(variables)
    out["params"] = overlay_variables(
        variables["params"], {"backbone": conv["params"]["backbone"]})
    out["batch_stats"] = overlay_variables(
        variables.get("batch_stats", {}),
        {"backbone": conv["batch_stats"]["backbone"]})
    return out


def _load_backbone(model: nn.Module, sd: Dict[str, np.ndarray]) -> nn.Module:
    """Copy ``sd``'s tensors into ``model`` (in place). Every key must
    name a backbone tensor of the model (conv1, bn1, layerL.B.*) and every
    backbone weight and statistic must be given (a missing
    ``num_batches_tracked`` keeps the model's); the head is not touched."""
    own = model.state_dict()
    backbone = {k for k in own if k.startswith(("conv1.", "bn1.", "layer"))}
    unknown = sorted(set(sd) - backbone)
    missing = sorted(k for k in backbone - set(sd)
                     if not k.endswith("num_batches_tracked"))
    if unknown or missing:
        raise KeyError(f"backbone: unknown {unknown}, missing {missing}")
    with torch.no_grad():
        for k, v in sd.items():
            own[k].copy_(torch.as_tensor(np.asarray(v)))
    return model


def init_backbone_from_imagenet(target, sd):
    """ImageNet weights (a torchvision-named ResNet state dict; ``fc.*``
    ignored) over a fresh PoseResNet; the head keeps its init. ``target``:
    the port's module, loaded in place and returned, or the reference's
    variable tree, returned overlaid as the reference's function does."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()
          if not k.removeprefix("module.").startswith("fc.")}
    if isinstance(target, nn.Module):
        return _load_backbone(target, state_dict_to_numpy(sd))
    return overlay_backbone(target, convert_resnet_backbone(sd))


def load_backbone_tree(model: nn.Module, conv: dict) -> nn.Module:
    """A converted backbone tree (``convert_resnet_backbone``'s, as
    ``tools/export_weights.py --kind backbone_imagenet`` writes it) ->
    ``model``'s backbone (in place); the head keeps its init."""
    sd = _reverse_backbone(conv)
    return _load_backbone(model, {k: v for k, v in sd.items()
                                  if not k.endswith("num_batches_tracked")})


def _stats_like(params: dict) -> dict:
    """A zero batch_stats tree for a params tree: each batch-norm node
    ({scale, bias}) gets {mean, var}."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            if set(v) == {"scale", "bias"}:
                z = np.zeros_like(np.asarray(v["scale"]))
                out[k] = {"mean": z, "var": z}
            else:
                out[k] = _stats_like(v)
    return out


def named_parameters_from_tree(module: nn.Module, params: dict,
                               reverse=reverse_pose_resnet) -> Dict[str, np.ndarray]:
    """A tree shaped like the reference's ``params`` (gradients, optimizer
    moments) -> {name: array} over ``module.named_parameters()``, through
    ``reverse`` (``reverse_pose_resnet``, ``reverse_flownet`` or
    ``reverse_flownet2``). A parameter the tree lacks raises KeyError."""
    sd = reverse({"params": params, "batch_stats": _stats_like(params)})
    return {name: np.asarray(sd[name]) for name, _ in module.named_parameters()}
