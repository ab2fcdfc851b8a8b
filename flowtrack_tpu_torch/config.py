"""The port's configuration: constants, dataclasses and presets.

Port of ``flowtrack_tpu/config.py``, so that the port and its smoke import
nothing of the reference package. The model, flow, train, test, track and
data sections and the mesh section (the multi-device layout,
``parallel/mesh.py``) keep the reference's field names and defaults one
for one (``tests/test_torch_isolation.py`` pins that), so a reference
config and a port config drive ``ClipTracker`` and the train steps alike.
The CLIs' dotted overrides (``apply_overrides``) and ``experiments/*.yaml``
(``load_yaml``, which reads the subset of YAML those files use without
PyYAML) are ported too. The flow section's ``use_pallas_corr``,
``use_pallas_warp`` and ``pallas_warp_impl`` choose TPU kernels in the
reference and have no effect here (``models/flownet.get_flow_net``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field, replace
from typing import Any, Tuple

COCO_NUM_JOINTS = 17
COCO_FLIP_PAIRS: Tuple[Tuple[int, int], ...] = (
    (1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16),
)
# OKS per-keypoint falloff constants (sigmas), from pycocotools cocoeval
COCO_SIGMAS: Tuple[float, ...] = (
    0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
    0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
)
MPII_NUM_JOINTS = 16
MPII_FLIP_PAIRS: Tuple[Tuple[int, int], ...] = (
    (0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13),
)

PIXEL_STD = 200.0  # box scale is expressed in units of 200 px

# ImageNet normalization: (x / 255 - mean) / std
IMAGENET_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class ModelConfig:
    """PoseResNet architecture."""

    num_layers: int = 50                      # 18 | 34 | 50 | 101 | 152
    num_joints: int = COCO_NUM_JOINTS
    image_size: Tuple[int, int] = (256, 192)  # (H, W)
    heatmap_size: Tuple[int, int] = (64, 48)  # input / 4
    num_deconv_layers: int = 3
    num_deconv_filters: Tuple[int, ...] = (256, 256, 256)
    num_deconv_kernels: Tuple[int, ...] = (4, 4, 4)
    final_conv_kernel: int = 1
    deconv_with_bias: bool = False
    sigma: float = 2.0                        # GT gaussian sigma
    dtype: str = "bfloat16"                   # compute dtype
    remat: bool = False                       # recompute each residual
                                              # block in the backward


@dataclass(frozen=True)
class FlowConfig:
    """FlowNet variant and its settings."""

    variant: str = "flownet_s"   # flownet_s | flownet_c | flownet_sd |
                                 # flownet2 | flownet2_cs | flownet2_css
    div_flow: float = 20.0       # the net predicts flow / 20
    rgb_max: float = 255.0
    batch_norm: bool = False
    # FlowNetC correlation: max displacement 20, stride2 2 -> 441 channels
    corr_max_displacement: int = 20
    corr_stride2: int = 2
    use_pallas_corr: bool = False
    use_pallas_warp: bool = False
    pallas_warp_impl: str = "shift"
    dtype: str = "bfloat16"
    # FlowNet2 cascade inter-stage tensor dtype (upsampled flows, warped
    # frames, brightness errors)
    glue_dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    lr: float = 1e-3
    lr_factor: float = 0.1
    lr_steps: Tuple[int, ...] = (90, 120)
    end_epoch: int = 140
    optimizer: str = "adam"
    # augmentation (the lineage's COCODataset defaults)
    flip_prob: float = 0.5
    rot_factor: float = 40.0
    scale_factor: float = 0.3
    use_target_weight: bool = True
    checkpoint_dir: str = "output/checkpoints"
    print_freq: int = 100
    seed: int = 0
    shuffle: bool = True


@dataclass(frozen=True)
class TestConfig:
    batch_size: int = 64
    flip_test: bool = True
    shift_heatmap: bool = True     # 1-px right shift of flipped heatmaps
    post_process: bool = True      # quarter-pixel offset decode
    blur_kernel: int = 0           # optional gaussian blur before decode
    oks_thre: float = 0.9          # OKS-NMS threshold
    in_vis_thre: float = 0.2       # keypoint visibility threshold
    nms_thre: float = 1.0          # bbox NMS threshold over det+prop boxes
    image_thre: float = 0.0        # detection box score threshold
    use_gt_bbox: bool = False
    soft_nms: bool = False
    bbox_file: str = ""            # precomputed person detections json


@dataclass(frozen=True)
class TrackConfig:
    """The video pipeline's tracking settings."""

    track_oks_thre: float = 0.5    # greedy matching similarity threshold
    box_nms_thre: float = 0.5      # unified det+propagated box suppression
    box_expand: float = 0.15       # propagated-box expansion
    max_persons: int = 32          # static pad for ragged persons-per-frame
    pose_score_thre: float = 0.3   # drop low-score candidates before matching
    keyframe_interval: int = 1     # run the detector every k frames
    clip_recover: bool = True      # flow-propagated recovery of missed people
    max_recovered: int = 4         # per-frame recovery candidate slots
    recover_budget: float = 1.0    # average recovered pose crops per frame
    max_miss_age: int = 3          # consecutive detector misses a track may
                                   # bridge with propagated boxes
    pose_chunk: int = 0            # crops per pose-net call (0 = one call)
    flow_chunk: int = 0            # pairs per flow-net call (0 = one call)


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "coco"          # coco | posetrack | mpii
    root: str = "data/coco"
    train_set: str = "train2017"
    test_set: str = "val2017"
    data_format: str = "jpg"


@dataclass(frozen=True)
class MeshConfig:
    """The multi-device layout: a 1-D mesh of ``num_devices`` devices (0:
    every CUDA device, or the one device an entry point was given) whose
    axis is named ``data_axis``."""

    data_axis: str = "data"
    num_devices: int = 0           # 0 = use all available


@dataclass(frozen=True)
class Config:
    name: str = "coco_res50_256x192"
    model: ModelConfig = field(default_factory=ModelConfig)
    flow: FlowConfig = field(default_factory=FlowConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    test: TestConfig = field(default_factory=TestConfig)
    track: TrackConfig = field(default_factory=TrackConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


def _nested_replace(obj: Any, dotted: str, value: Any) -> Any:
    head, _, rest = dotted.partition(".")
    if not rest:
        cur = getattr(obj, head)
        if cur is not None and not isinstance(value, type(cur)):
            if isinstance(cur, bool):
                value = str(value).lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                value = int(value)
            elif isinstance(cur, float):
                value = float(value)
            elif isinstance(cur, tuple):
                value = tuple(type(cur[0])(v) for v in str(value).split(","))
        return replace(obj, **{head: value})
    return replace(obj, **{head: _nested_replace(getattr(obj, head), rest,
                                                 value)})


def apply_overrides(cfg: Config, overrides) -> Config:
    """Apply dotted overrides: ['test.flip_test=false',
    'model.num_layers=152']."""
    for item in overrides or ():
        key, _, val = item.partition("=")
        cfg = _nested_replace(cfg, key.strip().lower(), val.strip())
    return cfg


def _res(num_layers: int, image_size, heatmap_size, sigma, name,
         num_joints: int = COCO_NUM_JOINTS,
         data: DataConfig = DataConfig()) -> Config:
    return Config(name=name, model=ModelConfig(
        num_layers=num_layers, image_size=image_size,
        heatmap_size=heatmap_size, sigma=sigma, num_joints=num_joints),
        data=data)


# the reference's presets
PRESETS = {
    "coco_res50_256x192": _res(50, (256, 192), (64, 48), 2.0, "coco_res50_256x192"),
    "coco_res50_384x288": _res(50, (384, 288), (96, 72), 3.0, "coco_res50_384x288"),
    "coco_res101_256x192": _res(101, (256, 192), (64, 48), 2.0, "coco_res101_256x192"),
    "coco_res101_384x288": _res(101, (384, 288), (96, 72), 3.0, "coco_res101_384x288"),
    "coco_res152_256x192": _res(152, (256, 192), (64, 48), 2.0, "coco_res152_256x192"),
    "coco_res152_384x288": _res(152, (384, 288), (96, 72), 3.0, "coco_res152_384x288"),
    "mpii_res50_256x256": _res(50, (256, 256), (64, 64), 2.0, "mpii_res50_256x256",
                               MPII_NUM_JOINTS,
                               DataConfig(dataset="mpii", root="data/mpii")),
    "flownet_s": Config(name="flownet_s", flow=FlowConfig(variant="flownet_s")),
    "flownet_c": Config(name="flownet_c", flow=FlowConfig(variant="flownet_c")),
    # PoseTrack's sets are "train" / "val" (annotations/<set>.json)
    "flowtrack_posetrack": _res(152, (256, 192), (64, 48), 2.0,
                                "flowtrack_posetrack", data=DataConfig(
                                    dataset="posetrack", root="data/posetrack",
                                    train_set="train", test_set="val")),
}


# YAML 1.1's float as PyYAML resolves it: a dot, and a signed exponent
_FLOAT = re.compile(r"[-+]?(\d+\.\d*|\.\d+)([eE][-+]\d+)?")


def _yaml_scalar(text: str):
    """A plain or quoted YAML scalar as PyYAML's safe loader reads it, for
    the kinds the experiment files hold: bool, int, float, null, string."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    low = text.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "~", ""):
        return None
    if re.fullmatch(r"[-+]?\d+", text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    return text


def _yaml_flow_list(text: str):
    """A flow sequence ``[a, [b, c]]`` -> nested lists of scalars."""
    stack = [[]]
    token = ""
    for ch in text.strip():
        if ch == "[":
            stack.append([])
        elif ch in ",]":
            if token.strip():
                stack[-1].append(_yaml_scalar(token))
            token = ""
            if ch == "]":
                done = stack.pop()
                stack[-1].append(done)
        else:
            token += ch
    if len(stack) != 1 or len(stack[0]) != 1 or token.strip():
        raise ValueError(f"unsupported YAML sequence {text!r}")
    return stack[0][0]


def parse_yaml(text: str) -> dict:
    """The YAML subset of ``experiments/*.yaml``: ``#`` comments, top-level
    keys holding a scalar or one level of indented ``key: value`` pairs,
    plain or quoted scalars and flow sequences (``[256, 192]``)."""
    out: dict = {}
    section = None
    for n, raw in enumerate(text.splitlines(), 1):
        line = re.sub(r"(^|\s)#.*$", "", raw).rstrip()
        if not line.strip():
            continue
        key, sep, value = line.strip().partition(":")
        if not sep or not key:
            raise ValueError(f"line {n}: expected 'key: value', got {raw!r}")
        value = value.strip()
        parsed = (_yaml_flow_list(value) if value.startswith("[")
                  else _yaml_scalar(value))
        if line[0] in " \t":
            if section is None:
                raise ValueError(f"line {n}: indented key outside a section")
            out[section][key] = parsed
        elif value:
            out[key] = parsed
            section = None
        else:
            out[key] = {}
            section = key
    return out


def load_yaml(path: str) -> Config:
    """An experiment file as a Config: each section's keys replace the
    defaults' (lists become tuples), ``name`` the name."""
    with open(path) as f:
        raw = parse_yaml(f.read())
    cfg = Config()
    for section, values in raw.items():
        section = section.lower()
        if section == "name":
            cfg = replace(cfg, name=values)
            continue
        sub = getattr(cfg, section)
        kw = {}
        for k, v in values.items():
            if isinstance(v, list):
                v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
            kw[k.lower()] = v
        cfg = replace(cfg, **{section: replace(sub, **kw)})
    return cfg


def get_config(name: str) -> Config:
    if name in PRESETS:
        return PRESETS[name]
    if name.endswith((".yaml", ".yml")):
        return load_yaml(name)
    raise KeyError(f"unknown config {name!r}; presets: {sorted(PRESETS)}")
