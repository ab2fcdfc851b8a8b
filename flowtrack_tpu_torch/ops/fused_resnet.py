"""BN-folded fused ResNet bottleneck stages (kernel K5) and the fused pose net.

Port of ``flowtrack_tpu/ops/fused_resnet.py``: the matmul layouts
``_as_matmul`` / ``block_from_folded`` / ``stage_blocks_from_folded``
(fused_resnet.py:86-126), the plain twin of ``_block_ref`` /
``fused_stage_ref`` (:134-176), ``_block_conv_xla`` (:185), and in place of
the TPU kernel ``_stage_kernel`` (:223) the CUDA kernels in
``csrc/fused_stage.cu`` (wgmma; its source note gives the design and the
bounds).
``FusedPoseResNet`` is the counterpart of ``FusedPoseAdapter`` (:404) and
``fuse_pose_model`` of :466.

Inference only. Per block (stride 1), on NHWC bfloat16 activations with
bfloat16 weights: conv1 (1x1) -> conv2 (3x3, pad 1) -> conv3 (1x1), each a
product summed in float32 plus the folded float32 bias; ReLU and one
rounding to bfloat16 after conv1 and conv2; conv3 joins the residual in
float32, ``relu((acc3 + b3) + res)``, where ``res`` is the block input
upcast or the projection ``acc_d + b_d``, then rounds to bfloat16.

A stage's striding first block runs through ``block_conv``, the library
convolutions, as the reference runs it through XLA's: each conv rounds its
bfloat16 output before the float32 bias is added, which is not the twin's
rounding (the reference's twin keeps the float32 sum plus the bias). The
port follows the reference's Pallas route, which is the one its path runs.

Dispatch (``fused_stage``): the stride-1 blocks of a CUDA tensor go to the
kernels, of a CPU tensor to ``fused_stage_plain``; the wrapper raises on
anything the kernels do not take. On the card each block takes one of two
forms by its shape alone (``block_form``): ``block``, the whole block in one
launch with y1 and y2 kept on chip (F = 64, or F = 128 without projection,
where whole image rows make a tile of 64, 128 or 192 pixels); ``wgmma``, one
launch per conv on the wgmma main loop (every other block: the 3x3's tile
is image rows or whole images of at most 192 pixels, so any image up to 192
pixels wide runs here).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from flowtrack_tpu_torch import kernels
from flowtrack_tpu_torch.config import ModelConfig
from flowtrack_tpu_torch.models.pose_resnet import RESNET_SPECS
from flowtrack_tpu_torch.models.quantize import fold_pose_resnet
from flowtrack_tpu_torch.utils.convert import fused_state_dict

_BF16 = torch.bfloat16
_BLOCK_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")
_PROJ_KEYS = ("wd", "bd")


# ---------------------------------------------------------------------------
# Parameter layouts (the reference's, so its trees load unchanged)
# ---------------------------------------------------------------------------


def _as_matmul(kernel):
    """(1, 1, Cin, Cout) -> (Cin, Cout); (3, 3, F, F) -> (3, 3F, F), the
    column taps flattened into K, row-tap-major."""
    k = torch.as_tensor(kernel)
    if k.shape[0] == 1:
        return k.reshape(k.shape[2], k.shape[3])
    kh, kw, cin, cout = k.shape
    return k.reshape(kh, kw * cin, cout)


def block_from_folded(node: dict) -> dict:
    """One folded block's {conv1/conv2/conv3[/downsample_conv]: {kernel,
    bias}} -> {w1, b1, w2, b2, w3, b3[, wd, bd]}: weights bfloat16 in the
    matmul layouts, biases (1, C) float32."""
    names = [("conv1", "w1", "b1"), ("conv2", "w2", "b2"),
             ("conv3", "w3", "b3")]
    if "downsample_conv" in node:
        names.append(("downsample_conv", "wd", "bd"))
    blk = {}
    for conv, wk, bk in names:
        blk[wk] = _as_matmul(node[conv]["kernel"]).to(_BF16)
        blk[bk] = torch.as_tensor(node[conv]["bias"],
                                  dtype=torch.float32).reshape(1, -1)
    return blk


def stage_blocks_from_folded(folded: dict, num_layers: int):
    """models/quantize.fold_pose_resnet's tree -> one list of block dicts
    per stage."""
    _, stage_sizes = RESNET_SPECS[num_layers]
    return [[block_from_folded(folded[f"layer{si + 1}_{bi}"])
             for bi in range(nblocks)]
            for si, nblocks in enumerate(stage_sizes)]


# ---------------------------------------------------------------------------
# Plain version (the reference's twin) and the library-conv block
# ---------------------------------------------------------------------------


def _mm(a, w):
    """bfloat16 (M, K) @ bfloat16 (K, N) summed in float32: the products of
    two bfloat16 values are exact in float32."""
    return a.float() @ w.float()


def _relu_bf16(y):
    return torch.relu(y).to(_BF16)


def fused_block_plain(x, blk: dict, stride: int):
    """One folded bottleneck block, the matmul decomposition of
    ``_block_ref``: x (B, H, W, Cin) bfloat16 -> (B, Ho, Wo, 4F) bfloat16.
    Ho, Wo are the convolution's ceil(H / stride), ceil(W / stride)."""
    b, h, w, cin = x.shape
    f = blk["w1"].shape[1]
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1

    y = _relu_bf16(_mm(x.reshape(-1, cin), blk["w1"]) + blk["b1"])
    yp = F.pad(y.reshape(b, h, w, f), (0, 0, 1, 1, 1, 1))
    acc = None
    for a in range(3):
        for c in range(3):
            tap = yp[:, a:a + (ho - 1) * stride + 1:stride,
                     c:c + (wo - 1) * stride + 1:stride]
            t = _mm(tap.reshape(-1, f), blk["w2"][a, c * f:(c + 1) * f])
            acc = t if acc is None else acc + t
    y = _relu_bf16(acc + blk["b2"])

    y = _mm(y, blk["w3"]) + blk["b3"]
    if "wd" in blk:
        xs = x[:, ::stride, ::stride]
        res = _mm(xs.reshape(-1, cin), blk["wd"]) + blk["bd"]
    else:
        res = x.reshape(-1, cin).float()
    return _relu_bf16(y + res).reshape(b, ho, wo, -1)


def fused_stage_plain(x, blocks: Sequence[dict], stride: int):
    """Plain version of a fused stage (``fused_stage_ref``)."""
    for i, blk in enumerate(blocks):
        x = fused_block_plain(x, blk, stride if i == 0 else 1)
    return x


def _conv(x, w_hwio, stride: int, pad: int):
    """Library convolution, NHWC bfloat16 in and out (cuDNN on the card):
    float32 sums rounded once to bfloat16, as XLA's bfloat16 conv."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def block_conv(x, blk: dict, stride: int):
    """One folded block through library convolutions (``_block_conv_xla``),
    the route of a stage's striding first block: every conv's bfloat16
    output is rounded before its float32 bias joins."""
    cin, f = blk["w1"].shape
    y = _relu_bf16(_conv(x, blk["w1"].reshape(1, 1, cin, f), 1, 0)
                   + blk["b1"][0])
    y = _relu_bf16(_conv(y, blk["w2"].reshape(3, 3, f, f), stride, 1)
                   + blk["b2"][0])
    y = _conv(y, blk["w3"].reshape(1, 1, f, -1), 1, 0) + blk["b3"][0]
    if "wd" in blk:
        res = _conv(x, blk["wd"].reshape(1, 1, cin, -1), stride, 0) \
            + blk["bd"][0]
    else:
        res = x
    return _relu_bf16(y + res).contiguous()


# ---------------------------------------------------------------------------
# The kernel's wrapper and the dispatch
# ---------------------------------------------------------------------------


def _check_tensors(named: dict, shapes: dict, device) -> None:
    """Weights (keys starting with w) contiguous bfloat16, biases float32,
    all on ``device`` and of the given shapes."""
    for k, v in named.items():
        dtype = _BF16 if k[0] == "w" else torch.float32
        if v.device != device or v.dtype != dtype or not v.is_contiguous():
            raise TypeError(f"{k} must be a contiguous {dtype} tensor on "
                            f"{device}, got {v.dtype} on {v.device}")
        if tuple(v.shape) != shapes[k]:
            raise ValueError(f"{k} must be {shapes[k]}, got {tuple(v.shape)}")


def _check_widths(cin: int, f: int, cout: int, proj: bool) -> None:
    if not proj and cout != cin:
        raise ValueError(f"a block without projection keeps its width, got "
                         f"{cin} -> {cout}")
    if cin % 64 or f % 64:
        raise ValueError(f"the kernel takes channel counts that are "
                         f"multiples of 64, got Cin {cin}, F {f}")


def _check_block(blk: dict, cin: int, device) -> None:
    keys = _BLOCK_KEYS + (_PROJ_KEYS if "wd" in blk else ())
    if set(blk) != set(keys):
        raise ValueError(f"a block holds {keys}, got {sorted(blk)}")
    f = blk["w1"].shape[1]
    cout = blk["w3"].shape[1]
    _check_tensors(blk, {"w1": (cin, f), "b1": (1, f), "w2": (3, 3 * f, f),
                         "b2": (1, f), "w3": (f, cout), "b3": (1, cout),
                         "wd": (cin, cout), "bd": (1, cout)}, device)
    _check_widths(cin, f, cout, "wd" in blk)


def transposed_weights(blk: dict) -> dict:
    """A block's weights as the wgmma kernels read them, (N, K) row-major
    with K contiguous: w1t (F, Cin), w2t (F, 9F) over K = (row tap, column
    tap, channel), w3t (4F, F) and, with a projection, wdt (4F, Cin)."""
    f = blk["w1"].shape[1]
    out = {"w1t": blk["w1"].t().contiguous(),
           "w2t": blk["w2"].reshape(9 * f, f).t().contiguous(),
           "w3t": blk["w3"].t().contiguous()}
    if "wd" in blk:
        out["wdt"] = blk["wd"].t().contiguous()
    return out


class CheckedBlocks(tuple):
    """A chain of block dicts checked once for the kernels: the keys, each
    tensor's dtype, shape, contiguity and device (the first weight's), and
    each block's input width the previous block's output width. It also
    keeps each block's ``transposed_weights``, made at the block's first
    launch on wgmma. A slice stays checked and shares them.
    ``fused_stage_cuda`` checks any other sequence of blocks on every call,
    and of a CheckedBlocks only the input's width and device."""

    def __new__(cls, blocks):
        blocks = tuple(blocks)
        if blocks:
            device, cin = blocks[0]["w1"].device, blocks[0]["w1"].shape[0]
            for blk in blocks:
                _check_block(blk, cin, device)
                cin = blk["w3"].shape[1]
        self = super().__new__(cls, blocks)
        self._transposed = [{} for _ in blocks]
        return self

    def __getitem__(self, i):
        got = super().__getitem__(i)
        if not isinstance(i, slice):
            return got
        new = tuple.__new__(CheckedBlocks, got)
        new._transposed = self._transposed[i]
        return new

    def transposed(self, i: int) -> dict:
        """Block i's ``transposed_weights``, made once."""
        t = self._transposed[i]
        if not t:
            t.update(transposed_weights(self[i]))
        return t


# ---------------------------------------------------------------------------
# Which form a block takes on the card (plain arithmetic on its shape)
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232448        # bytes of shared memory one block may use on sm_90
TILE_PIXELS = (192, 128, 64)   # pixels of a wgmma tile: 3, 2 or 1 m64 slices
_A_STAGE = 192 * 64 * 2    # a ring stage's activations: 192 pixels x 64 K


class BlockForm(NamedTuple):
    """How one stride-1 block runs on the card: ``kind`` "block" or "wgmma";
    the tile of its 3x3 (``rows`` image rows of one image, or ``images``
    whole images); its launches."""
    kind: str
    rows: int
    images: int
    launches: int


def row_tiling(h: int, w: int):
    """Image rows per tile so that a tile is ``rows`` whole rows of one
    image and 192, 128 or 64 pixels (the most that fits), or None."""
    for pixels in TILE_PIXELS:
        rows = pixels // w
        if rows * w == pixels and 0 < rows <= h and h % rows == 0:
            return rows
    return None


def conv_tiling(h: int, w: int):
    """The 3x3 conv's TMA box on wgmma: (rows, images) with ``rows`` image
    rows of one image (images == 1, rows divides h) or ``images`` whole
    images (rows == h), whichever holds the most pixels within a tile's 192
    (rows of one image where both hold as many); None for an image over 192
    pixels wide."""
    if w > TILE_PIXELS[0]:
        return None
    rows = max(r for r in range(1, h + 1)
               if h % r == 0 and r * w <= TILE_PIXELS[0])
    images = TILE_PIXELS[0] // (h * w)
    if images * h > rows:
        return h, images
    return rows, 1


def block_stages(f: int) -> int:
    """Ring stages of the whole-block kernel: what fits beside y1."""
    return 5 if f == 64 else 4


def block_smem_bytes(f: int, rows: int, w: int) -> int:
    """Shared memory of the whole-block kernel: the ring (``block_stages``
    stages, each 192 pixels of x and F rows of weights, 64 K wide), y1 over
    the tile and its two halo rows with one row of zeros (rows of 2F + 16
    bytes), barriers, and 1024 bytes to align."""
    stages = block_stages(f)
    return (1024 + stages * (_A_STAGE + f * 128)
            + ((rows + 2) * w + 1) * (2 * f + 16) + 16 * stages)


def conv_smem_bytes(bn: int) -> int:
    """Shared memory of the per-conv wgmma kernel at an output tile BN wide:
    4 stages, the 192 x BN bfloat16 output tile, barriers, and 1024 bytes to
    align."""
    return (1024 + 4 * (_A_STAGE + bn * 128) + (bn // 64) * _A_STAGE
            + 16 * 4 + 16)


def block_form(h: int, w: int, f: int, projection: bool) -> BlockForm:
    """The form of a stride-1 block over (h, w) images, by its shape alone."""
    rows = row_tiling(h, w)
    if (rows is not None and (f == 64 or (f == 128 and not projection))
            and block_smem_bytes(f, rows, w) <= SMEM_LIMIT):
        return BlockForm("block", rows, 1, 1)
    tiling = conv_tiling(h, w)
    if tiling is None:
        raise ValueError(f"the kernels tile images at most {TILE_PIXELS[0]} "
                         f"pixels wide, got {h} x {w}")
    return BlockForm("wgmma", *tiling, 3)


def stage_launches(h: int, w: int, blocks: Sequence[dict]) -> int:
    """K5 launches of a chain of stride-1 blocks over (h, w) images."""
    return sum(block_form(h, w, blk["w1"].shape[1], "wd" in blk).launches
               for blk in blocks)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launched(err: int) -> None:
    kernels.check(err, "fused_stage")
    fused_stage_cuda.launches += 1


_PARAM_KEYS = ("w1t", "b1", "w2t", "b2", "w3t", "b3")


def stage_params(blocks: Sequence[dict]):
    """A chain's tensors as the op ``flowtrack::fused_stage`` takes them:
    per block its transposed weights and its biases, (w1t, b1, w2t, b2,
    w3t, b3[, wdt, bd]), in one list, and whether each block has a
    projection. A ``CheckedBlocks`` gives the transposes it keeps; other
    blocks are transposed here, unchecked (the op's card route checks)."""
    params, projection = [], []
    for i, blk in enumerate(blocks):
        wt = (blocks.transposed(i) if isinstance(blocks, CheckedBlocks)
              else transposed_weights(blk))
        params += [wt["w1t"], blk["b1"], wt["w2t"], blk["b2"], wt["w3t"],
                   blk["b3"]]
        if "wd" in blk:
            params += [wt["wdt"], blk["bd"]]
        projection.append("wd" in blk)
    return params, projection


def _unpack_params(x, params, projection) -> list:
    """``stage_params``' list -> one dict of the kernel's tensors a block,
    each checked against the chain's widths and ``x``'s device."""
    blocks, i, cin = [], 0, x.shape[-1]
    for proj in projection:
        keys = _PARAM_KEYS + (("wdt", "bd") if proj else ())
        if i + len(keys) > len(params):
            raise ValueError(f"{len(params)} tensors for the blocks "
                             f"{projection}")
        p = dict(zip(keys, params[i:i + len(keys)]))
        i += len(keys)
        f, cout = p["w1t"].shape[0], p["w3t"].shape[0]
        _check_tensors(p, {"w1t": (f, cin), "b1": (1, f), "w2t": (f, 9 * f),
                           "b2": (1, f), "w3t": (cout, f), "b3": (1, cout),
                           "wdt": (cout, cin), "bd": (1, cout)}, x.device)
        _check_widths(cin, f, cout, proj)
        blocks.append(p)
        cin = cout
    if i != len(params):
        raise ValueError(f"{len(params)} tensors for the blocks {projection}")
    return blocks


def _plain_blocks(params, projection) -> list:
    """``stage_params``' list -> the block dicts of the plain version, the
    transposes undone into contiguous weights (exact: the same tensors)."""
    def back(wt):
        return wt.t().contiguous()

    blocks, i = [], 0
    for proj in projection:
        w1t, b1, w2t, b2, w3t, b3 = params[i:i + 6]
        f = w1t.shape[0]
        blk = {"w1": back(w1t), "b1": b1,
               "w2": back(w2t).reshape(3, 3 * f, f), "b2": b2,
               "w3": back(w3t), "b3": b3}
        i += 6
        if proj:
            blk.update(wd=back(params[i]), bd=params[i + 1])
            i += 2
        blocks.append(blk)
    return blocks


def _block_per_conv(lib, stream, x, p, form, out):
    """One block as three wgmma launches (``p``: the block's tensors as
    ``_unpack_params`` gives them)."""
    b, h, w, cin = x.shape
    m = b * h * w
    f, cout = p["w1t"].shape[0], p["w3t"].shape[0]
    proj = "wdt" in p
    y1 = torch.empty((m, f), dtype=_BF16, device=x.device)
    y2 = torch.empty((m, f), dtype=_BF16, device=x.device)
    res = None if proj else x
    conv = lib.ft_fused_conv_wgmma
    tile = (form.rows, form.images)
    a2, bd, k2 = (x, p["bd"], cin) if proj else (None, None, 0)
    _launched(conv(_ptr(x), _ptr(p["w1t"]), _ptr(p["b1"]), None, None, None,
                   None, _ptr(y1), m, f, cin, cin, 0, h, w, 1, *tile, stream))
    _launched(conv(_ptr(y1), _ptr(p["w2t"]), _ptr(p["b2"]), None, None, None,
                   None, _ptr(y2), m, f, 9 * f, f, 0, h, w, 9, *tile, stream))
    _launched(conv(_ptr(y2), _ptr(p["w3t"]), _ptr(p["b3"]), _ptr(res),
                   _ptr(a2), _ptr(p.get("wdt")), _ptr(bd), _ptr(out), m,
                   cout, f, f, k2, h, w, 1, *tile, stream))


def _check_input(x) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_stage kernel needs CUDA tensors, got "
                           f"{x.device}")
    if x.dim() != 4 or x.dtype != _BF16 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, H, W, C) bfloat16 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError("x is empty")


def _launch_stage(x, blocks: list):
    """Launch K5 over ``_unpack_params``' blocks, each in the form
    ``block_form`` gives its shape, with x's card current: the launches,
    their stream and the kernels' per-device shared-memory attribute are
    that card's whichever device the caller made current."""
    with torch.cuda.device(x.device):
        return _launch_blocks(x, blocks)


def _launch_blocks(x, blocks: list):
    b, h, w, _ = x.shape
    m = b * h * w
    lib = kernels.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for p in blocks:
        cin = x.shape[-1]
        f, cout = p["w1t"].shape[0], p["w3t"].shape[0]
        form = block_form(h, w, f, "wdt" in p)
        out = torch.empty((b, h, w, cout), dtype=_BF16, device=x.device)
        if form.kind == "block":
            _launched(lib.ft_fused_block(
                _ptr(x), _ptr(p["w1t"]), _ptr(p["b1"]), _ptr(p["w2t"]),
                _ptr(p["b2"]), _ptr(p["w3t"]), _ptr(p["b3"]),
                _ptr(p.get("wdt")), _ptr(p.get("bd")), _ptr(out), m, cin,
                f, h, w, form.rows, stream))
        else:
            _block_per_conv(lib, stream, x, p, form, out)
        x = out
    return x


def fused_stage_cuda(x, blocks: Sequence[dict]):
    """Launch K5 over a chain of stride-1 blocks: x (B, H, W, Cin) bfloat16
    contiguous on a CUDA device -> (B, H, W, Cout) bfloat16. Each block runs
    in the form ``block_form`` gives its shape: one launch for the whole
    block, or one per conv (conv1, the implicit 3x3 GEMM, conv3 with the
    residual or the projection in its epilogue). ``blocks``: block dicts,
    checked (and their weights transposed for wgmma) on each call, or a
    ``CheckedBlocks``, which does both once; every tensor is held to
    ``x``'s width and device before any launch (``_unpack_params``)."""
    _check_input(x)
    if not isinstance(blocks, CheckedBlocks):
        blocks = CheckedBlocks(blocks)
    params, projection = stage_params(blocks)
    return _launch_stage(x, _unpack_params(x, params, projection))


fused_stage_cuda.launches = 0


@torch.library.custom_op("flowtrack::fused_stage", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _fused_stage_op(x: torch.Tensor, params: Sequence[torch.Tensor],
                    projection: Sequence[bool]) -> torch.Tensor:
    if x.device.type == "cpu":
        return fused_stage_plain(x, _plain_blocks(params, projection), 1)
    _check_input(x)
    return _launch_stage(x, _unpack_params(x, params, projection))


@_fused_stage_op.register_fake
def _(x, params, projection):
    cout = params[-2].shape[0] if projection else x.shape[-1]
    return x.new_empty((*x.shape[:3], cout))


def fused_stage(x, blocks: Sequence[dict], stride: int):
    """Public entry (``fused_stage_pallas``): a striding first block through
    ``block_conv``, the stride-1 blocks through the op
    ``flowtrack::fused_stage``: the kernel (CUDA tensor) or the plain
    version (CPU tensor). x (B, H, W, Cin) bfloat16."""
    rest = blocks
    if stride != 1:
        x = block_conv(x, blocks[0], stride)
        rest = blocks[1:]
    if not rest:
        return x
    return _fused_stage_op(x.contiguous(), *stage_params(rest))


# ---------------------------------------------------------------------------
# The fused pose net
# ---------------------------------------------------------------------------


def prepare_fused_variables(folded: dict, num_layers: int) -> dict:
    """models/quantize.fold_pose_resnet's tree -> the fused inference tree
    of the reference's ``prepare_fused_variables``: {stem, stages, head,
    final}, kernels bfloat16 in the reference's layouts, biases float32."""

    def node(kernel, bias):
        return {"kernel": torch.as_tensor(kernel).to(_BF16),
                "bias": torch.as_tensor(bias, dtype=torch.float32)}

    head = {name: node(**folded[name])
            for name in (f"deconv{i}" for i in range(3)) if name in folded}
    return {"stem": node(**folded["conv1"]),
            "stages": stage_blocks_from_folded(folded, num_layers),
            "head": head,
            "final": node(folded["final_kernel"], folded["final_bias"])}


class _Buffers(nn.Module):
    """Named tensors as buffers (moved by ``.to``, in the state dict)."""

    def __init__(self, device, **shapes):
        super().__init__()
        for name, (shape, dtype) in shapes.items():
            self.register_buffer(name, torch.zeros(shape, dtype=dtype,
                                                   device=device))

    def tensors(self) -> dict:
        return dict(self.named_buffers())


def _conv_node(kernel_shape, cout, device):
    return _Buffers(device, kernel=(kernel_shape, _BF16),
                    bias=((cout,), torch.float32))


def _block_node(cin, f, proj, device):
    shapes = {"w1": (cin, f), "b1": (1, f), "w2": (3, 3 * f, f),
              "b2": (1, f), "w3": (f, 4 * f), "b3": (1, 4 * f)}
    if proj:
        shapes.update(wd=(cin, 4 * f), bd=(1, 4 * f))
    return _Buffers(device, **{k: (v, _BF16 if k[0] == "w" else torch.float32)
                               for k, v in shapes.items()})


def _bias_relu(y, bias):
    """NCHW bfloat16 + float32 bias, ReLU, round to bfloat16."""
    return torch.relu(y.float() + bias.view(1, -1, 1, 1)).to(_BF16)


class FusedPoseResNet(nn.Module):
    """PoseResNet inference with BN folded and the backbone stages fused.
    ``forward``: (M, 3, h, w) crops -> (M, K, h/4, w/4) float32 heatmaps, a
    drop-in pose model for ``ClipTracker``. Inside: the folded stem conv
    (bfloat16 out, + bias, ReLU, bfloat16) and max pool, the four stages
    through ``fused_stage`` in NHWC, the folded deconv head (bfloat16 out, +
    bias, ReLU) and the final conv in bfloat16, + bias in float32.

    Bottleneck depths only (50/101/152). The folded tensors are buffers,
    zero until a state is loaded (``fuse_pose_model``,
    ``utils.convert.load_fused_pose``). Crops are independent: any batch
    size gives each crop the result it has alone (the reference pads the
    batch to a multiple of 8 for its TPU tile; nothing here needs it).
    Each stage's blocks are checked for the kernel once, at the first
    forward after the buffers were built, moved or loaded."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        kind, stage_sizes = RESNET_SPECS[cfg.num_layers]
        if kind != "bottleneck":
            raise ValueError("fused inference supports bottleneck ResNets "
                             "(50/101/152)")
        self.cfg = cfg
        self.stem = _conv_node((64, 3, 7, 7), 64, device)
        self.stages = nn.ModuleList()
        inplanes = 64
        for s, nblocks in enumerate(stage_sizes):
            f = 64 * 2 ** s
            self.stages.append(nn.ModuleList(
                _block_node(inplanes if b == 0 else 4 * f, f, b == 0, device)
                for b in range(nblocks)))
            inplanes = 4 * f
        self.head = nn.ModuleList()
        for i in range(cfg.num_deconv_layers):
            k, filters = cfg.num_deconv_kernels[i], cfg.num_deconv_filters[i]
            self.head.append(_conv_node((inplanes, filters, k, k), filters,
                                        device))
            inplanes = filters
        fk = cfg.final_conv_kernel
        self.final = _conv_node((cfg.num_joints, inplanes, fk, fk),
                                cfg.num_joints, device)
        self._checked = None
        self._held = []

    def _apply(self, *args, **kwargs):
        self._checked = None
        return super()._apply(*args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self._checked = None
        return super().load_state_dict(*args, **kwargs)

    def _stage_tensors(self) -> list:
        return [t for stage in self.stages for blk in stage
                for t in blk._buffers.values()]

    def stage_blocks(self) -> list:
        """Each stage's block dicts as ``CheckedBlocks``, kept while the
        stages hold the same tensors: made again after the buffers were
        moved or loaded, or while ``torch.func.functional_call`` swaps them
        (an export with the weights as call arguments)."""
        current = self._stage_tensors()
        if self._checked is None or len(current) != len(self._held) or any(
                a is not b for a, b in zip(current, self._held)):
            self._checked = [CheckedBlocks(blk.tensors() for blk in stage)
                             for stage in self.stages]
            self._held = current
        return self._checked

    def kernel_launches(self, image_hw) -> int:
        """K5 launches of one forward over crops of ``image_hw`` on the
        card: each stage's stride-1 blocks in the form their shape gives."""
        h, w = (((n - 1) // 2 + 1 - 1) // 2 + 1 for n in image_hw)
        total = 0
        for s, blocks in enumerate(self.stage_blocks()):
            if s:
                h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
            total += stage_launches(h, w, blocks[1:] if s else blocks)
        return total

    def forward(self, x):
        cfg = self.cfg
        x = x.to(_BF16)
        x = _bias_relu(F.conv2d(x, self.stem.kernel, stride=2, padding=3),
                       self.stem.bias)
        x = F.max_pool2d(x, 3, 2, 1).permute(0, 2, 3, 1).contiguous()
        for s, blocks in enumerate(self.stage_blocks()):
            x = fused_stage(x, blocks, 1 if s == 0 else 2)
        x = x.permute(0, 3, 1, 2)
        for i, d in enumerate(self.head):
            k = cfg.num_deconv_kernels[i]
            x = _bias_relu(F.conv_transpose2d(x, d.kernel, stride=2,
                                              padding=(k - 2) // 2), d.bias)
        fk = cfg.final_conv_kernel
        x = F.conv2d(x, self.final.kernel, padding=(fk - 1) // 2)
        return x.float() + self.final.bias.view(1, -1, 1, 1)


def fuse_pose_model(cfg: ModelConfig, model: nn.Module) -> FusedPoseResNet:
    """The port's PoseResNet (float, with its batch norms) -> the fused
    inference net on the model's device. Bottleneck depths only; 18/34
    raise ValueError."""
    device = next(model.parameters()).device
    fused = FusedPoseResNet(cfg, device=device)
    folded = fold_pose_resnet(model)
    fused.load_state_dict(fused_state_dict(
        prepare_fused_variables(folded, cfg.num_layers)), strict=True)
    return fused.eval()
