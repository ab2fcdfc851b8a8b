"""Fused person crop + resize + normalize (kernel K1).

Port of ``flowtrack_tpu/ops/crop.py``: ``crop_params`` (crop.py:41), the
plain twin of ``crop_resize_normalize`` (:79), and in place of the TPU
kernel ``_crop_kernel`` (:113) the CUDA kernel in ``csrc/crop.cu``, whose
source note says what bounds it and how it is built.

At inference the crop transform has no rotation, so the map is separable:
crop pixel i of either axis reads source coordinate ``s * i + t`` with one
isotropic ``s`` per person. ``crop_frames`` takes a whole clip's frames and a
frame index per crop, so every crop of a pose pass is one kernel launch and
no other device operation: the kernel works out ``crop_params`` itself from
the centers and scales, rounded as this module's ``crop_params`` rounds them.

Dispatch: ``crop_frames`` calls the custom op ``flowtrack::crop_frames``
(``torch.ops.flowtrack.crop_frames``), which a CUDA graph capture and
``torch.export`` see as one node. The op's implementation sends a CPU
tensor to the plain version and a CUDA tensor to the kernel's wrapper, which
launches it or raises; its fake implementation gives the output's shape,
dtype and strides.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from flowtrack_tpu_torch import kernels
from flowtrack_tpu_torch.config import PIXEL_STD


def crop_params(centers, scales, out_hw: Tuple[int, int]):
    """Per-person separable map: (sx, tx, sy, ty), each (P,) float32, with
    ``src = s * i + t`` on each axis (sy == sx, a similarity transform)."""
    out_h, out_w = out_hw
    centers = torch.as_tensor(centers, dtype=torch.float32)
    scales = torch.as_tensor(scales, dtype=torch.float32)
    src_w = scales[:, 0] * PIXEL_STD
    # a true division on every device: by a Python scalar a CUDA tensor is
    # multiplied by the rounded reciprocal, one ulp off where 1 / out_w is
    # not exact (192, 288)
    s = src_w / src_w.new_full((), out_w)
    tx = centers[:, 0] - s * (out_w * 0.5)
    ty = centers[:, 1] - s * (out_h * 0.5)
    return s, tx, s, ty


def _bilinear_matrix(s, t, out_size: int, src_size: int):
    """(P, out_size, src_size) bilinear weights ``relu(1 - |s*i + t - j|)``;
    taps outside the image get no column, so they weigh 0."""
    i = torch.arange(out_size, dtype=torch.float32, device=s.device)
    j = torch.arange(src_size, dtype=torch.float32, device=s.device)
    src = s[:, None, None] * i[None, :, None] + t[:, None, None]
    return torch.clamp(1.0 - (src - j[None, None, :]).abs(), min=0.0)


def _normalize(out, mean, std, rgb_max):
    if mean is None:
        return out
    mean = torch.as_tensor(mean, dtype=torch.float32, device=out.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=out.device)
    # divisions by tensors, which stay true divisions on a CUDA device
    return (out / out.new_full((), rgb_max) - mean) / std


def crop_frames_plain(frames, frame_idx, centers, scales, out_hw,
                      mean=None, std=None, rgb_max: float = 255.0,
                      out_dtype=torch.float32):
    """Plain PyTorch version of K1: the twin's two interpolation matmuls
    ``Wy . img . Wx^T`` per crop, in float32."""
    out_h, out_w = out_hw
    h, w = frames.shape[1], frames.shape[2]
    sx, tx, sy, ty = (v.to(frames.device)
                      for v in crop_params(centers, scales, out_hw))
    wy = _bilinear_matrix(sy, ty, out_h, h)
    wx = _bilinear_matrix(sx, tx, out_w, w)
    img = frames[frame_idx.long()].float()                 # (P, H, W, C)
    tmp = torch.einsum("phH,pHWc->phWc", wy, img)
    out = torch.einsum("phWc,pwW->phwc", tmp, wx)
    return _normalize(out, mean, std, rgb_max).to(out_dtype)


def _on_device(x, dev, dtypes):
    """``x`` as a contiguous tensor on ``dev`` in one of ``dtypes`` (the
    first if it has another): no operation when it already is."""
    x = torch.as_tensor(x, device=dev)
    if x.dtype not in dtypes:
        x = x.to(dtypes[0])
    return x if x.is_contiguous() else x.contiguous()


def crop_frames_cuda(frames, frame_idx, centers, scales, out_hw,
                     mean=None, std=None, rgb_max: float = 255.0,
                     out_dtype=torch.float32, band_counts=None):
    """Launch K1. frames (F, H, W, 3) uint8 or float32, contiguous, on a
    CUDA device -> (P, out_h, out_w, 3) in ``out_dtype`` (float32 or
    bfloat16), a channel-last view of the (P, 3, out_h, out_w) buffer the
    kernel writes. A frame index outside [0, F) gives a NaN crop.

    With float32 ``centers`` and ``scales`` and an int64 or int32
    ``frame_idx`` on the frames' device the call is one kernel launch and no
    other device operation; inputs of another type or place are converted
    first. ``band_counts``, two int32 on the device, receives the number of
    bands the launch read from staged rows ([0]) and straight from the
    frame ([1]), for a check of which path a shape takes."""
    out_h, out_w = out_hw
    if frames.device.type != "cuda":
        raise RuntimeError(f"crop kernel needs CUDA tensors, got {frames.device}")
    if frames.dim() != 4 or frames.shape[3] != 3:
        raise ValueError(f"frames must be (F, H, W, 3), got {tuple(frames.shape)}")
    if frames.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"frames must be uint8 or float32, got {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    n_frames, h, w = frames.shape[:3]
    if h < 2 or w < 2 or h * w * 3 * frames.element_size() >= 2 ** 31:
        raise ValueError(f"frames of {h}x{w} pixels: the kernel takes 2x2 "
                         f"up to a frame of 2^31 bytes")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    dev = frames.device
    centers = _on_device(centers, dev, (torch.float32,))
    scales = _on_device(scales, dev, (torch.float32,))
    idx = _on_device(frame_idx, dev, (torch.int64, torch.int32))
    p = centers.shape[0]
    if centers.shape != (p, 2) or scales.shape != (p, 2):
        raise ValueError(f"centers and scales must be (P, 2), got "
                         f"{tuple(centers.shape)} and {tuple(scales.shape)}")
    if idx.shape != (p,):
        raise ValueError(f"frame_idx must be ({p},), got {tuple(idx.shape)}")
    if band_counts is not None and (
            band_counts.dtype != torch.int32 or band_counts.shape != (2,)
            or band_counts.device != dev):
        raise ValueError("band_counts must be two int32 on the frames' device")
    out = torch.empty((p, 3, out_h, out_w), dtype=out_dtype, device=dev)
    if p and out_h and out_w:
        m = (0.0, 0.0, 0.0) if mean is None else tuple(float(v) for v in mean)
        s = (1.0, 1.0, 1.0) if mean is None else tuple(float(v) for v in std)
        r = 1.0 if mean is None else float(rgb_max)
        # the frames' card current, so that the launch and its stream are
        # that card's whichever device the caller made current
        with torch.cuda.device(dev):
            err = kernels.library().ft_crop_resize_normalize(
                frames.data_ptr(), int(frames.dtype == torch.uint8), n_frames,
                h, w, idx.data_ptr(), int(idx.dtype == torch.int64),
                centers.data_ptr(), scales.data_ptr(), p, out_h, out_w,
                PIXEL_STD, r, *m, *s, out.data_ptr(),
                int(out_dtype == torch.bfloat16),
                None if band_counts is None else band_counts.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        kernels.check(err, "crop")
        crop_frames_cuda.launches += 1
    return out.permute(0, 2, 3, 1)


crop_frames_cuda.launches = 0


@torch.library.custom_op("flowtrack::crop_frames", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _crop_frames_op(frames: torch.Tensor, frame_idx: torch.Tensor,
                    centers: torch.Tensor, scales: torch.Tensor,
                    out_hw: Sequence[int], mean: Optional[Sequence[float]],
                    std: Optional[Sequence[float]], rgb_max: float,
                    out_dtype: torch.dtype) -> torch.Tensor:
    if frames.device.type == "cpu":
        # the kernel's layout, (P, C, h, w) memory under an NHWC view
        out = crop_frames_plain(frames, frame_idx, centers, scales, out_hw,
                                mean, std, rgb_max, out_dtype)
        return out.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    return crop_frames_cuda(frames, frame_idx, centers, scales, out_hw,
                            mean, std, rgb_max, out_dtype)


@_crop_frames_op.register_fake
def _(frames, frame_idx, centers, scales, out_hw, mean, std, rgb_max,
      out_dtype):
    p, (out_h, out_w), c = centers.shape[0], out_hw, frames.shape[3]
    return frames.new_empty((p, c, out_h, out_w),
                            dtype=out_dtype).permute(0, 2, 3, 1)


def crop_frames(frames, frame_idx, centers, scales, out_hw,
                mean: Optional[Sequence[float]] = None,
                std: Optional[Sequence[float]] = None,
                rgb_max: float = 255.0, out_dtype=torch.float32):
    """frames (F, H, W, C); frame_idx (P,); centers/scales (P, 2)
    -> (P, out_h, out_w, C) crops of ``frames[frame_idx]``, the NHWC view
    of (P, C, out_h, out_w) memory on either device, normalized as
    ``(x / rgb_max - mean) / std`` when ``mean`` is given. Index, center
    and scale arrays that are not yet tensors on the frames' device are
    made so first."""
    dev = frames.device
    idx = torch.as_tensor(frame_idx, device=dev)
    if idx.dtype not in (torch.int64, torch.int32):
        idx = idx.long()
    return _crop_frames_op(
        frames, idx, torch.as_tensor(centers, dtype=torch.float32, device=dev),
        torch.as_tensor(scales, dtype=torch.float32, device=dev),
        tuple(out_hw), None if mean is None else [float(v) for v in mean],
        None if std is None else [float(v) for v in std], float(rgb_max),
        out_dtype)


def crop_resize_normalize(image, centers, scales, out_hw, mean=None,
                          std=None, rgb_max: float = 255.0,
                          out_dtype=torch.float32):
    """One frame: image (H, W, C); centers/scales (P, 2)
    -> (P, out_h, out_w, C). The reference's signature."""
    p = torch.as_tensor(centers).shape[0]
    idx = torch.zeros(p, dtype=torch.int32, device=image.device)
    return crop_frames(image.unsqueeze(0).contiguous(), idx, centers, scales,
                       out_hw, mean, std, rgb_max, out_dtype)
