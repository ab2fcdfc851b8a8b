"""Fused person crop + resize + normalize (kernel K1).

Port of ``flowtrack_tpu/ops/crop.py``: ``crop_params`` (crop.py:41), the
plain twin of ``crop_resize_normalize`` (:79), and in place of the TPU
kernel ``_crop_kernel`` (:113) the CUDA kernel in ``csrc/crop.cu``, whose
source note says what bounds it and how it is built.

At inference the crop transform has no rotation, so the map is separable:
crop pixel i of either axis reads source coordinate ``s * i + t`` with one
isotropic ``s`` per person. ``crop_frames`` takes a whole clip's frames and a
frame index per crop, so every crop of a clip is one kernel launch.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel, or the wrapper raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from flowtrack_tpu.config import PIXEL_STD
from flowtrack_tpu_torch import kernels


def crop_params(centers, scales, out_hw: Tuple[int, int]):
    """Per-person separable map: (sx, tx, sy, ty), each (P,) float32, with
    ``src = s * i + t`` on each axis (sy == sx, a similarity transform)."""
    out_h, out_w = out_hw
    centers = torch.as_tensor(centers, dtype=torch.float32)
    scales = torch.as_tensor(scales, dtype=torch.float32)
    src_w = scales[:, 0] * PIXEL_STD
    s = src_w / out_w
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
    return (out / rgb_max - mean) / std


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


def crop_frames_cuda(frames, frame_idx, centers, scales, out_hw,
                     mean=None, std=None, rgb_max: float = 255.0,
                     out_dtype=torch.float32):
    """Launch K1. frames (F, H, W, 3) uint8 or float32, contiguous, on a
    CUDA device -> (P, out_h, out_w, 3) in ``out_dtype`` (float32 or
    bfloat16), a channel-last view of the (P, 3, out_h, out_w) buffer the
    kernel writes. A frame index outside [0, F) gives a NaN crop."""
    out_h, out_w = out_hw
    if frames.device.type != "cuda":
        raise RuntimeError(f"crop kernel needs CUDA tensors, got {frames.device}")
    if frames.dim() != 4 or frames.shape[3] != 3:
        raise ValueError(f"frames must be (F, H, W, 3), got {tuple(frames.shape)}")
    if frames.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"frames must be uint8 or float32, got {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    dev = frames.device
    sx, tx, sy, ty = crop_params(torch.as_tensor(centers, device=dev),
                                 torch.as_tensor(scales, device=dev), out_hw)
    params = torch.stack([sx, tx, sy, ty], dim=1).contiguous()
    idx = torch.as_tensor(frame_idx, device=dev).to(torch.int32).contiguous()
    p = params.shape[0]
    if idx.shape != (p,):
        raise ValueError(f"frame_idx must be ({p},), got {tuple(idx.shape)}")
    out = torch.empty((p, 3, out_h, out_w), dtype=out_dtype, device=dev)
    if p:
        m = (0.0, 0.0, 0.0) if mean is None else tuple(float(v) for v in mean)
        s = (1.0, 1.0, 1.0) if mean is None else tuple(float(v) for v in std)
        r = 1.0 if mean is None else float(rgb_max)
        err = kernels.library().ft_crop_resize_normalize(
            frames.data_ptr(), int(frames.dtype == torch.uint8),
            frames.shape[0], frames.shape[1], frames.shape[2],
            idx.data_ptr(), params.data_ptr(), p, out_h, out_w,
            r, *m, *s, out.data_ptr(), int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
        kernels.check(err, "crop")
        crop_frames_cuda.launches += 1
    return out.permute(0, 2, 3, 1)


crop_frames_cuda.launches = 0


def crop_frames(frames, frame_idx, centers, scales, out_hw,
                mean: Optional[Sequence[float]] = None,
                std: Optional[Sequence[float]] = None,
                rgb_max: float = 255.0, out_dtype=torch.float32):
    """frames (F, H, W, C); frame_idx (P,); centers/scales (P, 2)
    -> (P, out_h, out_w, C) crops of ``frames[frame_idx]``, normalized as
    ``(x / rgb_max - mean) / std`` when ``mean`` is given."""
    if frames.device.type == "cpu":
        return crop_frames_plain(frames, frame_idx, centers, scales, out_hw,
                                 mean, std, rgb_max, out_dtype)
    return crop_frames_cuda(frames, frame_idx, centers, scales, out_hw,
                            mean, std, rgb_max, out_dtype)


def crop_resize_normalize(image, centers, scales, out_hw, mean=None,
                          std=None, rgb_max: float = 255.0,
                          out_dtype=torch.float32):
    """One frame: image (H, W, C); centers/scales (P, 2)
    -> (P, out_h, out_w, C). The reference's signature."""
    p = torch.as_tensor(centers).shape[0]
    idx = torch.zeros(p, dtype=torch.int32, device=image.device)
    return crop_frames(image.unsqueeze(0).contiguous(), idx, centers, scales,
                       out_hw, mean, std, rgb_max, out_dtype)
