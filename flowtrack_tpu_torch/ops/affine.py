"""Crop affine transforms: numpy for the data pipeline, tensors for the
device, and the bilinear warp of an image by one.

Port of ``flowtrack_tpu/ops/affine.py``:

* the numpy half (affine.py:33-146): ``get_affine_transform`` with rotation,
  shift and ``inv`` (the lineage's three-point construction, solved as
  cv2.getAffineTransform solves it), ``affine_transform``,
  ``box_to_center_scale`` and ``fliplr_joints``;
* the tensor half (:148-297): ``get_affine_transform_tensor`` (the
  reference's ``get_affine_transform_jax``, forward or inverse, with
  rotation, in closed form), ``get_affine_transform_inv`` (its inverse
  without rotation, what decode needs), ``affine_transform_tensor`` (the
  reference's ``affine_transform_jax``), ``warp_affine`` (cv2.warpAffine's
  twin, the dataset's warp when cv2 is missing), ``crop_persons`` and
  ``normalize_image``.

Divisions by a constant on the tensor side divide by a tensor: by a Python
scalar a CUDA tensor is multiplied by the rounded reciprocal.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from flowtrack_tpu_torch.config import PIXEL_STD


# ---------------------------------------------------------------------------
# numpy: the data pipeline's transforms
# ---------------------------------------------------------------------------

def _get_dir(src_point, rot_rad):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array(
        [src_point[0] * cs - src_point[1] * sn,
         src_point[0] * sn + src_point[1] * cs], dtype=np.float64)


def _get_3rd_point(a, b):
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float64)


def _solve_affine(src, dst):
    """The 2x3 affine that maps the 3 src points onto the 3 dst points
    (cv2.getAffineTransform(src, dst))."""
    a = np.zeros((6, 6), dtype=np.float64)
    b = np.zeros((6,), dtype=np.float64)
    for i in range(3):
        a[i, 0:2] = src[i]
        a[i, 2] = 1.0
        a[3 + i, 3:5] = src[i]
        a[3 + i, 5] = 1.0
        b[i] = dst[i, 0]
        b[3 + i] = dst[i, 1]
    return np.linalg.solve(a, b).reshape(2, 3)


def get_affine_transform(center, scale, rot, output_size, shift=(0.0, 0.0),
                         inv=False):
    """(2, 3) float64 map from the image to the ``output_size`` = (w, h)
    crop of (center, scale) rotated by ``rot`` degrees, the center moved by
    ``shift`` patch sizes; ``inv`` gives the crop -> image map."""
    center = np.asarray(center, dtype=np.float64)
    scale = np.asarray(scale, dtype=np.float64)
    if scale.ndim == 0:
        scale = np.array([scale, scale], dtype=np.float64)
    shift = np.asarray(shift, dtype=np.float64)

    scale_tmp = scale * PIXEL_STD
    src_w = scale_tmp[0]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    rot_rad = np.pi * rot / 180.0
    src_dir = _get_dir([0.0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0.0, dst_w * -0.5], dtype=np.float64)

    src = np.zeros((3, 2), dtype=np.float64)
    dst = np.zeros((3, 2), dtype=np.float64)
    src[0, :] = center + scale_tmp * shift
    src[1, :] = center + src_dir + scale_tmp * shift
    dst[0, :] = [dst_w * 0.5, dst_h * 0.5]
    dst[1, :] = np.array([dst_w * 0.5, dst_h * 0.5]) + dst_dir
    src[2, :] = _get_3rd_point(src[0, :], src[1, :])
    dst[2, :] = _get_3rd_point(dst[0, :], dst[1, :])

    if inv:
        return _solve_affine(dst, src)
    return _solve_affine(src, dst)


def affine_transform(pt, t):
    """A (2, 3) transform applied to a point or (..., 2) points, float64."""
    pt = np.asarray(pt, dtype=np.float64)
    return pt @ t[:, :2].T + t[:, 2]


def box_to_center_scale(box, aspect_ratio, scale_padding=1.25):
    """COCO box (x, y, w, h) -> (center, scale): the short side grown to the
    aspect ratio, scale = size / 200 * 1.25."""
    x, y, w, h = [float(v) for v in box]
    center = np.array([x + w * 0.5, y + h * 0.5], dtype=np.float64)
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    scale = np.array([w / PIXEL_STD, h / PIXEL_STD],
                     dtype=np.float64) * scale_padding
    return center, scale


def fliplr_joints(joints, joints_vis, width, flip_pairs):
    """Mirror joint x coordinates in an image ``width`` wide and swap the
    left / right pairs; invisible joints are zeroed for both layouts of
    ``joints_vis``, (K,) and (K, dims)."""
    joints = np.array(joints, dtype=np.float64)
    joints_vis = np.array(joints_vis)
    joints[:, 0] = width - joints[:, 0] - 1
    for a, b in flip_pairs:
        joints[[a, b]] = joints[[b, a]]
        joints_vis[[a, b]] = joints_vis[[b, a]]
    vis_col = joints_vis[:, :1] if joints_vis.ndim == 2 \
        else joints_vis[:, None]
    return joints * (vis_col > 0), joints_vis


# ---------------------------------------------------------------------------
# tensors: the device's transforms and warp
# ---------------------------------------------------------------------------

def get_affine_transform_tensor(center, scale, rot_deg, output_size,
                                inv=False):
    """(..., 2, 3) float32 transforms for centers and scales (..., 2) and
    rotations (...,) in degrees, in closed form: the three-point
    construction is the similarity of factor dst_w / src_w and rotation
    ``rot_deg``. ``inv`` gives the crop -> image map."""
    center = torch.as_tensor(center, dtype=torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=center.device)
    rot = torch.as_tensor(rot_deg, dtype=torch.float32, device=center.device)
    rot = rot * (math.pi / 180.0)
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    src_w = scale[..., 0] * PIXEL_STD
    cs, sn = torch.cos(rot), torch.sin(rot)
    width = src_w.new_full((), dst_w)
    if not inv:
        s = width / src_w
        a00, a01, a10, a11 = s * cs, s * sn, -s * sn, s * cs
        tx = dst_w * 0.5 - (a00 * center[..., 0] + a01 * center[..., 1])
        ty = dst_h * 0.5 - (a10 * center[..., 0] + a11 * center[..., 1])
    else:
        s = src_w / width
        a00, a01, a10, a11 = s * cs, -s * sn, s * sn, s * cs
        tx = center[..., 0] - (a00 * dst_w * 0.5 + a01 * dst_h * 0.5)
        ty = center[..., 1] - (a10 * dst_w * 0.5 + a11 * dst_h * 0.5)
    row0 = torch.stack(torch.broadcast_tensors(a00, a01, tx), dim=-1)
    row1 = torch.stack(torch.broadcast_tensors(a10, a11, ty), dim=-1)
    return torch.stack([row0, row1], dim=-2)


def get_affine_transform_inv(center, scale, output_size):
    """(..., 2, 3) float32 map from an ``output_size`` = (w, h) crop back to
    the image, for the crop of (center, scale) without rotation: the
    similarity the reference's 3-point construction defines, in closed
    form."""
    center = torch.as_tensor(center, dtype=torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32)
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    # a true division on every device: by a Python scalar a CUDA tensor is
    # multiplied by the rounded reciprocal (48 and 72 have no exact one)
    src_w = scale[..., 0] * PIXEL_STD
    s = src_w / src_w.new_full((), dst_w)
    zero = torch.zeros_like(s)
    tx = center[..., 0] - s * dst_w * 0.5
    ty = center[..., 1] - s * dst_h * 0.5
    row0 = torch.stack([s, zero, tx], dim=-1)
    row1 = torch.stack([zero, s, ty], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def affine_transform_tensor(pts, t):
    """Apply (..., 2, 3) transforms to (..., K, 2) points, elementwise."""
    pts = pts.float()
    x, y = pts[..., 0], pts[..., 1]
    t = t[..., None, :, :]
    xo = t[..., 0, 0] * x + t[..., 0, 1] * y + t[..., 0, 2]
    yo = t[..., 1, 0] * x + t[..., 1, 1] * y + t[..., 1, 2]
    return torch.stack([xo, yo], dim=-1)


def _bilinear_sample(img, src_x, src_y):
    """img (H, W, C) sampled at float coordinates (...); taps off the image
    read 0. Integer images blend in float32 and round back (cv2)."""
    h, w = img.shape[0], img.shape[1]
    out_dtype = img.dtype
    compute = img.dtype if img.is_floating_point() else torch.float32
    img = img.to(compute)
    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    wx = (src_x - x0)[..., None].to(compute)
    wy = (src_y - y0)[..., None].to(compute)
    x0i = x0.long()
    y0i = y0.long()

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return v * valid[..., None].to(compute)

    top = tap(y0i, x0i) * (1.0 - wx) + tap(y0i, x0i + 1) * wx
    bot = tap(y0i + 1, x0i) * (1.0 - wx) + tap(y0i + 1, x0i + 1) * wx
    out = top * (1.0 - wy) + bot * wy
    if out.dtype != out_dtype:
        out = torch.round(out).to(out_dtype)
    return out


def _grid(out_hw, device):
    out_h, out_w = out_hw
    ys = torch.arange(out_h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(out_w, dtype=torch.float32, device=device)[None, :]
    return xs.expand(out_h, out_w), ys.expand(out_h, out_w)


def warp_affine(img, trans, out_hw):
    """cv2.warpAffine's twin (bilinear, border 0): the (H, W, C) image
    warped by the forward 2x3 ``trans`` (image -> crop) to (out_h, out_w,
    C); the inverse map is worked out from ``trans`` here."""
    a = torch.as_tensor(trans, dtype=torch.float32, device=img.device)
    lin = a[:, :2]
    det = lin[0, 0] * lin[1, 1] - lin[0, 1] * lin[1, 0]
    inv_lin = torch.stack([torch.stack([lin[1, 1], -lin[0, 1]]),
                           torch.stack([-lin[1, 0], lin[0, 0]])]) / det
    # -inv_lin @ t as the reference's float32 dot takes it on the CPU: the
    # first product rounded, the second fused into the sum (a float32
    # product is exact in float64)
    m, t = -inv_lin, a[:, 2]
    inv_t = ((m[:, 0] * t[0]).double() + m[:, 1].double() * t[1].double()
             ).float()
    xs, ys = _grid(out_hw, img.device)
    src_x = inv_lin[0, 0] * xs + inv_lin[0, 1] * ys + inv_t[0]
    src_y = inv_lin[1, 0] * xs + inv_lin[1, 1] * ys + inv_t[1]
    return _bilinear_sample(img, src_x, src_y)


def crop_persons(image, inv_trans, out_hw):
    """N crops (N, out_h, out_w, C) of one (H, W, C) image, given (N, 2, 3)
    crop -> image transforms (``get_affine_transform_tensor(...,
    inv=True)``)."""
    t = torch.as_tensor(inv_trans, dtype=torch.float32, device=image.device)
    xs, ys = _grid(out_hw, image.device)
    t = t[:, :, :, None, None]
    src_x = t[:, 0, 0] * xs + t[:, 0, 1] * ys + t[:, 0, 2]
    src_y = t[:, 1, 0] * xs + t[:, 1, 1] * ys + t[:, 1, 2]
    return _bilinear_sample(image, src_x, src_y)


def normalize_image(x, mean, std, rgb_max=255.0):
    """(x / rgb_max - mean) / std, channel-last, in x's dtype."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return (x / x.new_full((), rgb_max) - mean) / std
