"""Flow warping: the dense warp resample2d (kernels K3/K4), channelnorm, and
the sparse sampling of a flow field.

Port of ``flowtrack_tpu/ops/warp.py``:

* ``resample2d_plain`` is the plain twin of ``_bilinear_sample_clamp`` +
  ``resample2d`` (warp.py:31-110). In place of the TPU kernels
  ``_warp_kernel_mm`` (K3, :344) and ``_warp_kernel`` (K4, :215) there is
  one CUDA kernel, ``csrc/resample2d.cu``, whose source note gives its bytes
  and design. K3 and K4 are two formulations of one function, made because
  a TPU has no gather; on the GPU a gather is the natural form, so one kernel
  serves both ``pallas_warp_impl`` names, held to K4's contract (the XLA
  path's value, bitwise at integer flows).
* ``channelnorm`` (:549) is a plain float32 reduction, as in the reference,
  but for its gradient at a zero norm: the reference's is NaN there (the
  square root's derivative at 0 times 0), which a brightness error of
  exactly 0, one pixel of two frames equal in every channel, puts into
  every FlowNet2 weight under it; the port's is 0 there, as the lineage's
  ChannelNorm backward gives (it divides by the norm plus 1e-9).
* ``flow_gather`` and ``_bilinear_sample_points`` (:555-590), the tracker's
  joint propagation primitive.

resample2d's contract: out[n, :, y, x] = img[n] sampled bilinearly at
(x + u, y + v), coordinates clamped to [0, W-1] x [0, H-1], the 2x2 anchor
clamped to (W-2, H-2) with the weights recomputed against it, weights in the
image dtype, ``top = v00*(1-wx) + v01*wx`` (and ``bot``) then
``top*(1-wy) + bot*wy``, each operation rounded in the image dtype. The
coordinates are float32 (float64 for a float64 flow).

Gradients: ``resample2d_nchw`` and ``resample2d`` go through the
``autograd.Function`` ``_Resample2d``: the kernel (or the plain version)
forward, ``resample2d_backward`` backward, plain PyTorch as the reference's
``_warp_bwd`` (warp.py:536) is the VJP of its XLA warp. The image's
gradient scatters g with the four bilinear weights; the flow's is the
weights' derivative times the taps, times the clamp's derivative: 1 inside
the frame, 0 outside, and 1/2 on the frame's edge, as ``jnp.clip`` splits a
tie (a zero flow on the left or top edge sits on one); ``floor`` and the
anchor's ``min(., W-2)`` carry none.

Dispatch: the forward is the custom op ``flowtrack::resample2d``
(``torch.ops.flowtrack.resample2d``), which a CUDA graph capture and
``torch.export`` see as one node. Its implementation applies the module's
rule ``_runs_kernel``: a CPU tensor goes to the plain version; a CUDA
tensor goes to the kernel, or the wrapper raises.
"""

from __future__ import annotations

import torch

from flowtrack_tpu_torch import kernels


def _coordinates(flow):
    """The unclamped sample coordinates (x + u, y + v), each (N, H, W), in
    float32 (float64 for a float64 flow)."""
    n, _, h, w = flow.shape
    dt = torch.promote_types(flow.dtype, torch.float32)
    xs = torch.arange(w, dtype=dt, device=flow.device)
    ys = torch.arange(h, dtype=dt, device=flow.device)[:, None]
    return xs + flow[:, 0].to(dt), ys + flow[:, 1].to(dt)


def resample2d_plain(img, flow):
    """Plain PyTorch version: img (N, C, H, W) float32 or bfloat16, flow
    (N, 2, H, W) -> (N, C, H, W) in img's dtype."""
    n, c, h, w = img.shape
    dt = img.dtype
    if h == 1 and w == 1:
        return img.clone()
    sx, sy = _coordinates(flow)
    sx = sx.clamp(0.0, w - 1.0)
    sy = sy.clamp(0.0, h - 1.0)
    flat = img.reshape(n, c, h * w)

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(n, 1, h * w).expand(n, c, h * w)
        return flat.gather(2, idx).reshape(n, c, h, w)

    def anchor(s, size):
        """-> (anchor as long (N, H, W), weight (N, 1, H, W) in dt)"""
        a = s.floor().clamp(max=size - 2.0)
        return a.long(), (s - a).unsqueeze(1).to(dt)

    def lerp(a, b, t):
        return a * (1.0 - t) + b * t

    if h == 1:   # one row: 1-D along x
        x0, wx = anchor(sx, w)
        return lerp(tap(0, x0), tap(0, x0 + 1), wx)
    if w == 1:   # one column: 1-D along y
        y0, wy = anchor(sy, h)
        return lerp(tap(y0, 0), tap(y0 + 1, 0), wy)
    x0, wx = anchor(sx, w)
    y0, wy = anchor(sy, h)
    top = lerp(tap(y0, x0), tap(y0, x0 + 1), wx)
    bot = lerp(tap(y0 + 1, x0), tap(y0 + 1, x0 + 1), wx)
    return lerp(top, bot, wy)


def resample2d_cuda(img, flow):
    """Launch the warp kernel. img (N, C, H, W) float32 or bfloat16, flow
    (N, 2, H, W) float32 or bfloat16, both contiguous on one CUDA device ->
    (N, C, H, W) in img's dtype."""
    if img.device.type != "cuda" or flow.device != img.device:
        raise RuntimeError(f"resample2d kernel needs CUDA tensors on one "
                           f"device, got {img.device} and {flow.device}")
    if img.dim() != 4 or flow.shape != (img.shape[0], 2, *img.shape[2:]):
        raise ValueError(f"img must be (N, C, H, W) and flow (N, 2, H, W), "
                         f"got {tuple(img.shape)} and {tuple(flow.shape)}")
    floats = (torch.bfloat16, torch.float32)
    if img.dtype not in floats or flow.dtype not in floats:
        raise TypeError(f"img and flow must be bfloat16 or float32, got "
                        f"{img.dtype} and {flow.dtype}")
    if not (img.is_contiguous() and flow.is_contiguous()):
        raise ValueError("img and flow must be contiguous")
    n, c, h, w = img.shape
    out = torch.empty_like(img)
    if out.numel():
        with torch.cuda.device(img.device):
            err = kernels.library().ft_resample2d_forward(
                img.data_ptr(), flow.data_ptr(), out.data_ptr(), n, c, h, w,
                int(img.dtype == torch.bfloat16),
                int(flow.dtype == torch.bfloat16),
                torch.cuda.current_stream(img.device).cuda_stream)
        kernels.check(err, "resample2d")
        resample2d_cuda.launches += 1
    return out


resample2d_cuda.launches = 0


def _axis(s, size, dt):
    """One axis of the backward: the clamped coordinate's anchor (long),
    the neighbour's index, the weight of the neighbour in ``dt`` and the
    clamp's derivative. An axis of one pixel has one tap of weight 1 and no
    coordinate gradient."""
    if size == 1:
        zero = torch.zeros_like(s)
        return zero.long(), zero.long(), zero.to(dt), zero.to(dt)
    hi = size - 1.0
    # jnp.clip's derivative: 1 inside, 1/2 on a bound (a tie), 0 outside
    dclip = ((s > 0.0) & (s < hi)).to(dt) + 0.5 * ((s == 0.0) | (s == hi)).to(dt)
    sc = s.clamp(0.0, hi)
    a = sc.floor().clamp(max=size - 2.0)
    return a.long(), a.long() + 1, (sc - a).to(dt), dclip


def resample2d_backward(img, flow, grad):
    """The warp's VJP: img (N, C, H, W), flow (N, 2, H, W) and the
    output's cotangent ``grad`` -> (dimg, dflow) in img's and flow's dtypes,
    computed in float32 (float64 for float64 inputs)."""
    n, c, h, w = img.shape
    dt = torch.promote_types(img.dtype, torch.float32)
    sx, sy = _coordinates(flow)
    x0, x1, wx, dcx = _axis(sx, w, dt)
    y0, y1, wy, dcy = _axis(sy, h, dt)
    wx, wy = wx.unsqueeze(1), wy.unsqueeze(1)
    g = grad.to(dt)
    flat = img.to(dt).reshape(n, c, h * w)
    taps = [(yi * w + xi).reshape(n, 1, h * w).expand(n, c, h * w)
            for yi, xi in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
    v00, v01, v10, v11 = (flat.gather(2, i).reshape(n, c, h, w)
                          for i in taps)
    g_top, g_bot = g * (1.0 - wy), g * wy
    dimg = torch.zeros_like(flat)
    for idx, part in zip(taps, (g_top * (1.0 - wx), g_top * wx,
                                g_bot * (1.0 - wx), g_bot * wx)):
        dimg.scatter_add_(2, idx, part.reshape(n, c, h * w))
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    du = (g_top * (v01 - v00) + g_bot * (v11 - v10)).sum(1) * dcx
    dv = (g * (bot - top)).sum(1) * dcy
    dflow = torch.stack([du, dv], dim=1)
    return dimg.reshape(n, c, h, w).to(img.dtype), dflow.to(flow.dtype)


def _runs_kernel(t) -> bool:
    """The dispatch rule: a tensor off the CPU takes the kernel."""
    return t.device.type != "cpu"


@torch.library.custom_op("flowtrack::resample2d", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _resample2d_op(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    if _runs_kernel(img):
        return resample2d_cuda(img.contiguous(), flow.contiguous())
    return resample2d_plain(img, flow).contiguous()


@_resample2d_op.register_fake
def _(img, flow):
    return img.new_empty(img.shape)


class _Resample2d(torch.autograd.Function):
    """The warp with its gradient: the op forward (the kernel, or for CPU
    tensors the plain version), ``resample2d_backward`` backward."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, img, flow):
        ctx.save_for_backward(img, flow)
        return _resample2d_op(img, flow)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        img, flow = ctx.saved_tensors
        return resample2d_backward(img, flow, grad)


def resample2d_nchw(img, flow):
    """The cascade's call: NCHW image and flow -> warped NCHW image,
    differentiable in both."""
    return _Resample2d.apply(img, flow)


def resample2d(img, flow):
    """Public entry, the reference's layout: img (N, H, W, C), flow
    (N, H, W, 2) -> (N, H, W, C)."""
    out = resample2d_nchw(img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1)


def channelnorm(x, eps: float = 0.0, dim: int = -1):
    """L2 norm over the channel axis ``dim`` in float32, kept as a size-1
    axis: (N, H, W, C) -> (N, H, W, 1) by default. Where the norm is 0 its
    gradient is 0, not NaN; elsewhere the values and gradients are the
    square root's."""
    s = x.float().square().sum(dim, keepdim=True) + eps
    nonzero = s > 0
    return torch.where(nonzero, torch.sqrt(torch.where(nonzero, s, 1.0)),
                       0.0)


def _bilinear_sample_points(img, sx, sy):
    """img (*B, H, W, C) sampled at points (sx, sy) (*B, *S): coordinates
    clamped to the image, four-point bilinear -> (*B, *S, C)."""
    h, w, c = img.shape[-3:]
    batch = img.shape[:-3]
    sx = sx.clamp(0.0, w - 1.0)
    sy = sy.clamp(0.0, h - 1.0)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0)[..., None].to(img.dtype)
    wy = (sy - y0)[..., None].to(img.dtype)
    x0i = x0.long()
    y0i = y0.long()
    x1i = (x0i + 1).clamp(max=w - 1)
    y1i = (y0i + 1).clamp(max=h - 1)
    flat = img.reshape(*batch, h * w, c)

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(*batch, -1, 1).expand(*batch, -1, c)
        return flat.gather(-2, idx).reshape(*yi.shape, c)

    top = tap(y0i, x0i) * (1.0 - wx) + tap(y0i, x1i) * wx
    bot = tap(y1i, x0i) * (1.0 - wx) + tap(y1i, x1i) * wx
    return top * (1.0 - wy) + bot * wy


def flow_gather(flow, pts_xy):
    """flow (*B, H, W, 2) sampled at points (*B, *S, 2) -> (*B, *S, 2) flow
    vectors; each leading index of ``flow`` (a clip lane) serves the points
    of the same leading index."""
    return _bilinear_sample_points(flow, pts_xy[..., 0], pts_xy[..., 1])
