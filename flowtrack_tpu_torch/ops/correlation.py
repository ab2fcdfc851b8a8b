"""Correlation (cost volume), the FlowNetC matching layer (kernel K2).

Port of ``flowtrack_tpu/ops/correlation.py``: ``displacement_grid``
(correlation.py:43), the plain twin of ``correlation_xla`` (:48), and in
place of the TPU kernel ``_corr_kernel`` (:73) the CUDA kernels in
``csrc/correlation.cu``, whose source note gives the bytes, the products and
the design: bfloat16 features run as a banded product on the tensor cores
(any channel count and map width: ``band_plan``), float32 features, and
bfloat16 ones displaced by more than 24, on the CUDA cores.

Contract (the lineage's correlation package): kernel 1, max displacement
``md``, stride2 ``s2``, D = len({-md, -md+s2, ..., md}) shifts per axis,
D*D output channels dy-major / dx-minor; channel (dy, dx) is the mean over
input channels of ``f1[y, x] * f2[y+dy, x+dx]``, reading 0 outside the
map; the output is float32 (float64 for float64 features).

Gradients: ``correlation_nchw`` and ``correlation`` go through the
``autograd.Function`` ``_Correlation``, whose forward is the kernel (or the
plain version) and whose backward is ``correlation_backward``, plain
PyTorch as the reference's ``_corr_bwd`` (correlation.py:195) is the VJP of
its XLA version: for the volume's cotangent g, df1[y, x] = sum over d of
g[y, x, d] * f2[y+dy, x+dx] / C and df2 the same products shifted back,
one pass over the D*D displacements with no forward recomputed. The
backward runs in the forward's autocast state and returns each gradient
in its feature's dtype.

Dispatch: the forward is the custom op ``flowtrack::correlation``
(``torch.ops.flowtrack.correlation``), which a CUDA graph capture and
``torch.export`` see as one node. Its implementation applies the module's
rule ``_runs_kernel``: a CPU tensor goes to the plain version; a CUDA
tensor goes to the kernel of its dtype (``correlation_route``), or the
wrapper raises. Its fake implementation gives the volume's shape, dtype
and strides.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from flowtrack_tpu_torch import kernels

_MAX_D = 21  # displacements per axis the CUDA-core kernel keeps in registers
# the tensor-core kernel: a warp pair's band of round8(md) + 16 + md columns
# fits eight n8 tiles
_MAX_BAND_MD = 24
_GROUP_W = 256       # columns a block takes: two warps per 16 of them
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def displacement_grid(max_displacement: int = 20, stride2: int = 2):
    """Displacement values along one axis: {-md, -md+s2, ..., md}."""
    return list(range(-max_displacement, max_displacement + 1, stride2))


def _sum_dtype(dtype):
    """float32 sums for bfloat16 and float32 features, float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def correlation_plain(f1, f2, max_displacement: int = 20, stride2: int = 2):
    """Plain PyTorch version: f1, f2 (N, H, W, C) -> (N, H, W, D*D) float32,
    D*D shifted elementwise products over a zero-padded f2."""
    n, h, w, c = f1.shape
    md = max_displacement
    dt = _sum_dtype(f1.dtype)
    f1 = f1.to(dt)
    f2p = F.pad(f2.to(dt), (0, 0, md, md, md, md))
    inv_c = 1.0 / c
    outs = []
    for dy in displacement_grid(md, stride2):
        for dx in displacement_grid(md, stride2):
            f2s = f2p[:, md + dy:md + dy + h, md + dx:md + dx + w, :]
            outs.append((f1 * f2s).sum(-1) * inv_c)
    return torch.stack(outs, dim=-1)


class BandPlan(NamedTuple):
    """How the tensor-core kernel runs a (C, W) map: ``kc`` channels staged
    at a time (a multiple of 16; round16(C) when both rows fit whole),
    ``smem_bytes`` of shared memory, ``groups`` blocks of 256 columns."""
    kc: int
    smem_bytes: int
    groups: int


def band_plan(c: int, w: int) -> BandPlan:
    """The tensor-core kernel's staging for C channels of W columns: a row of
    f1 and one of f2, each ``kc`` channels of round16(W) + 8 bfloat16 values,
    with the channels cut into the fewest equal chunks that fit a block's
    shared memory. Raises when 16 channels of one row pair do not fit."""
    cp, wp = -(-c // 16) * 16, -(-w // 16) * 16
    per_channel = 2 * (wp + 8) * 2
    most = SMEM_LIMIT // per_channel // 16 * 16
    if most < 16:
        raise ValueError(f"two rows of 16 channels x {w} columns take "
                         f"{16 * per_channel} bytes of shared memory, over "
                         f"{SMEM_LIMIT}")
    chunks = -(-cp // most)
    kc = -(-cp // chunks // 16) * 16
    return BandPlan(kc, kc * per_channel, -(-wp // _GROUP_W))


def correlation_route(dtype, c: int, w: int, max_displacement: int,
                      stride2: int) -> str:
    """Which kernel takes these features, by dtype and shape: "mma"
    (bfloat16, the banded product on the tensor cores) or "cuda_core"
    (float32, and bfloat16 displaced by more than 24). Raises on what
    neither takes."""
    if max_displacement < 0 or stride2 < 1:
        raise ValueError(f"max_displacement >= 0 and stride2 >= 1, got "
                         f"{max_displacement} and {stride2}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"f1, f2 must both be bfloat16 or float32, got "
                        f"{dtype}")
    if dtype == torch.bfloat16 and max_displacement <= _MAX_BAND_MD:
        band_plan(c, w)
        return "mma"
    d = len(displacement_grid(max_displacement, stride2))
    if d > _MAX_D:
        raise ValueError(f"the CUDA-core kernel takes at most {_MAX_D} "
                         f"displacements per axis, got {d}")
    return "cuda_core"


def correlation_cuda(f1, f2, max_displacement: int = 20, stride2: int = 2):
    """Launch K2. f1, f2 (N, C, H, W) contiguous, bfloat16 or float32, on a
    CUDA device -> (N, D*D, H, W) float32."""
    if f1.device.type != "cuda" or f2.device != f1.device:
        raise RuntimeError(f"correlation kernel needs CUDA tensors on one "
                           f"device, got {f1.device} and {f2.device}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"f1, f2 must be equal (N, C, H, W), got "
                         f"{tuple(f1.shape)} and {tuple(f2.shape)}")
    if f2.dtype != f1.dtype:
        raise TypeError(f"f1, f2 must both be bfloat16 or float32, got "
                        f"{f1.dtype} and {f2.dtype}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("f1, f2 must be contiguous")
    n, c, h, w = f1.shape
    route = correlation_route(f1.dtype, c, w, max_displacement, stride2)
    d = len(displacement_grid(max_displacement, stride2))
    out = torch.empty((n, d * d, h, w), dtype=torch.float32, device=f1.device)
    if out.numel():
        lib = kernels.library()
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        args = (f1.data_ptr(), f2.data_ptr(), out.data_ptr(), n, c, h, w,
                max_displacement, stride2, d)
        # the tensors' card current: the kernel's shared-memory attribute
        # is set for the device cudaGetDevice reports
        with torch.cuda.device(f1.device):
            if route == "mma":
                err = lib.ft_correlation_mma(*args, band_plan(c, w).kc,
                                             stream)
            else:
                err = lib.ft_correlation_forward(
                    *args, int(f1.dtype == torch.bfloat16), stream)
        kernels.check(err, "correlation")
        correlation_cuda.launches += 1
    return out


correlation_cuda.launches = 0


def correlation_backward(f1, f2, grad, max_displacement: int = 20,
                         stride2: int = 2):
    """The volume's VJP: f1, f2 (N, C, H, W), grad (N, D*D, H, W) ->
    (df1, df2) in f1's and f2's dtypes, summed in float32 (float64 for
    float64 features). df1 gathers g_d * f2 shifted by d, df2 scatters
    g_d * f1 back by d, over a zero-padded f2's frame."""
    n, c, h, w = f1.shape
    md = max_displacement
    dt = _sum_dtype(f1.dtype)
    a = f1.to(dt)
    f2p = F.pad(f2.to(dt), (md, md, md, md))
    # the forward takes the sum times the rounded 1 / C
    g = grad.to(dt) * (1.0 / c)
    df1 = torch.zeros_like(a)
    df2p = torch.zeros_like(f2p)
    disps = displacement_grid(md, stride2)
    for i, dy in enumerate(disps):
        for j, dx in enumerate(disps):
            gd = g[:, i * len(disps) + j].unsqueeze(1)
            ys, xs = slice(md + dy, md + dy + h), slice(md + dx, md + dx + w)
            df1.addcmul_(gd, f2p[:, :, ys, xs])
            df2p[:, :, ys, xs].addcmul_(gd, a)
    return df1.to(f1.dtype), df2p[:, :, md:md + h, md:md + w].to(f2.dtype)


def _runs_kernel(t) -> bool:
    """The dispatch rule: a tensor off the CPU takes the kernel."""
    return t.device.type != "cpu"


@torch.library.custom_op("flowtrack::correlation", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _correlation_op(f1: torch.Tensor, f2: torch.Tensor,
                    max_displacement: int, stride2: int) -> torch.Tensor:
    if _runs_kernel(f1):
        return correlation_cuda(f1.contiguous(), f2.contiguous(),
                                max_displacement, stride2)
    out = correlation_plain(f1.permute(0, 2, 3, 1), f2.permute(0, 2, 3, 1),
                            max_displacement, stride2)
    return out.permute(0, 3, 1, 2)


@_correlation_op.register_fake
def _(f1, f2, max_displacement, stride2):
    n, _, h, w = f1.shape
    dd = len(displacement_grid(max_displacement, stride2)) ** 2
    dt = _sum_dtype(f1.dtype)
    if _runs_kernel(f1):
        return f1.new_empty((n, dd, h, w), dtype=dt)
    # the plain version stacks the displacements last
    return f1.new_empty((n, h, w, dd), dtype=dt).permute(0, 3, 1, 2)


class _Correlation(torch.autograd.Function):
    """The cost volume with its gradient: the op forward (the kernel, or
    for CPU tensors the plain version), ``correlation_backward``
    backward."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, f1, f2, max_displacement, stride2):
        ctx.save_for_backward(f1, f2)
        ctx.geometry = (max_displacement, stride2)
        return _correlation_op(f1, f2, max_displacement, stride2)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        f1, f2 = ctx.saved_tensors
        df1, df2 = correlation_backward(f1, f2, grad, *ctx.geometry)
        return df1, df2, None, None


def correlation_nchw(f1, f2, max_displacement: int = 20, stride2: int = 2):
    """FlowNetC's call: NCHW features -> (N, D*D, H, W) float32 volume,
    differentiable in f1 and f2."""
    return _Correlation.apply(f1, f2, max_displacement, stride2)


def correlation(f1, f2, max_displacement: int = 20, stride2: int = 2):
    """Public entry, the reference's layout: (N, H, W, C) -> (N, H, W, D*D)."""
    out = correlation_nchw(f1.permute(0, 3, 1, 2), f2.permute(0, 3, 1, 2),
                           max_displacement, stride2)
    return out.permute(0, 2, 3, 1)
