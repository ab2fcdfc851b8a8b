"""The int8 convolution product of the W8A8 pose model (models/quantize.py).

The reference computes it with XLA's ``conv_general_dilated(int8, int8,
preferred_element_type=int32)`` (quantize.py:95, :122), not in a Pallas
kernel, so on the card the port uses the library's int8 GEMM:
``torch._int_mm`` (cuBLASLt) over an int8 patch matrix built on the device.

Two versions, both exact, so they agree bit for bit:

* ``int8_conv2d_plain``: ``F.conv2d`` / ``F.conv_transpose2d`` in float64
  on the int8 values, cast to int32. Every product is at most 127^2 and
  every sum at most 32768 * 127^2 ~ 5.3e8 (a 4x4 deconv over 2048
  channels), far below 2^53, so float64 holds the true int32 result.
* ``int8_conv2d_gemm``: the input as NHWC int8, its k x k windows gathered
  by one copy of a strided view into an (M, K) patch matrix whose columns
  run (row tap, column tap, channel), K zero-padded to a multiple of 8 (the
  stem's 7*7*3 = 147 becomes 152; zero columns leave the sum unchanged),
  times the
  (K, Cout) weight matrix, column-major, in one ``torch._int_mm`` per chunk
  of whole images (a chunk's patch matrix stays under ``max_bytes``). A
  chunk of 16 rows or fewer is padded with zero rows (cuBLASLt's int8 GEMM
  wants m > 16). A transposed conv (stride s, padding p) is the conv of
  the input with s - 1 zeros inserted between its pixels and k - 1 - p
  zeros around them, by the spatially flipped kernel at stride 1: the
  reference's ``lhs_dilation`` form. It runs on CPU tensors too
  (``torch._int_mm`` has a CPU version), which is how the tests hold it to
  the plain version.

Dispatch (``int8_conv2d``): a CPU tensor takes the plain version, a CUDA
tensor the GEMM route; any other device raises. The GEMM route counts its
``torch._int_mm`` calls in ``int8_conv2d_gemm.launches``.

Inputs are NCHW int8 activations and int8 weights in torch's layouts
(Conv2d (Cout, Cin, k, k), ConvTranspose2d (Cin, Cout, k, k)); the result
is (N, Cout, Ho, Wo) int32 (from the GEMM route, an NCHW view of NHWC
memory).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# cuBLASLt's int8 GEMM: k and n multiples of 8, m > 16
_ALIGN = 8
_MIN_ROWS = 17
MAX_PATCH_BYTES = 1 << 30


def _check(xq, wq):
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {xq.dtype} and {wq.dtype}")
    if xq.dim() != 4 or wq.dim() != 4 or wq.shape[2] != wq.shape[3]:
        raise ValueError(f"NCHW input and a square kernel expected, got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")


def int8_conv2d_plain(xq, wq, stride: int, padding: int,
                      transpose: bool = False):
    """The exact int32 convolution by float64 convolution (module
    docstring)."""
    _check(xq, wq)
    conv = F.conv_transpose2d if transpose else F.conv2d
    y = conv(xq.double(), wq.double(), stride=stride, padding=padding)
    return y.to(torch.int32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def patch_matrix(x, k: int, stride: int, k_cols: int):
    """x (N, Hp, Wp, C) int8, already padded -> (N * Ho * Wo, k_cols) int8:
    row (n, i, j) holds the k x k window at (i * stride, j * stride), its
    columns ordered (row tap, column tap, channel), zero beyond k * k * C.
    The windows are a strided view of ``x`` gathered by one copy (none for
    a 1x1 conv at stride 1)."""
    n, _, _, c = x.shape
    win = x.unfold(1, k, stride).unfold(2, k, stride).permute(0, 1, 2, 4, 5, 3)
    m, kkc = n * win.shape[1] * win.shape[2], k * k * c
    if k_cols == kkc:
        return win.reshape(m, kkc)
    out = x.new_empty((*win.shape[:3], k_cols))
    out[..., :kkc].unflatten(-1, (k, k, c)).copy_(win)
    # zero_, not ``= 0``: assigning a number makes a host tensor and reads
    # it back (aten::_local_scalar_dense), a host sync on every forward
    out[..., kkc:].zero_()
    return out.reshape(m, k_cols)


def gemm_weight(wq, transpose: bool = False):
    """int8 weights in torch's layout -> the (Kp, Np) column-major matrix
    the patch matrix multiplies: K = (row tap, column tap, input channel)
    padded to a multiple of 8, Cout padded likewise. A transposed conv's
    kernel is flipped and its channel axes swapped first."""
    if transpose:
        wq = wq.flip(2, 3).transpose(0, 1)
    cout, cin, k, _ = wq.shape
    kc, nc = _round_up(k * k * cin, _ALIGN), _round_up(cout, _ALIGN)
    w = wq.new_zeros((nc, kc))
    w[:cout, :k * k * cin] = wq.permute(0, 2, 3, 1).reshape(cout, -1)
    return w.t()


def _padded_nhwc(x, pad: int, dilation: int = 1):
    """NCHW -> NHWC with ``dilation - 1`` zeros between pixels and ``pad``
    zeros around them."""
    x = x.permute(0, 2, 3, 1)
    if pad == 0 and dilation == 1:
        return x.contiguous()
    n, h, w, c = x.shape
    hd, wd = (h - 1) * dilation + 1, (w - 1) * dilation + 1
    out = x.new_zeros((n, hd + 2 * pad, wd + 2 * pad, c))
    out[:, pad:pad + hd:dilation, pad:pad + wd:dilation] = x
    return out


def int8_conv2d_gemm(xq, wq, stride: int, padding: int,
                     transpose: bool = False,
                     max_bytes: int = MAX_PATCH_BYTES):
    """The exact int32 convolution as int8 patch-matrix GEMMs (module
    docstring); on CUDA or CPU tensors."""
    _check(xq, wq)
    k = wq.shape[2]
    if transpose:
        xp = _padded_nhwc(xq, k - 1 - padding, stride)
        stride = 1
    else:
        xp = _padded_nhwc(xq, padding)
    w = gemm_weight(wq, transpose)
    kc, cout = w.shape[0], wq.shape[1] if transpose else wq.shape[0]
    n, hp, wp, _ = xp.shape
    ho, wo = (hp - k) // stride + 1, (wp - k) // stride + 1
    rows = ho * wo
    out = torch.empty((n * rows, w.shape[1]), dtype=torch.int32,
                      device=xq.device)
    per_chunk = max(1, max_bytes // (rows * kc))
    for i in range(0, n, per_chunk):
        j = min(n, i + per_chunk)
        a = patch_matrix(xp[i:j], k, stride, kc)
        if a.shape[0] < _MIN_ROWS:
            a = torch.cat([a, a.new_zeros((_MIN_ROWS - a.shape[0], kc))])
            out[i * rows:j * rows] = torch._int_mm(a, w)[:(j - i) * rows]
        else:
            torch._int_mm(a, w, out=out[i * rows:j * rows])
        int8_conv2d_gemm.launches += 1
    return out[:, :cout].reshape(n, ho, wo, cout).permute(0, 3, 1, 2)


int8_conv2d_gemm.launches = 0


def int8_conv2d(xq, wq, stride: int, padding: int, transpose: bool = False):
    """xq (N, Cin, H, W) int8 * wq int8 -> (N, Cout, Ho, Wo) int32, exact:
    the plain version on the CPU, the GEMM route on the card."""
    if xq.device.type == "cpu":
        return int8_conv2d_plain(xq, wq, stride, padding, transpose)
    if xq.device.type != "cuda":
        raise RuntimeError(f"int8 conv runs on CPU or CUDA tensors, got "
                           f"{xq.device}")
    with torch.cuda.device(xq.device):
        return int8_conv2d_gemm(xq, wq, stride, padding, transpose)
