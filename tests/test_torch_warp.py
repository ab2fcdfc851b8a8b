"""The port's dense warp, channelnorm and antialiased shrink against the JAX
package, on the CPU.

On the CPU ``resample2d`` takes its plain PyTorch version; the CUDA kernel
that serves the TPU kernels K3 and K4 is held to that version on the card
by chip_smoke.py. The plain version is held here to the JAX XLA warp and to
both Pallas kernels, run in interpret mode as tests/test_correlation_warp.py
runs them. Inputs come from numpy with fixed seeds; each assertion states
its tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowtrack_tpu.ops import warp as jwarp
from flowtrack_tpu_torch.models import flownet as tflownet
from flowtrack_tpu_torch.ops import warp as twarp

# the five shapes of tests/test_correlation_warp.py::TestResample2dPallas
SHAPES = [
    (16, 24, 3, 2.0),     # cascade-like smooth flow
    (24, 16, 3, 30.0),    # large displacements
    (13, 27, 3, 5.0),     # ragged dims
    (8, 128, 2, 5.0),     # full lane tile
    (16, 24, 3, 300.0),   # everything clamped to the edges
]
REFERENCES = ["xla", "pallas_shift", "pallas_matmul"]


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _reference(name, img, flow):
    """The JAX warp ``name`` on numpy inputs -> float32 numpy."""
    img, flow = jnp.asarray(img), jnp.asarray(flow)
    if name == "xla":
        out = jwarp.resample2d(img, flow)
    elif name == "pallas_shift":
        out = jwarp.resample2d_pallas(img, flow, interpret=True)
    else:
        out = jwarp.resample2d_pallas_mm(img, flow, interpret=True)
    return np.asarray(out, np.float32)


def _port(img, flow, dtype=torch.float32):
    return twarp.resample2d(T(img).to(dtype), T(flow)).float().numpy()


def _case(seed, h, w, c, scale):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(2, h, w, c)).astype(np.float32)
    flow = rng.uniform(-scale, scale, (2, h, w, 2)).astype(np.float32)
    return img, flow


@pytest.mark.parametrize("ref", REFERENCES)
@pytest.mark.parametrize("h,w,c,scale", SHAPES)
def test_resample2d_float32_matches_reference(ref, h, w, c, scale):
    """float32 within 4 eps of the image's magnitude: the plain version
    does the XLA path's operations in its order (equal in practice); the
    Pallas kernels differ from it by FMA order (shift) and a float32
    contraction (matmul), K3/K4's own contract."""
    img, flow = _case(h * w + c, h, w, c, scale)
    got = _port(img, flow)
    assert got.shape == img.shape
    tol = 4 * np.finfo(np.float32).eps * np.abs(img).max()
    np.testing.assert_allclose(got, _reference(ref, img, flow), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("ref", REFERENCES)
def test_resample2d_bfloat16_matches_reference(ref):
    """A bfloat16 image (the bf16 glue) with float32 flow: within 2 bf16
    ulps of the image's magnitude (the plain version rounds each operation
    to bf16, as the XLA path does)."""
    img, flow = _case(5, 16, 24, 3, 5.0)
    img16 = np.asarray(jnp.asarray(img, jnp.bfloat16))
    got = _port(img16.astype(np.float32), flow, torch.bfloat16)
    want = _reference(ref, img16, flow)
    tol = 2 * 2.0 ** -8 * np.abs(img).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("ref", REFERENCES)
def test_resample2d_bitwise_at_integer_flows(ref):
    """Integer flows make every weight 0 or 1: the warp copies taps, and
    all versions agree bitwise."""
    rng = np.random.default_rng(6)
    img = rng.normal(size=(1, 16, 24, 3)).astype(np.float32)
    flow = rng.integers(-6, 7, (1, 16, 24, 2)).astype(np.float32)
    np.testing.assert_array_equal(_port(img, flow),
                                  _reference(ref, img, flow))


@pytest.mark.parametrize("h,w", [(1, 9), (9, 1), (1, 1)])
def test_resample2d_degenerate_fields(h, w):
    """One row, one column, one pixel: the reference's h < 2 / w < 2
    branches (1-D bilinear, or the single value), bitwise, in float32 and
    bfloat16."""
    img, flow = _case(7, h, w, 3, 4.0)
    np.testing.assert_array_equal(_port(img, flow),
                                  _reference("xla", img, flow))
    img16 = np.asarray(jnp.asarray(img, jnp.bfloat16))
    np.testing.assert_array_equal(
        _port(img16.astype(np.float32), flow, torch.bfloat16),
        _reference("xla", img16, flow))


def test_resample2d_takes_bfloat16_flow():
    """bf16 glue makes the flow bfloat16 too: the sample coordinates are
    computed in float32 from it, as the reference does (bitwise)."""
    img, flow = _case(8, 16, 24, 3, 5.0)
    img16 = np.asarray(jnp.asarray(img, jnp.bfloat16))
    flow16 = np.asarray(jnp.asarray(flow, jnp.bfloat16))
    got = twarp.resample2d(T(img16.astype(np.float32)).to(torch.bfloat16),
                           T(flow16.astype(np.float32)).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  _reference("xla", img16, flow16))


def test_resample2d_nchw_is_the_cascade_layout():
    """The NCHW entry the cascade calls gives the NHWC entry's values."""
    img, flow = _case(9, 13, 27, 3, 5.0)
    got = twarp.resample2d_nchw(T(img).permute(0, 3, 1, 2),
                                T(flow).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  _port(img, flow))


def test_resample2d_cpu_tensors_launch_nothing():
    """CPU tensors take the plain version and count no kernel launch; the
    kernel's wrapper refuses them."""
    img, flow = _case(10, 8, 8, 3, 2.0)
    before = twarp.resample2d_cuda.launches
    twarp.resample2d(T(img), T(flow))
    assert twarp.resample2d_cuda.launches == before
    with pytest.raises(RuntimeError, match="CUDA"):
        twarp.resample2d_cuda(T(img).permute(0, 3, 1, 2).contiguous(),
                              T(flow).permute(0, 3, 1, 2).contiguous())


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_channelnorm_matches_reference(dtype):
    """The float32 L2 norm over channels, from float32 or bfloat16 input:
    within 2 float32 ulps of the norm (summation order)."""
    x = np.random.default_rng(11).normal(size=(2, 9, 11, 3))
    x = np.asarray(jnp.asarray(x, dtype))
    want = np.asarray(jwarp.channelnorm(jnp.asarray(x)))
    got = twarp.channelnorm(T(x.astype(np.float32)).to(
        torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2.5e-7, atol=0)
    nchw = twarp.channelnorm(T(x.astype(np.float32)).permute(0, 3, 1, 2),
                             dim=1)
    np.testing.assert_allclose(nchw.permute(0, 2, 3, 1).numpy(), want,
                               rtol=2.5e-7, atol=0)


@pytest.mark.parametrize("in_shape,out_hw", [
    ((2, 64, 64, 3), (60, 64)),         # one axis, 64-rounded net size back
    ((2, 128, 128, 3), (72, 100)),      # both axes, non-integer factors
    ((1, 768, 1280, 2), (720, 1280)),   # PoseTrack's 720p flow
])
def test_resize_shrink_matches_jax_image_resize(in_shape, out_hw):
    """The antialiased shrink of jax.image.resize(..., "bilinear"): float32
    within 4e-6 of the values' magnitude (the weights and the two
    contractions rounded in another order; observed below 1e-6)."""
    x = np.random.default_rng(12).uniform(-10, 10, in_shape).astype(
        np.float32)
    n, _, _, c = in_shape
    want = np.asarray(jax.image.resize(x, (n, *out_hw, c), "bilinear"))
    got = tflownet.resize_bilinear(T(x), out_hw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=4e-6 * np.abs(x).max())
