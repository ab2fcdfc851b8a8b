"""The port's crop (kernel K1's plain version and its wrapper's contract)
against the JAX reference, on the CPU.

The CUDA kernel itself runs only on the card (chip_smoke.py holds it to the
plain version there, on these same cases at full size). Here the plain
version, which defines what the kernel computes, is held to
``flowtrack_tpu.ops.crop``; inputs come from numpy with a fixed seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flowtrack_tpu.config import IMAGENET_MEAN, IMAGENET_STD
from flowtrack_tpu.ops import crop as jcrop
from flowtrack_tpu_torch.ops import crop as tcrop

FRAME_HW = (40, 56)
# float32: the plain version and the reference's twin sum the same two taps
# per axis in float32; 1e-5 of the normalized value (|x| < 3) is a few ulp
F32_TOL = 1e-5


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def N(a):
    return np.asarray(a.detach().cpu())


def _frame(rng, dtype="float32"):
    img = rng.uniform(0, 255, (*FRAME_HW, 3))
    return img.astype(np.uint8 if dtype == "uint8" else np.float32)


def _boxes(case):
    """(centers, scales) of a named case on a 40x56 frame; scales are in
    units of 200 px, so 0.28 is the frame's width."""
    if case == "larger_than_frame":     # s > 4 at 24 columns out
        centers = [[28.0, 20.0], [10.0, 30.0]]
        scales = [[0.6, 0.8], [1.2, 1.6]]
    elif case == "off_frame":           # every tap outside the frame
        centers = [[-80.0, 20.0], [28.0, -90.0], [200.0, 150.0]]
        scales = [[0.1, 0.13], [0.1, 0.13], [0.2, 0.27]]
    elif case == "single":
        centers, scales = [[30.5, 17.25]], [[0.12, 0.16]]
    elif case == "empty":
        centers, scales = np.zeros((0, 2)), np.zeros((0, 2))
    else:
        raise KeyError(case)
    return (np.asarray(centers, np.float32).reshape(-1, 2),
            np.asarray(scales, np.float32).reshape(-1, 2))


@pytest.mark.parametrize("out_hw", [(256, 192), (384, 288), (50, 38)])
def test_crop_params_bitwise(out_hw):
    """s, tx, ty equal the reference's bit for bit over 300 seeded boxes:
    a true division by out_w, no fused multiply-add."""
    rng = np.random.default_rng(10)
    centers = rng.uniform(-200, 2100, (300, 2)).astype(np.float32)
    scales = rng.uniform(0.05, 6.0, (300, 2)).astype(np.float32)
    want = jcrop.crop_params(centers, scales, out_hw)
    got = tcrop.crop_params(T(centers), T(scales), out_hw)
    for name, a, b in zip(("sx", "tx", "sy", "ty"), got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(N(a), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("out_hw", [(32, 24), (50, 38)])
@pytest.mark.parametrize("case", ["larger_than_frame", "off_frame", "single"])
def test_crop_cases_match_reference(case, out_hw):
    """crop_frames (plain) against the reference's twin within F32_TOL."""
    rng = np.random.default_rng(11)
    img = _frame(rng)
    centers, scales = _boxes(case)
    idx = np.zeros(len(centers), np.int64)
    got = tcrop.crop_frames(T(img[None]), T(idx), T(centers), T(scales),
                            out_hw, IMAGENET_MEAN, IMAGENET_STD)
    want = np.asarray(jcrop.crop_resize_normalize(
        jnp.asarray(img), centers, scales, out_hw, IMAGENET_MEAN,
        IMAGENET_STD))
    assert got.shape == (len(centers), *out_hw, 3)
    np.testing.assert_allclose(N(got), want, atol=F32_TOL, rtol=0)


def test_off_frame_crop_is_the_normalized_zero():
    """A box wholly off the frame reads cv2's constant border: every value
    is (0 / 255 - mean) / std exactly."""
    rng = np.random.default_rng(12)
    centers, scales = _boxes("off_frame")
    idx = np.zeros(len(centers), np.int32)
    got = N(tcrop.crop_frames(T(_frame(rng, "uint8")[None]), T(idx),
                              T(centers), T(scales), (32, 24),
                              IMAGENET_MEAN, IMAGENET_STD))
    zero = ((np.float32(0) / np.float32(255) - np.asarray(IMAGENET_MEAN, np.float32))
            / np.asarray(IMAGENET_STD, np.float32))
    np.testing.assert_array_equal(got, np.broadcast_to(zero, got.shape))


def test_larger_than_frame_matches_pallas_interpret():
    """The box larger than the frame against the TPU kernel in interpret
    mode: 1e-4, the kernel's own distance from its twin on the CPU."""
    rng = np.random.default_rng(13)
    img = _frame(rng)
    centers, scales = _boxes("larger_than_frame")
    want = np.asarray(jcrop.crop_resize_normalize_pallas(
        jnp.asarray(img), jnp.asarray(centers), jnp.asarray(scales),
        (32, 24), IMAGENET_MEAN, IMAGENET_STD, interpret=True))
    got = tcrop.crop_resize_normalize(T(img), T(centers), T(scales), (32, 24),
                                      IMAGENET_MEAN, IMAGENET_STD)
    np.testing.assert_allclose(N(got), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_no_crops_give_an_empty_tensor(out_dtype):
    centers, scales = _boxes("empty")
    frames = T(_frame(np.random.default_rng(14))[None])
    got = tcrop.crop_frames(frames, torch.zeros(0, dtype=torch.int64),
                            T(centers), T(scales), (32, 24), IMAGENET_MEAN,
                            IMAGENET_STD, out_dtype=out_dtype)
    assert got.shape == (0, 32, 24, 3) and got.dtype == out_dtype


@pytest.mark.parametrize("idx_dtype", [np.int64, np.int32])
def test_frame_index_types_give_the_same_crops(idx_dtype):
    """int64 and int32 frame indices select the same frames: each crop
    equals the reference's crop of its frame."""
    rng = np.random.default_rng(15)
    frames = np.stack([_frame(rng) for _ in range(3)])
    centers = rng.uniform(0, 56, (6, 2)).astype(np.float32)
    hh = rng.uniform(0.1, 0.4, 6)
    scales = np.stack([hh * 0.75, hh], 1).astype(np.float32)
    idx = np.array([2, 0, 1, 1, 2, 0], idx_dtype)
    got = N(tcrop.crop_frames(T(frames), T(idx), T(centers), T(scales),
                              (32, 24), IMAGENET_MEAN, IMAGENET_STD))
    for i, f in enumerate(idx):
        want = np.asarray(jcrop.crop_resize_normalize(
            jnp.asarray(frames[f]), centers[i:i + 1], scales[i:i + 1],
            (32, 24), IMAGENET_MEAN, IMAGENET_STD))
        np.testing.assert_allclose(got[i:i + 1], want, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("dtype,kept", [(torch.float32, True),
                                        (torch.float64, False)])
def test_wrapper_converts_only_what_is_not_right(dtype, kept):
    """The kernel's wrapper passes float32 centers through untouched (no
    copy, so no device operation) and converts another type."""
    x = torch.zeros((4, 2), dtype=dtype)
    y = tcrop._on_device(x, x.device, (torch.float32,))
    assert (y is x) == kept and y.dtype == torch.float32 and y.is_contiguous()
    strided = torch.zeros((4, 4))[:, :2]
    assert tcrop._on_device(strided, x.device, (torch.float32,)).is_contiguous()


@pytest.mark.parametrize("dtype,want", [(torch.int64, torch.int64),
                                        (torch.int32, torch.int32),
                                        (torch.int16, torch.int64)])
def test_wrapper_keeps_both_index_types(dtype, want):
    idx = torch.zeros(4, dtype=dtype)
    got = tcrop._on_device(idx, idx.device, (torch.int64, torch.int32))
    assert got.dtype == want and (got is idx) == (dtype == want)


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback inside the kernel's wrapper: a CPU tensor raises there;
    crop_frames is what routes it to the plain version."""
    frames = torch.zeros((1, 8, 8, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        tcrop.crop_frames_cuda(frames, torch.zeros(1, dtype=torch.int64),
                               torch.zeros((1, 2)), torch.ones((1, 2)), (8, 6))
