"""The PyTorch port's ops against the JAX reference, on the CPU.

On the CPU the port's kernel wrappers take their plain PyTorch versions;
the CUDA kernels themselves are checked against those on the card by
chip_smoke.py. Inputs come from numpy with a fixed seed and go through both
packages; each assertion states its tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowtrack_tpu.config import COCO_FLIP_PAIRS, IMAGENET_MEAN, IMAGENET_STD
from flowtrack_tpu.models import flownet as jflownet
from flowtrack_tpu.ops import correlation as jcorr
from flowtrack_tpu.ops import crop as jcrop
from flowtrack_tpu.ops import decode as jdecode
from flowtrack_tpu.ops import heatmap as jheatmap
from flowtrack_tpu.ops.nms import iou_matrix as j_iou
from flowtrack_tpu.ops.oks import oks_matrix as j_oks, pose_area as j_area
from flowtrack_tpu.ops.warp import flow_gather as j_flow_gather
from flowtrack_tpu.tracking import tracker as jtracker
from flowtrack_tpu_torch.models import flownet as tflownet
from flowtrack_tpu_torch.ops import correlation as tcorr
from flowtrack_tpu_torch.ops import crop as tcrop
from flowtrack_tpu_torch.ops import decode as tdecode
from flowtrack_tpu_torch.ops import heatmap as theatmap
from flowtrack_tpu_torch.ops.nms import iou_matrix as t_iou
from flowtrack_tpu_torch.ops.oks import oks_matrix as t_oks, pose_area as t_area
from flowtrack_tpu_torch.ops.warp import flow_gather as t_flow_gather
from flowtrack_tpu_torch.tracking import clip_pipeline as tclip
from flowtrack_tpu_torch.tracking import tracker as ttracker

OUT_HW = (32, 24)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def N(a):
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)


# ---------------------------------------------------------------- crop (K1)

def _crop_case(rng, img_dtype):
    """Persons inside the frame plus boxes hanging off every edge."""
    h, w = 40, 56
    img = rng.uniform(0, 255, (h, w, 3))
    img = img.astype(np.uint8) if img_dtype == "uint8" else img.astype(np.float32)
    centers = np.array([[28, 20], [0, 20], [56, 20], [28, 0], [28, 40],
                        [-3, -4], [60, 45], [20, 15]], np.float32)
    hh = rng.uniform(0.1, 0.3, len(centers))
    scales = np.stack([hh * 0.75, hh], 1).astype(np.float32)
    return img, centers, scales


@pytest.mark.parametrize("img_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_crop_matches_reference(img_dtype, out_dtype):
    """crop_resize_normalize (plain) vs the XLA twin and the Pallas kernel
    (interpret). float32: 1e-5 against the twin (same two-tap sums), 1e-4
    against the Pallas kernel (which is itself 1e-4 from its twin on the
    CPU, tests/test_crop.py). bfloat16: one bf16 ulp at |x| < 4 (2^-6)."""
    rng = np.random.default_rng(1)
    img, centers, scales = _crop_case(rng, img_dtype)
    jdt = jnp.float32 if out_dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if out_dtype == "float32" else torch.bfloat16
    args = (centers, scales, OUT_HW, IMAGENET_MEAN, IMAGENET_STD)
    want = np.asarray(jcrop.crop_resize_normalize(
        jnp.asarray(img), *args, out_dtype=jdt), np.float32)
    pallas = np.asarray(jcrop.crop_resize_normalize_pallas(
        jnp.asarray(img), *args, out_dtype=jdt, interpret=True), np.float32)
    got = tcrop.crop_resize_normalize(T(img), T(centers), T(scales), OUT_HW,
                                      IMAGENET_MEAN, IMAGENET_STD,
                                      out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (len(centers), *OUT_HW, 3)
    got = N(got.float())
    tol = (1e-5, 1e-4) if out_dtype == "float32" else (2.0 ** -6,) * 2
    np.testing.assert_allclose(got, want, atol=tol[0], rtol=0)
    np.testing.assert_allclose(got, pallas, atol=tol[1], rtol=0)


def test_crop_zero_border_and_raw_values():
    """Without normalization the crop of a constant frame reads exactly the
    constant inside and 0 where both taps fall outside (cv2's border)."""
    img = np.full((20, 30, 3), 100.0, np.float32)
    centers = np.array([[0.0, 10.0]], np.float32)   # half off the left edge
    scales = np.array([[0.06, 0.08]], np.float32)
    got = N(tcrop.crop_resize_normalize(T(img), T(centers), T(scales), OUT_HW))
    want = np.asarray(jcrop.crop_resize_normalize(
        jnp.asarray(img), centers, scales, OUT_HW))
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert got[0, :, 0].max() == 0.0 and got[0, :, -1].min() == 100.0


def test_crop_frames_indexes_the_clip():
    """crop_frames over a clip with a frame index per crop equals the
    per-frame crop of each selected frame (0 ulp: the same plain math)."""
    rng = np.random.default_rng(2)
    frames = rng.uniform(0, 255, (3, 40, 56, 3)).astype(np.float32)
    _, centers, scales = _crop_case(rng, "float32")
    idx = np.array([2, 0, 1, 1, 0, 2, 2, 0])
    got = N(tcrop.crop_frames(T(frames), T(idx), T(centers), T(scales),
                              OUT_HW, IMAGENET_MEAN, IMAGENET_STD))
    for i, f in enumerate(idx):
        want = N(tcrop.crop_resize_normalize(
            T(frames[f]), T(centers[i:i + 1]), T(scales[i:i + 1]), OUT_HW,
            IMAGENET_MEAN, IMAGENET_STD))
        np.testing.assert_array_equal(got[i:i + 1], want)


def test_crop_params_match_reference():
    rng = np.random.default_rng(3)
    centers = rng.uniform(0, 300, (5, 2)).astype(np.float32)
    scales = rng.uniform(0.1, 2, (5, 2)).astype(np.float32)
    want = jcrop.crop_params(centers, scales, (256, 192))
    got = tcrop.crop_params(T(centers), T(scales), (256, 192))
    for a, b in zip(got, want):
        np.testing.assert_allclose(N(a), np.asarray(b), rtol=1e-7)


# --------------------------------------------------------- correlation (K2)

def test_correlation_md4_matches_reference():
    """md 4 on a small non-aligned map: plain vs correlation_xla and vs the
    Pallas kernel in interpret mode, 1e-5 (float32 sums of 32 products)."""
    rng = np.random.default_rng(4)
    f1 = rng.normal(size=(2, 9, 11, 32)).astype(np.float32)
    f2 = rng.normal(size=(2, 9, 11, 32)).astype(np.float32)
    got = N(tcorr.correlation(T(f1), T(f2), 4, 2))
    assert got.shape == (2, 9, 11, 25)
    xla = np.asarray(jcorr.correlation_xla(f1, f2, 4, 2))
    pallas = np.asarray(jcorr.correlation_pallas(f1, f2, 4, 2, block_h=4,
                                                 interpret=True))
    np.testing.assert_allclose(got, xla, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-5)


def test_correlation_md20_full_grid():
    """The production grid (md 20, stride2 2: 441 channels, dy-major) on an
    8x8x256 map, bf16 features as FlowNetC feeds them: plain vs the Pallas
    kernel in interpret mode, 1e-5 (float32 sums of exact bf16 products)."""
    rng = np.random.default_rng(5)
    f1 = rng.normal(size=(1, 8, 8, 256)).astype(np.float32)
    f2 = rng.normal(size=(1, 8, 8, 256)).astype(np.float32)
    f1b, f2b = jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16)
    want = np.asarray(jcorr.correlation_pallas(f1b, f2b, 20, 2, block_h=8,
                                               interpret=True))
    got = N(tcorr.correlation(T(f1).bfloat16(), T(f2).bfloat16(), 20, 2))
    assert got.shape == (1, 8, 8, 441) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # every read of f2 lands outside an 8x8 map beyond |d| >= 8
    assert np.all(got[..., 0] == 0.0)


@pytest.mark.parametrize("dtype,c,w,md,s2,route", [
    (torch.bfloat16, 256, 80, 20, 2, "mma"),      # the paths' volume
    (torch.bfloat16, 40, 11, 4, 1, "mma"),        # ragged: masked, not refused
    (torch.bfloat16, 64, 24, 5, 3, "mma"),
    (torch.bfloat16, 16, 256, 24, 1, "mma"),      # the farthest band
    (torch.bfloat16, 256, 240, 20, 2, "mma"),     # a 1080x1920 video's map
    (torch.bfloat16, 256, 257, 20, 2, "mma"),     # two groups of columns
    (torch.bfloat16, 1024, 80, 20, 2, "mma"),     # channels in chunks
    (torch.bfloat16, 256, 80, 40, 4, "cuda_core"),  # a band over 64 columns
    (torch.float32, 32, 11, 4, 1, "cuda_core"),
    (torch.float32, 256, 80, 20, 2, "cuda_core"),
])
def test_correlation_route_by_dtype(dtype, c, w, md, s2, route):
    """bfloat16 features take the tensor-core kernel at any channel count
    and width, float32 features the CUDA-core kernel (the float32 contract
    admits no bf16 or TF32 product), as do bfloat16 features displaced
    further than a warp pair's band."""
    assert tcorr.correlation_route(dtype, c, w, md, s2) == route


@pytest.mark.parametrize("dtype,c,w,md,s2,error,match", [
    (torch.bfloat16, 256, 80, 25, 1, ValueError, "at most 21 displacements"),
    (torch.bfloat16, 256, 80, 44, 4, ValueError, "at most 21 displacements"),
    (torch.bfloat16, 16, 4000, 4, 1, ValueError, "shared memory"),
    (torch.float32, 32, 11, 11, 1, ValueError, "at most 21 displacements"),
    (torch.float16, 32, 11, 4, 1, TypeError, "bfloat16 or float32"),
    (torch.bfloat16, 32, 11, 4, 0, ValueError, "stride2 >= 1"),
    (torch.float32, 32, 11, -1, 1, ValueError, "max_displacement >= 0"),
])
def test_correlation_route_refuses(dtype, c, w, md, s2, error, match):
    with pytest.raises(error, match=match):
        tcorr.correlation_route(dtype, c, w, md, s2)


@pytest.mark.parametrize("c,w,kc,groups", [
    (256, 80, 256, 1),      # the paths' map: both rows whole, two blocks an SM
    (40, 11, 48, 1),        # channels rounded up to 16
    (256, 240, 128, 1),     # 1080x1920 frames: 253,952 bytes whole, so halves
    (512, 256, 176, 1),     # thirds, rounded up to 16
    (1024, 80, 512, 1),     # halves
    (32, 300, 32, 2),       # a map wider than one block's 256 columns
    (16, 3600, 16, 15),     # the widest 16 channels fit
])
def test_correlation_band_shared_memory(c, w, kc, groups):
    """Two staged rows of kc channels, columns rounded to 16 plus 8 of
    padding: the fewest equal channel chunks that stay under a block's
    232,448 bytes, and one block per 256 columns."""
    plan = tcorr.band_plan(c, w)
    wp = -(-w // 16) * 16
    assert plan == (kc, 2 * kc * (wp + 8) * 2, groups)
    assert plan.smem_bytes <= tcorr.SMEM_LIMIT and kc % 16 == 0
    cp = -(-c // 16) * 16
    chunks = -(-cp // kc)
    # no fewer chunks would fit
    assert chunks == 1 or (2 * (wp + 8) * 2
                           * (-(-cp // (chunks - 1) // 16) * 16)
                           > tcorr.SMEM_LIMIT)


def test_correlation_wrapper_refuses_cpu_and_mismatched_tensors():
    f = torch.zeros((1, 16, 4, 8), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcorr.correlation_cuda(f, f, 4, 1)
    before = tcorr.correlation_cuda.launches
    out = tcorr.correlation_nchw(f, f, 4, 1)       # the plain version
    assert out.shape == (1, 81, 4, 8) and out.dtype == torch.float32
    assert tcorr.correlation_cuda.launches == before


def test_correlation_nchw_is_the_nhwc_volume():
    rng = np.random.default_rng(6)
    f1 = rng.normal(size=(2, 5, 6, 8)).astype(np.float32)
    f2 = rng.normal(size=(2, 5, 6, 8)).astype(np.float32)
    nhwc = N(tcorr.correlation(T(f1), T(f2), 2, 1))
    nchw = N(tcorr.correlation_nchw(T(f1).permute(0, 3, 1, 2),
                                    T(f2).permute(0, 3, 1, 2), 2, 1))
    np.testing.assert_array_equal(nchw, nhwc.transpose(0, 3, 1, 2))


def test_displacement_grid():
    assert tcorr.displacement_grid(20, 2) == jcorr.displacement_grid(20, 2)
    assert len(tcorr.displacement_grid(20, 2)) == 21


# ------------------------------------------------------- flip merge, decode

@pytest.mark.parametrize("shift", [True, False])
def test_flip_merge_matches_reference(shift):
    """Pure data movement and one average: equal to 0 ulp."""
    rng = np.random.default_rng(7)
    hm = rng.normal(size=(3, 8, 6, 17)).astype(np.float32)
    hf = rng.normal(size=(3, 8, 6, 17)).astype(np.float32)
    want = np.asarray(jheatmap.merge_flip_test(hm, hf, COCO_FLIP_PAIRS,
                                               shift=shift))
    got = N(theatmap.merge_flip_test(T(hm), T(hf), COCO_FLIP_PAIRS,
                                     shift=shift))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("post_process", [True, False])
def test_decode_matches_reference(post_process):
    """get_final_preds + rescore: float32 geometry, 1e-4 px; maxvals exact."""
    rng = np.random.default_rng(8)
    hm = rng.normal(size=(4, 16, 12, 17)).astype(np.float32)
    hm[0, :, :, 3] = -1.0                      # max <= 0: coordinates zeroed
    centers = rng.uniform(50, 200, (4, 2)).astype(np.float32)
    scales = rng.uniform(0.3, 1.5, (4, 2)).astype(np.float32)
    wp, wm = jdecode.get_final_preds(hm, centers, scales, post_process)
    gp, gm = tdecode.get_final_preds(T(hm), T(centers), T(scales),
                                     post_process)
    np.testing.assert_allclose(N(gp), np.asarray(wp), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(N(gm), np.asarray(wm))
    box = rng.uniform(0.5, 1, 4).astype(np.float32)
    np.testing.assert_allclose(
        N(tdecode.rescore(T(box), gm, 0.2)),
        np.asarray(jdecode.rescore(box, wm, 0.2)), rtol=1e-6)


def test_decode_argmax_tie_takes_first_index():
    """Two equal peaks: both packages decode the first in row-major order."""
    hm = np.zeros((1, 8, 8, 1), np.float32)
    hm[0, 5, 2, 0] = hm[0, 2, 6, 0] = 1.0       # (y=2, x=6) comes first
    want_p, want_m = jdecode.get_max_preds(hm)
    got_p, got_m = tdecode.get_max_preds(T(hm))
    np.testing.assert_array_equal(N(got_p), np.asarray(want_p))
    assert N(got_p)[0, 0].tolist() == [6.0, 2.0]
    np.testing.assert_array_equal(N(got_m), np.asarray(want_m))


def test_blur_heatmaps_matches_reference():
    rng = np.random.default_rng(9)
    hm = rng.uniform(0, 1, (2, 12, 10, 3)).astype(np.float32)
    want = np.asarray(jdecode.blur_heatmaps(hm, 5))
    got = N(tdecode.blur_heatmaps(T(hm), 5))
    np.testing.assert_allclose(got, want, atol=1e-6)


# ------------------------------------------------- tracking primitives

def test_oks_area_iou_match_reference():
    """float32 elementwise math in the same order: 1e-6 relative."""
    rng = np.random.default_rng(10)
    a = rng.uniform(0, 100, (5, 17, 2)).astype(np.float32)
    b = rng.uniform(0, 100, (6, 17, 2)).astype(np.float32)
    b[2] = a[1] + rng.normal(0, 2, (17, 2))
    b[4] = 0.0                                   # zero-area pose
    np.testing.assert_allclose(N(t_area(T(a))), np.asarray(j_area(a)),
                               rtol=1e-6)
    want = np.asarray(j_oks(a, j_area(a), b, j_area(b)))
    got = N(t_oks(T(a), t_area(T(a)), T(b), t_area(T(b))))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[1, 2] > 0.5          # the near-copy of a[1] matches
    boxes_a = np.concatenate([a[:, 0], a[:, 0] + 20], 1)
    boxes_b = np.concatenate([b[:, 1], b[:, 1] + 15], 1)
    np.testing.assert_allclose(N(t_iou(T(boxes_a), T(boxes_b))),
                               np.asarray(j_iou(boxes_a, boxes_b)), rtol=1e-6)


def test_flow_gather_and_propagation_match_reference():
    """Bilinear, edge-clamped (points off the map included): 1e-5."""
    rng = np.random.default_rng(11)
    flow = rng.normal(0, 3, (12, 16, 2)).astype(np.float32)
    pts = rng.uniform(-4, 20, (5, 17, 2)).astype(np.float32)
    np.testing.assert_allclose(N(t_flow_gather(T(flow), T(pts))),
                               np.asarray(j_flow_gather(flow, pts)),
                               atol=1e-5)
    np.testing.assert_allclose(
        N(ttracker.propagate_poses(T(pts), T(flow))),
        np.asarray(jtracker.propagate_poses(pts, flow)), atol=1e-5)
    np.testing.assert_allclose(
        N(ttracker.boxes_from_poses(T(pts), 0.15)),
        np.asarray(jtracker.boxes_from_poses(pts, 0.15)), atol=1e-5)


def _greedy_cases():
    rng = np.random.default_rng(12)
    rand = rng.uniform(0, 1, (5, 7)).astype(np.float32)
    ties = np.array([[0.9, 0.9, 0.2], [0.9, 0.9, 0.9], [0.1, 0.9, 0.9]],
                    np.float32)
    return [
        (rand, None, None),
        (rand, rng.uniform(size=5) > 0.3, rng.uniform(size=7) > 0.3),
        (ties, None, None),                       # equal scores everywhere
        (ties, np.array([True, False, True]), None),
        (np.full((4, 4), -np.inf, np.float32), None, None),
        (rand[:3], np.zeros(3, bool), np.ones(7, bool)),   # all rows padded
    ]


@pytest.mark.parametrize("case", range(6))
def test_greedy_match_matches_reference(case):
    """Equal assignments, including -inf padding and tied similarities
    (the first maximum in row-major order wins)."""
    sim, rv, cv = _greedy_cases()[case]
    want = np.asarray(jtracker.greedy_match(
        sim, 0.3, None if rv is None else jnp.asarray(rv),
        None if cv is None else jnp.asarray(cv)))
    got = N(ttracker.greedy_match(T(sim), 0.3,
                                  None if rv is None else T(rv),
                                  None if cv is None else T(cv)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_top_k_breaks_ties_like_lax_top_k():
    """Equal values (and -inf slots) come out lower index first."""
    x = np.array([0.5, -np.inf, 0.9, 0.5, -np.inf, 0.9, 0.1], np.float32)
    for k in (1, 3, 5, 7):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = tclip._top_k(T(x), k)
        np.testing.assert_array_equal(N(gi), np.asarray(wi))
        np.testing.assert_array_equal(N(gv), np.asarray(wv))


def test_assign_ids_matches_reference():
    from flowtrack_tpu.tracking import clip_pipeline as jclip

    assign = np.array([2, -1, 0, -1, -1], np.int32)
    cvalid = np.array([True, True, True, False, True])
    tids = np.array([7, 8, 9], np.int32)
    wi, wn = jclip._assign_ids(jnp.asarray(assign), jnp.asarray(cvalid),
                               jnp.asarray(tids), jnp.asarray(10, jnp.int32))
    gi, gn = tclip._assign_ids(T(assign), T(cvalid), T(tids),
                               torch.tensor(10, dtype=torch.int32))
    np.testing.assert_array_equal(N(gi), np.asarray(wi))
    assert int(gn) == int(wn) == 12


# ------------------------------------------------------------ flow pre/post

@pytest.mark.parametrize("in_hw,out_hw", [((16, 24), (64, 96)),
                                          ((72, 100), (128, 128)),
                                          ((18, 25), (72, 100))])
def test_resize_matches_jax_image_resize(in_hw, out_hw):
    """Enlarging bilinear: F.interpolate (align_corners=False) against
    jax.image.resize at x4 and at non-integer factors, where jax
    renormalises the in-image taps and torch clamps the source coordinate:
    the two agree to 1e-5 on values of order 10."""
    rng = np.random.default_rng(13)
    x = rng.uniform(0, 10, (2, *in_hw, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, *out_hw, 3), "bilinear"))
    got = N(tflownet.resize_bilinear(T(x), out_hw))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("in_hw,out_hw", [((16, 24), (12, 40)),
                                          ((20, 16), (40, 12))])
def test_resize_shrinks_like_jax_image_resize(in_hw, out_hw):
    """A resize that shrinks one axis and enlarges the other takes jax's
    weights on both (antialiased triangle on the shrinking axis): float32
    within 1e-6 of values of order 10 (observed 1e-6)."""
    rng = np.random.default_rng(15)
    x = rng.uniform(0, 10, (2, *in_hw, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, *out_hw, 3), "bilinear"))
    got = N(tflownet.resize_bilinear(T(x), out_hw))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_preprocess_and_postprocess_flow_match_reference():
    """Frames of 72x100 (not a multiple of 64): the pair normalisation
    (1e-6) and the quarter-resolution flow brought to frame size with its
    components rescaled (values of order 50: 1e-4, a few float32 ulp)."""
    rng = np.random.default_rng(14)
    im1 = rng.integers(0, 256, (2, 72, 100, 3), np.uint8)
    im2 = rng.integers(0, 256, (2, 72, 100, 3), np.uint8)
    np.testing.assert_allclose(
        N(tflownet.preprocess_pair(T(im1), T(im2))),
        np.asarray(jflownet.preprocess_pair(im1, im2)), atol=1e-6)
    q = rng.normal(size=(2, 32, 32, 2)).astype(np.float32)
    want = np.asarray(jflownet.postprocess_flow(q, "flownet_c", (72, 100)))
    got = N(tflownet.postprocess_flow(T(q), "flownet_c", (72, 100)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        N(tflownet.flow_at_full_res(T(q))),
        np.asarray(jflownet.flow_at_full_res(q)), atol=1e-4, rtol=0)


@pytest.mark.parametrize("variant", ["flownet2", "flownet2_cs",
                                     "flownet2_css"])
def test_postprocess_full_res_flow_matches_reference(variant):
    """The cascades' full-resolution flow at the /64 net size (64x128)
    back to 60x100 frames: no x4 and no div_flow, the antialiased shrink
    and the components rescaled (values of order 20: 1e-4)."""
    flow = np.random.default_rng(16).normal(0, 8, (2, 64, 128, 2)).astype(
        np.float32)
    want = np.asarray(jflownet.postprocess_flow(flow, variant, (60, 100)))
    got = N(tflownet.postprocess_flow(T(flow), variant, (60, 100)))
    assert got.shape == want.shape == (2, 60, 100, 2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert not tflownet.flow_output_is_full_res("flownet_sd")


# ----------------------------------- divisions by a constant, bit for bit
# On a CUDA device PyTorch divides a tensor by a Python scalar as a multiply
# by the rounded reciprocal; the port divides by a tensor at each such site,
# so its CPU run (and chip_smoke holds the card's to the CPU's) is the
# reference's to the bit.

def test_box_xyxy_to_center_scale_matches_reference_bitwise():
    """The recovery crops' centers and scales (w / 0.75, / 200), on
    aspect-wide and aspect-tall boxes of any size: equal bits."""
    from flowtrack_tpu.tracking import clip_pipeline as jclip

    rng = np.random.default_rng(20)
    xy = rng.uniform(-50, 600, (4096, 2))
    wh = rng.uniform(0.5, 400, (4096, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    for aspect in (192 / 256, 288 / 384, 48 / 64):
        want = jclip._box_xyxy_to_center_scale(jnp.asarray(boxes), aspect)
        got = tclip._box_xyxy_to_center_scale(T(boxes), aspect)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(N(g), np.asarray(w))
    # leading lane axes change nothing
    lanes = tclip._box_xyxy_to_center_scale(T(boxes.reshape(4, 1024, 4)),
                                            0.75)
    flat = tclip._box_xyxy_to_center_scale(T(boxes), 0.75)
    for a, b in zip(lanes, flat):
        np.testing.assert_array_equal(N(a).reshape(-1, 2), N(b))


@pytest.mark.parametrize("out_wh", [(48, 64), (72, 96), (12, 16)])
def test_affine_transform_inv_matches_reference_bitwise(out_wh):
    """The decode's inverse map (scale * 200 / dst_w): equal bits."""
    from flowtrack_tpu.ops.affine import get_affine_transform_jax
    from flowtrack_tpu_torch.ops.affine import get_affine_transform_inv

    rng = np.random.default_rng(21)
    centers = rng.uniform(0, 640, (2048, 2)).astype(np.float32)
    scales = rng.uniform(0.05, 4.0, (2048, 2)).astype(np.float32)
    want = np.asarray(get_affine_transform_jax(centers, scales, 0.0, out_wh,
                                               inv=True))
    got = N(get_affine_transform_inv(T(centers), T(scales), out_wh))
    np.testing.assert_array_equal(got, want)


def test_preprocess_pair_matches_reference_bitwise():
    """uint8 pairs: the per-pair channel mean (jnp.mean: the sum, exact
    here as every partial sum is an integer below 2^24, times the float32
    1 / count) and the true division by 255 give equal bits; float frames
    within 4 float32 ulps of |x| < 1 (the reference's float32 sum of 4480
    values rounds in its own order, the port's float64 sum once; observed
    2 ulps)."""
    rng = np.random.default_rng(22)
    im1 = rng.integers(0, 256, (3, 40, 56, 3), np.uint8)
    im2 = rng.integers(0, 256, (3, 40, 56, 3), np.uint8)
    np.testing.assert_array_equal(
        N(tflownet.preprocess_pair(T(im1), T(im2))),
        np.asarray(jflownet.preprocess_pair(im1, im2)))
    f1, f2 = (rng.uniform(0, 255, (2, 40, 56, 3)).astype(np.float32)
              for _ in range(2))
    np.testing.assert_allclose(
        N(tflownet.preprocess_pair(T(f1), T(f2))),
        np.asarray(jflownet.preprocess_pair(f1, f2)), rtol=0, atol=2 ** -21)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cascade_divisions_match_reference_bitwise(dtype):
    """FlowNet2's stage input ``flow / div_flow`` and the SD branch's
    ``flow / div_flow`` (``flownet._div``), in the glue's dtype: equal bits
    to jax's division."""
    rng = np.random.default_rng(23)
    flow = rng.normal(0, 30, (2, 2, 24, 32)).astype(np.float32)
    want = np.asarray((jnp.asarray(flow).astype(dtype) / 20.0)
                      .astype(jnp.float32))
    got = N(tflownet._div(T(flow).to(getattr(torch, dtype)), 20.0).float())
    np.testing.assert_array_equal(got, want)
    # the stage input carries that quotient as channels 9:11
    from flowtrack_tpu_torch.config import FlowConfig

    net = tflownet.get_flow_net(FlowConfig(variant="flownet2_cs",
                                           dtype="float32"))
    x = T(rng.normal(0, 1, (2, 6, 24, 32)).astype(np.float32))
    stage = N(net._stage_input(x, T(flow)))
    np.testing.assert_array_equal(stage[:, 9:11],
                                  np.asarray(jnp.asarray(flow) / 20.0))
