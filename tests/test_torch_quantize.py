"""The port's int8 post-training quantization against the JAX package.

``flowtrack_tpu_torch/models/quantize.py`` (QuantConv, PoseResNetQ, the
prequantized tree, calibration, quantize_pose_model) and the int8 product
of ``ops/int8_conv.py``, on R18 at 64x64 crops with the reference test's
``CFG``: random weights and batch-norm statistics from seeded numpy, filled
into the reference's variable shapes (``jax.eval_shape``, no compile of
init), both packages fed the same arrays. The reference runs op by op
(``apply`` outside jit), the port on the CPU, where the int8 product is the
float64 plain version; the GEMM route (the card's) is held to it here on
CPU tensors. Then a ClipTracker with the prequantized R18 and FlowNetS
against the JAX ClipTracker with ``QuantPoseAdapter``, and the port alone
through the checks of ``tests/test_quantize.py``.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from flowtrack_tpu.config import Config, FlowConfig, ModelConfig
from flowtrack_tpu.models import quantize as jq
from flowtrack_tpu.models.flownet import get_flow_net as jax_flow_net
from flowtrack_tpu.models.pose_resnet import get_pose_net as jax_pose_net
from flowtrack_tpu.tracking.clip_pipeline import ClipTracker as JaxClipTracker
from flowtrack_tpu_torch.models import quantize as tq
from flowtrack_tpu_torch.models.flownet import get_flow_net
from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
from flowtrack_tpu_torch.ops import int8_conv
from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker
from flowtrack_tpu_torch.utils.convert import (
    conv_kernel_to_torch,
    deconv_kernel_to_torch,
    load_flownet,
    load_pose_resnet,
    load_quant_pose,
)
from tests.test_torch_fused_resnet import P, _clip, _random_variables

CFG = ModelConfig(num_layers=18, image_size=(64, 64), heatmap_size=(16, 16),
                  dtype="float32")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(y):
    return y.permute(0, 2, 3, 1).numpy()


def _ref_apply(qmodel, params, quant, x, **kw):
    return qmodel.apply({"params": params, "quant": quant}, jnp.asarray(x),
                        calibrate=False, **kw)


def _ref_calibrated(qmodel, folded, x):
    """The reference's calibration from zero scales, without a compile of
    init: the quant collection's shapes from ``jax.eval_shape``."""
    shapes = jax.eval_shape(lambda: qmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x), calibrate=False,
        quantized=False))["quant"]
    zeros = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                   shapes)
    return jq.calibrate(qmodel, {"params": folded, "quant": zeros},
                        [jnp.asarray(x)])["quant"]


@pytest.fixture(scope="module")
def r18():
    """The reference's R18 variables, its folded tree and calibrated scales
    at float32, the calibration batch (NHWC), and the port's float model and
    runtime-int8 model built from them by the port's own fold and
    calibration."""
    v = _random_variables(jax_pose_net(CFG), (1, 64, 64, 3),
                          np.random.default_rng(0))
    x = np.random.default_rng(1).normal(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    folded = jq.fold_pose_resnet(v)
    quant = _ref_calibrated(jq.PoseResNetQ(cfg=CFG), folded, x)
    port = load_pose_resnet(get_pose_net(CFG), v)
    qport = tq.quantize_pose_model(port, CFG, [_nchw(x)])
    return dict(v=v, x=x, folded=folded, quant=quant, port=port, qport=qport)


def _amax_pairs(quant, qmodel):
    """(port buffer name, reference amax, port amax) for every conv."""
    ref = {".".join(k.key for k in path[:-1]): float(leaf) for path, leaf in
           jax.tree_util.tree_flatten_with_path(_np(quant))[0]}
    port = {name.removesuffix(".amax"): float(b)
            for name, b in qmodel.named_buffers() if name.endswith("amax")}
    assert sorted(ref) == sorted(port)
    return [(k, ref[k], port[k]) for k in sorted(ref)]


# ---------------------------------------------------------------------------
# The int8 product: plain version and the card's GEMM route
# ---------------------------------------------------------------------------


def _patch_sum(x, w, stride, pad):
    """int64 numpy conv by explicit patch sums: x (N, C, H, W), w (O, C,
    k, k)."""
    x = np.pad(x.astype(np.int64), ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    k = w.shape[2]
    ho = (x.shape[2] - k) // stride + 1
    wo = (x.shape[3] - k) // stride + 1
    out = np.zeros((x.shape[0], w.shape[0], ho, wo), np.int64)
    for a in range(k):
        for b in range(k):
            win = x[:, :, a:a + stride * (ho - 1) + 1:stride,
                    b:b + stride * (wo - 1) + 1:stride]
            out += np.einsum("nchw,oc->nohw", win,
                             w[:, :, a, b].astype(np.int64))
    return out


@pytest.mark.parametrize("sign", [1, -1])
def test_plain_int8_conv_is_exact_at_the_extremes(sign):
    """K = 3 * 3 * 512 = 4608 at +-127 (the largest 3x3 sums of R50, ~7.4e7)
    and a random mix: the float64 plain version equals an int64 patch sum."""
    rng = np.random.default_rng(2)
    x = np.full((1, 512, 4, 4), 127, np.int8)
    x[0, :, 0, 0] = rng.integers(-127, 128, 512)
    w = np.full((8, 512, 3, 3), sign * 127, np.int8)
    w[1] = rng.integers(-127, 128, (512, 3, 3))
    got = int8_conv.int8_conv2d_plain(torch.from_numpy(x),
                                      torch.from_numpy(w), 1, 1)
    want = _patch_sum(x, w, 1, 1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert abs(want).max() == 4608 * 127 * 127


@pytest.mark.parametrize("k,stride,cin,cout,hw,transpose", [
    (1, 1, 64, 256, 9, False),
    (1, 2, 256, 512, 9, False),
    (3, 1, 64, 64, 7, False),
    (3, 2, 128, 128, 9, False),
    (7, 2, 3, 64, 16, False),      # the stem: K = 147 padded to 152
    (4, 2, 64, 32, 5, True),       # a deconv of the head
    (3, 1, 16, 12, 3, False),      # Cout 12 padded; 9 rows an image
])
def test_gemm_route_matches_plain(k, stride, cin, cout, hw, transpose):
    """The card's route (patch matrix + ``torch._int_mm``), run on CPU
    tensors, equals the plain version bit for bit; a small ``max_bytes``
    splits the batch into chunks of one image (the last case's 9 rows are
    padded to cuBLASLt's 17)."""
    rng = np.random.default_rng(k * 10 + stride)
    pad = (k - 2) // 2 if transpose else (k - 1) // 2
    x = torch.from_numpy(rng.integers(-127, 128, (2, cin, hw, hw), np.int8))
    wshape = (cin, cout, k, k) if transpose else (cout, cin, k, k)
    w = torch.from_numpy(rng.integers(-127, 128, wshape, np.int8))
    want = int8_conv.int8_conv2d_plain(x, w, stride, pad, transpose)
    before = int8_conv.int8_conv2d_gemm.launches
    got = int8_conv.int8_conv2d_gemm(x, w, stride, pad, transpose)
    assert int8_conv.int8_conv2d_gemm.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    chunked = int8_conv.int8_conv2d_gemm(x, w, stride, pad, transpose,
                                         max_bytes=1)
    assert int8_conv.int8_conv2d_gemm.launches == before + 3
    assert torch.equal(chunked, want)


def test_dispatch_by_device():
    """A CPU tensor takes the plain version and launches no GEMM; a device
    that is neither CPU nor CUDA raises."""
    x = torch.randint(-127, 128, (1, 8, 5, 5), dtype=torch.int8)
    w = torch.randint(-127, 128, (8, 8, 3, 3), dtype=torch.int8)
    before = int8_conv.int8_conv2d_gemm.launches
    assert torch.equal(int8_conv.int8_conv2d(x, w, 1, 1),
                       int8_conv.int8_conv2d_plain(x, w, 1, 1))
    assert int8_conv.int8_conv2d_gemm.launches == before
    with pytest.raises(RuntimeError, match="CPU or CUDA"):
        int8_conv.int8_conv2d(x.to("meta"), w.to("meta"), 1, 1)
    with pytest.raises(TypeError, match="int8"):
        int8_conv.int8_conv2d(x.float(), w, 1, 1)


def test_patch_matrix_pads_the_stem_and_gemm_weight_matches():
    """The stem's 7x7x3 window: K 147 padded to 152 with zero columns,
    ordered (row tap, column tap, channel) as ``gemm_weight``'s rows."""
    x = torch.arange(2 * 10 * 10 * 3, dtype=torch.int32).remainder(
        255).sub(127).to(torch.int8).reshape(2, 10, 10, 3)
    a = int8_conv.patch_matrix(x, 7, 2, 152)
    assert a.shape == (2 * 2 * 2, 152)
    assert (a[:, 147:] == 0).all()
    assert torch.equal(a[3, :147].reshape(7, 7, 3), x[0, 2:9, 2:9])
    w = torch.randint(-127, 128, (64, 3, 7, 7), dtype=torch.int8)
    b = int8_conv.gemm_weight(w)
    assert b.shape == (152, 64) and (b[147:] == 0).all()
    assert b[(2 * 7 + 5) * 3 + 1, 9] == w[9, 1, 2, 5]


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


def test_prequantized_tree_matches_reference(r18):
    """The port's fold + ``prequantize_params`` give the reference's wq,
    w_scale and bias bit for bit (the same float32 numpy recipe)."""
    want = jax.tree_util.tree_flatten_with_path(
        _np(jq.prequantize_params(r18["folded"])))[0]
    got = tq.prequantize_params(tq.fold_pose_resnet(r18["port"]))
    assert len(jax.tree_util.tree_leaves(got)) == len(want)
    for path, leaf in want:
        node = got
        for key in path:
            node = node[key.key]
        assert node.dtype == (torch.int8 if path[-1].key == "wq"
                              else torch.float32)
        np.testing.assert_array_equal(node.numpy(), leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_calibration_matches_reference(r18):
    """Every conv's activation absmax after calibration at float32 equals
    the reference's within rtol 1e-5 (the float convs sum in other
    orders)."""
    pairs = _amax_pairs(r18["quant"], r18["qport"])
    assert len(pairs) == 1 + 8 * 2 + 3 + 3  # stem, blocks, downsamples, head
    for name, ref, got in pairs:
        assert got > 0
        np.testing.assert_allclose(got, ref, rtol=1e-5, err_msg=name)


def test_folded_float32_matches_reference(r18):
    qmodel = jq.PoseResNetQ(cfg=CFG)
    want = np.asarray(_ref_apply(qmodel, r18["folded"], r18["quant"],
                                 r18["x"], quantized=False))
    got = r18["qport"](_nchw(r18["x"]), quantized=False)
    np.testing.assert_allclose(_nhwc(got), want, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("k,stride,cin,cout,hw,transpose", [
    (7, 2, 3, 64, 64, False),      # R18's stem
    (3, 1, 64, 64, 16, False),     # layer1
    (3, 2, 64, 128, 16, False),    # layer2_0.conv1
    (1, 2, 64, 128, 16, False),    # layer2_0's downsample
    (1, 1, 64, 128, 8, False),
    (4, 2, 512, 256, 2, True)])    # deconv0
def test_quant_conv_int8_matches_reference(k, stride, cin, cout, hw,
                                           transpose):
    """One QuantConv in int8 on the same float input, weights, bias and
    absmax (a little under max|x|, so some inputs clip): equal to the
    reference's bit for bit. R18's own shapes at batch 2, which the
    reference compiles once for this test and the whole-model one."""
    rng = np.random.default_rng(k + 10 * stride)
    pad = (k - 2) // 2 if transpose else (k - 1) // 2
    x = rng.normal(0, 1, (2, hw, hw, cin)).astype(np.float32)
    kernel = rng.normal(0, 0.2, (k, k, cin, cout)).astype(np.float32)
    bias = rng.normal(0, 0.1, cout).astype(np.float32)
    amax = np.float32(0.9 * np.abs(x).max())
    ref = jq.QuantConv(cout, k, stride, pad, transpose=transpose)
    want = np.asarray(ref.apply(
        {"params": {"kernel": kernel, "bias": bias},
         "quant": {"amax": jnp.asarray(amax)}}, jnp.asarray(x)))
    conv = tq.QuantConv(cin, cout, k, stride, pad, transpose=transpose)
    to_torch = deconv_kernel_to_torch if transpose else conv_kernel_to_torch
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(to_torch(kernel)))
        conv.bias.copy_(torch.from_numpy(bias))
        conv.amax.fill_(float(amax))
    got = conv(_nchw(x))
    np.testing.assert_array_equal(_nhwc(got), want)


def _record_ref_inputs(qmodel, params, quant, x):
    seen = []

    def record(next_fun, args, kwargs, context):
        if (isinstance(context.module, jq.QuantConv)
                and context.method_name == "__call__"):
            seen.append(np.asarray(args[0]))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(record):
        out = np.asarray(_ref_apply(qmodel, params, quant, x))
    return out, seen


def _record_port_inputs(qmodel, x):
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: seen.append((name, _nhwc(args[0]))))
        for name, m in qmodel.named_modules()
        if isinstance(m, tq.QuantConv)]
    try:
        out = _nhwc(qmodel(_nchw(x)))
    finally:
        for h in hooks:
            h.remove()
    return out, seen


def _codes(x, amax):
    a_scale = np.maximum(np.float32(amax), np.float32(1e-6)) / np.float32(127)
    return np.clip(np.round(x / a_scale), -127, 127)


def _code_diffs(port_in, ref_in, amax):
    """(differing codes, codes) over every conv's input, each side's input
    quantized with its own absmax."""
    assert len(ref_in) == len(port_in) == len(amax)
    differ = total = 0
    for (name, xp), xr in zip(port_in, ref_in):
        cr, cp = _codes(xr, amax[name][0]), _codes(xp, amax[name][1])
        differ += int((cr != cp).sum())
        total += cr.size
    return differ, total


def test_int8_r18_matches_reference(r18):
    """The whole R18 in int8 on the same folded weights and absmax values
    (the reference's, loaded into the port's runtime-int8 model): heatmaps
    within 1e-3 of the reference's peak (measured 2.2e-7 of it, the float32
    head's summation order) and no activation code apart.

    Each package calibrated by itself, the absmax values agree within rtol
    1e-5 (test_calibration_matches_reference) but not bit for bit, and a
    code that lands one step apart at a rounding boundary grows through the
    random-weight net (measured: 1 code of 32768 apart at layer1_1.conv2,
    3520 at deconv2, 12405 of 401408 in all, heatmaps 3.5% of the peak
    apart, correlation 0.99967): held there, as the reference holds int8
    against float, to a correlation above 0.98."""
    qmodel = jq.PoseResNetQ(cfg=CFG)
    want, ref_in = _record_ref_inputs(qmodel, r18["folded"], r18["quant"],
                                      r18["x"])
    same = load_quant_pose(tq.PoseResNetQ(CFG), {
        "params": tq.fold_pose_resnet(r18["port"]), "quant": r18["quant"]})
    got, port_in = _record_port_inputs(same, r18["x"])
    amax = {name: (ref, ref) for name, ref, _ in
            _amax_pairs(r18["quant"], r18["qport"])}
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-3 * peak
    assert _code_diffs(port_in, ref_in, amax) == (0, 401408)

    own = _nhwc(r18["qport"](_nchw(r18["x"])))
    assert np.corrcoef(own.ravel(), want.ravel())[0, 1] > 0.98


def test_reference_variables_load_and_match(r18):
    """The reference's prequantized variables (int8 weights, its own absmax)
    load into the port's prequantized model; the forward then equals the
    reference's but for the float32 head's summation order. A float tree
    does not load into a prequantized model, nor an incomplete one."""
    params = _np(jq.prequantize_params(r18["folded"]))
    variables = {"params": params, "quant": _np(r18["quant"])}
    want = np.asarray(_ref_apply(jq.PoseResNetQ(cfg=CFG, prequantized=True),
                                 params, r18["quant"], r18["x"]))
    port = load_quant_pose(tq.PoseResNetQ(CFG, prequantized=True), variables)
    got = _nhwc(port(_nchw(r18["x"])))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(RuntimeError, match="Missing"):
        load_quant_pose(tq.PoseResNetQ(CFG, prequantized=True),
                        {"params": _np(r18["folded"])})
    partial = {**params}
    del partial["deconv2"]
    with pytest.raises(RuntimeError, match="Missing"):
        load_quant_pose(tq.PoseResNetQ(CFG, prequantized=True),
                        {"params": partial})


def test_mixed_bf16_matches_reference(r18):
    """The mixed rule (int8 for 1x1 convs and <= 64-channel inputs, bf16
    elsewhere), each package calibrated in bf16: within 2e-2 of the
    reference's peak."""
    qmodel = jq.PoseResNetQ(cfg=CFG, mixed=True, compute_dtype=jnp.bfloat16)
    quant = _ref_calibrated(qmodel, r18["folded"], r18["x"])
    want = np.asarray(_ref_apply(qmodel, r18["folded"], quant, r18["x"]))
    port = tq.quantize_pose_model(r18["port"], CFG, [_nchw(r18["x"])],
                                  mixed=True, compute_dtype=torch.bfloat16)
    got = _nhwc(port(_nchw(r18["x"])))
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_int8_clip_tracker_matches_reference(r18):
    """Two chained 4-frame clips (64x64 frames, a detection dropped in the
    second) through ClipTracker with the prequantized R18 and FlowNetS,
    against the JAX ClipTracker with ``QuantPoseAdapter`` on the same
    variables. The tracker's config is bf16, as ``BENCH_QUANT=pre`` keeps
    the run's: both crop in bf16 and the quantized net casts the crops to
    float32. ids and valid equal; at least 90% of the detector slots' valid
    joints within 0.5 px (measured 98.5% and 100%; the jitted reference
    divides and multiplies in its own way, so a code can land one step
    apart and move a joint whose heatmap holds two near-equal cells), their
    maxvals within 2^-5 of the peak (measured 0.97% and 1.7e-7)."""
    cfg = Config(model=replace(CFG, dtype="bfloat16"),
                 flow=FlowConfig(variant="flownet_s", dtype="float32"))
    cfg = replace(cfg, track=replace(cfg.track, max_persons=P,
                                     max_recovered=2, pose_score_thre=-1.0,
                                     track_oks_thre=0.1))
    jflow = jax_flow_net(cfg.flow)
    fv = _random_variables(jflow, (1, 64, 64, 6), np.random.default_rng(8),
                           bias_std=0.0)
    variables = {"params": _np(jq.prequantize_params(r18["folded"])),
                 "quant": _np(r18["quant"])}
    ref = JaxClipTracker(cfg, jq.QuantPoseAdapter(
        jq.PoseResNetQ(cfg=CFG, prequantized=True)), variables, jflow, fv)
    pose = load_quant_pose(tq.PoseResNetQ(CFG, prequantized=True), variables)
    port = ClipTracker(cfg, pose, load_flownet(get_flow_net(cfg.flow), fv),
                       device="cpu")
    c1, c2 = _clip(0, 4), _clip(3, 4, drop_at=4, seed=1)
    want1, wseed = ref.track_clip(*c1, return_seed=True)
    want2 = ref.track_clip(*c2, seed=wseed, frame_offset=3)
    got1, gseed = port.track_clip(*c1, return_seed=True)
    got2 = port.track_clip(*c2, seed=gseed, frame_offset=3)
    for got, want in ((got1, want1), (got2, want2)):
        np.testing.assert_array_equal(got["ids"], want["ids"])
        np.testing.assert_array_equal(got["valid"], want["valid"])
        det = want["valid"][:, :P]
        moved = np.abs(got["joints"][:, :P] - want["joints"][:, :P]).max(-1)
        assert (moved[det] <= 0.5).mean() >= 0.9
        peak = np.abs(want["maxvals"][:, :P][det]).max()
        assert np.abs(got["maxvals"][:, :P][det]
                      - want["maxvals"][:, :P][det]).max() <= peak * 2.0 ** -5


# ---------------------------------------------------------------------------
# The port alone: tests/test_quantize.py's checks
# ---------------------------------------------------------------------------


def test_bn_folding_exact(r18):
    x = _nchw(r18["x"])
    with torch.no_grad():
        want = r18["port"](x)
    got = r18["qport"](x, quantized=False)
    torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-3)


def test_calibration_gives_positive_scales(r18):
    scales = [float(b) for name, b in r18["qport"].named_buffers()
              if name.endswith("amax")]
    assert len(scales) == 23 and all(s > 0 for s in scales)


def test_prequantized_weights_bitwise_match_runtime_quant(r18):
    """Weights stored int8 at conversion give exactly the runtime-quantized
    model's outputs; the stored weights are int8."""
    x = _nchw(r18["x"])
    want = r18["qport"](x)
    pre = tq.quantize_pose_model(r18["port"], CFG, [x], prequantized=True)
    assert pre.conv1.wq.dtype == torch.int8
    assert not hasattr(pre.conv1, "weight")
    assert torch.equal(pre(x), want)


def test_mixed_mode_close_to_float(r18):
    x = _nchw(r18["x"])
    with torch.no_grad():
        want = r18["port"](x).numpy()
    got = tq.quantize_pose_model(r18["port"], CFG, [x], mixed=True,
                                 compute_dtype=torch.bfloat16)(x).numpy()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.98


def test_inference_only_and_modes(r18):
    """Train mode raises, as the reference adapter's assert; prequantized
    excludes mixed and calibration."""
    x = _nchw(r18["x"])
    with pytest.raises(ValueError, match="full-int8"):
        tq.quantize_pose_model(r18["port"], CFG, [x], mixed=True,
                               prequantized=True)
    pre = tq.PoseResNetQ(CFG, prequantized=True)
    with pytest.raises(ValueError, match="int8-inference-only"):
        pre(x, calibrate=True)
    pre.train()
    with pytest.raises(RuntimeError, match="inference-only"):
        pre(x)
    assert not r18["qport"].training
