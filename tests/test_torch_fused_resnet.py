"""The port's BN-folded fused pose path against the JAX package.

The fold of ``models/quantize.py``, the fused-stage plain version against
the reference's Pallas kernel (interpret mode) and its XLA twin, the whole
``FusedPoseResNet`` against ``FusedPoseAdapter(use_pallas=True,
interpret=True)``, and a ClipTracker with the fused R50 and FlowNetS
against the JAX ClipTracker with the interpret-mode adapter. Random
weights and random batch-norm statistics come from seeded numpy, filled
into the reference's variable shapes (``jax.eval_shape``, no compile of
init) and loaded into the port with ``utils/convert.py``. The stage widths
stay multiples of 2 at every stage (64x64 crops): the reference's twin
breaks at odd extents (ROADMAP queue 3).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowtrack_tpu.config import Config, FlowConfig, ModelConfig
from flowtrack_tpu.models.flownet import get_flow_net as jax_flow_net
from flowtrack_tpu.models.pose_resnet import get_pose_net as jax_pose_net
from flowtrack_tpu.models.quantize import fold_pose_resnet as jax_fold
from flowtrack_tpu.ops import fused_resnet as jfr
from flowtrack_tpu.tracking.clip_pipeline import ClipTracker as JaxClipTracker
from flowtrack_tpu_torch.models.flownet import get_flow_net
from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
from flowtrack_tpu_torch.models.quantize import fold_pose_resnet
from flowtrack_tpu_torch.ops import fused_resnet as tfr
from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker, pad_detections
from flowtrack_tpu_torch.utils.convert import (
    load_flownet,
    load_fused_pose,
    load_pose_resnet,
)

R50 = ModelConfig(num_layers=50, image_size=(64, 64), heatmap_size=(16, 16),
                  dtype="bfloat16")
P = 3


def _random_variables(model, input_shape, rng, bias_std=0.1):
    """The model's variable tree filled from ``rng``: He-normal kernels,
    batch-norm scale and running variance U(0.5, 1.5), running means
    N(0, 0.1) and biases N(0, bias_std), so the fold does real work."""
    tree = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros(input_shape), train=False))

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            std = np.sqrt(2.0 / np.prod(shape[:-1]))
            return rng.normal(0, std, shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        std = 0.1 if name == "mean" else bias_std
        return rng.normal(0, std, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def r50():
    """(JAX variables, the reference's fused tree as numpy, the port's
    float PoseResNet with those weights)."""
    v = _random_variables(jax_pose_net(R50), (1, 64, 64, 3),
                          np.random.default_rng(0))
    fused = _np(jfr.prepare_fused_variables(v, 50))
    return v, fused, load_pose_resnet(get_pose_net(R50), v)


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# The fold
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_layers,deconv_with_bias", [(50, False),
                                                         (18, True)])
def test_fold_matches_reference(num_layers, deconv_with_bias):
    """Every folded kernel and bias equals the reference's: the same float64
    products, one rounding to float32 (measured bitwise). R18 covers the
    basic blocks and the deconvs' transpose bias."""
    cfg = replace(R50, num_layers=num_layers,
                  deconv_with_bias=deconv_with_bias)
    v = _random_variables(jax_pose_net(cfg), (1, 64, 64, 3),
                          np.random.default_rng(1))
    want = jax.tree_util.tree_flatten_with_path(_np(jax_fold(v)))[0]
    got = fold_pose_resnet(load_pose_resnet(get_pose_net(cfg), v))
    assert len(jax.tree_util.tree_leaves(got)) == len(want)
    for path, leaf in want:
        node = got
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), leaf,
                                      err_msg=jax.tree_util.keystr(path))
    assert ("bias" in v["params"]["deconv0"]) == deconv_with_bias


def test_both_routes_give_the_same_buffers(r50):
    """The reference's fused tree through ``load_fused_pose`` and the port's
    PoseResNet through ``fuse_pose_model`` give equal buffers; a tree with a
    tensor missing or one too many does not load."""
    _, fused, port = r50
    loaded = load_fused_pose(tfr.FusedPoseResNet(R50), fused)
    folded = tfr.fuse_pose_model(R50, port)
    a, b = loaded.state_dict(), folded.state_dict()
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k
    assert a["stages.0.0.w2"].shape == (3, 3 * 64, 64)
    assert a["stages.0.0.w2"].dtype == torch.bfloat16
    assert a["stages.1.0.bd"].shape == (1, 512)

    missing = {**fused, "stages": [list(s) for s in fused["stages"]]}
    missing["stages"][2] = missing["stages"][2][:-1]
    with pytest.raises(RuntimeError, match="Missing"):
        load_fused_pose(tfr.FusedPoseResNet(R50), missing)
    extra = {**fused, "head": {**fused["head"], "deconv3": fused["head"]["deconv2"]}}
    with pytest.raises(RuntimeError, match="Unexpected"):
        load_fused_pose(tfr.FusedPoseResNet(R50), extra)


# ---------------------------------------------------------------------------
# The stage: plain version against the Pallas kernel and the XLA twin
# ---------------------------------------------------------------------------


def _folded_blocks(rng, cin, f, nblocks, projection):
    """Random folded block nodes, the first with a projection if asked."""

    def conv(k, ci, co):
        return {"kernel": rng.normal(0, np.sqrt(2.0 / (k * k * ci)),
                                     (k, k, ci, co)).astype(np.float32),
                "bias": rng.normal(0, 0.1, co).astype(np.float32)}

    nodes = []
    for i in range(nblocks):
        c = cin if i == 0 else 4 * f
        node = {"conv1": conv(1, c, f), "conv2": conv(3, f, f),
                "conv3": conv(1, f, 4 * f)}
        if i == 0 and projection:
            node["downsample_conv"] = conv(1, c, 4 * f)
        nodes.append(node)
    return nodes


def _stage_inputs(seed, shape, f, nblocks, projection):
    rng = np.random.default_rng(seed)
    nodes = _folded_blocks(rng, shape[-1], f, nblocks, projection)
    x = rng.normal(0, 1, shape).astype(np.float32)
    return ([jfr.block_from_folded(n) for n in nodes], jnp.asarray(x, jnp.bfloat16),
            [tfr.block_from_folded(n) for n in nodes],
            torch.from_numpy(x).to(torch.bfloat16))


@pytest.mark.parametrize("shape,f,nblocks,projection,stride", [
    ((2, 8, 6, 16), 8, 2, True, 1),     # layer1-like: projection, stride 1
    ((2, 8, 6, 32), 8, 3, False, 1),    # identity residuals only
    ((4, 16, 12, 32), 16, 2, True, 2),  # striding first block (library convs)
])
def test_stage_matches_pallas_kernel(shape, f, nblocks, projection, stride):
    """``fused_stage`` on a CPU tensor (the plain version, and ``block_conv``
    for a striding first block) equals the reference's Pallas route
    ``fused_stage_pallas(interpret=True)`` bitwise at these widths."""
    jb, xj, tb, xt = _stage_inputs(2, shape, f, nblocks, projection)
    want = np.asarray(jfr.fused_stage_pallas(xj, jb, stride, interpret=True)
                      .astype(jnp.float32))
    got = tfr.fused_stage(xt, tb, stride)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("shape,f,nblocks,stride", [
    ((4, 64, 48, 64), 64, 3, 1),     # layer1 at 256x192, 4 crops
    ((2, 32, 24, 256), 128, 2, 2),   # layer2's input, the twin's strided branch
])
def test_plain_matches_xla_twin(shape, f, nblocks, stride):
    """At stage widths against ``fused_stage_ref``: the float32 sums run in
    another order (torch's CPU matmul against XLA's), so a bfloat16 rounding
    flips here and there. Bound 2^-7 of max |ref| with >= 95% of the
    elements bitwise (measured 0.29% / 99.1% and 0.55% / 98.4%)."""
    jb, xj, tb, xt = _stage_inputs(3, shape, f, nblocks, True)
    want = np.asarray(jfr.fused_stage_ref(xj, jb, stride).astype(jnp.float32))
    got = tfr.fused_stage_plain(xt, tb, stride).float().numpy()
    assert got.shape == want.shape
    assert _rel_err(got, want) <= 2.0 ** -7
    assert (got == want).mean() >= 0.95


def test_plain_takes_odd_extents():
    """The plain version's strided branch gives the convolution's ceil shape
    (the reference's twin takes h // stride and breaks at 3-wide inputs), and
    agrees with ``block_conv`` there to a bfloat16 rounding."""
    _, _, tb, xt = _stage_inputs(4, (2, 5, 3, 32), 8, 2, True)
    got = tfr.fused_stage_plain(xt, tb, 2)
    assert got.shape == (2, 3, 2, 32)
    conv = tfr.fused_stage(xt, tb, 2)
    assert _rel_err(got.float().numpy(), conv.float().numpy()) <= 2.0 ** -6


# ---------------------------------------------------------------------------
# The whole fused pose net
# ---------------------------------------------------------------------------


def test_fused_pose_net_matches_adapter(r50):
    """``FusedPoseResNet`` on 4 crops against ``FusedPoseAdapter`` (Pallas
    route, interpret mode): within 2^-5 of the heatmaps' peak, and the same
    argmax in >= 95% of the joint maps. Measured 1.46% and 98.5%: the bf16
    roundings flip with the float32 sum order through 16 blocks, as far as
    the reference's own XLA twin route is from its Pallas route (1.55% and
    95.6% on the same input)."""
    v, fused, port = r50
    x = np.random.default_rng(5).normal(0, 1, (4, 64, 64, 3)).astype(np.float32)
    adapter = jfr.FusedPoseAdapter(R50, use_pallas=True, interpret=True)
    want = np.asarray(adapter.apply(jfr.prepare_fused_variables(v, 50),
                                    jnp.asarray(x, jnp.bfloat16)))
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = load_fused_pose(tfr.FusedPoseResNet(R50), fused)(xt)
        got_folded = tfr.fuse_pose_model(R50, port)(xt)
    assert got.dtype == torch.float32 and got.shape == (4, 17, 16, 16)
    torch.testing.assert_close(got_folded, got, rtol=0, atol=0)
    got = got.permute(0, 2, 3, 1).numpy()
    assert _rel_err(got, want) <= 2.0 ** -5
    same_peak = (got.reshape(4, -1, 17).argmax(1)
                 == want.reshape(4, -1, 17).argmax(1))
    assert same_peak.mean() >= 0.95


def test_ragged_batch_gives_each_crop_its_own_result(r50):
    """No batch padding: 3 crops give the first crop what it gets alone."""
    _, fused, _ = r50
    model = load_fused_pose(tfr.FusedPoseResNet(R50), fused)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (3, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        three, one = model(x), model(x[:1])
    assert three.shape == (3, 17, 16, 16)
    torch.testing.assert_close(three[:1], one, rtol=0, atol=0)


def test_stage_blocks_are_checked_once(r50):
    """The module checks its stages' blocks for the kernel once and keeps
    them, slices included, until its buffers are moved or loaded again; a
    block the kernel does not take fails when the chain is built."""
    _, fused, _ = r50
    model = load_fused_pose(tfr.FusedPoseResNet(R50), fused)
    chains = model.stage_blocks()
    assert model.stage_blocks() is chains
    assert [len(c) for c in chains] == [3, 4, 6, 3]
    assert all(isinstance(c, tfr.CheckedBlocks) for c in chains)
    assert isinstance(chains[1][1:], tfr.CheckedBlocks)
    load_fused_pose(model, fused)
    assert model.stage_blocks() is not chains
    first = model.stage_blocks()[0][0]
    with pytest.raises(TypeError, match="w1"):
        tfr.CheckedBlocks([{**first, "w1": first["w1"].float()}])
    with pytest.raises(ValueError, match="w1"):
        tfr.CheckedBlocks(list(chains[0][:1]) + list(chains[1][1:2]))
    with pytest.raises(TypeError, match="bfloat16"):
        model.to(torch.float32).stage_blocks()


def test_fused_rejects_basic_block_nets():
    cfg = replace(R50, num_layers=18)
    with pytest.raises(ValueError, match="bottleneck"):
        tfr.FusedPoseResNet(cfg)
    with pytest.raises(ValueError, match="bottleneck"):
        tfr.fuse_pose_model(cfg, get_pose_net(cfg))


def test_stage_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only; ``fused_stage`` sends a
    CPU tensor to the plain version and launches nothing."""
    _, _, tb, xt = _stage_inputs(7, (1, 4, 4, 64), 64, 1, True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfr.fused_stage_cuda(xt, tb)
    before = tfr.fused_stage_cuda.launches
    torch.testing.assert_close(tfr.fused_stage(xt, tb, 1),
                               tfr.fused_stage_plain(xt, tb, 1), rtol=0, atol=0)
    assert tfr.fused_stage_cuda.launches == before


# ---------------------------------------------------------------------------
# What the wrapper computes in Python around the kernels: the form a block
# takes on the card, its tile and halo, shared memory, launches, layouts
# ---------------------------------------------------------------------------


# R50 at 256x192 crops: (h, w, f, projection) of the stride-1 blocks
R50_BLOCKS = {"layer1_0": (64, 48, 64, True), "layer1": (64, 48, 64, False),
              "layer2": (32, 24, 128, False), "layer3": (16, 12, 256, False),
              "layer4": (8, 6, 512, False)}


@pytest.mark.parametrize("name,form", [
    ("layer1_0", ("block", 4, 1, 1)), ("layer1", ("block", 4, 1, 1)),
    ("layer2", ("block", 8, 1, 1)), ("layer3", ("wgmma", 16, 1, 3)),
    ("layer4", ("wgmma", 8, 4, 3))])
def test_r50_chunk_shapes_dispatch_to_their_form(name, form):
    """Layers 1 and 2 run a whole block per launch on tiles of 4 and 8 image
    rows; layer3 one conv per launch on whole images, layer4 on four."""
    assert tuple(tfr.block_form(*R50_BLOCKS[name])) == form


@pytest.mark.parametrize("h,w,f,proj,form", [
    (16, 16, 64, True, ("block", 8, 1, 1)),      # 128-pixel tiles
    (32, 24, 128, True, ("wgmma", 8, 1, 3)),     # no F=128 block with projection
    (4, 4, 512, False, ("wgmma", 4, 12, 3)),     # twelve whole images
    (8, 8, 256, False, ("wgmma", 8, 3, 3)),      # 192 pixels before 64
    (10, 10, 64, False, ("wgmma", 10, 1, 3)),    # a tile of 100 pixels
    (64, 40, 64, False, ("wgmma", 4, 1, 3)),     # 160 pixels
    (96, 72, 64, True, ("wgmma", 2, 1, 3)),      # the 384x288 presets' stages
    (48, 36, 128, False, ("wgmma", 4, 1, 3)),
    (24, 18, 256, False, ("wgmma", 8, 1, 3)),
    (12, 9, 512, False, ("wgmma", 12, 1, 3)),
    (3, 64, 64, False, ("block", 3, 1, 1)),      # one tile per image
])
def test_other_shapes_dispatch_by_shape_alone(h, w, f, proj, form):
    assert tuple(tfr.block_form(h, w, f, proj)) == form


@pytest.mark.parametrize("name,kind", [
    ("layer1", "block"), ("layer2", "block"), ("layer3", "wgmma"),
    ("layer4", "wgmma"), ("layer1_b3", "block"), ("layer3_b3", "wgmma"),
    ("layer4_b3", "wgmma"), ("rows_wgmma", "wgmma"), ("w40_partial", "wgmma"),
    ("layer1_384x288", "wgmma"), ("layer4_384x288", "wgmma")])
def test_the_smoke_checks_every_form_on_the_card(name, kind):
    """The chunks that the smoke holds against the plain version on the card
    cover both forms, the 3x3 of the per-conv form tiled by whole images
    (R50's layers 3 and 4), by image rows, and by tiles whose pixels are no
    multiple of 64 (the 384x288 presets' first and last stages)."""
    import chip_smoke

    chunks = {c[0]: c[1:] for c in chip_smoke.FUSED_CHUNKS}
    assert len(chunks) == 11
    (_, h, w, _), f, _, projection = chunks[name]
    form = tfr.block_form(h, w, f, projection)   # the first block's
    assert form.kind == kind
    later = tfr.block_form(h, w, f, False)
    assert later.kind == kind
    if name == "rows_wgmma":
        assert (form.rows, form.images) == (8, 1)
    if name in ("layer3", "layer4"):
        assert form.rows == h and form.images == 192 // (h * w)
    if name in ("w40_partial", "layer1_384x288", "layer4_384x288"):
        assert (form.rows * form.images * w) % 64


@pytest.mark.parametrize("h,w", [(64, 48), (32, 24), (16, 12), (8, 6),
                                 (16, 16), (4, 4), (8, 8), (2, 96), (1, 64),
                                 (96, 72), (48, 36), (24, 18), (12, 9),
                                 (10, 10), (6, 40), (5, 7), (300, 1)])
def test_tiles_are_boxes_of_whole_rows_or_images(h, w):
    """A tile is at most 192 pixels: whole image rows that divide the image,
    or whole images; the most pixels that fit, and where whole rows make 64,
    128 or 192 pixels the whole-block form's rows are the same."""
    rows, images = tfr.conv_tiling(h, w)
    pixels = rows * w * images
    assert 0 < pixels <= 192
    assert (images == 1 and h % rows == 0) or rows == h
    assert max(rows, images, w) <= 256          # a TMA box's extents
    for r in range(1, h + 1):
        assert h % r or r * w > 192 or r * w <= pixels
    assert h * w > 192 or pixels + h * w > 192
    if images == 1 and tfr.row_tiling(h, w) is not None and pixels == 192:
        assert tfr.row_tiling(h, w) == rows


@pytest.mark.parametrize("h,w", [(1, 200), (300, 193), (5, 256), (4, 1000)])
def test_untileable_extents_have_no_tiling(h, w):
    """Only an image over 192 pixels wide has no tile: the wrapper raises."""
    assert tfr.conv_tiling(h, w) is None and tfr.row_tiling(h, w) is None
    with pytest.raises(ValueError, match="192 pixels wide"):
        tfr.block_form(h, w, 64, False)


@pytest.mark.parametrize("name", ["layer1_0", "layer1", "layer2"])
def test_block_form_fits_shared_memory(name):
    """The whole-block kernel's shared memory, counted as the kernel lays it
    out, stays under a block's 232,448 bytes at R50's shapes; y1 with its
    halo is (rows + 2) image rows."""
    h, w, f, proj = R50_BLOCKS[name]
    form = tfr.block_form(h, w, f, proj)
    used = tfr.block_smem_bytes(f, form.rows, w)
    assert used <= tfr.SMEM_LIMIT == 232448
    y1 = ((form.rows + 2) * w + 1) * (2 * f + 16)
    stages = {64: 5, 128: 4}[f]
    assert tfr.block_stages(f) == stages
    assert used == 1024 + stages * (192 * 128 + f * 128) + y1 + 16 * stages
    assert {"layer1_0": 206560, "layer1": 206560, "layer2": 230480}[name] == used


@pytest.mark.parametrize("bn", [64, 128])
def test_conv_form_fits_shared_memory(bn):
    assert tfr.conv_smem_bytes(bn) <= tfr.SMEM_LIMIT
    assert tfr.conv_smem_bytes(bn) == (1024 + 4 * (24576 + bn * 128)
                                       + bn // 64 * 24576 + 80)


def test_block_form_gives_way_when_shared_memory_does_not_fit():
    """A tile whose y1 does not fit keeps one launch per conv (F = 128 on
    rows of 96 pixels: 6 halo'd rows of 272 bytes a pixel)."""
    assert tfr.block_smem_bytes(128, 2, 96) > tfr.SMEM_LIMIT
    assert tfr.block_form(4, 96, 128, False).kind == "wgmma"
    assert tfr.block_form(4, 96, 64, False).kind == "block"


@pytest.mark.parametrize("image_hw,launches", [((256, 192), 27),
                                               ((64, 64), 27),
                                               ((128, 96), 27),
                                               ((160, 160), 39)])
def test_launches_per_forward_follow_the_forms(r50, image_hw, launches):
    """R50 has 3 + 3 + 5 + 2 stride-1 blocks. At 256x192 layers 1 and 2 take
    one launch a block, layers 3 and 4 three: 3 + 3 + 15 + 6, and so at
    64x64 (16x16 and 8x8 images tile by rows too). At 160x160 (40x40 at
    layer1) no stage has whole rows of 64, 128 or 192 pixels and every block
    takes three launches. The count is held to the forms of the blocks'
    shapes."""
    _, fused, _ = r50
    model = load_fused_pose(tfr.FusedPoseResNet(replace(R50, image_size=image_hw)),
                            fused)
    h, w = image_hw[0] // 4, image_hw[1] // 4
    want = 0
    for s, nblocks in enumerate((3, 4, 6, 3)):
        f = 64 * 2 ** s
        if s:
            h, w = (h + 1) // 2, (w + 1) // 2
        for b in range(1 if s else 0, nblocks):
            want += tfr.block_form(h, w, f, s == 0 and b == 0).launches
    assert model.kernel_launches(image_hw) == want == launches


def test_stage_launches_counts_each_block():
    _, _, tb, _ = _stage_inputs(3, (1, 64, 48, 64), 64, 3, True)
    assert tfr.stage_launches(64, 48, tb) == 3
    assert tfr.stage_launches(10, 10, tb) == 9


@pytest.mark.parametrize("f,projection", [(64, True), (64, False),
                                          (128, False)])
def test_transposed_weights_are_the_same_block(f, projection):
    """The wgmma kernels read (N, K) weights with K contiguous; transposed
    back into the reference's layouts they give the plain block bitwise, and
    w2t's K index is (row tap, column tap, channel)."""
    cin = 64 if projection else 4 * f
    _, _, tb, xt = _stage_inputs(11, (2, 4, 4, cin), f, 1, projection)
    blk = tb[0]
    t = tfr.transposed_weights(blk)
    assert set(t) == {"w1t", "w2t", "w3t"} | ({"wdt"} if projection else set())
    assert t["w1t"].shape == (f, cin) and t["w2t"].shape == (f, 9 * f)
    assert t["w3t"].shape == (4 * f, f)
    assert all(v.is_contiguous() and v.dtype == torch.bfloat16
               for v in t.values())
    a, b, c, n = 2, 1, 5, 3
    assert t["w2t"][n, (a * 3 + b) * f + c] == blk["w2"][a, b * f + c, n]
    back = dict(blk, w1=t["w1t"].t().contiguous(),
                w2=t["w2t"].t().reshape(3, 3 * f, f).contiguous(),
                w3=t["w3t"].t().contiguous())
    if projection:
        back["wd"] = t["wdt"].t().contiguous()
    torch.testing.assert_close(tfr.fused_block_plain(xt, back, 1),
                               tfr.fused_block_plain(xt, blk, 1),
                               rtol=0, atol=0)


def test_checked_blocks_keep_their_transposes_through_slices():
    _, _, tb, _ = _stage_inputs(5, (1, 4, 4, 64), 64, 3, True)
    chain = tfr.CheckedBlocks(tb)
    first = chain.transposed(1)
    assert chain.transposed(1) is first
    assert chain[1:].transposed(0) is first
    assert sorted(chain[1:].transposed(1)) == ["w1t", "w2t", "w3t"]
    assert sorted(chain.transposed(0)) == ["w1t", "w2t", "w3t", "wdt"]


# ---------------------------------------------------------------------------
# The slice: ClipTracker with the fused R50 and FlowNetS
# ---------------------------------------------------------------------------


def _clip(t0, f, drop_at=None, seed=0):
    """Two persons on a fixed textured background, moving 1 px per frame;
    the second person's detection is dropped at global frame ``drop_at``."""
    rng = np.random.default_rng(seed)
    base = np.random.default_rng(99).uniform(0, 255, (64, 64, 3))
    frames = np.stack([np.clip(base + rng.normal(0, 3, base.shape), 0, 255)
                       for _ in range(f)]).astype(np.float32)
    boxes, scores = [], []
    for i in range(f):
        t = t0 + i
        b, s = [[8 + t, 10, 20, 30], [36, 12 + t, 18, 28]], [0.9, 0.8]
        if t == drop_at:
            b, s = b[:1], s[:1]
        boxes.append(b)
        scores.append(s)
    return (frames, *pad_detections(boxes, scores, P))


def test_fused_slice_matches_reference(r50):
    """Two chained 4-frame clips (64x64 frames, the second seeded by the
    first, a detection dropped inside it): ids and valid equal. The bf16
    pose net's heatmaps differ by ~1% of their peak (previous test), and a
    random net's heatmap often holds two cells within that of its maximum,
    so such a joint lands on the other cell: at least 90% of the detector
    slots' valid joints within 0.5 px (measured 97.8% and 98.3%), their
    maxvals within 2^-5 of the largest (measured 0.70% and 0.84%). Recovered
    slots are boxed around flow-propagated joints, so a moved joint moves
    their crop: ids and valid only."""
    v, fused, _ = r50
    cfg = Config(model=R50, flow=FlowConfig(variant="flownet_s",
                                            dtype="float32"))
    cfg = replace(cfg, track=replace(cfg.track, max_persons=P,
                                     max_recovered=2, pose_score_thre=-1.0,
                                     track_oks_thre=0.1))
    jflow = jax_flow_net(cfg.flow)
    # zero conv biases, as the flow net's own init: with random biases its
    # flow carries every pose off the frame and no track is ever matched
    fv = _random_variables(jflow, (1, 64, 64, 6), np.random.default_rng(8),
                           bias_std=0.0)
    ref = JaxClipTracker(cfg, jfr.FusedPoseAdapter(R50, use_pallas=True,
                                                   interpret=True),
                         jfr.prepare_fused_variables(v, 50), jflow, fv)
    port = ClipTracker(cfg, load_fused_pose(tfr.FusedPoseResNet(R50), fused),
                       load_flownet(get_flow_net(cfg.flow), fv), device="cpu")
    c1, c2 = _clip(0, 4), _clip(3, 4, drop_at=4, seed=1)
    want1, wseed = ref.track_clip(*c1, return_seed=True)
    want2 = ref.track_clip(*c2, seed=wseed, frame_offset=3)
    got1, gseed = port.track_clip(*c1, return_seed=True)
    got2 = port.track_clip(*c2, seed=gseed, frame_offset=3)
    assert set(got2["ids"][0][got2["valid"][0]]) & set(
        got1["ids"][-1][got1["valid"][-1]])
    for got, want in ((got1, want1), (got2, want2)):
        np.testing.assert_array_equal(got["ids"], want["ids"])
        np.testing.assert_array_equal(got["valid"], want["valid"])
        det = want["valid"][:, :P]
        moved = np.abs(got["joints"][:, :P] - want["joints"][:, :P]).max(-1)
        assert (moved[det] <= 0.5).mean() >= 0.9
        peak = np.abs(want["maxvals"][:, :P][det]).max()
        assert np.abs(got["maxvals"][:, :P][det]
                      - want["maxvals"][:, :P][det]).max() <= peak * 2.0 ** -5
