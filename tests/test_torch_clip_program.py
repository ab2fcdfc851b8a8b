"""The groundwork of the port's compiled clip program: the kernels as
``torch.library`` custom ops, ``real_frames`` as a device scalar, and a clip
that takes no data from the host and gives none back (what a CUDA graph
capture requires), the int8 pose net included.

A CUDA graph needs a card: on the CPU ``run_prepared_lanes`` runs ``_clip``
eagerly, and ``chip_smoke.py``'s ``[graph]`` phase holds the replayed graph
to it on the card.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from flowtrack_tpu_torch.config import ModelConfig
from flowtrack_tpu_torch.models import quantize
from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
from flowtrack_tpu_torch.ops import correlation as tcorr
from flowtrack_tpu_torch.ops import crop as tcrop
from flowtrack_tpu_torch.ops import fused_resnet as tfr
from flowtrack_tpu_torch.ops import int8_conv
from flowtrack_tpu_torch.ops import warp as twarp
from flowtrack_tpu_torch.tracking.clip_pipeline import (
    ClipTracker,
    pad_detections,
    recovery_rank_limit,
)
from flowtrack_tpu_torch.utils.graphs import net_state, state_key
from tests.test_torch_clip_scenarios import (
    StubFlowTorch,
    StubPoseTorch,
    _cfg_for,
    _moving,
)


class HostData(TorchDispatchMode):
    """Records every operator that makes a tensor from host data
    (``aten.lift_fresh``: ``torch.tensor``, ``as_tensor`` of an array, a
    number assigned into a slice) or reads a value back to the host
    (``item``, ``_local_scalar_dense``)."""

    FLAGGED = ("lift_fresh", "item", "_local_scalar_dense")

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(name in str(func) for name in self.FLAGGED):
            self.found.append(str(func))
        return func(*args, **(kwargs or {}))


def _rng_tensor(rng, shape, dtype=torch.float32):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)


def _op_cases():
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.uniform(0, 255, (2, 16, 20, 3))
                              .astype(np.float32))
    crop_args = (frames, torch.tensor([1, 0]), torch.tensor([[8.0, 8.0]] * 2),
                 torch.tensor([[0.06, 0.08]] * 2), (8, 6))
    blocks = [tfr.block_from_folded({
        "conv1": {"kernel": _rng_tensor(rng, (1, 1, 16, 8)),
                  "bias": _rng_tensor(rng, (8,))},
        "conv2": {"kernel": _rng_tensor(rng, (3, 3, 8, 8)),
                  "bias": _rng_tensor(rng, (8,))},
        "conv3": {"kernel": _rng_tensor(rng, (1, 1, 8, 32)),
                  "bias": _rng_tensor(rng, (32,))},
        "downsample_conv": {"kernel": _rng_tensor(rng, (1, 1, 16, 32)),
                            "bias": _rng_tensor(rng, (32,))}})]
    x = _rng_tensor(rng, (2, 4, 6, 16), torch.bfloat16)
    f1, f2 = _rng_tensor(rng, (1, 4, 5, 6)), _rng_tensor(rng, (1, 4, 5, 6))
    img, flow = _rng_tensor(rng, (1, 3, 5, 6)), _rng_tensor(rng, (1, 2, 5, 6))
    norm = ([0.4, 0.5, 0.6], [0.2, 0.3, 0.25], 255.0)
    return {
        "crop_frames": (
            torch.ops.flowtrack.crop_frames,
            (*crop_args, *norm, torch.bfloat16),
            lambda: tcrop.crop_frames(*crop_args, *norm,
                                      out_dtype=torch.bfloat16),
            lambda: tcrop.crop_frames_plain(*crop_args, *norm,
                                            out_dtype=torch.bfloat16)),
        "correlation": (
            torch.ops.flowtrack.correlation, (f1, f2, 2, 1),
            lambda: tcorr.correlation_nchw(f1, f2, 2, 1),
            lambda: tcorr.correlation_plain(
                f1.permute(0, 2, 3, 1), f2.permute(0, 2, 3, 1), 2, 1
            ).permute(0, 3, 1, 2)),
        "resample2d": (
            torch.ops.flowtrack.resample2d, (img, flow),
            lambda: twarp.resample2d_nchw(img, flow),
            lambda: twarp.resample2d_plain(img, flow)),
        "fused_stage": (
            torch.ops.flowtrack.fused_stage,
            (x, *tfr.stage_params(blocks)),
            lambda: tfr.fused_stage(x, blocks, 1),
            lambda: tfr.fused_stage_plain(x, blocks, 1)),
    }


@pytest.mark.parametrize("name", ["crop_frames", "correlation", "resample2d",
                                  "fused_stage"])
def test_kernel_op_matches_its_plain_version_and_fake(name):
    """Each kernel is a ``flowtrack`` custom op: its schema, its fake
    (meta) implementation (opcheck holds its shape, dtype and strides to
    the real output's) and its registration pass
    ``torch.library.opcheck``; on CPU tensors the op's route gives the
    plain version bit for bit and counts no kernel launch."""
    op, args, route, plain = _op_cases()[name]
    wrappers = (tcrop.crop_frames_cuda, tcorr.correlation_cuda,
                twarp.resample2d_cuda, tfr.fused_stage_cuda)
    before = [fn.launches for fn in wrappers]
    torch.library.opcheck(op, args, test_utils=(
        "test_schema", "test_autograd_registration", "test_faketensor"))
    torch.testing.assert_close(route(), plain(), rtol=0, atol=0)
    assert [fn.launches for fn in wrappers] == before


def test_fused_stage_op_checks_its_tensors_for_the_kernel():
    """The op's card route checks the tensors it is handed (a weight of
    the wrong shape, a channel count the kernel does not take) before any
    launch, and refuses a CPU input."""
    op, args, _, _ = _op_cases()["fused_stage"]
    x, params, projection = args
    with pytest.raises(ValueError, match="multiples of 64"):
        tfr._unpack_params(x, params, projection)
    with pytest.raises(ValueError, match="w3t must be"):
        tfr._unpack_params(x, params[:4] + [params[4].t().contiguous()]
                           + params[5:], projection)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfr._check_input(x)


def test_clip_state_names_what_a_graph_reads():
    """On the card a tracker replays a captured clip graph only while its
    nets hold the tensors that the capture read (``net_state``, keyed by
    ``state_key``), and drops its graphs when the key changes. The key
    stays from run to run and when a state is loaded into a net's tensors
    in place (the graph reads the new values); it changes when a fused net
    loads a state or moves (its blocks are checked and transposed anew,
    the former transposes released) and when a net's tensors move."""
    mcfg = ModelConfig(num_layers=50, image_size=(64, 48),
                       heatmap_size=(16, 12))
    fused = tfr.FusedPoseResNet(mcfg, device="cpu")
    flow = StubFlowTorch()

    def key(*nets):
        return state_key(net_state(*nets))

    k0 = key(fused, flow)
    blocks = fused.stage_blocks()
    assert key(fused, flow) == k0 and fused.stage_blocks() is blocks
    assert all(any(b is o for o in net_state(fused, flow)) for b in blocks)
    fused.load_state_dict(fused.state_dict())
    k1 = key(fused, flow)
    assert k1 != k0
    fused.to("cpu")
    assert key(fused, flow) != k1
    pose = get_pose_net(replace(mcfg, num_layers=18), "cpu",
                        torch.Generator().manual_seed(0))
    k2 = key(pose, flow)
    pose.load_state_dict(pose.state_dict())
    assert key(pose, flow) == k2
    pose.to(torch.float64)
    assert key(pose, flow) != k2


def _budget_clip(f):
    """budget_pressure's persons, both missed at frames 2 and 3, over the
    first ``f`` frames."""
    cfg = _cfg_for("budget_pressure")
    frames, boxes, scores = _moving(f, [(30, 40, 0.9), (90, 70, 0.85)],
                                    drop=((2, 3), (2, 3)))
    return cfg, (frames, *pad_detections(boxes, scores,
                                         cfg.track.max_persons))


def test_rank_limit_is_the_host_formula():
    """recovery_rank_limit on a device int32 scalar gives the int formula
    min(f*r, max(r, ceil(float32(real) * float32(budget)))) for every real
    frame count of a clip, at budgets whose products round in float32."""
    for f, r, budget in ((8, 2, 0.5), (16, 4, 1.0), (7, 3, 0.3),
                         (64, 2, 0.1)):
        for real in range(1, f + 1):
            want = min(f * r, max(r, int(np.ceil(np.float32(real)
                                                 * np.float32(budget)))))
            got = recovery_rank_limit(torch.tensor(real, dtype=torch.int32),
                                      f, r, budget)
            assert got.dtype == torch.int32 and int(got) == want, (f, real)


def test_device_real_frames_every_length_of_a_padded_clip():
    """budget_pressure padded to F = 8 frames, for every real count 1..F
    (which ``run_prepared`` hands the clip program as a device int32
    scalar): on the real frames and in the seed, bit for bit the unpadded
    run of those frames. One padded program serves every length."""
    f = 8
    cfg, (frames, db, dsc, dv) = _budget_clip(f)
    tracker = ClipTracker(cfg, StubPoseTorch(), StubFlowTorch(),
                          device="cpu")
    for real in range(1, f + 1):
        keep = np.arange(f) < real
        padded = tracker.prepare(
            np.where(keep[:, None, None, None], frames, frames[real - 1]),
            db * keep[:, None, None], dsc * keep[:, None], dv & keep[:, None],
            keep)
        got = tracker.run_prepared(padded, budget_frames=real)
        alone = tracker.run_prepared(tracker.prepare(
            frames[:real], db[:real], dsc[:real], dv[:real]))
        for a, c in zip(got[:5], alone[:5]):
            torch.testing.assert_close(a[:real], c, rtol=0, atol=0)
        for a, c in zip(got[5], alone[5]):
            torch.testing.assert_close(a, c, rtol=0, atol=0)
    assert alone[4].any() and tracker.graphs == {}
    with pytest.raises(ValueError, match="real_frames"):
        tracker.run_prepared(padded, budget_frames=f + 1)


def test_clip_takes_no_host_data():
    """After one warm-up run (which makes the clip's small constants on its
    device), a padded, flip-tested two-lane clip run makes no tensor from
    host data and reads no value back: nothing that a CUDA graph capture
    refuses."""
    cfg, (frames, db, dsc, dv) = _budget_clip(6)
    cfg = replace(cfg, test=replace(cfg.test, flip_test=True))
    tracker = ClipTracker(cfg, StubPoseTorch(), StubFlowTorch(),
                          device="cpu")
    args = [torch.stack([a, a]) for a in tracker.prepare(frames, db, dsc, dv)]
    tracker.run_prepared_lanes(args, budget_frames=5)
    seed = [torch.stack([s, s]) for s in tracker.empty_seed()]
    real = torch.tensor(5, dtype=torch.int32)
    with torch.inference_mode(), HostData() as mode:
        out = tracker._clip(*args, *seed, real_frames=real)
    assert mode.found == []
    assert out[3].shape == (2, 6, tracker.num_slots)


def test_int8_forward_takes_no_host_data(monkeypatch):
    """The calibrated, prequantized int8 PoseResNet on the card's route
    (the patch-matrix GEMMs, run here on CPU tensors) calls no .item() or
    .tolist() and makes no tensor from host data: the stem's zero padding
    of K once assigned a number, a host sync on every forward."""
    mcfg = ModelConfig(num_layers=18, image_size=(64, 64),
                       heatmap_size=(16, 16), dtype="float32")
    gen = torch.Generator().manual_seed(0)
    model = quantize.quantize_pose_model(
        get_pose_net(mcfg, "cpu", gen), mcfg,
        [torch.randn(4, 3, 64, 64, generator=gen)], prequantized=True,
        compute_dtype=torch.bfloat16)
    monkeypatch.setattr(quantize, "int8_conv2d", int8_conv.int8_conv2d_gemm)

    def refuse(*args, **kwargs):
        raise AssertionError("a value read back to the host")

    x = torch.randn(3, 3, 64, 64, generator=gen).to(torch.bfloat16)
    before = int8_conv.int8_conv2d_gemm.launches
    with monkeypatch.context() as m:
        for name in ("item", "tolist", "numpy", "__bool__", "__int__",
                     "__float__"):
            m.setattr(torch.Tensor, name, refuse)
        with torch.inference_mode(), HostData() as mode:
            y = model(x)
    assert mode.found == []
    assert y.shape == (3, 17, 16, 16) and bool(torch.isfinite(y).all())
    assert int8_conv.int8_conv2d_gemm.launches > before
