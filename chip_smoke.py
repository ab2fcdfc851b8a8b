"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives the port's three paths through ``flowtrack_tpu_torch.tracking.
clip_pipeline.ClipTracker`` (flip test, detector-miss recovery, cross-clip
seed), through the port's hand-written CUDA kernels: slice 1, PoseResNet-50
at 256x192 with FlowNetC; slice 2, the paper's full pipeline
(experiments/flowtrack_posetrack_flownet2.yaml), PoseResNet-152 at 256x192
with the FlowNet2 cascade; slice 3, the BN-folded fused backbone
(``BENCH_FUSED=1 python bench.py``): the coco_res50_256x192 config as it
stands, PoseResNet-50 folded into ``FusedPoseResNet`` with FlowNetS; the
int8 path (``BENCH_QUANT=pre python bench.py``): the same config with
PoseResNet-50 folded and quantized W8A8 (``models/quantize.py``), its
weights stored int8, its int8 products on ``torch._int_mm``; and
the serving slice on slice 1's models: ``serving.MultiStreamTracker``,
``serving.StreamingClipTracker`` and the per-frame ``tracking.FlowTracker``
over ``pipeline.PosePredictor`` and ``FlowPredictor``; and the port's
command-line entry points (``flowtrack_tpu_torch/tools``) with the
evaluators behind them. Phases that each print one or more lines:

  1. device: refuses to run without CUDA; prints the card's name and power
     limit as nvidia-smi reports them;
  2. build: compiles the kernels in flowtrack_tpu_torch/csrc with nvcc, one
     process per source;
  3. kernels: each kernel (crop, correlation, resample2d, fused_stage)
     against its plain PyTorch version on the card at the paths' shapes
     (max error against a stated tolerance; its time beside the bound the
     card sets for the same work, the plain version's time and, for the
     warp, the one library call that computes it, grid_sample; the crop also
     at the 384x288 presets' size, a 50x38 output, one crop, boxes off and
     larger than the frame, 1080x1920 frames, an unaligned frame address and
     a frame index out of range, with the bands it read from staged rows
     and straight from the frame, crop_params on the card against the CPU
     bit for bit, one device event a call, and two times: ``ms`` by events
     around eager calls and ``device_ms`` from a CUDA graph of 20 calls, on
     which its share of the bound is reckoned; fused_stage,
     in the form each chunk's shape dispatches to, also beside the same
     blocks through cuDNN bf16 convolutions; the stamp kernel's seven
     clock readings in order, their span within 10 us of CUDA events' over
     the same work, eagerly and replayed in a CUDA graph);
  4. slice: three chained 16-frame 384x640 clips of slice 1 at full width
     with seeded random weights after a warm-up clip, the crop and
     correlation launch counts set to 0 just before the run and read just
     after from its device trace (on the card ``run_prepared_lanes``
     replays the clip program as one CUDA graph per geometry, captured in
     the warm-up clip, and a replay launches the kernels without calling
     their wrappers, so each kernel's device functions are counted by
     name), and frames/s of the traced run; ``[graph]``: the graph
     against the eager ``_clip`` on one clip (ids, valid masks and seeds
     bit for bit, joints within 1e-3 px), frames/s of each in turns,
     capture ms, what the capture added to the tracker's graph pool, no
     host sync in either route under
     ``torch.cuda.set_sync_debug_mode("error")``, each route's wall, busy,
     idle share and device events under torch.profiler, the eager run's
     kernels by name equal to the wrappers' counts and one replay's equal
     to the eager run's; then one clip under
     torch.profiler on each route (the graph's device busy and idle share,
     host syncs, each kernel's device time; the eager route's time per
     clip.* stage); ``[graph]`` then a sparse batch (4 lanes of 16 720x1280
     frames, 32 slots, 2-6 persons a frame) posed at its bucket of 8 slots
     against its twin posing all 32: equal with the nets at fixed batches,
     K1's crops per launch from a replay's trace, replay ms in turns;
  5. flownet2: the same for slice 2 on 360x640 frames (the flow net runs at
     the /64-rounded 384x640, its fused flow shrinks back through the
     antialiased resize); the crop, correlation and warp kernels must all
     launch;
  6. fused: the same for slice 3 on 384x640 frames, the R50's batch norms
     holding seeded random statistics so that the fold does real work; the
     crop and fused_stage kernels must launch;
  6b. int8: the int8 product's card route (``ops/int8_conv.py``: patch
     matrix + ``torch._int_mm``) against its plain version (float64 conv)
     bit for bit at every distinct conv shape of the quantized R50 at 256
     crops, each timed beside cuDNN bf16, the plain version and its bound
     at the int8 peak, and all +-127 operands at the largest K; the four
     modes (folded bf16, int8, prequantized, mixed bf16) at 256 crops
     beside the bf16 PoseResNet and the fused one of the same weights, ms a
     forward, and the card against the port's CPU run on 4 crops; three
     chained clips of the int8 path (crop and int8 GEMM launched) beside
     the same config with the bf16 PoseResNet; the closed loop's check
     (tests/test_quantize.py:119) runs in phase 12 on the R18 it trains;
  6c. aot: slice 1's and the fused path's clip programs exported for
     ``cuda`` by ``flowtrack_tpu_torch/aot.py`` (``torch.export``) and
     loaded back: over two chained clips the artifact equals the live
     tracker bit for bit, and launches the path's kernels; the live
     tracker's second clip, run after the export, equals the eager
     ``_clip`` (the fused net's graph is captured again after the export
     rebuilt its blocks);
  7. tracking: planted-heatmap pose and constant-flow stubs, under both
     flow conventions (FlowNetC's quarter-resolution flow / div_flow, and
     the FlowNet2 cascade's full-resolution flow on 360x640 frames); ids
     must stay stable across clip boundaries and survive a dropped
     detection, and equal the port's plain run on the CPU; the clip graph
     equals the eager ``_clip`` bit for bit over the chained clips;
  8. eval: the port's CLIs through their own ``main``, their stdout kept
     aside: ``track`` with flowtrack_posetrack (R152 256x192) and FlowNetC,
     bf16, seeded random weights written as the reference's .npz, over a
     synthetic PoseTrack set of 2 videos x 16 frames of 384x640 with 4
     persons (tests/fixtures.py), under the stream and the clip engine, the
     crop and correlation launch counts read around each run, tracks.json's
     keys and the printed stats checked, ms a frame of the tracking; ``test``
     (coco_res50_256x192) on a synthetic COCO set, its ten AP stats finite;
     ``track_video`` with the two videos as two streams, ``demo`` on one
     frame and ``eval_flow`` with FlowNetC on 4 pairs against a .flo
     truth, each with its launches read; then the closed loops of
     ``bench.py`` through the port's evaluators: gaussian heatmaps planted
     at known joints of 8 images x 8 persons, decoded and rescored on the
     card (COCO AP 1.0, decode error under one heatmap cell, equal to the
     CPU's within 1e-3 px), and the planted stubs on a 6-frame clip with a
     detector miss at frame 3 (PoseTrack MOTA 1.0 and no switch from both
     backends, the run with no miss as the truth);
  9. serving: slice 1's models at full width (every candidate kept); four
     streams of 40 frames submitted in turns to MultiStreamTracker
     (16-frame clips, the four streams batched as lanes of one run) at
     pipeline depths 0 and 1, with the launches of one batched step read
     around it (2 crop launches, 1 correlation launch, for four lanes),
     every count of this phase's tracker runs from their device trace; how
     far the nets' outputs move with the batch; each stream's emissions
     equal to track_video_clips on it alone with the nets called at one
     lane's batch, and the path's own divergence; the planted stubs
     through it with a detection dropped at a clip boundary, one id a
     person, equal to the CPU's run; StreamingClipTracker on 32 frames equal to
     track_video_clips at clip length 2, its submit-to-emit latency after a
     warm-up; FlowTracker over PosePredictor and FlowPredictor, its ms per
     frame and its planted ids equal to the CPU's; track_clips of 4 lanes
     against 4 track_clip calls in turns (frames/s of both, every slot
     equal with the nets at one lane's batch); the 4-lane clip graph
     against the eager ``_clip`` (``[graph]``); every serving tracker's
     graphs (geometry, capture ms, each capture's pool growth, the shared
     pool's MiB), and one tracker over clips of three frame sizes, each
     run equal to the eager ``_clip``; device events per lane-clip
     at C=1 and C=4 under torch.profiler;
 10. precision: the bf16 pose and flow nets (FlowNetC, FlowNet2 with
     float32 glue) against float32 ones with the same weights, and the
     fused R50 against the unfused bf16 and float32 ones, at full width;
 10b. mesh: slice 1's tracker on the mesh of every card and on a 2-slot
     mesh repeating the first (``flowtrack_tpu_torch/parallel``):
     ``track_clips(sharding=)`` of 4 lanes of 16-frame 384x640 clips bit
     for bit against each slot's lanes run alone, K1 and K2 launches per
     device from its own trace, sharded and unsharded frames/s in turns;
     one clip frame-sharded (``track_clip(frame_sharding=)``), its
     divergence from the whole clip logged (half the batch per call);
     ``MultiStreamTracker(sharding=)`` with four 40-frame streams against
     the same groups of streams served unsharded, bit for bit;
     ``run_validation(mesh=)`` with the unsharded AP table; the sharded
     train step in two gloo ranks on the first card (R50 256x192, 16 a
     rank, and FlowNetC with K2 in every rank, float32, SGD) within 1e-6 +
     1e-5 relative of the unsharded step on the global batch; with two
     cards or more, the same over nccl across cards;
 11. train: coco_res50_256x192's train section (R50 256x192, batch 32,
     Adam, bf16) over a synthetic COCO set (tests/fixtures.py) through
     BatchLoader, then timed steps on one batch on the card (ms/step,
     samples/s; the loss must fall and the running statistics move); a
     FlowNetC step and a FlowNet2 fine-tune step at 320x448, batch 8, timed,
     with their K2 and warp launches; kernel-route gradients against
     plain-route ones (bf16 and float32; K2 in FlowNetC, the warp in
     FlowNet2), FlowNetC's conv1 gradient with
     the cost volume detached, and K2 and the warp alone against central
     differences, with the plain backward's time beside the forward's;
 11b. compiled: the reference's jitted programs outside the clip as CUDA
     graphs (``flowtrack_tpu_torch/utils/graphs.py``), each against its
     eager program run on the same padded batch (``eager_programs``):
     ``FlowTracker`` over ``PosePredictor`` and ``FlowPredictor`` with
     slice 1's nets at coco_res50_256x192's bucket of 32, 16 frames of
     384x640, 8 persons a frame and one frame of 33 detections (a second
     bucket), tracks bit for bit, ms a frame in turns, each route traced
     (idle share, K1 and K2 by name), the graphs by bucket with capture ms
     and pool MiB, the padded rows' share of the pose call's device time;
     the train steps as the CLIs make them (``make_jit_train_step``: R50
     256x192 b32 bf16 Adam; ``train_flow.flow_step``: FlowNetC and
     FlowNet2 at 320x448 b8), 6 steps from the same weights and batches
     with the schedule's milestone at step 3, losses, parameters and
     buffers within REMAT_REPEAT_FACTOR times the eager runs' own
     difference, the device rate the schedule's, a run saved at step 3 and
     resumed into a fresh state equal to the uninterrupted one (R50,
     FlowNetC), ms a step in turns, samples/s, K2 and the warp by name in
     the replays' trace; ``run_validation`` and ``train_flow.validate``
     graph against eager bit for bit;
 12. train_cli: the train CLIs through their own ``main``, the launch
     counts read around each run: ``train_flow`` with FlowNetC at 320x448,
     batch 8, bf16, 2 epochs over a synthetic FlyingChairs-style corpus of
     16 pairs of 384x512 with a smooth planted flow (8 more for
     validation): K2 launched, val_epe finite, ``--resume`` to a third
     epoch, the saved .npz through ``eval_flow`` (K2 launched), one step
     under torch.profiler (the device ms of the step, K2's forward and
     plain backward, the warp's, the convolutions); the FlowNet2 variant
     one epoch (K2 and the warp launched, finite); ``train`` with
     coco_res50_256x192 (R50 256x192, batch 32, bf16) 2 epochs with
     validation on the synthetic COCO set, each epoch's validation
     returning (``train`` scores a failed one 0, as the reference does),
     ``--resume`` to a third with the step count carried, ms a step;
     ``--imagenet-backbone`` with a torchvision-named R50 .pth, the
     backbone on the card equal to the file bit for bit; ``remat`` on one
     R152 step of flowtrack_posetrack with, without and again without:
     gradients and running statistics within 4x what the two runs without
     differ by, every batch norm counted once, lower peak memory, ms a
     step, forward and backward ms and one profiled step each (wall
     against device busy); and the train-to-eval closed loop of
     ``bench.py`` (R18 64x64, 60 epochs) through ``train``, AP above
     max(0.3, AP before + 0.25); that R18 quantized W8A8 (``[int8]
     check=closed_loop``): its keypoints within 4 px of the float model's
     for more than 90% of the joints, both APs printed.

Phase 3 also holds the divisions by a constant on the slice's path (the
recovery crops' centers and scales, the decode's inverse map, the flow's
pair normalisation) on the card to the CPU bit for bit. A profile that
records no device event, or whose kernels by name fall short of what the
run must launch (the profiler drops a record now and then), is taken
again once, and fails the run if the second does too.

Then a short ``[summary]`` line repeating the run's headline numbers (build
seconds, K5's chunk times, frames/s and the profiled clip's wall, busy and
idle share per path, the fused R50's errors, the int8 forwards, the
serving numbers), a JSON
line with each kernel's numbers (launches from the fused path for crop and
fused_stage, which must equal what the blocks' forms give, from the
FlowNet2 path for correlation and resample2d; ``launches_by_path`` holds
each path's counts, the eval, serving, mesh and train runs' included) and,
last,
the
device line ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero.
It needs the repository checkout (it imports the port from beside this
file) and no network; it imports neither jax nor the reference package
``flowtrack_tpu`` (the presets come from ``flowtrack_tpu_torch.config``).
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

# path shapes: slice 1 at 384x640, slice 2 (FlowNet2) at 360x640
FRAMES, FRAME_H, FRAME_W = 16, 384, 640
FN2_H, FN2_W = 360, 640
PERSONS, RECOVERED = 8, 4
# frame sizes one serving tracker captures graphs for, into one pool
POOL_FRAME_SIZES = ((FRAME_H, FRAME_W), (FN2_H, FN2_W), (192, 320))
CLIPS = 3
SEED = 0
# kernel-vs-plain tolerances, max |kernel - plain|:
# crop float32: a few ulp of the normalized value (|x| < 3; summation order)
# crop bf16: one bf16 ulp at |x| < 4 (both round float32 values that may
#   differ in the last bits)
# correlation: float32 sums of 256 bf16 products in another order, /256
CROP_F32_TOL = 1e-4
CROP_BF16_TOL = 2.0 ** -6
CORR_TOL = 1e-4
# resample2d: K4's contract against the same operations in the same order,
# each rounded once in the image dtype: 4 float32 eps, or 2 bf16 ulps, of
# the image's max |value|; integer flows copy taps and must match bitwise
WARP_F32_ULPS = 4
WARP_BF16_ULPS = 2
# bf16 compute against float32 at full width, same random weights: max
# |diff| over the float32 output's max |value| (measured on an NVIDIA H100
# 80GB HBM3 at 700 W: pose 1.5%, flow 0.5%)
POSE_BF16_REL_TOL = 0.05
FLOW_BF16_REL_TOL = 0.02
# fused_stage: the kernel and fused_stage_plain both sum exact bf16 products
# in float32, in other orders, and round to bf16 after each conv, so a sum
# that lies near a rounding boundary lands one bf16 ulp apart and the next
# conv carries that on: the bitwise share falls with depth. Measured on
# an NVIDIA H100 80GB HBM3 at 700 W: at most 1.03% of max |plain| (layer3,
# 5 blocks; 55% of the elements bitwise), under 1.5 bf16 ulps everywhere.
# Bound: 2^-6 of max |plain| per chunk, 2-4 bf16 ulps at the chunk's peak
FUSED_REL_TOL = 2.0 ** -6
# (name, (B, H, W, Cin), F, blocks, projection): every stride-1 chunk of R50
# at 256x192 with the flip batch of 256 crops (layer1 whole, layers 2-4
# after their striding first block), ragged batches of 3 crops, whose
# B*H*W leaves a partial tile at layers 3 and 4, and shapes off R50's
# path that tile as it does not, on one wgmma launch per conv: a 3x3 tiled
# by image rows, and tiles whose pixels are no multiple of 64 (three rows of
# 40 pixels; the first and last stage of the 384x288 presets at 64 crops,
# two rows of 72 pixels and one whole image of 108, timed too)
FUSED_CHUNKS = (
    ("layer1", (256, 64, 48, 64), 64, 3, True),
    ("layer2", (256, 32, 24, 512), 128, 3, False),
    ("layer3", (256, 16, 12, 1024), 256, 5, False),
    ("layer4", (256, 8, 6, 2048), 512, 2, False),
    ("layer1_b3", (3, 64, 48, 64), 64, 3, True),
    ("layer3_b3", (3, 16, 12, 1024), 256, 5, False),
    ("layer4_b3", (3, 8, 6, 2048), 512, 2, False),
    ("rows_wgmma", (3, 32, 24, 1024), 256, 1, False),
    ("w40_partial", (3, 6, 40, 256), 64, 2, False),
    ("layer1_384x288", (64, 96, 72, 64), 64, 3, True),
    ("layer4_384x288", (64, 12, 9, 2048), 512, 2, False),
)
# the chunks whose times add up to K5's time on the fused path
R50_CHUNKS = ("layer1", "layer2", "layer3", "layer4")
# FlowNet2 (float32 glue) in bf16 against float32, same metric: each stage's
# flow moves the next stage's warp, so the cascade compounds bf16 rounding.
# CPU rehearsal with random weights, 2 pairs: 9.9% and 9.6% at 128x192,
# 11.4% and 9.4% at 192x320 (two seeds); 2.2x the worst of those
FLOWNET2_BF16_REL_TOL = 0.25
# the card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W):
# operations per second by operand type, and bytes per second of HBM
PEAK_OPS = {"bf16": 989e12, "float32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12
# the serving phase: 4 streams of 40 frames (two 16-frame clips chained by
# their overlap frame, then a ragged tail of 10), StreamingClipTracker on
# 32 frames, the per-frame FlowTracker on 16
SERVE_STREAMS, SERVE_FRAMES = 4, 40
STREAM_FRAMES, FLOWTRACKER_FRAMES = 32, 16
# the exported clip programs' length: an export traces every op of the
# clip's scans on the host (seconds per thousand ops), so it is cut short
AOT_FRAMES = 4
# the planted stubs' constant motion, px per frame
PLANTED_VEL = (3.0, 1.5)
# card against card (a batched lane against its stream alone): the CPU
# tests' joint tolerance; card against CPU: the planted-pose phase's
SAME_DEVICE_JOINT_TOL = 1e-3
CPU_JOINT_TOL = 0.5
# the pose-bucket check: the benchmark's frame size, and the crops a pose
# call of its chunked nets (a divisor of both routes' pose batches and the
# recovery pass's 64 crops)
BUCKET_FRAME_HW = (720, 1280)
POSE_BUCKET_CHUNK = 64
# the run's headline numbers, printed again on one short line near the end
SUMMARY: dict = {}


def bound_ms(operations: float, op_type: str, tensors) -> tuple:
    """The least time the card could take: the larger of the operations over
    the peak rate of their type and the bytes of ``tensors`` (every input
    read once, every output written once) over the memory rate. Returns
    (ms, "operations" or "bytes")."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_ops = operations / PEAK_OPS[op_type] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def bound_fields(ms: float, bound: tuple) -> dict:
    return {"bound_ms": bound[0], "bound_by": bound[1],
            "bound_share": bound[0] / ms}


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def require(cond, what) -> None:
    """A check that stays under ``python -O`` (unlike ``assert``)."""
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn()`` with no host work between its launches:
    ``launches`` calls captured in one CUDA graph, the replays timed by CUDA
    events. The calls run back to back, so inputs that fit the L2 stay
    there."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return time_ms(graph.replay, replays, warmup=1) / launches


def device_events(fn, calls: int = 5) -> tuple:
    """``fn()`` under torch.profiler: (device events per call, {kernel or
    copy name: device ms per call})."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name, count = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            count += 1
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.device_time_total / 1e3 / calls)
    return count / calls, by_name


def crop_case(rng, dev, persons: int = PERSONS, frame_hw=(FRAME_H, FRAME_W),
              out_hw=(256, 192), frames: int = FRAMES):
    """K1's inputs at the path's shape: ``frames`` uint8 frames (numpy; one
    clip's, or C lanes' of a batched step, lane i's at i * FRAMES), and on
    the card the frame index (int64, as ClipTracker._clip makes it),
    centers and scales of ``persons`` boxes per frame, some hanging off the
    frame's edges."""
    from flowtrack_tpu_torch.pipeline import batched_box_to_center_scale

    h, w = frame_hw
    boxes = random_boxes(rng, frames, persons, h, w).reshape(-1, 4)
    centers, scales = batched_box_to_center_scale(boxes,
                                                  out_hw[1] / out_hw[0])
    centers = torch.as_tensor(centers, dtype=torch.float32, device=dev)
    scales = torch.as_tensor(scales, dtype=torch.float32, device=dev)
    idx = torch.arange(frames, device=dev).repeat_interleave(persons)
    pixels = rng.integers(0, 256, (frames, h, w, 3), np.uint8)
    return pixels, idx, centers, scales


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke runs only "
                         "on the card")
    import flowtrack_tpu_torch  # noqa: F401  (the checkout's port, or fail)

    card = card_line()
    print(card, flush=True)
    # float32 references compare in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    return card


def phase_build():
    from flowtrack_tpu_torch import kernels

    t0 = time.perf_counter()
    path = kernels.build()
    kernels.library()
    SUMMARY["build_s"] = round(time.perf_counter() - t0, 1)
    log("build", seconds=SUMMARY["build_s"], library=path.name)


def random_boxes(rng, f, p, h, w):
    """Person boxes (F, P, 4) xywh, some hanging off the frame's edges."""
    bw = rng.uniform(40, 260, (f, p))
    bh = bw * rng.uniform(1.2, 2.5, (f, p))
    x = rng.uniform(-0.2, 1.0, (f, p)) * w - bw * 0.3
    y = rng.uniform(-0.2, 1.0, (f, p)) * h - bh * 0.3
    return np.stack([x, y, bw, bh], -1).astype(np.float32)


def check_crop(dev, rng):
    """K1: crop_frames_cuda against crop_frames_plain on the path's shape in
    the four type pairs and on the shapes that take the kernel's other
    branches (which path each took is read from the kernel's own band
    counts); crop_params on the card against the CPU, bit for bit; one call
    is one device event; then the times."""
    from flowtrack_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
    from flowtrack_tpu_torch.ops import crop as crop_mod

    u8, f32, bf16 = torch.uint8, torch.float32, torch.bfloat16
    tols = {bf16: CROP_BF16_TOL, f32: CROP_F32_TOL}
    norm = (IMAGENET_MEAN, IMAGENET_STD, 255.0)
    pixels, idx, centers, scales = crop_case(rng, dev)
    frames_u8 = torch.as_tensor(pixels, device=dev).contiguous()
    worst = 0.0

    def check(name, frames, idx, centers, scales, out_hw, out_dtype,
              good=None, path=None, whole_grid=False):
        """Kernel against plain on the crops ``good`` selects (all when
        None); ``path`` names the path at least one band must have taken;
        with ``whole_grid`` every band of every crop must be counted once,
        by one path or the other."""
        nonlocal worst
        counts = torch.zeros(2, dtype=torch.int32, device=dev)
        got = crop_mod.crop_frames_cuda(frames, idx, centers, scales, out_hw,
                                        *norm, out_dtype, band_counts=counts)
        safe = idx.clamp(0, frames.shape[0] - 1)
        want = crop_mod.crop_frames_plain(frames, safe, centers, scales,
                                          out_hw, *norm, out_dtype)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == out_dtype,
                f"crop {name}: {got.dtype} {tuple(got.shape)}")
        sel = slice(None) if good is None else good
        err = (got[sel].float() - want[sel].float()).abs().max().item()
        tol = tols[out_dtype]
        staged, direct = counts.tolist()
        require(err <= tol, f"crop {name}: max err {err} > {tol}")
        bands = got.shape[0] * -(-out_hw[0] // 8)
        require(not whole_grid or staged + direct == bands,
                f"crop {name}: {staged} + {direct} bands read, the grid has "
                f"{bands}")
        require(path is None or {"staged": staged, "direct": direct}[path] > 0,
                f"crop {name}: no band took the {path} path "
                f"(staged {staged}, direct {direct})")
        worst = max(worst, err)
        log("kernels", kernel="crop", case=name, frames=str(frames.dtype),
            frame_hw=f"{frames.shape[1]}x{frames.shape[2]}",
            out=str(out_dtype), out_hw=f"{out_hw[0]}x{out_hw[1]}",
            crops=got.shape[0], bands_staged=staged, bands_direct=direct,
            max_abs_err=err, tol=tol)
        return got, want

    # the path's shape in the four type pairs
    for frames in (frames_u8.float(), frames_u8):
        for out_dtype in (bf16, f32):
            check("path", frames, idx, centers, scales, (256, 192), out_dtype,
                  path="staged", whole_grid=True)
    # a batched serving step of SERVE_STREAMS lanes: one launch for its
    # C*F*P crops from the lanes' C*F frames (512 crops x 32 bands from 64
    # frames), and its recovery pass's budget of F crops a lane at the
    # lanes' frame offsets
    lane_pixels, lane_idx, lane_c, lane_s = crop_case(
        rng, dev, frames=SERVE_STREAMS * FRAMES)
    lane_frames = torch.as_tensor(lane_pixels, device=dev).contiguous()
    rec_idx = (torch.arange(SERVE_STREAMS, device=dev)[:, None] * FRAMES
               + torch.as_tensor(rng.integers(0, FRAMES, (SERVE_STREAMS,
                                                          FRAMES)),
                                 device=dev)).reshape(-1)
    rec_pick = torch.as_tensor(rng.choice(len(lane_idx), len(rec_idx),
                                          replace=False), device=dev)
    lane_cases = {
        "serving_step": (lane_frames, lane_idx, lane_c, lane_s),
        "serving_recovery": (lane_frames, rec_idx, lane_c[rec_pick],
                             lane_s[rec_pick])}
    for name, case in lane_cases.items():
        for out_dtype in (bf16, f32):
            check(name, *case, (256, 192), out_dtype, whole_grid=True)
    # the 384x288 presets' crops; a plane that is no multiple of 8 elements
    # (scalar stores); one crop
    for out_hw in ((384, 288), (50, 38)):
        _, idx2, c2, s2 = crop_case(rng, dev, out_hw=out_hw)
        for out_dtype in (bf16, f32):
            check("out_size", frames_u8, idx2, c2, s2, out_hw, out_dtype)
    check("one_crop", frames_u8, idx[5:6], centers[5:6], scales[5:6],
          (256, 192), bf16)
    # int32 indices select the same frames
    a, _ = check("int32_index", frames_u8, idx.int(), centers, scales,
                 (256, 192), bf16)
    b = crop_mod.crop_frames_cuda(frames_u8, idx, centers, scales, (256, 192),
                                  *norm, bf16)
    require(torch.equal(a, b), "crop: int32 and int64 indices disagree")
    # boxes wholly off the frame: the normalized zero (0 / 255 - mean) / std
    off_c = torch.tensor([[-900.0, 100.0], [300.0, -1200.0], [2500.0, 2000.0],
                          [300.0, 1500.0]], device=dev)
    off_s = torch.tensor([[0.6, 0.8], [0.9, 1.2], [1.5, 2.0], [0.3, 0.4]],
                         device=dev)
    got, want = check("off_frame", frames_u8, idx[:4], off_c, off_s,
                      (256, 192), f32)
    zero = -torch.tensor(IMAGENET_MEAN, device=dev) / torch.tensor(
        IMAGENET_STD, device=dev)
    require(max((got - zero).abs().max().item(),
                (want - zero).abs().max().item()) <= CROP_F32_TOL,
            "crop: a box off the frame is not the normalized zero")
    # boxes larger than the frame (s 4.2 to 10): the rectangle of a band
    # exceeds the staging buffer, the kernel reads global memory
    big_c = torch.tensor([[320.0, 192.0], [100.0, 300.0], [600.0, 50.0]],
                         device=dev)
    big_s = torch.tensor([[4.0, 5.4], [6.0, 8.0], [9.6, 12.8]], device=dev)
    for frames in (frames_u8, frames_u8.float()):
        for out_dtype in (bf16, f32):
            check("larger_than_frame", frames, idx[:3], big_c, big_s,
                  (256, 192), out_dtype, path="direct")
    # 1080x1920 frames, uint8 and float32, boxes of 50 to 600 px
    hd_pixels, hd_idx, hd_c, hd_s = crop_case(rng, dev, persons=1,
                                              frame_hw=(1080, 1920))
    hd = torch.as_tensor(hd_pixels[:4], device=dev).contiguous()
    hd_s = hd_s * torch.linspace(1.0, 4.0, len(hd_s), device=dev)[:, None]
    for frames, out_dtype in ((hd, bf16), (hd, f32), (hd.float(), bf16),
                              (hd.float(), f32)):
        check("1080p", frames, hd_idx % 4, hd_c, hd_s, (256, 192), out_dtype,
              path="direct")
    # frames at an address that is no multiple of 16: all direct
    flat = torch.empty(frames_u8.numel() + 16, dtype=u8, device=dev)
    shifted = flat[3:3 + frames_u8.numel()].view(frames_u8.shape)
    shifted.copy_(frames_u8)
    require(shifted.data_ptr() % 16 != 0 and shifted.is_contiguous(),
            "unaligned frames")
    check("unaligned_frames", shifted, idx, centers, scales, (256, 192), bf16,
          path="direct")
    # a frame index out of range: a NaN crop, its neighbours untouched
    bad = idx.clone()
    bad[[3, 77]] = torch.tensor([-1, FRAMES], device=dev)
    good = torch.ones(len(bad), dtype=torch.bool, device=dev)
    good[[3, 77]] = False
    got, _ = check("bad_index", frames_u8, bad, centers, scales, (256, 192),
                   f32, good=good)
    require(torch.isnan(got[~good]).all().item()
            and torch.isfinite(got[good]).all().item(),
            "crop: an index out of range must give a NaN crop and only that")
    # crop_params on the card equals the CPU's bit for bit (a division by a
    # Python scalar would be a multiply by the rounded reciprocal there)
    for out_hw in ((256, 192), (384, 288), (50, 38)):
        on_card = crop_mod.crop_params(centers, scales, out_hw)
        on_cpu = crop_mod.crop_params(centers.cpu(), scales.cpu(), out_hw)
        differ = sum(int((a.cpu() != b).sum()) for a, b in zip(on_card, on_cpu))
        require(differ == 0, f"crop_params {out_hw}: {differ} values differ "
                             f"between the card and the CPU")
        log("kernels", kernel="crop", check="crop_params card == cpu",
            out_hw=f"{out_hw[0]}x{out_hw[1]}", boxes=len(centers), differ=0)

    # timed at the main path's own types: the video's uint8 frames, as
    # ClipTracker.prepare puts them on the card, -> bf16 crops
    args = (frames_u8, idx, centers, scales, (256, 192), *norm, bf16)

    def call():
        return crop_mod.crop_frames_cuda(*args)

    events, by_name = device_events(call)
    require(events == 1 and all("crop" in k for k in by_name),
            f"crop: one call must be one kernel and nothing else, got "
            f"{events} device events: {sorted(by_name)}")
    ms = time_ms(call, 200)
    device_ms = graph_ms(call)
    plain_ms = time_ms(lambda: crop_mod.crop_frames_plain(*args), 5)
    # the recovery pass's launch: 16 crops
    few = (frames_u8, idx[::PERSONS].contiguous(),
           centers[::PERSONS].contiguous(), scales[::PERSONS].contiguous(),
           (256, 192), *norm, bf16)
    few_ms = time_ms(lambda: crop_mod.crop_frames_cuda(*few), 200)
    few_device_ms = graph_ms(lambda: crop_mod.crop_frames_cuda(*few))
    step = (*lane_cases["serving_step"], (256, 192), *norm, bf16)
    step_ms = time_ms(lambda: crop_mod.crop_frames_cuda(*step), 50)
    step_device_ms = graph_ms(lambda: crop_mod.crop_frames_cuda(*step))
    step_crops = crop_mod.crop_frames_cuda(*step)
    step_bound = bound_ms(10.0 * step_crops.numel(), "float32",
                          (*lane_cases["serving_step"], step_crops))
    # per output value: 4 taps weighted and summed, scaled and normalised
    # in float32 (about 10 operations); no one library call crops by boxes.
    # The share of the bound is reckoned on the device time alone; `ms`, by
    # events around eager calls, also holds the launch's host cost
    crops = call()
    bound = bound_fields(device_ms, bound_ms(
        10.0 * crops.numel(), "float32",
        (frames_u8, idx, centers, scales, crops)))
    SUMMARY["k1_ms_device_ms"] = (round(ms, 4), round(device_ms, 4))
    log("kernels", kernel="crop", frames=str(frames_u8.dtype),
        out=str(crops.dtype), crops=crops.shape[0], device_events=events,
        ms=ms, device_ms=device_ms, plain_ms=plain_ms, **bound,
        recovery_crops=len(few[1]), recovery_ms=few_ms,
        recovery_device_ms=few_device_ms)
    log("kernels", kernel="crop", case="serving_step", frames=len(step[0]),
        crops=step_crops.shape[0], ms=step_ms, device_ms=step_device_ms,
        bound_ms=step_bound[0], bound_by=step_bound[1],
        bound_share=step_bound[0] / step_device_ms)
    return {"name": "crop_resize_normalize", "route": "cuda",
            "source": "flowtrack_tpu_torch/csrc/crop.cu",
            "replaces": "flowtrack_tpu/ops/crop.py:113",
            "max_abs_err": worst, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, **bound, "library_ms": None}


def check_divisions(dev, rng):
    """The divisions by a constant on the slice's path, on the card against
    the CPU bit for bit (a division by a Python scalar would be a multiply
    by the rounded reciprocal there): the recovery crops' centers and
    scales, the decode's inverse map and the flow's pair normalisation, at
    the path's shapes."""
    from flowtrack_tpu_torch.models.flownet import preprocess_pair
    from flowtrack_tpu_torch.ops.affine import get_affine_transform_inv
    from flowtrack_tpu_torch.tracking.clip_pipeline import (
        _box_xyxy_to_center_scale,
    )

    xy = rng.uniform(-50, FRAME_W, (4096, 2))
    boxes = torch.as_tensor(
        np.concatenate([xy, xy + rng.uniform(0.5, 400, (4096, 2))], 1),
        dtype=torch.float32)
    centers, scales = _box_xyxy_to_center_scale(boxes, 192 / 256)
    frames = torch.as_tensor(rng.integers(0, 256, (FRAMES, FRAME_H, FRAME_W,
                                                   3), np.uint8))
    cases = {
        "box_xyxy_to_center_scale": lambda d: _box_xyxy_to_center_scale(
            boxes.to(d), 192 / 256),
        "affine_transform_inv": lambda d: (get_affine_transform_inv(
            centers.to(d), scales.to(d), (48, 64)),),
        "preprocess_pair": lambda d: (preprocess_pair(
            frames[:-1].to(d), frames[1:].to(d)),),
    }
    for name, fn in cases.items():
        on_card, on_cpu = fn(dev), fn(torch.device("cpu"))
        differ = sum(int((a.cpu() != b).sum()) for a, b in zip(on_card, on_cpu))
        values = sum(b.numel() for b in on_cpu)
        require(differ == 0, f"{name}: {differ} of {values} values differ "
                             f"between the card and the CPU")
        log("kernels", check=f"{name} card == cpu", values=values, differ=0)


STAMP_TOL_MS = 0.01


def check_stamp(dev):
    """``flowtrack::stamp`` (csrc/stamp.cu) on the card: seven stamps around
    six matmuls do not decrease, and the first and last differ by the CUDA
    events' time of the same work within ``STAMP_TOL_MS``; captured in a
    CUDA graph, each replay reads the clock anew. The device sleeps first,
    so that every launch is queued before the work starts and no host
    launch time lies between the events."""
    from flowtrack_tpu_torch.utils import profiling

    a = torch.randn(2048, 2048, device=dev)
    buf = torch.zeros(7, dtype=torch.int64, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def stamped():
        profiling.stamp(buf, 0)
        for i in range(1, 7):
            a @ a
            profiling.stamp(buf, i)

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        stamps = buf.cpu()
        require((stamps.diff() >= 0).all(), f"stamps decrease: {stamps}")
        stamp_ms = (stamps[-1] - stamps[0]).item() / 1e6
        event_ms = start.elapsed_time(end)
        require(0 < stamp_ms <= event_ms + STAMP_TOL_MS
                and event_ms - stamp_ms <= STAMP_TOL_MS,
                f"stamps span {stamp_ms} ms, events {event_ms} ms")
        return stamps, stamp_ms, event_ms

    stamped()
    _, stamp_ms, event_ms = timed(stamped)
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        stamped()
    first, _, _ = timed(graph.replay)
    second, g_stamp_ms, g_event_ms = timed(graph.replay)
    require(second[0] > first[-1], "a replay reread no clock: "
            f"{first.tolist()} then {second.tolist()}")
    log("kernels", kernel="stamp", stamp_ms=stamp_ms, event_ms=event_ms,
        graph_stamp_ms=g_stamp_ms, graph_event_ms=g_event_ms,
        tol_ms=STAMP_TOL_MS)


def phase_kernels():
    from flowtrack_tpu_torch.ops import correlation as corr_mod

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    results = []

    results.append(check_crop(dev, rng))
    check_divisions(dev, rng)
    check_stamp(dev)

    # K2: the FlowNetC cost volume of one clip's 15 pairs at 1/8 resolution
    shape = (FRAMES - 1, FRAME_H // 8, FRAME_W // 8, 256)
    f1 = torch.as_tensor(rng.standard_normal(shape), device=dev).to(torch.bfloat16)
    f2 = torch.as_tensor(rng.standard_normal(shape), device=dev).to(torch.bfloat16)
    f1n = f1.permute(0, 3, 1, 2).contiguous()
    f2n = f2.permute(0, 3, 1, 2).contiguous()
    route = corr_mod.correlation_route(f1n.dtype, 256, shape[2], 20, 2)
    require(route == "mma", f"bf16 features take route {route}")
    got = corr_mod.correlation_cuda(f1n, f2n, 20, 2)
    want = corr_mod.correlation_plain(f1, f2, 20, 2).permute(0, 3, 1, 2)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    require(err <= CORR_TOL, f"correlation: max err {err} > {CORR_TOL}")
    # a batched serving step: the C*(F-1) = 60 in-lane pairs of 4 lanes in
    # one launch
    lane_shape = (SERVE_STREAMS * (FRAMES - 1), *shape[1:])
    l1, l2 = (torch.as_tensor(rng.standard_normal(lane_shape), device=dev
                              ).to(torch.bfloat16) for _ in range(2))
    l1n, l2n = (x.permute(0, 3, 1, 2).contiguous() for x in (l1, l2))
    got_l = corr_mod.correlation_cuda(l1n, l2n, 20, 2)
    want_l = corr_mod.correlation_plain(l1, l2, 20, 2).permute(0, 3, 1, 2)
    torch.cuda.synchronize()
    err_l = (got_l - want_l).abs().max().item()
    require(got_l.shape == want_l.shape and err_l <= CORR_TOL,
            f"correlation {lane_shape[0]} pairs: shape {tuple(got_l.shape)}, "
            f"max err {err_l} > {CORR_TOL}")
    del got_l, want_l
    lane_ms = time_ms(lambda: corr_mod.correlation_cuda(l1n, l2n, 20, 2), 10)
    lane_bound = correlation_bound_ms(*l1n.shape, 21)
    log("kernels", kernel="correlation", case="serving_step",
        pairs=lane_shape[0], max_abs_err=err_l, tol=CORR_TOL, ms=lane_ms,
        bound_ms=lane_bound[0], bound_by=lane_bound[1],
        bound_share=lane_bound[0] / lane_ms)
    err = max(err, err_l)
    # bf16 features on a ragged map (W no multiple of 8, C none of 16, odd
    # stride2): the tensor-core kernel's masks; a 1080x1920 video's map,
    # whose 256 channels go through in two chunks; a ragged map wider than
    # one block's 256 columns with its channels in three chunks; and a
    # displacement over 24, the CUDA-core kernel's
    for rag_shape, md, s2 in (((2, 40, 9, 11), 4, 1), ((1, 64, 7, 24), 5, 3),
                              ((1, 256, 5, 240), 20, 2),
                              ((1, 520, 3, 301), 20, 2),
                              ((1, 24, 6, 90), 40, 4)):
        r1 = torch.as_tensor(rng.standard_normal(rag_shape), device=dev
                             ).to(torch.bfloat16)
        r2 = torch.as_tensor(rng.standard_normal(rag_shape), device=dev
                             ).to(torch.bfloat16)
        got16 = corr_mod.correlation_cuda(r1, r2, md, s2)
        want16 = corr_mod.correlation_plain(
            r1.permute(0, 2, 3, 1), r2.permute(0, 2, 3, 1), md, s2
        ).permute(0, 3, 1, 2)
        torch.cuda.synchronize()
        err16 = (got16 - want16).abs().max().item()
        require(got16.shape == want16.shape and err16 <= CORR_TOL,
                f"correlation bf16 {rag_shape} md {md} stride2 {s2}: shape "
                f"{tuple(got16.shape)}, max err {err16} > {CORR_TOL}")
        rag_route = corr_mod.correlation_route(r1.dtype, rag_shape[1],
                                               rag_shape[3], md, s2)
        require(rag_route == ("mma" if md <= 24 else "cuda_core"),
                f"correlation bf16 md {md}: route {rag_route}")
        log("kernels", kernel="correlation", features="bfloat16",
            route=rag_route,
            shape="x".join(map(str, rag_shape)), md=md, stride2=s2,
            staging=tuple(corr_mod.band_plan(rag_shape[1], rag_shape[3]))
            if rag_route == "mma" else None,
            max_abs_err=err16, tol=CORR_TOL)
    # float32 features (float32 configs) at another grid, on a ragged map
    g1 = torch.as_tensor(rng.standard_normal((2, 32, 9, 11)), device=dev).float()
    g2 = torch.as_tensor(rng.standard_normal((2, 32, 9, 11)), device=dev).float()
    got32 = corr_mod.correlation_cuda(g1, g2, 4, 1)
    want32 = corr_mod.correlation_plain(g1.permute(0, 2, 3, 1),
                                        g2.permute(0, 2, 3, 1), 4, 1)
    torch.cuda.synchronize()
    err32 = (got32 - want32.permute(0, 3, 1, 2)).abs().max().item()
    require(got32.shape == (2, 81, 9, 11) and err32 <= CORR_TOL,
            f"correlation float32 md 4: shape {tuple(got32.shape)}, "
            f"max err {err32} > {CORR_TOL}")
    log("kernels", kernel="correlation", features="float32",
        route=corr_mod.correlation_route(g1.dtype, 32, 11, 4, 1), md=4,
        stride2=1, max_abs_err=err32, tol=CORR_TOL)
    ms = time_ms(lambda: corr_mod.correlation_cuda(f1n, f2n, 20, 2), 20)
    plain_ms = time_ms(lambda: corr_mod.correlation_plain(f1, f2, 20, 2), 2,
                       warmup=1)
    # no one library call gives the banded volume (F.unfold would build
    # the 441 shifted copies first)
    bound = bound_fields(ms, correlation_bound_ms(*f1n.shape, 21))
    log("kernels", kernel="correlation", features="bfloat16", route=route,
        max_abs_err=err, tol=CORR_TOL, ms=ms, plain_ms=plain_ms, **bound)
    results.append({"name": "correlation", "route": "cuda",
                    "source": "flowtrack_tpu_torch/csrc/correlation.cu",
                    "replaces": "flowtrack_tpu/ops/correlation.py:73",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    **bound, "library_ms": None})
    results.append(check_warp(dev, rng))
    results.append(check_fused_stage(dev))
    torch.cuda.synchronize()
    return results


def correlation_bound_ms(n, c, h, w, d) -> tuple:
    """K2's bound for bf16 features: the D*D kept sums over C as tensor-core
    operations, two feature maps in and the float32 volume out."""
    meta = torch.device("meta")
    feat = torch.empty((2, n, c, h, w), dtype=torch.bfloat16, device=meta)
    vol = torch.empty((n, d * d, h, w), dtype=torch.float32, device=meta)
    return bound_ms(2.0 * n * d * d * h * w * c, "bf16", (feat, vol))


def smooth_flow(rng, n, h, w, amplitude, dev):
    """Cascade-like flow (n, 2, h, w): a random 6x10 grid of displacements
    within +-amplitude px, bilinearly enlarged."""
    coarse = torch.as_tensor(rng.uniform(-amplitude, amplitude, (n, 2, 6, 10)),
                             dtype=torch.float32, device=dev)
    return torch.nn.functional.interpolate(coarse, size=(h, w),
                                           mode="bilinear",
                                           align_corners=False).contiguous()


def check_warp(dev, rng):
    """K3/K4: the FlowNet2 cascade's dense warp of one clip's 15 pairs at
    the 384x640 net size, against resample2d_plain in each regime."""
    from flowtrack_tpu_torch.ops import warp as warp_mod

    n, c, h, w = FRAMES - 1, 3, FRAME_H, FRAME_W
    img = torch.as_tensor(rng.normal(0, 0.3, (n, c, h, w)),
                          dtype=torch.float32, device=dev)
    smooth = smooth_flow(rng, n, h, w, 5.0, dev)
    big = torch.as_tensor(rng.uniform(-30, 30, (n, 2, h, w)),
                          dtype=torch.float32, device=dev)
    # |u|, |v| >= 700 > 640: every sample coordinate clamps to an edge
    clamped = torch.as_tensor(rng.choice([-1.0, 1.0], (n, 2, h, w))
                              * rng.uniform(700, 3000, (n, 2, h, w)),
                              dtype=torch.float32, device=dev)
    integer = torch.as_tensor(rng.integers(-6, 7, (n, 2, h, w)),
                              dtype=torch.float32, device=dev)
    rag_img = torch.as_tensor(rng.normal(0, 0.3, (2, c, 13, 27)),
                              dtype=torch.float32, device=dev)
    rag_flow = torch.as_tensor(rng.uniform(-5, 5, (2, 2, 13, 27)),
                               dtype=torch.float32, device=dev)
    bf16 = torch.bfloat16
    f32_ulp = torch.finfo(torch.float32).eps
    bf16_ulp = 2.0 ** -8     # half the spacing above 1, as the eps above
    cases = [("smooth", img, smooth, WARP_F32_ULPS * f32_ulp),
             ("large", img, big, WARP_F32_ULPS * f32_ulp),
             ("clamped", img, clamped, WARP_F32_ULPS * f32_ulp),
             ("integer", img, integer, 0.0),
             ("bf16", img.to(bf16), smooth.to(bf16), WARP_BF16_ULPS * bf16_ulp),
             ("bf16_integer", img.to(bf16), integer.to(bf16), 0.0),
             ("ragged_13x27", rag_img, rag_flow, WARP_F32_ULPS * f32_ulp),
             ("ragged_bf16", rag_img.to(bf16), rag_flow,
              WARP_BF16_ULPS * bf16_ulp)]
    worst = 0.0
    for name, im, fl, ulps in cases:
        got = warp_mod.resample2d_cuda(im, fl)
        want = warp_mod.resample2d_plain(im, fl)
        torch.cuda.synchronize()
        require(got.dtype == im.dtype and got.shape == im.shape,
                f"resample2d {name}: {got.dtype} {tuple(got.shape)}")
        err = (got.float() - want.float()).abs().max().item()
        tol = ulps * im.float().abs().max().item()
        require(err <= tol, f"resample2d {name}: max err {err} > {tol}")
        worst = max(worst, err)
        log("kernels", kernel="resample2d", case=name, img=str(im.dtype),
            flow=str(fl.dtype), shape="x".join(map(str, im.shape)),
            max_abs_err=err, tol=tol)
    # timed at the path's types: float32 glue, cascade-like flow
    ms = time_ms(lambda: warp_mod.resample2d_cuda(img, smooth), 50)
    plain_ms = time_ms(lambda: warp_mod.resample2d_plain(img, smooth), 5)

    def library():
        """The one library call that warps: grid_sample, with its grid built
        from the flow inside the timed region. A yardstick only: the port
        never calls it, and it rounds in another order than the kernel."""
        ys = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
        xs = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
        grid = torch.stack(((xs + smooth[:, 0]) * (2.0 / (w - 1)) - 1.0,
                            (ys + smooth[:, 1]) * (2.0 / (h - 1)) - 1.0), -1)
        return torch.nn.functional.grid_sample(
            img, grid, mode="bilinear", padding_mode="border",
            align_corners=True)

    lib_err = (library() - warp_mod.resample2d_cuda(img, smooth)
               ).abs().max().item()
    require(lib_err <= 1e-3, f"grid_sample is not the same warp: {lib_err}")
    library_ms = time_ms(library, 20)
    # per output value: 4 taps weighted and summed in float32 (about 8
    # operations, the coordinates shared by the 3 channels)
    bound = bound_fields(ms, bound_ms(8.0 * img.numel(), "float32",
                                      (img, smooth, img)))
    log("kernels", kernel="resample2d", ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, library_max_abs_diff=lib_err, **bound)
    return {"name": "resample2d", "route": "cuda",
            "source": "flowtrack_tpu_torch/csrc/resample2d.cu",
            "replaces": "flowtrack_tpu/ops/warp.py:344 and "
                        "flowtrack_tpu/ops/warp.py:215",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": library_ms}


def random_blocks(gen, cin, f, nblocks, projection, dev):
    """Seeded folded bottleneck blocks in the kernel's layouts: He-normal
    bf16 weights (fan-in), float32 biases N(0, 0.1)."""

    def weight(k, n, fan_in):
        return (torch.randn((k, n), generator=gen) * (2.0 / fan_in) ** 0.5
                ).to(dev, torch.bfloat16)

    def bias(n):
        return (torch.randn((1, n), generator=gen) * 0.1).to(dev)

    blocks = []
    for i in range(nblocks):
        c = cin if i == 0 else 4 * f
        blk = {"w1": weight(c, f, c), "b1": bias(f),
               "w2": weight(9 * f, f, 9 * f).view(3, 3 * f, f), "b2": bias(f),
               "w3": weight(f, 4 * f, f), "b3": bias(4 * f)}
        if i == 0 and projection:
            blk.update(wd=weight(c, 4 * f, c), bd=bias(4 * f))
        blocks.append(blk)
    return blocks


def chunk_flops(shape, blocks) -> int:
    """Multiply-adds x 2 of a chunk of stride-1 blocks over B*H*W pixels."""
    m = shape[0] * shape[1] * shape[2]
    return 2 * m * sum(v.numel() for blk in blocks
                       for k, v in blk.items() if k[0] == "w")


def fused_bound_ms(shape, blocks) -> tuple:
    """K5's bound for a chunk: its products as bf16 tensor-core operations;
    the chunk's input, its weights and biases in, its output out (what lies
    between the blocks need never touch device memory)."""
    meta = torch.device("meta")
    x = torch.empty(shape, dtype=torch.bfloat16, device=meta)
    out = torch.empty((*shape[:3], blocks[-1]["w3"].shape[1]),
                      dtype=torch.bfloat16, device=meta)
    params = [v for blk in blocks for v in blk.values()]
    return bound_ms(chunk_flops(shape, blocks), "bf16", (x, out, *params))


def check_fused_stage(dev):
    """K5: fused_stage_cuda against fused_stage_plain (float32 sums of the
    same bf16 products) at every R50 stage-chunk shape of the fused path, in
    the form the shape dispatches to (the launch count must be the form's),
    each timed beside its bound, the plain version and the same blocks
    through cuDNN bf16 convolutions (``block_conv``: many library calls, a
    yardstick and not one call that computes the chunk)."""
    from flowtrack_tpu_torch.ops import fused_resnet as fr

    gen = torch.Generator().manual_seed(SEED + 3)
    worst, rows, bounds = 0.0, {}, []
    for name, shape, f, nblocks, projection in FUSED_CHUNKS:
        blocks = fr.CheckedBlocks(
            random_blocks(gen, shape[-1], f, nblocks, projection, dev))
        x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
        forms = [fr.block_form(shape[1], shape[2], f, "wd" in blk).kind
                 for blk in blocks]
        before = fr.fused_stage_cuda.launches
        got = fr.fused_stage_cuda(x, blocks)
        launched = fr.fused_stage_cuda.launches - before
        require(launched == fr.stage_launches(shape[1], shape[2], blocks),
                f"fused_stage {name}: {launched} launches for forms {forms}")
        want = fr.fused_stage_plain(x, blocks, 1)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == torch.bfloat16,
                f"fused_stage {name}: {got.dtype} {tuple(got.shape)}")
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        bitwise = (got == want).float().mean().item()
        require(rel <= FUSED_REL_TOL,
                f"fused_stage {name}: max err {rel} of max |plain| > "
                f"{FUSED_REL_TOL}")
        worst = max(worst, err)
        fields = dict(kernel="fused_stage", chunk=name,
                      shape="x".join(map(str, shape)), f=f, blocks=nblocks,
                      projection=projection, forms="+".join(forms),
                      launches=launched, max_abs_err=err, rel_err=rel,
                      tol=FUSED_REL_TOL, bitwise_share=bitwise)
        if shape[0] > 3:
            tflop = chunk_flops(shape, blocks) / 1e12

            def cudnn(x=x, blocks=blocks):
                for blk in blocks:
                    x = fr.block_conv(x, blk, 1)
                return x

            ms = time_ms(lambda: fr.fused_stage_cuda(x, blocks), 10)
            plain_ms = time_ms(lambda: fr.fused_stage_plain(x, blocks, 1), 2,
                               warmup=1)
            cudnn_ms = time_ms(cudnn, 10)
            bound = fused_bound_ms(shape, blocks)
            if name in R50_CHUNKS:
                rows[name] = (ms, plain_ms, cudnn_ms)
                bounds.append(bound)
            SUMMARY.setdefault("k5_ms", {})[name] = round(ms, 3)
            fields.update(ms=ms, plain_ms=plain_ms, cudnn_ms=cudnn_ms,
                          **bound_fields(ms, bound),
                          tflop=tflop, tflops=tflop / ms * 1e3,
                          plain_tflops=tflop / plain_ms * 1e3,
                          cudnn_tflops=tflop / cudnn_ms * 1e3)
        log("kernels", **fields)
    ms, plain_ms, cudnn_ms = (sum(r[i] for r in rows.values())
                              for i in range(3))
    # the four chunks run one after the other: their bounds add, and what
    # binds the sum is what binds most of it
    by = max(("operations", "bytes"),
             key=lambda k: sum(b[0] for b in bounds if b[1] == k))
    bound = bound_fields(ms, (sum(b[0] for b in bounds), by))
    log("kernels", kernel="fused_stage", chunks="layer1-4", ms=ms,
        plain_ms=plain_ms, cudnn_ms=cudnn_ms, **bound)
    return {"name": "fused_stage", "route": "cuda",
            "source": "flowtrack_tpu_torch/csrc/fused_stage.cu",
            "replaces": "flowtrack_tpu/ops/fused_resnet.py:223",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": None}


def video_detections(rng, n_frames, persons, h, w, vel, drop=()):
    """Persons moving at constant velocity: boxes (n_frames, P, 4) xywh,
    scores and valid (n_frames, P); person j is undetected at the global
    frames in drop[j]."""
    p = persons
    bw = rng.uniform(60, 110, p)
    bh = bw * rng.uniform(1.6, 2.2, p)
    x0 = rng.uniform(0.05, 0.6, p) * w
    y0 = rng.uniform(0.05, 0.4, p) * h
    t = np.arange(n_frames)[:, None]
    boxes = np.stack([x0 + vel[0] * t, y0 + vel[1] * t,
                      np.broadcast_to(bw, (n_frames, p)),
                      np.broadcast_to(bh, (n_frames, p))], -1)
    scores = np.broadcast_to(rng.uniform(0.6, 0.95, p), (n_frames, p)).copy()
    valid = np.ones((n_frames, p), bool)
    for j, frames in enumerate(drop):
        valid[list(frames), j] = False
    return boxes.astype(np.float32), scores.astype(np.float32), valid


def run_clips(tracker, frames, boxes, scores, valid, clip_len):
    """Chained clips overlapping by one frame, each seeded by the last."""
    outs, seed, start = [], None, 0
    while start + clip_len <= len(frames):
        sl = slice(start, start + clip_len)
        out, seed = tracker.track_clip(frames[sl], boxes[sl], scores[sl],
                                       valid[sl], seed=seed,
                                       frame_offset=start, return_seed=True)
        outs.append(out)
        start += clip_len - 1
    return outs


def kernel_counters():
    """name -> the wrapper whose ``launches`` counts that kernel."""
    from flowtrack_tpu_torch.ops import correlation as corr_mod
    from flowtrack_tpu_torch.ops import crop as crop_mod
    from flowtrack_tpu_torch.ops import fused_resnet as fused_mod
    from flowtrack_tpu_torch.ops import int8_conv
    from flowtrack_tpu_torch.ops import warp as warp_mod

    return {"crop_resize_normalize": crop_mod.crop_frames_cuda,
            "correlation": corr_mod.correlation_cuda,
            "resample2d": warp_mod.resample2d_cuda,
            "fused_stage": fused_mod.fused_stage_cuda,
            # the int8 product's library route (torch._int_mm), no kernel
            # of the port's own
            "int8_gemm": int8_conv.int8_conv2d_gemm}


# each counted kernel's device functions, as the profiler names them: the
# port's kernels by function name, and torch._int_mm's int8 GEMMs (library
# kernels, CUTLASS's tensor-op GEMMs on the H100) by the mark of their s8
# operands. ``graph_route`` holds the names to the wrappers' counts on the
# eager route.
KERNEL_FUNCTIONS = {
    "crop_resize_normalize": re.compile(r"\bcrop_band_kernel[<(]"),
    "correlation": re.compile(r"\bcorrelation(_mma)?_kernel[<(]"),
    "resample2d": re.compile(r"\bresample2d_kernel[<(]"),
    "fused_stage": re.compile(r"\b(block|conv)_wgmma_kernel[<(]"),
    "int8_gemm": re.compile(r"gemm_s8"),
}


def kernel_events(device_events) -> dict:
    """Device events of each counted kernel, by name."""
    return {k: sum(bool(rule.search(e.name)) for e in device_events)
            for k, rule in KERNEL_FUNCTIONS.items()}


def zero_counts(run):
    """``run`` with every wrapper's launch count set to 0 just before."""
    def counted_run():
        for fn in kernel_counters().values():
            fn.launches = 0
        return run()

    return counted_run


def counted(tag, run, check=None) -> tuple:
    """``run()``, every launch count set to 0 just before, under
    torch.profiler (``profile_run``): (its result, seconds, launches). A
    replayed graph launches its kernels without calling their wrappers, so
    each kernel's launches are its device functions counted by name in
    this run's trace; the wrappers' counts, read just after, may not
    exceed them (a wrapper counts only where it launches: its eager calls,
    and a capture's, whose graph then replays). ``check(launches)`` holds
    the counts to what the run must launch; a trace that fails either is
    taken again once, with the counts at 0 again."""
    out, wall_ms, device = traced_run(tag, run, check)
    return out, wall_ms / 1e3, kernel_events(device)


def traced_run(tag, run, check=None) -> tuple:
    """``counted``'s run and checks: (run's result, wall ms, device
    events)."""
    counters = kernel_counters()
    result = {}

    def counted_run():
        result["out"] = zero_counts(run)()

    def holds(device):
        launches = kernel_events(device)
        wrappers = {k: fn.launches for k, fn in counters.items()}
        require(all(wrappers[k] <= launches[k] for k in launches),
                f"{tag}: the wrappers counted {wrappers}, the trace shows "
                f"{launches}")
        if check is not None:
            check(launches)

    _, wall_ms, device = profile_run(tag, counted_run, holds)
    return result["out"], wall_ms, device


def eager_run(tracker, args, seeds=None):
    """``run_prepared_lanes``' eager route: ``ClipTracker._clip``, the
    clip graph's plain version, called directly on lane args (C, ...)."""
    with torch.inference_mode():
        empty = tracker.empty_seed()
        seeds = [empty if s is None else s
                 for s in (seeds or [None] * args[0].shape[0])]
        seed = [torch.stack(leaves) for leaves in zip(*seeds)]
        return tracker._clip(*args, *seed)


def same_routes(what, got, want, joint_tol) -> dict:
    """The clip graph's outputs against the eager ``_clip``'s (lane axis
    kept): ids, valid masks and every seed leaf equal bit for bit; joints,
    maxvals and scores within ``joint_tol`` (0: bit for bit). Returns the
    max |diff| of each float output."""
    names = ("joints", "maxvals", "scores", "ids", "valid")
    for name, a, b in zip(names[3:], got[3:5], want[3:5]):
        require(torch.equal(a, b), f"{what}: graph and eager {name} differ")
    for i, (a, b) in enumerate(zip(got[5], want[5])):
        require(torch.equal(a, b), f"{what}: graph and eager seed leaf {i} "
                                   f"differs")
    diffs = {name: (a.double() - b.double()).abs().max().item()
             for name, a, b in zip(names[:3], got[:3], want[:3])}
    require(max(diffs.values()) <= joint_tol,
            f"{what}: graph against eager {diffs} > {joint_tol}")
    return diffs


def graph_route(tag, tracker, args, card_f, bitwise=False):
    """The clip as its CUDA graph against the eager ``_clip`` on the same
    prepared lane args: the outputs (``same_routes``), each route's
    frames/s in turns (eager, graph, graph, eager; CLIPS runs each, each
    fetched to the host), the capture's ms and what it added to the
    tracker's graph pool, and no host sync in either route
    (``torch.cuda.set_sync_debug_mode("error")``). Then one run of each
    route under torch.profiler, the launch counts at 0 just before: wall
    time, device busy time and idle share, device events and host syncs
    (none allowed); the eager run's kernels by name equal to the wrappers'
    counts (which checks the names ``kernel_events`` counts by), and the
    replay's to the eager run's; for the graph, the port's kernels' device
    ms and the heaviest device ops; for the eager ``_clip`` (a replayed
    graph has no host ranges), each clip.* stage's host ms, kernel ms and
    device span ms."""
    c, f = args[0].shape[:2]
    graph = tracker.graphs.get(tracker.graph_key(args, None))
    if graph is None:
        tracker.run_prepared_lanes(args)
        graph = tracker.graphs[tracker.graph_key(args, None)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tracker.run_prepared_lanes(args)
        want = eager_run(tracker, args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    diffs = same_routes(f"{tag} graph", got, want,
                        0.0 if bitwise else SAME_DEVICE_JOINT_TOL)
    runs = {"eager": lambda: tracker.to_host(eager_run(tracker, args)),
            "graph": lambda: tracker.to_host(tracker.run_prepared_lanes(args))}
    fps = {"eager": [], "graph": []}
    for name in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CLIPS):
            runs[name]()
        fps[name].append(CLIPS * c * f / (time.perf_counter() - t0))
    fields = {"lanes": c, "frames_per_clip": f,
              "eager_frames_per_s": fps["eager"],
              "graph_frames_per_s": fps["graph"],
              "capture_ms": graph.capture_ms,
              "pool_mib": graph.pool_bytes / 2 ** 20,
              "tracker_pool_mib": sum(g.pool_bytes for g in
                                      tracker.graphs.values()) / 2 ** 20,
              "no_host_sync": True, "max_abs_diff": diffs,
              "bitwise": max(diffs.values()) == 0.0}
    counters = kernel_counters()
    seen = {}

    def same_as_wrappers(device):
        got = kernel_events(device)
        wrappers = {k: fn.launches for k, fn in counters.items()}
        require(got == wrappers, f"{tag}: the eager clip's trace shows "
                                 f"{got}, its wrappers counted {wrappers}")

    def same_as_eager(device):
        got = kernel_events(device)
        require(got == seen["eager"], f"{tag}: a replay launched {got}, "
                                      f"the eager clip {seen['eager']}")

    checks = {"eager": same_as_wrappers, "graph": same_as_eager}
    for name, run in runs.items():
        prof, wall_ms, device = profile_run(f"{tag}_{name}", zero_counts(run),
                                            checks[name])
        seen[name] = kernel_events(device)
        busy_ms = sum(e.device_time_total for e in device) / 1e3
        host_syncs = sum(e.name == "aten::_local_scalar_dense"
                         for e in prof.events())
        require(host_syncs == 0, f"{tag} {name}: {host_syncs} host syncs")
        fields[name] = {"wall_ms": round(wall_ms, 2),
                        "busy_ms": round(busy_ms, 2),
                        "idle_share": round(1 - busy_ms / wall_ms, 4),
                        "device_events": len(device)}
        if name == "eager":
            log("profile", path=tag, route=name,
                stages_host_kernel_span_ms=clip_stages(prof))
            continue
        log("graph", path=tag, check="replay launches by kernel name",
            launches=seen[name], card=card_f)
        by_name = {}
        for e in device:
            by_name[e.name[:60]] = (by_name.get(e.name[:60], 0.0)
                                    + e.device_time_total / 1e3)
        ours = {k: round(sum(v for n, v in by_name.items() if k in n), 3)
                for k in ("crop_band_kernel", "correlation_kernel",
                          "correlation_mma_kernel", "resample2d_kernel",
                          "block_wgmma_kernel", "conv_wgmma_kernel")}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log("profile", path=tag, route=name, port_kernels_device_ms=ours)
        log("profile", path=tag, route=name,
            top_device_ms=[(k, round(v, 3)) for k, v in top])
    SUMMARY.setdefault("graph", {})[tag] = {
        **{f"fps_{k}": [round(x, 1) for x in v] for k, v in fps.items()},
        **{f"wall_busy_idle_events_{k}": tuple(fields[k].values())
           for k in runs},
        "capture_ms": round(graph.capture_ms),
        "pool_mib": round(fields["pool_mib"])}
    log("graph", path=tag, **fields, card=card_f)
    return fields


def clip_stages(prof) -> dict:
    """Each clip.* range of an eager clip's profile: (host ms, kernel ms,
    device span ms)."""
    stages = {}
    for e in prof.key_averages():
        if e.key.startswith("clip."):
            host, kern, span = stages.get(e.key, (0.0, 0.0, 0.0))
            if e.cpu_time_total > 0:
                host, kern = e.cpu_time_total / 1e3, e.device_time_total / 1e3
            else:
                span = e.device_time_total / 1e3
            stages[e.key] = (round(host, 3), round(kern, 3), round(span, 3))
    return stages


def random_bn_pose_net(model_cfg, dev, gen):
    """``get_pose_net``'s seeded PoseResNet with every batch norm's running
    mean ~ N(0, 0.1) and running variance and scale ~ U(0.5, 1.5), drawn
    from ``gen``: the seeded init leaves batch norm the identity, and the
    fold should do real work."""
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net

    model = get_pose_net(model_cfg, dev, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
                m.weight.copy_(torch.rand(n, generator=gen) + 0.5)
    return model


def drive_path(tag, card, cfg, frame_hw, path_kernels, pose_model=None,
               check=None):
    """Full width, seeded random weights: one warm-up clip, then CLIPS
    chained FRAMES-frame clips, the main path's run, with every launch
    count set to 0 just before and read just after from the run's device
    trace (``counted``: the clips replay their graph); each kernel of
    ``path_kernels`` must have launched, and ``check(launches)`` hold.
    ``pose_model`` replaces the config's seeded PoseResNet. Checks the
    outputs' shapes and finiteness, logs frames/s, then holds the clip
    graph to the eager ``_clip`` on one clip and profiles both routes
    (``graph_route``). Returns the launch counts of the run."""
    from flowtrack_tpu_torch.models.flownet import get_flow_net
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker

    require(cfg.model.dtype == cfg.flow.dtype == "bfloat16", "bf16 config")
    require(cfg.test.flip_test and cfg.track.clip_recover, "flip + recovery")
    h, w = frame_hw
    gen = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    if pose_model is None:
        pose_model = get_pose_net(cfg.model, dev, gen)
    tracker = ClipTracker(cfg, pose_model, get_flow_net(cfg.flow, dev, gen),
                          max_persons=PERSONS, device=dev)
    rng = np.random.default_rng(SEED)
    n_frames = CLIPS * (FRAMES - 1) + 1
    video = rng.integers(0, 256, (n_frames, h, w, 3), np.uint8)
    boxes, scores, valid = video_detections(
        rng, n_frames, PERSONS, h, w, (2.0, 1.0),
        drop=[(2, 3), (FRAMES + 4,), (FRAMES - 1,)])
    log(tag, setup_s=f"{time.perf_counter() - t0:.1f}")

    warm = run_clips(tracker, video[:FRAMES], boxes, scores, valid, FRAMES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    def holds(launches):
        require(all(launches[k] for k in path_kernels),
                f"{tag}: a kernel of the path never launched: {launches}")
        if check is not None:
            check(launches)

    outs, elapsed, launches = counted(tag, lambda: run_clips(
        tracker, video, boxes, scores, valid, FRAMES), holds)
    slots = PERSONS + RECOVERED
    for out in warm + outs:
        require(out["joints"].shape == (FRAMES, slots, 17, 2),
                f"joints {out['joints'].shape}")
        require(out["maxvals"].shape == (FRAMES, slots, 17),
                f"maxvals {out['maxvals'].shape}")
        require(out["ids"].shape == out["valid"].shape == (FRAMES, slots),
                f"ids {out['ids'].shape}")
        for key in ("joints", "maxvals", "scores"):
            require(np.isfinite(out[key]).all(), f"non-finite {key}")
    fps = CLIPS * FRAMES / elapsed
    SUMMARY.setdefault("frames_per_s", {})[tag] = round(fps, 2)
    log(tag, clips=len(outs), frames_per_clip=FRAMES, frame_hw=f"{h}x{w}",
        persons=PERSONS, seconds=elapsed, frames_per_s=fps,
        launches=launches, device_traced=True, card=f"'{card}'",
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    args = tracker.prepare_lanes(video[None, :FRAMES], boxes[None, :FRAMES],
                                 scores[None, :FRAMES], valid[None, :FRAMES])
    graph_route(tag, tracker, args, f"'{card}'")
    return launches


def slice_config():
    """Slice 1's config: R50 256x192 + FlowNetC, bf16, flip test, recovery,
    the smoke's 8 persons and 4 recovery slots."""
    from flowtrack_tpu_torch.config import get_config

    base = get_config("coco_res50_256x192")
    return replace(base, flow=replace(base.flow, variant="flownet_c",
                                      use_pallas_corr=True),
                   track=replace(base.track, max_persons=PERSONS,
                                 max_recovered=RECOVERED))


def phase_slice(card):
    """Slice 1: R50 256x192 + FlowNetC, bf16, flip test, recovery; then
    its pose pass at the bucket of a sparse batch (``check_pose_buckets``)."""
    launches = drive_path("slice", card, slice_config(), (FRAME_H, FRAME_W),
                          ("crop_resize_normalize", "correlation"))
    torch.cuda.synchronize()
    gc.collect()   # the slice's tracker and its graph pool
    torch.cuda.empty_cache()
    check_pose_buckets(f"'{card}'")
    return launches


def crop_counts(prof) -> list:
    """The crops of each K1 launch in a profile, in order: the x extent of
    ``crop_band_kernel``'s grid (a block column a crop), from the trace's
    kernel records, which a replayed graph's kernels have too."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"
                      and KERNEL_FUNCTIONS["crop_resize_normalize"].search(
                          e.get("name", ""))), key=lambda e: e["ts"])
    return [e["args"]["grid"][0] for e in kernels]


def check_pose_buckets(card_f) -> dict:
    """The clip's first pose pass at the bucket of a sparse batch (4 lanes
    of 16 frames of 720x1280, 32 person slots, 2-6 persons a frame: 8
    slots a frame), slice 1's nets with every candidate kept, against its
    twin made to pose all 32
    (``prepare_lanes(..., slots=32)``), both replayed as graphs. With the
    nets called in chunks of POSE_BUCKET_CHUNK crops (the same batches on
    both routes), ids, valid masks and seeds equal bit for bit and joints,
    maxvals and scores within SAME_DEVICE_JOINT_TOL; on the path (one pose
    call a pass) the divergence is logged. Each route's K1 crops per
    launch read from one replay's trace (C*F*Pb, then C times the recovery
    budget), and each replay's device ms by CUDA events in turns (bucket,
    all, all, bucket; CLIPS replays each)."""
    from flowtrack_tpu_torch.models.flownet import get_flow_net
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from flowtrack_tpu_torch.tracking.clip_pipeline import (ClipTracker,
                                                            pad_detections)

    c, f, p, (h, w) = 4, FRAMES, 32, BUCKET_FRAME_HW
    cfg = slice_config()
    # every candidate kept, so that the scans have tracks to carry
    cfg = replace(cfg, track=replace(cfg.track, max_persons=p,
                                     pose_score_thre=0.0))
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    tracker = ClipTracker(cfg, get_pose_net(cfg.model, dev, gen),
                          get_flow_net(cfg.flow, dev, gen), device=dev)
    exact = ClipTracker(
        replace(cfg, track=replace(cfg.track, pose_chunk=POSE_BUCKET_CHUNK)),
        tracker.pose_model, tracker.flow_model, device=dev)
    rng = np.random.default_rng(SEED + 17)
    video = rng.integers(0, 256, (c, f, h, w, 3), np.uint8)
    lanes = []
    for _ in range(c):
        boxes, scores, _ = video_detections(rng, f, 6, h, w, (2.0, 1.0))
        n = rng.integers(2, 7, f)
        lanes.append(pad_detections([b[:k] for b, k in zip(boxes, n)],
                                    [s[:k] for s, k in zip(scores, n)], p))
    host = (video, *(np.stack(x) for x in zip(*lanes)))
    routes = {}
    for trk in (tracker, exact):
        routes[trk] = {"bucket": trk.prepare_lanes(*host),
                       "all": trk.prepare_lanes(*host, slots=p)}
    args = routes[tracker]
    require(args["bucket"][1].shape[2] == 8 and args["all"][1].shape[2] == p,
            f"pose slots {args['bucket'][1].shape} / {args['all'][1].shape}")
    out = {trk: {k: trk.run_prepared_lanes(a) for k, a in r.items()}
           for trk, r in routes.items()}
    torch.cuda.synchronize()
    got, want = out[exact]["bucket"], out[exact]["all"]
    diffs = same_routes("pose bucket (chunked nets)", got, want,
                        SAME_DEVICE_JOINT_TOL)
    require(got[4].any(), "pose bucket: no valid slot")
    got, want = out[tracker]["bucket"], out[tracker]["all"]
    path = {"ids_equal": bool(torch.equal(got[3], want[3])),
            "valid_equal": bool(torch.equal(got[4], want[4])),
            **{name: (a.double() - b.double()).abs().max().item()
               for name, a, b in zip(("joints", "maxvals", "scores"),
                                     got[:3], want[:3])}}
    budget = tracker.recovery_budget(f)
    crops = {}
    for name, a in args.items():
        prof, _, _ = profile_run(f"pose_bucket_{name}",
                                 lambda a=a: tracker.run_prepared_lanes(a))
        crops[name] = crop_counts(prof)
        want_crops = [c * f * a[1].shape[2], c * budget]
        require(crops[name] == want_crops,
                f"pose bucket {name}: K1 crops {crops[name]}, want "
                f"{want_crops}")
    ms = {"bucket": [], "all": []}
    for name in ("bucket", "all", "all", "bucket"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(CLIPS):
            tracker.run_prepared_lanes(args[name])
        end.record()
        torch.cuda.synchronize()
        ms[name].append(start.elapsed_time(end) / CLIPS)
    SUMMARY["pose_bucket_replay_ms"] = {k: [round(x, 2) for x in v]
                                        for k, v in ms.items()}
    fields = {"lanes": c, "frames_per_clip": f, "frame_hw": f"{h}x{w}",
              "max_persons": p, "slots": args["bucket"][1].shape[2],
              "persons_a_frame": "2-6", "k1_crops": crops,
              "max_abs_diff_chunked": diffs, "path": path,
              "replay_ms": ms, "card": card_f}
    log("graph", check="pose bucket against every slot", **fields)
    return fields


def flownet2_config():
    """Slice 2's config: the flowtrack_posetrack preset (R152 256x192, bf16)
    with the flow section of experiments/flowtrack_posetrack_flownet2.yaml,
    built without PyYAML (tests/test_torch_models.py pins the equality), the
    yaml's track thresholds, and the smoke's traffic: 8 persons, 4
    recovery slots."""
    from flowtrack_tpu_torch.config import get_config

    base = get_config("flowtrack_posetrack")
    return replace(
        base,
        flow=replace(base.flow, variant="flownet2", dtype="bfloat16",
                     use_pallas_corr=True, use_pallas_warp=True,
                     pallas_warp_impl="matmul", glue_dtype="float32"),
        track=replace(base.track, max_persons=PERSONS,
                      max_recovered=RECOVERED))


def phase_flownet2(card):
    """Slice 2: R152 256x192 + FlowNet2 (bf16 nets, float32 glue) on 360x640
    frames: the crop, correlation and warp kernels all run."""
    cfg = flownet2_config()
    require(cfg.model.num_layers == 152 and cfg.flow.variant == "flownet2",
            "R152 + FlowNet2")
    return drive_path("flownet2", card, cfg, (FN2_H, FN2_W),
                      ("crop_resize_normalize", "correlation", "resample2d"))


def phase_fused(card):
    """Slice 3, ``BENCH_FUSED=1 python bench.py``'s path: the
    coco_res50_256x192 config as it stands (FlowNetS, R50 bf16, flip,
    recovery) with the pose net folded by ``fuse_pose_model``: the crop and
    fused_stage kernels both run."""
    from flowtrack_tpu_torch.config import get_config
    from flowtrack_tpu_torch.ops.fused_resnet import fuse_pose_model

    base = get_config("coco_res50_256x192")
    cfg = replace(base, track=replace(base.track, max_persons=PERSONS,
                                      max_recovered=RECOVERED))
    require(cfg.model.num_layers == 50 and cfg.flow.variant == "flownet_s",
            "R50 + FlowNetS")
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 4)
    fused = fuse_pose_model(cfg.model, random_bn_pose_net(
        cfg.model, torch.device("cuda"), gen))
    per_forward = fused.kernel_launches(cfg.model.image_size)
    log("fused", fold_s=f"{time.perf_counter() - t0:.1f}",
        fused_stage_launches_per_forward=per_forward)
    def forms(launches):
        # every pose pass is one crop launch and one forward of the fused
        # net
        expected = launches["crop_resize_normalize"] * per_forward
        require(launches["fused_stage"] == expected,
                f"fused: {launches['fused_stage']} fused_stage launches, "
                f"the blocks' forms give {expected}")

    return drive_path("fused", card, cfg, (FRAME_H, FRAME_W),
                      ("crop_resize_normalize", "fused_stage"), fused, forms)


def profile_run(tag, run, check=None):
    """``run()`` under torch.profiler, ending in a synchronize: (profile,
    wall ms, device events). Device work is kernels and copies; the clip.*
    ranges also appear as device-side annotations spanning their kernels,
    so they are left out. ``check(device events)`` holds the trace to what
    the run must show (it raises AssertionError). A trace with no device
    event, or one that fails the check, is taken again once: the profiler
    has recorded no event of a path whose kernels had all launched, and has
    dropped one kernel's record in about one trace of sixty on an H100. A
    second such trace raises, so no line reads 100% idle."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in (1, 2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith("clip.")]
        try:
            require(device, f"{tag}: the trace recorded no device event")
            if check is not None:
                check(device)
            return prof, wall_ms, device
        except AssertionError as err:
            if attempt == 2:
                raise
            log("profile", path=tag, attempt=attempt,
                note=f"{err}; profiling again")


class PlantedPose(torch.nn.Module):
    """A pose net whose heatmaps hold a fixed star of 17 gaussian peaks
    around the crop centre, whatever the crop: decoded joints follow the
    boxes through the real crop, decode and rescore."""

    def __init__(self, hm_hw, device):
        super().__init__()
        ang = np.linspace(0, 2 * np.pi, 17, endpoint=False)
        offs = np.stack([np.cos(ang), np.sin(ang)], 1) * 0.3 + 0.5
        hh, hw = hm_hw
        ys = torch.arange(hh, dtype=torch.float32)[:, None]
        xs = torch.arange(hw, dtype=torch.float32)[None, :]
        maps = [torch.exp(-((xs - round(ox * hw)) ** 2
                            + (ys - round(oy * hh)) ** 2) / 8.0)
                for ox, oy in offs]
        self.register_buffer("hm", torch.stack(maps).to(device))

    def forward(self, x):
        return self.hm.expand(x.shape[0], -1, -1, -1)


class ConstantFlow(torch.nn.Module):
    """A flow net that returns the true constant motion, at quarter
    resolution in units of div_flow."""

    def __init__(self, vel, div_flow, device):
        super().__init__()
        self.register_buffer("vel", torch.tensor(
            [vel[0] / div_flow, vel[1] / div_flow], device=device))

    def forward(self, x):
        n, _, h, w = x.shape
        return self.vel.view(1, 2, 1, 1).expand(n, 2, h // 4, w // 4)


class ConstantFullResFlow(torch.nn.Module):
    """A flow net with the FlowNet2 cascade's convention: the true constant
    motion at full resolution in pixels of the net's input, which is the
    frames enlarged to the /64-rounded size."""

    def __init__(self, vel, frame_hw, device):
        super().__init__()
        self.frame_hw = frame_hw
        self.register_buffer("vel", torch.tensor(vel, device=device))

    def forward(self, x):
        n, _, h, w = x.shape
        # filled on the device: a clip graph's capture takes no host data
        scale = torch.stack([x.new_full((), w / self.frame_hw[1],
                                        dtype=torch.float32),
                             x.new_full((), h / self.frame_hw[0],
                                        dtype=torch.float32)])
        return (self.vel * scale).view(1, 2, 1, 1).expand(n, 2, h, w)


def planted_config(variant="flownet_c"):
    """The planted-pose phases' config: coco_res50_256x192 without flip
    test, ``variant``'s flow convention, 4 person slots, 4 recovery
    slots."""
    from flowtrack_tpu_torch.config import get_config

    base = get_config("coco_res50_256x192")
    return replace(base, test=replace(base.test, flip_test=False),
                   flow=replace(base.flow, variant=variant),
                   track=replace(base.track, max_persons=4,
                                 max_recovered=RECOVERED))


def phase_tracking(card, variant, frame_hw):
    """Planted-heatmap pose + constant-flow stubs through the real crop
    kernel, decode and scans, under ``variant``'s flow convention: ids
    stable across clip boundaries and through dropped detections, equal
    to the port's plain run on the CPU, and the clip graph equal to the
    eager ``_clip`` on the card bit for bit over the chained clips."""
    from flowtrack_tpu_torch.models.flownet import flow_output_is_full_res
    from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker

    cfg = planted_config(variant)
    card_f = f"'{card}'"
    persons = cfg.track.max_persons
    vel = PLANTED_VEL
    h, w = frame_hw
    rng = np.random.default_rng(SEED + 1)
    n_frames = CLIPS * (FRAMES - 1) + 1
    video = rng.integers(0, 256, (n_frames, h, w, 3), np.uint8)
    # 3 persons in 4 slots; person 0 missed inside clip 2, person 2 at the
    # boundary frame shared by clips 2 and 3
    boxes, scores, valid = video_detections(
        rng, n_frames, 3, h, w, vel,
        drop=[(FRAMES + FRAMES // 4,), (), (2 * (FRAMES - 1),)])
    pad = persons - 3
    boxes = np.concatenate([boxes, np.zeros((n_frames, pad, 4), np.float32)], 1)
    scores = np.concatenate([scores, np.zeros((n_frames, pad), np.float32)], 1)
    valid = np.concatenate([valid, np.zeros((n_frames, pad), bool)], 1)

    results, trackers = {}, {}
    for name in ("cuda", "cpu"):
        dev = torch.device(name)
        flow = (ConstantFullResFlow(vel, frame_hw, dev)
                if flow_output_is_full_res(variant)
                else ConstantFlow(vel, cfg.flow.div_flow, dev))
        trackers[name] = ClipTracker(
            cfg, PlantedPose(cfg.model.heatmap_size, dev), flow, device=dev)
        results[name] = run_clips(trackers[name], video, boxes, scores,
                                  valid, FRAMES)
    torch.cuda.synchronize()
    # the clip graph against the eager _clip over the chained clips, each
    # seeded by its own route's last seed: bit for bit
    tracker = trackers["cuda"]
    seeds, start = {"graph": None, "eager": None}, 0
    while start + FRAMES <= n_frames:
        sl = slice(start, start + FRAMES)
        args = tracker.prepare_lanes(video[None, sl], boxes[None, sl],
                                     scores[None, sl], valid[None, sl],
                                     frame_offsets=[start])
        got = tracker.run_prepared_lanes(args, [seeds["graph"]])
        want = eager_run(tracker, args, [seeds["eager"]])
        same_routes(f"tracking {variant} clip at {start}", got, want, 0.0)
        seeds = {"graph": tuple(x[0] for x in got[5]),
                 "eager": tuple(x[0] for x in want[5])}
        start += FRAMES - 1
    graph_route(f"planted_{variant}", tracker, tracker.prepare_lanes(
        video[None, :FRAMES], boxes[None, :FRAMES], scores[None, :FRAMES],
        valid[None, :FRAMES]), card_f, bitwise=True)
    for got, want in zip(results["cuda"], results["cpu"]):
        np.testing.assert_array_equal(got["ids"], want["ids"])
        np.testing.assert_array_equal(got["valid"], want["valid"])
        v = want["valid"]
        np.testing.assert_allclose(got["joints"][v], want["joints"][v],
                                   atol=0.5)

    person_ids = {}
    recovered = 0
    for c, out in enumerate(results["cuda"]):
        for t in range(FRAMES):
            g = c * (FRAMES - 1) + t
            live = out["ids"][t][out["valid"][t]].tolist()
            for j in range(3):
                if valid[g, j]:
                    pid = int(out["ids"][t, j])
                else:            # missed: carried by one recovery slot
                    rec = out["ids"][t, persons:][out["valid"][t, persons:]]
                    require(len(rec) == 1, (g, j, out["ids"][t]))
                    pid = int(rec[0])
                    recovered += 1
                require(pid >= 0 and live.count(pid) == 1, (g, j, live))
                if person_ids.setdefault(j, pid) != pid:
                    raise AssertionError(f"person {j} changed id at frame "
                                         f"{g}: {person_ids[j]} -> {pid}")
    require(len(set(person_ids.values())) == 3, person_ids)
    log("tracking", flow=variant, frame_hw=f"{h}x{w}",
        clips=len(results["cuda"]), ids=person_ids,
        recovered_frames=recovered, cpu_equal=True, graph_equal_eager=True)


def pool_over_frame_sizes(tracker, rng, card_f) -> None:
    """One clip at each of POOL_FRAME_SIZES through ``tracker``, then the
    first size again: each new geometry captures a graph into the
    tracker's one pool. Each run equals the eager ``_clip`` (ids, valid
    and seeds bit for bit, the rest within SAME_DEVICE_JOINT_TOL), so no
    replay sees another graph's memory; logs each capture's pool growth,
    the pool's total and the device memory reserved."""
    grown = []
    for h, w in (*POOL_FRAME_SIZES, POOL_FRAME_SIZES[0]):
        video = rng.integers(0, 256, (1, FRAMES, h, w, 3), np.uint8)
        det = video_detections(rng, FRAMES, PERSONS, h, w, (2.0, 1.0))
        args = tracker.prepare_lanes(video, *(x[None] for x in det))
        before = len(tracker.graphs)
        got = tracker.run_prepared_lanes(args)
        graph = tracker.graphs[tracker.graph_key(args, None)]
        same_routes(f"pool {h}x{w}", got, eager_run(tracker, args),
                    SAME_DEVICE_JOINT_TOL)
        grown.append((f"{h}x{w}", round(graph.pool_bytes / 2 ** 20)
                      if len(tracker.graphs) > before else 0))
    total = sum(g.pool_bytes for g in tracker.graphs.values()) / 2 ** 20
    SUMMARY["graph_pool_mib_tracker"] = round(total)
    log("graph", check="one pool over frame sizes", geometries=len(
        tracker.graphs), capture_growth_mib=grown, pool_mib=total,
        reserved_mib=torch.cuda.memory_reserved() / 2 ** 20,
        equal_to_eager=True, card=card_f)


def ragged(boxes, scores, valid):
    """Padded (F, P) detections -> per-frame lists of the valid boxes and
    scores, as a detector hands them to the serving classes."""
    return ([b[v] for b, v in zip(boxes, valid)],
            [s[v] for s, v in zip(scores, valid)])


def serve(tracker, streams, depth):
    """Every stream's frames submitted in turns, one frame of each stream
    a tick, to a MultiStreamTracker of 16-frame clips batching all streams,
    stepping each tick, then flushed: -> ({stream: per-frame tracks},
    latency stats). Every frame must be emitted exactly once."""
    from flowtrack_tpu_torch.serving import MultiStreamTracker

    mst = MultiStreamTracker(tracker, clip_len=FRAMES,
                             batch_streams=len(streams), pipeline_depth=depth)
    n = len(next(iter(streams.values()))[0])
    emitted = []
    for t in range(n):
        for sid, (frames, boxes, scores) in streams.items():
            mst.submit(sid, frames[t], boxes[t], scores[t])
        emitted += mst.step()
    emitted += mst.flush()
    got = {sid: [None] * n for sid in streams}
    for sid, first, tracks in emitted:
        for i, fr in enumerate(tracks):
            require(got[sid][first + i] is None,
                    f"serving: {sid} frame {first + i} emitted twice")
            got[sid][first + i] = fr
    require(all(fr is not None for per in got.values() for fr in per),
            "serving: a frame was never emitted")
    return got, mst.latency_stats()


def same_emissions(what, got, want, joint_tol) -> int:
    """Per frame the same tracks in the same order with the same ids, joints
    within ``joint_tol`` px, and maxvals and scores within ``joint_tol``
    where both sides carry them; returns the number of tracks compared."""
    require(len(got) == len(want), f"{what}: {len(got)} != {len(want)} frames")
    tracks = 0
    for t, (g, w) in enumerate(zip(got, want)):
        gi, wi = [x["track_id"] for x in g], [x["track_id"] for x in w]
        require(gi == wi, f"{what}: frame {t} ids {gi} != {wi}")
        for a, b in zip(g, w):
            for key in ("joints", "maxvals", "score"):
                if key in a and key in b:
                    err = float(np.abs(np.asarray(a[key])
                                       - np.asarray(b[key])).max())
                    require(err <= joint_tol,
                            f"{what}: frame {t} {key} differ by {err}")
        tracks += len(g)
    return tracks


def divergence(got, want) -> dict:
    """Batched emissions against each stream alone, without a limit: the
    frames whose ids agree, of all, and the largest joint difference on
    them."""
    frames = agree = 0
    worst = 0.0
    for sid in got:
        for g, w in zip(got[sid], want[sid]):
            frames += 1
            if [x["track_id"] for x in g] == [x["track_id"] for x in w]:
                agree += 1
                worst = max([worst] + [float(np.abs(
                    np.asarray(a["joints"]) - np.asarray(b["joints"])).max())
                    for a, b in zip(g, w)])
    return {"frames": frames, "ids_agree": agree, "max_joint_diff": worst}


def library_batch_variance(tracker, exact, frames, rng, card_f) -> None:
    """How far the nets' outputs move with the batch on the card: the
    path's flow over C lanes' pairs in one call against one call a lane
    (``exact``'s chunks), and the pose net's flip-merged heatmaps over C
    lanes' detection crops and recovery crops against calls of one lane's
    recovery budget. Logged, not held: the library convs pick their
    algorithms by shape."""
    from flowtrack_tpu_torch.tracking.clip_pipeline import _chunked_apply

    c, f = frames.shape[:2]
    h, w = tracker.img_hw
    with torch.inference_mode():
        x = torch.as_tensor(frames, device=tracker.device)
        flow = (tracker._flows(x) - exact._flows(x)).abs().max().item()
        pose = {}
        for n in (c * f * PERSONS, c * f):
            crops = torch.as_tensor(rng.standard_normal((n, h, w, 3)),
                                    device=tracker.device
                                    ).to(tracker.crop_dtype)
            one = tracker._pose_heatmaps(crops)
            chunked = _chunked_apply(exact._pose_heatmaps, crops,
                                     exact.cfg.track.pose_chunk)
            pose[n] = (one - chunked).abs().max().item()
    log("serving", check="library batch variance", lanes=c,
        flow_pairs=c * (f - 1), flow_max_abs_diff=flow,
        pose_crops_max_abs_diff=pose, card=card_f)


def planted_detections(n_frames, h, w, vel, drop):
    """Three persons in a row, 30% of the frame's width apart, moving at
    ``vel``: boxes (n_frames, 3, 4) xywh, scores and valid (n_frames, 3);
    person j is undetected at the frames in drop[j]."""
    t = np.arange(n_frames)[:, None]
    x0 = np.array([0.05, 0.35, 0.65]) * w
    bw = np.array([0.09, 0.1, 0.11]) * w
    boxes = np.stack(np.broadcast_arrays(x0 + vel[0] * t, 0.15 * h
                                         + vel[1] * t, bw, 1.8 * bw), -1)
    scores = np.broadcast_to(np.array([0.9, 0.8, 0.85]), (n_frames, 3))
    valid = np.ones((n_frames, 3), bool)
    for j, frames in enumerate(drop):
        valid[list(frames), j] = False
    return (boxes.astype(np.float32), scores.astype(np.float32).copy(),
            valid)


def person_ids(what, per_frame, boxes):
    """The emitted track that carries each person at each frame (the one
    whose joints' centre lies nearest the person's box centre, within 20
    px): one track a person and none else, one id a person across the
    frames, the persons' ids apart."""
    ids = {}
    for t, tracks in enumerate(per_frame):
        centres = np.array([np.asarray(x["joints"]).mean(0) for x in tracks])
        require(len(tracks) == len(boxes[t]),
                f"{what}: frame {t}: {len(tracks)} tracks")
        box_c = boxes[t, :, :2] + boxes[t, :, 2:] / 2
        dist = np.hypot(*(centres[None] - box_c[:, None]).transpose(2, 0, 1))
        near = dist.argmin(1)
        require(len(set(near.tolist())) == len(box_c)
                and (dist.min(1) < 20).all(),
                f"{what}: frame {t}: persons' nearest tracks {near}")
        for j, k in enumerate(near):
            pid = tracks[k]["track_id"]
            require(ids.setdefault(j, pid) == pid,
                    f"{what}: person {j} changed id at frame {t}: "
                    f"{ids[j]} -> {pid}")
    require(len(set(ids.values())) == len(ids), f"{what}: ids {ids}")
    return ids


def phase_serving(card, dev=None):
    """The serving slice on slice 1's config at full width: four streams
    through MultiStreamTracker at pipeline depths 0 and 1, each equal to
    track_video_clips on that stream alone (with the nets called at one
    lane's batch; the path's own run timed and its divergence read), with
    the crop and correlation launches of one batched step read around it;
    the planted stubs with a detection dropped at a clip boundary, card
    against CPU;
    StreamingClipTracker against track_video_clips at clip length 2, its
    latency; the per-frame FlowTracker over PosePredictor and
    FlowPredictor, its ms per frame and its planted ids against the CPU's;
    track_clips of 4 lanes against 4 track_clip calls in turns; device
    events per lane-clip at C=1 and C=4. The slice's models run with
    ``pose_score_thre`` 0: under it every random-weight candidate would
    drop, and the equalities would compare empty frames. Returns the launch
    counts of the path's two MultiStreamTracker runs."""
    from flowtrack_tpu_torch.models.flownet import get_flow_net
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from flowtrack_tpu_torch.pipeline import FlowPredictor, PosePredictor
    from flowtrack_tpu_torch.serving import StreamingClipTracker
    from flowtrack_tpu_torch.tracking import FlowTracker
    from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker
    from flowtrack_tpu_torch.utils.video import track_video_clips

    dev = torch.device("cuda") if dev is None else dev
    cpu = torch.device("cpu")
    card_f = f"'{card}'"
    base = slice_config()
    cfg = replace(base, track=replace(base.track, pose_score_thre=0.0))
    gen = torch.Generator().manual_seed(SEED)
    tracker = ClipTracker(cfg, get_pose_net(cfg.model, dev, gen),
                          get_flow_net(cfg.flow, dev, gen),
                          max_persons=PERSONS, device=dev)
    # the same nets with every library call at one lane's batch, batched or
    # alone: flow in chunks of a clip's pairs, pose in chunks of a lane's
    # recovery budget (F crops at recover_budget 1), of which a clip's F*P
    # detections are a multiple. The library convs are not batch-invariant
    # on the card, and random-weight heatmaps turn their last-bit
    # differences into other argmax cells; this tracker holds the lanes'
    # own arithmetic to a stream alone.
    require(cfg.track.recover_budget == 1.0, "recovery budget F a lane")
    exact = ClipTracker(replace(cfg, track=replace(
        cfg.track, flow_chunk=FRAMES - 1, pose_chunk=FRAMES)),
        tracker.pose_model, tracker.flow_model, max_persons=PERSONS,
        device=dev)
    rng = np.random.default_rng(SEED + 5)
    padded, streams = {}, {}
    for i in range(SERVE_STREAMS):
        video = rng.integers(0, 256, (SERVE_FRAMES, FRAME_H, FRAME_W, 3),
                             np.uint8)
        det = video_detections(rng, SERVE_FRAMES, PERSONS, FRAME_H, FRAME_W,
                               (2.0, 1.0), drop=[(FRAMES - 1,), (5, 6)])
        padded[f"s{i}"] = (video, *det)
        streams[f"s{i}"] = (video, *ragged(*det))
    clips = [tuple(x[:FRAMES] for x in padded[sid]) for sid in padded]
    stacked = [np.stack(x) for x in zip(*clips)]
    lanes = tracker.prepare_lanes(*stacked)
    one_lane = tuple(x[:1] for x in lanes)
    # warm-up: the first calls at the batched and the one-lane shapes
    tracker.to_host(tracker.run_prepared_lanes(lanes))
    tracker.to_host(tracker.run_prepared_lanes(one_lane))
    counters = kernel_counters()

    # one batched step of the four streams: one crop launch per pose pass
    # and one correlation launch, whatever the lane count
    def one_step(step):
        require(step["crop_resize_normalize"] == 2
                and step["correlation"] == 1,
                f"serving: one batched step of {len(clips)} lanes launched "
                f"{step}, not 2 crop and 1 correlation launches")

    _, _, step = counted("serving_step", lambda: tracker.to_host(
        tracker.run_prepared_lanes(lanes)), one_step)
    log("serving", check="launches of one batched step", lanes=len(clips),
        launches=step)

    library_batch_variance(tracker, exact, stacked[0], rng, card_f)

    # each stream alone on the card, then the streams batched: equal with
    # the nets called at one lane's batch; timed, and their divergence
    # read, as the path runs
    launches = {}
    for name, trk in (("exact", exact), ("path", tracker)):
        want = {sid: track_video_clips(trk, *st, clip_len=FRAMES)
                for sid, st in streams.items()}
        for depth in (0, 1):
            (got, lat), seconds, counts = counted(
                f"serving_{name}_{depth}", lambda: serve(trk, streams, depth))
            require(counts["crop_resize_normalize"] and counts["correlation"],
                    f"serving: a kernel of the path never launched: {counts}")
            fields = {"frames_per_s": len(streams) * SERVE_FRAMES / seconds,
                      "latency_ms": lat, "launches": counts,
                      "device_traced": True}
            if name == "exact":
                tracks = sum(same_emissions(
                    f"serving depth {depth} {sid}", got[sid], want[sid],
                    SAME_DEVICE_JOINT_TOL) for sid in streams)
                require(tracks >= len(streams) * SERVE_FRAMES,
                        f"serving depth {depth}: {tracks} tracks emitted "
                        f"over {len(streams) * SERVE_FRAMES} frames; the "
                        f"equality is empty")
                fields.update(equal_to_alone=True, tracks_compared=tracks)
            else:
                launches[depth] = counts
                fields.update(divergence_from_alone=divergence(got, want))
            log("serving", nets=name, streams=len(streams),
                frames=SERVE_FRAMES, clip_len=FRAMES, pipeline_depth=depth,
                seconds=seconds, **fields, card=card_f)

    # the planted stubs, card against CPU, with a detection dropped at the
    # boundary frame two clips share
    pcfg = planted_config()
    vel = PLANTED_VEL
    n_planted = 2 * (FRAMES - 1) + 1
    planted = {}
    for i, drop in enumerate([[(), (FRAMES - 1,), ()],
                              [(FRAMES + 3,), (), (FRAMES - 1, FRAMES)]]):
        video = rng.integers(0, 256, (n_planted, FRAME_H, FRAME_W, 3),
                             np.uint8)
        det = planted_detections(n_planted, FRAME_H, FRAME_W, vel, drop)
        planted[f"p{i}"] = (video, *det)
    ptrackers = {d.type: ClipTracker(
        pcfg, PlantedPose(pcfg.model.heatmap_size, d),
        ConstantFlow(vel, pcfg.flow.div_flow, d), device=d)
        for d in (dev, cpu)}
    results = {k: serve(t, {sid: (v, *ragged(b, s, m))
                            for sid, (v, b, s, m) in planted.items()}, 0)[0]
               for k, t in ptrackers.items()}
    ids = {}
    for sid, (video, boxes, scores, valid) in planted.items():
        same_emissions(f"planted {sid} card vs cpu", results[dev.type][sid],
                       results["cpu"][sid], CPU_JOINT_TOL)
        same_emissions(f"planted {sid} batched vs alone",
                       results[dev.type][sid],
                       track_video_clips(ptrackers[dev.type], video,
                                         *ragged(boxes, scores, valid),
                                         clip_len=FRAMES),
                       SAME_DEVICE_JOINT_TOL)
        ids[sid] = person_ids(f"planted {sid}", results[dev.type][sid],
                              boxes)
    log("serving", check="planted stubs", streams=len(planted),
        frames=n_planted, ids=ids, cpu_equal=True, equal_to_alone=True)

    # StreamingClipTracker: one clip of 2 frames a step (one lane, as
    # track_video_clips runs it: the same library calls)
    video, boxes, scores = (x[:STREAM_FRAMES] for x in streams["s0"])
    st = StreamingClipTracker(tracker)
    got = [None] * STREAM_FRAMES
    for t in range(STREAM_FRAMES):
        if t == 4:             # past the first calls at this shape
            st.reset_latency_stats()
        emitted = st.step(video[t], boxes[t], scores[t])
        require([i for i, _ in emitted] == ([] if t == 0 else [0, 1]
                                            if t == 1 else [t]),
                f"streaming: step {t} emitted {[i for i, _ in emitted]}")
        for i, fr in emitted:
            got[i] = fr
    require(st.flush() == [], "streaming: frames left at flush")
    streamed = same_emissions("streaming", got,
                              track_video_clips(tracker, video, boxes, scores,
                                                clip_len=2),
                              SAME_DEVICE_JOINT_TOL)
    require(streamed >= STREAM_FRAMES,
            f"streaming: {streamed} tracks emitted over {STREAM_FRAMES} "
            f"frames; the equality is empty")
    lat = st.latency_stats()
    SUMMARY["streaming_p50_p90_p99_ms"] = (lat["p50_ms"], lat["p90_ms"],
                                           lat["p99_ms"])
    log("serving", check="StreamingClipTracker", frames=STREAM_FRAMES,
        equal_to_track_video_clips=True, tracks_compared=streamed,
        latency_ms=lat, card=card_f)

    # the per-frame FlowTracker: planted stubs card against CPU, then the
    # slice's models timed (every candidate kept, so that tracks live on
    # and the flow net runs each frame)
    video, boxes, scores, valid = (x[:FLOWTRACKER_FRAMES]
                                   for x in planted["p1"])
    dets = [(b[m], s[m]) for b, s, m in zip(boxes, scores, valid)]
    per_device = {}
    for d in (dev, cpu):
        ft = FlowTracker(pcfg, PosePredictor(
            pcfg, PlantedPose(pcfg.model.heatmap_size, d), device=d),
            FlowPredictor(pcfg, ConstantFlow(vel, pcfg.flow.div_flow, d),
                          device=d), device=d)
        per_device[d.type] = [[{"track_id": x.track_id, "joints": x.joints}
                               for x in fr]
                              for fr in ft.track_sequence(video, dets)]
    same_emissions("FlowTracker card vs cpu", per_device[dev.type],
                   per_device["cpu"], CPU_JOINT_TOL)
    ft_ids = sorted({x["track_id"] for fr in per_device[dev.type]
                     for x in fr})
    ft = FlowTracker(cfg, PosePredictor(cfg, tracker.pose_model, device=dev),
                     FlowPredictor(cfg, tracker.flow_model, device=dev),
                     device=dev)
    video, boxes, scores = (x[:FLOWTRACKER_FRAMES] for x in streams["s1"])
    dets = list(zip(boxes, scores))
    # the first run captures the programs' graphs of every bucket it meets
    ft.track_sequence(video, dets)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracks = ft.track_sequence(video, dets)
    torch.cuda.synchronize()
    ms_per_frame = (time.perf_counter() - t0) * 1e3 / FLOWTRACKER_FRAMES

    def once_a_frame(launches):
        require(launches["crop_resize_normalize"] == FLOWTRACKER_FRAMES
                and launches["correlation"] == FLOWTRACKER_FRAMES - 1,
                f"FlowTracker: one crop launch a frame and one correlation "
                f"launch a pair, got {launches}")

    # a replay launches the kernels without their wrappers: the counts come
    # from the run's own trace
    _, _, ft_launches = counted(
        "serving_flowtracker", lambda: ft.track_sequence(video, dets),
        once_a_frame)
    SUMMARY["flowtracker_ms_per_frame"] = round(ms_per_frame, 2)
    log("serving", check="FlowTracker", frames=FLOWTRACKER_FRAMES,
        planted_ids=ft_ids, cpu_equal=True, ms_per_frame=ms_per_frame,
        live_tracks=[len(t) for t in tracks], launches=ft_launches,
        card=card_f)

    # track_clips of 4 lanes against 4 track_clip calls, in turns; then
    # equal with the nets at one lane's batch
    def batched(trk=tracker):
        return trk.track_clips(*stacked)

    def separate(trk=tracker):
        return [trk.track_clip(*c) for c in clips]

    seconds = {"separate": [], "batched": []}
    outs = {}
    for name in ("separate", "batched", "batched", "separate"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = (batched if name == "batched" else separate)()
        seconds[name].append(time.perf_counter() - t0)
    path_diffs = {key: float(max(np.abs(outs["batched"][key][i] - one[key])
                                     .max() for i, one in
                                     enumerate(outs["separate"])))
                  for key in ("joints", "maxvals", "scores")}
    outs = {"batched": batched(exact), "separate": separate(exact)}
    diffs = {"joints": 0.0, "maxvals": 0.0, "scores": 0.0}
    for i, one in enumerate(outs["separate"]):
        for key in ("ids", "valid"):
            require(np.array_equal(outs["batched"][key][i], one[key]),
                    f"track_clips lane {i}: {key} differ from track_clip")
        # every slot, valid or not
        for key in diffs:
            diffs[key] = max(diffs[key], float(np.abs(
                outs["batched"][key][i] - one[key]).max()))
        require(one["valid"].any(), f"track_clips lane {i}: no valid slot")
    require(max(diffs.values()) <= SAME_DEVICE_JOINT_TOL,
            f"track_clips against track_clip: max |diff| {diffs} > "
            f"{SAME_DEVICE_JOINT_TOL}")
    fps = {k: [len(clips) * FRAMES / x for x in v] for k, v in seconds.items()}
    SUMMARY["serving_frames_per_s_batched_separate"] = (
        [round(x, 2) for x in fps["batched"]],
        [round(x, 2) for x in fps["separate"]])
    log("serving", check="track_clips vs track_clip in turns",
        lanes=len(clips), frames_per_clip=FRAMES, order="sep,bat,bat,sep",
        batched_frames_per_s=fps["batched"],
        separate_frames_per_s=fps["separate"], ids_valid_equal=True,
        valid_slots=int(sum(o["valid"].sum() for o in outs["separate"])),
        max_abs_diff_exact=diffs, max_abs_diff_path=path_diffs, card=card_f)

    # the four lanes' clip graph against the eager _clip, in turns
    graph_route(f"serving_c{len(clips)}", tracker, lanes, card_f)
    for name, trk in (("path", tracker), ("exact", exact)):
        log("graph", check="serving graphs", nets=name,
            geometries=[(k[0], k[1], k[6]) for k in trk.graphs],
            capture_ms=[round(g.capture_ms, 1) for g in trk.graphs.values()],
            pool_growth_mib=[round(g.pool_bytes / 2 ** 20) for g in
                             trk.graphs.values()],
            pool_mib=round(sum(g.pool_bytes for g in trk.graphs.values())
                           / 2 ** 20), card=card_f)
    pool_over_frame_sizes(tracker, rng, card_f)

    # device events per lane-clip, one lane against four
    per_lane = {}
    for c, run in ((1, lambda: tracker.to_host(
            tracker.run_prepared_lanes(one_lane))),
                   (len(clips), lambda: tracker.to_host(
                       tracker.run_prepared_lanes(lanes)))):
        _, wall_ms, device = profile_run(f"serving_c{c}", run)
        busy_ms = sum(e.device_time_total for e in device) / 1e3
        per_lane[c] = len(device) / c
        log("profile", path=f"serving_c{c}", lanes=c, wall_ms=wall_ms,
            device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
            device_events=len(device), device_events_per_lane_clip=per_lane[c],
            card=card_f)
    SUMMARY["serving_events_per_lane_clip_c1_c4"] = (per_lane[1],
                                                     per_lane[len(clips)])
    return launches[0]


def phase_precision():
    """What bfloat16 compute (autocast, float32 parameters) costs against
    float32 on the card, at full width with the same random weights: the
    largest difference of each model's output over the float32 output's
    largest magnitude."""
    from flowtrack_tpu_torch.config import get_config
    from flowtrack_tpu_torch.models.flownet import get_flow_net, preprocess_pair
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from flowtrack_tpu_torch.ops.fused_resnet import fuse_pose_model

    base = get_config("coco_res50_256x192")
    flow_cfg = replace(base.flow, variant="flownet_c")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    pose16 = get_pose_net(base.model, dev, gen)
    pose32 = get_pose_net(replace(base.model, dtype="float32"), dev)
    pose32.load_state_dict(pose16.state_dict())
    flow16 = get_flow_net(flow_cfg, dev, gen)
    flow32 = get_flow_net(replace(flow_cfg, dtype="float32"), dev)
    flow32.load_state_dict(flow16.state_dict())
    fn2_cfg = flownet2_config().flow
    fn2_16 = get_flow_net(fn2_cfg, dev, gen)
    fn2_32 = get_flow_net(replace(fn2_cfg, dtype="float32"), dev)
    fn2_32.load_state_dict(fn2_16.state_dict())
    # the fused R50 against the unfused one, both with random batch norms
    bn16 = random_bn_pose_net(base.model, dev, gen)
    bn32 = get_pose_net(replace(base.model, dtype="float32"), dev)
    bn32.load_state_dict(bn16.state_dict())
    fused = fuse_pose_model(base.model, bn16)
    rng = np.random.default_rng(SEED + 2)
    crops = torch.as_tensor(rng.standard_normal((16, 3, 256, 192)),
                            dtype=torch.float32, device=dev)
    frames = torch.as_tensor(
        rng.integers(0, 256, (3, FRAME_H, FRAME_W, 3), np.uint8), device=dev)
    pairs = preprocess_pair(frames[:-1], frames[1:]).permute(0, 3, 1, 2)
    errs = {}
    with torch.inference_mode():
        for name, m16, m32, x, tol in (
                ("pose", pose16, pose32, crops, POSE_BF16_REL_TOL),
                ("flow", flow16, flow32, pairs.contiguous(), FLOW_BF16_REL_TOL),
                ("flownet2", fn2_16, fn2_32, pairs.contiguous(),
                 FLOWNET2_BF16_REL_TOL),
                ("fused", fused, bn32, crops, POSE_BF16_REL_TOL),
                ("fused_vs_bf16", fused, bn16, crops, POSE_BF16_REL_TOL)):
            want = m32(x)
            err = ((m16(x) - want).abs().max() / want.abs().max()).item()
            torch.cuda.synchronize()
            require(err <= tol, f"{name} vs {m32.__class__.__name__}: "
                                f"{err} > {tol}")
            errs[name] = err
    SUMMARY["fused_rel_err"] = (round(errs["fused"], 4),
                                round(errs["fused_vs_bf16"], 4))
    log("precision", pose_rel_err=errs["pose"], pose_tol=POSE_BF16_REL_TOL,
        flow_rel_err=errs["flow"], flow_tol=FLOW_BF16_REL_TOL,
        flownet2_rel_err=errs["flownet2"],
        flownet2_tol=FLOWNET2_BF16_REL_TOL,
        fused_rel_err=errs["fused"],
        fused_vs_bf16_rel_err=errs["fused_vs_bf16"],
        fused_tol=POSE_BF16_REL_TOL)


# the int8 phase (models/quantize.py, ops/int8_conv.py): the pose net at the
# flip batch of 8 persons x 16 frames, 256 crops; the port's CPU run on 4
INT8_CROPS, INT8_CPU_CROPS = 256, 4
# card against the port's CPU run, same weights and crops, max |diff| over
# max |CPU output|: the int8 products are exact on both and their float
# epilogues (scale, bias, ReLU, max pool) IEEE operations on both, so in
# the int8 modes only the float32 head's summation order differs; the
# modes with bf16 convs (folded, mixed) differ as bf16 compute does
INT8_CPU_REL_TOL = 1e-4
# tests/test_quantize.py:165's closed-loop contract: the int8 model's
# decoded keypoints within one heatmap cell (4 px) of the float model's for
# more than 90% of joints
INT8_LOOP_PX, INT8_LOOP_SHARE = 4.0, 0.9


def int8_conv_shapes(model, crop_hw):
    """Every distinct QuantConv shape of ``model`` in forward order, read by
    forward hooks on one crop: {(cin, cout, k, stride, padding, transpose,
    h, w): [name of its first conv, convs of that shape in a forward]}."""
    from flowtrack_tpu_torch.models.quantize import QuantConv

    shapes = {}

    def record(mod, args, name):
        x = args[0]
        key = (x.shape[1], mod.bias.numel(), mod.kernel_size, mod.strides,
               mod.padding, mod.transpose, x.shape[2], x.shape[3])
        shapes.setdefault(key, [name, 0])[1] += 1

    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: record(mod, args, name))
        for name, m in model.named_modules() if isinstance(m, QuantConv)]
    try:
        with torch.inference_mode():
            model(torch.zeros(1, 3, *crop_hw,
                              device=model.conv1.amax.device))
    finally:
        for h in hooks:
            h.remove()
    return shapes


def int8_conv_macs(n, cin, cout, k, stride, pad, transpose, h, w) -> int:
    """Multiply-adds of one conv over n images: every tap of every output
    (a transposed conv: every tap of every input pixel)."""
    if transpose:
        return n * h * w * cin * cout * k * k
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    return n * ho * wo * cout * cin * k * k


def check_int8_convs(dev, shapes, on_card):
    """The int8 product's card route (patch matrix + torch._int_mm) against
    its plain version (float64 conv) bit for bit at every distinct conv
    shape of the path's net at INT8_CROPS crops, random int8 operands (the
    input in NHWC memory, as the path hands it on); each
    timed beside the same conv through cuDNN in bf16 (channels last), the
    plain version and its bound (int8 operations at the card's int8 peak).
    Then all +-127 operands at the largest dense K (a 3x3 over the most
    channels, every product counted) and at the largest GEMM K (the
    transposed conv over the most channels, K = 16 x Cin with its inserted
    zeros). -> (rows, names of the shapes where the int8 route beat cuDNN
    bf16)."""
    import torch.nn.functional as F

    from flowtrack_tpu_torch.ops import int8_conv

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    rows, wins = [], []

    def operands(key, n, fill=None):
        cin, cout, k, _, _, transpose, h, w = key
        wshape = (cin, cout, k, k) if transpose else (cout, cin, k, k)
        if fill is not None:
            x = torch.full((n, cin, h, w), 127, dtype=torch.int8, device=dev)
            wq = torch.full(wshape, fill, dtype=torch.int8, device=dev)
            # the other sign for the first half of the output channels
            wq.narrow(int(transpose), 0, cout // 2).neg_()
            return x, wq
        # NHWC memory, as the path's activations leave an int8 conv
        return (torch.randint(-127, 128, (n, cin, h, w), generator=gen,
                              dtype=torch.int8, device=dev).contiguous(
                                  memory_format=torch.channels_last),
                torch.randint(-127, 128, wshape, generator=gen,
                              dtype=torch.int8, device=dev))

    for key, (name, count) in shapes.items():
        cin, cout, k, s, p, t, h, w = key
        x, wq = operands(key, INT8_CROPS)
        got = int8_conv.int8_conv2d(x, wq, s, p, t)
        want = int8_conv.int8_conv2d_plain(x, wq, s, p, t)
        require(got.shape == want.shape and torch.equal(got, want),
                f"int8 conv {name} {key}: card route != plain version")
        del want
        row = dict(conv=name, shape=f"{cin}->{cout} {k}x{k}/{s}"
                   + (" transposed" if t else ""), input_hw=f"{h}x{w}",
                   per_forward=count, bitwise=True)
        if on_card:
            conv = F.conv_transpose2d if t else F.conv2d
            xb = x.to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            wb = wq.to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            ms = time_ms(lambda: int8_conv.int8_conv2d(x, wq, s, p, t), 5)
            cudnn_ms = time_ms(lambda: conv(xb, wb, stride=s, padding=p), 5)
            plain_ms = time_ms(
                lambda: int8_conv.int8_conv2d_plain(x, wq, s, p, t), 2,
                warmup=1)
            macs = int8_conv_macs(INT8_CROPS, *key)
            row.update(ms=ms, cudnn_bf16_ms=cudnn_ms, plain_ms=plain_ms,
                       **bound_fields(ms, bound_ms(2 * macs, "int8",
                                                   (x, wq, got))),
                       int8_tops=2 * macs / ms / 1e9)
            if ms < cudnn_ms:
                wins.append(name)
            del xb, wb
        log("int8", check="conv", **row)
        rows.append(row)
        del x, wq, got
    dense = max((key for key in shapes if not key[5]),
                key=lambda key: (key[0] * key[2] ** 2, -key[3]))
    deep = max((key for key in shapes if key[5]), key=lambda key: key[0])
    for label, key in (("dense", dense), ("gemm", deep)):
        for sign in (1, -1):
            cin, cout, k, s, p, t, h, w = key
            x, wq = operands(key, 2, fill=sign * 127)
            got = int8_conv.int8_conv2d(x, wq, s, p, t)
            want = int8_conv.int8_conv2d_plain(x, wq, s, p, t)
            require(torch.equal(got, want),
                    f"int8 conv +-127 at the largest {label} K {key}: card "
                    f"route != plain version")
            peak = int(got.abs().max())
            if not t and s == 1 and min(h, w) >= k:
                # every tap of an interior output is a product
                require(peak == cin * k * k * 127 * 127,
                        f"int8 conv +-127 {key}: peak {peak}")
            log("int8", check="extremes", k_kind=label,
                gemm_k=k * k * cin, shape=shapes[key][0], sign=sign,
                peak=peak, bitwise=True)
    return rows, wins


def quantized_models(cfg, dev, gen):
    """``BENCH_QUANT``'s pose nets from one float R50 (float32 copy of the
    config, random batch-norm statistics), calibrated on 2 x PERSONS random
    crops as bench.py does, compute dtype bf16: runtime int8 (also run
    float, "folded"), prequantized and mixed; and the same weights as the
    config's bf16 PoseResNet and FusedPoseResNet."""
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from flowtrack_tpu_torch.models.quantize import quantize_pose_model
    from flowtrack_tpu_torch.ops.fused_resnet import fuse_pose_model

    fcfg = replace(cfg.model, dtype="float32")
    float_model = random_bn_pose_net(fcfg, dev, gen)
    calib = torch.randn(2 * PERSONS, 3, *fcfg.image_size, generator=gen
                        ).to(dev)
    bf16 = torch.bfloat16
    runtime = quantize_pose_model(float_model, fcfg, [calib],
                                  compute_dtype=bf16)
    pre = quantize_pose_model(float_model, fcfg, [calib], prequantized=True,
                              compute_dtype=bf16)
    mixed = quantize_pose_model(float_model, fcfg, [calib], mixed=True,
                                compute_dtype=bf16)
    base = get_pose_net(cfg.model, dev)
    base.load_state_dict(float_model.state_dict())
    return {"folded_bf16": lambda x: runtime(x, quantized=False),
            "int8": runtime, "prequantized": pre, "mixed_bf16": mixed,
            "pose_resnet_bf16": base,
            "fused": fuse_pose_model(cfg.model, base)}


def check_int8_modes(dev, models, crop_hw, on_card, card_f):
    """The four modes and the two float nets on INT8_CROPS bf16 crops (as
    ClipTracker crops): finite heatmaps of the right shape, runtime int8
    equal to prequantized bit for bit, ms a forward and the int8 GEMMs a
    forward; then the quantized nets moved to the CPU against the card on
    INT8_CPU_CROPS crops."""
    import copy

    from flowtrack_tpu_torch.ops import int8_conv

    hm_hw = tuple(d // 4 for d in crop_hw)
    crops = torch.randn(INT8_CROPS, 3, *crop_hw, device=dev).to(torch.bfloat16)
    out, ms = {}, {}
    with torch.inference_mode():
        for mode, model in models.items():
            before = int8_conv.int8_conv2d_gemm.launches
            y = model(crops)
            gemms = int8_conv.int8_conv2d_gemm.launches - before
            require(y.shape == (INT8_CROPS, 17, *hm_hw)
                    and y.dtype == torch.float32
                    and bool(torch.isfinite(y).all()),
                    f"int8 {mode}: {y.dtype} {tuple(y.shape)} or not finite")
            if on_card:
                ms[mode] = time_ms(lambda m=model: m(crops), 3)
            out[mode] = y[:INT8_CPU_CROPS].float().cpu()
            log("int8", check="forward", mode=mode, crops=INT8_CROPS,
                ms=ms.get(mode), int8_gemm_launches=gemms, card=card_f)
        require(torch.equal(models["int8"](crops),
                            models["prequantized"](crops)),
                "int8: prequantized != runtime int8 on the card")
        cpu_crops = crops[:INT8_CPU_CROPS].cpu()
        errs = {}
        for mode, tol in (("int8", INT8_CPU_REL_TOL),
                          ("prequantized", INT8_CPU_REL_TOL),
                          ("mixed_bf16", POSE_BF16_REL_TOL),
                          ("folded_bf16", POSE_BF16_REL_TOL)):
            if mode == "folded_bf16":
                cpu = copy.deepcopy(models["int8"]).cpu()
                want = cpu(cpu_crops, quantized=False)
            else:
                want = copy.deepcopy(models[mode]).cpu()(cpu_crops)
            errs[mode] = ((out[mode] - want).abs().max()
                          / want.abs().max()).item()
            require(errs[mode] <= tol,
                    f"int8 {mode}: card vs CPU {errs[mode]} > {tol}")
    log("int8", check="card_vs_cpu", crops=INT8_CPU_CROPS, rel_err=errs,
        tol={"int8": INT8_CPU_REL_TOL, "bf16": POSE_BF16_REL_TOL})
    return ms, errs


def phase_int8(card, dev=None):
    """``BENCH_QUANT=pre python bench.py``'s path on the port: the
    coco_res50_256x192 config (FlowNetS, flip, recovery, bf16 crops) with
    PoseResNet-50 folded, calibrated and quantized W8A8, its weights stored
    int8. The int8 product at every conv shape, the four modes and the float
    nets at 256 crops, the card against the CPU, then three chained clips
    of the path (crop and int8 GEMM launched) beside the same config with
    the bf16 PoseResNet of the same weights. Returns the int8 path's launch
    counts."""
    from flowtrack_tpu_torch.config import get_config

    dev = torch.device("cuda") if dev is None else dev
    on_card = dev.type == "cuda"
    card_f = f"'{card}'"
    t_phase = time.perf_counter()
    base = get_config("coco_res50_256x192")
    cfg = replace(base, track=replace(base.track, max_persons=PERSONS,
                                      max_recovered=RECOVERED))
    require(cfg.model.num_layers == 50 and cfg.flow.variant == "flownet_s"
            and cfg.model.dtype == "bfloat16", "R50 + FlowNetS, bf16")
    gen = torch.Generator().manual_seed(SEED + 6)
    models = quantized_models(cfg, dev, gen)
    shapes = int8_conv_shapes(models["prequantized"], cfg.model.image_size)
    rows, wins = check_int8_convs(dev, shapes, on_card)
    ms, errs = check_int8_modes(dev, models, cfg.model.image_size, on_card,
                                card_f)
    SUMMARY["int8_forward_ms"] = {k: round(v, 2) for k, v in ms.items()}
    SUMMARY["int8_wins_over_cudnn_bf16"] = wins
    log("int8", convs=len(rows), int8_wins_over_cudnn_bf16=wins,
        route_ms_a_forward=sum(r.get("ms", 0) * r["per_forward"]
                               for r in rows),
        cudnn_bf16_ms_a_forward=sum(r.get("cudnn_bf16_ms", 0)
                                    * r["per_forward"] for r in rows),
        card=card_f)
    if not on_card:
        return {}
    def two_crops_a_clip(launches):
        require(launches["crop_resize_normalize"] == 2 * CLIPS,
                f"int8: {launches['crop_resize_normalize']} crop launches "
                f"for {CLIPS} clips")

    launches = drive_path("int8", card, cfg, (FRAME_H, FRAME_W),
                          ("crop_resize_normalize", "int8_gemm"),
                          models["prequantized"], two_crops_a_clip)
    drive_path("int8_base", card, cfg, (FRAME_H, FRAME_W),
               ("crop_resize_normalize",), models["pose_resnet_bf16"])
    fps = SUMMARY["frames_per_s"]
    log("int8", frames_per_s=fps["int8"], bf16_same_config=fps["int8_base"],
        slice=fps.get("slice"), fused=fps.get("fused"), card=card_f)
    SUMMARY["int8_phase_s"] = round(time.perf_counter() - t_phase, 1)
    log("int8", phase_s=time.perf_counter() - t_phase, launches=launches,
        card=card_f)
    return launches


def phase_aot(card):
    """``flowtrack_tpu_torch/aot.py`` on the card: slice 1's and the fused
    path's clip programs exported for ``cuda`` at full width (AOT_FRAMES
    float32 frames of FRAME_H x FRAME_W, PERSONS persons) and
    loaded back; over two chained clips the artifact's outputs and seeds
    equal the live tracker's (its clip graph) bit for bit, its own seed_out
    feeding its second call; and the artifact launches the path's kernels
    (slice 1: crop and correlation; fused: crop and fused_stage). The live
    tracker runs its first clip before the export and its second after
    it, and that second run equals the eager ``_clip`` bit for bit: a
    graph never reads weights that the export made its nets rebuild."""
    from flowtrack_tpu_torch import aot
    from flowtrack_tpu_torch.config import get_config
    from flowtrack_tpu_torch.models.flownet import get_flow_net
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from flowtrack_tpu_torch.ops.fused_resnet import fuse_pose_model
    from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker

    dev = torch.device("cuda")
    card_f = f"'{card}'"
    t_phase = time.perf_counter()
    base = get_config("coco_res50_256x192")
    fused_cfg = replace(base, track=replace(base.track, max_persons=PERSONS,
                                            max_recovered=RECOVERED))
    rng = np.random.default_rng(SEED + 8)
    n_frames = 2 * AOT_FRAMES - 1
    video = rng.integers(0, 256, (n_frames, FRAME_H, FRAME_W, 3),
                         np.uint8).astype(np.float32)
    det = video_detections(rng, n_frames, PERSONS, FRAME_H, FRAME_W,
                           (2.0, 1.0), drop=[(1,), (AOT_FRAMES + 1,)])
    counters = kernel_counters()
    for tag, kernels in (("slice", ("crop_resize_normalize", "correlation")),
                         ("fused", ("crop_resize_normalize", "fused_stage"))):
        gen = torch.Generator().manual_seed(SEED)
        if tag == "slice":
            cfg = slice_config()
            pose = get_pose_net(cfg.model, dev, gen)
        else:
            cfg = fused_cfg
            pose = fuse_pose_model(cfg.model,
                                   random_bn_pose_net(cfg.model, dev, gen))
        # every random-weight candidate kept, so the equality is not empty
        cfg = replace(cfg, track=replace(cfg.track, pose_score_thre=0.0))
        tracker = ClipTracker(cfg, pose, get_flow_net(cfg.flow, dev, gen),
                              max_persons=PERSONS, device=dev)
        clips = [tracker.prepare(*(x[sl] for x in (video, *det)),
                                 frame_offset=sl.start)
                 for sl in (slice(0, AOT_FRAMES),
                            slice(AOT_FRAMES - 1, n_frames))]
        # the live tracker captures its graph before the export, which
        # swaps the nets' tensors (a fused net then checks and transposes
        # its blocks anew); its next run must read the nets' tensors as
        # they are after it
        live1 = tracker.run_prepared(clips[0])
        graph = next(iter(tracker.graphs.values()))
        t0 = time.perf_counter()
        blob = aot.export_clip_program(tracker, AOT_FRAMES,
                                       (FRAME_H, FRAME_W))
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        call = aot.load_clip_program(blob)
        load_s = time.perf_counter() - t0
        weights = (tracker.pose_model.state_dict(),
                   tracker.flow_model.state_dict())
        live2 = tracker.run_prepared(clips[1], seed=live1[5])
        recaptured = next(iter(tracker.graphs.values())) is not graph
        require(recaptured or tag != "fused", "aot fused: the live graph "
                "was not captured again after the export rebuilt the fused "
                "net's blocks")
        eager2 = eager_run(tracker, [x[None] for x in clips[1]],
                           [live1[5]])
        for a, b in zip((*live2[:5], *live2[5]),
                        (*eager2[:5], *eager2[5])):
            require(torch.equal(a, b[0]), f"aot {tag}: after the export "
                                          f"the live tracker's graph "
                                          f"differs from the eager clip")
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        with torch.inference_mode():
            out1 = call(*weights, *clips[0], *tracker.empty_seed())
            out2 = call(*weights, *clips[1], *out1[5])
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        require(all(launches[k] for k in kernels),
                f"aot {tag}: a kernel of the path never launched: "
                f"{launches}")
        leaves = 0
        for live, got in ((live1, out1), (live2, out2)):
            for a, b in zip((*live[:5], *live[5]), (*got[:5], *got[5])):
                require(torch.equal(a, b), f"aot {tag}: the artifact's "
                                           f"output differs from the live "
                                           f"tracker's")
                leaves += 1
        require(bool(live2[4].any()), f"aot {tag}: no valid slot")
        ops = sorted(op for op in call.ops if op.startswith("flowtrack."))
        want_ops = {"crop_resize_normalize": "flowtrack.crop_frames.default",
                    "correlation": "flowtrack.correlation.default",
                    "fused_stage": "flowtrack.fused_stage.default"}
        require({want_ops[k] for k in kernels} <= set(ops),
                f"aot {tag}: the program calls {ops}, not every kernel of "
                f"the path as its op")
        SUMMARY.setdefault("aot_export_load_s", {})[tag] = (
            round(export_s, 1), round(load_s, 1))
        log("aot", path=tag, clips=2, frames_per_clip=AOT_FRAMES,
            frame_hw=f"{FRAME_H}x{FRAME_W}", export_s=export_s,
            load_s=load_s, mib=len(blob) / 2 ** 20, kernel_ops=ops,
            bitwise_leaves=leaves, launches=launches,
            graph_recaptured_after_export=recaptured,
            live_graph_equal_to_eager_after_export=True, card=card_f)
        del tracker, call
    log("aot", phase_s=time.perf_counter() - t_phase, card=card_f)


def int8_closed_loop(cfg, model, dev, card_f):
    """tests/test_quantize.py:119's contract on the R18 the train CLI's
    closed loop trained: quantized W8A8 (float32 compute, calibrated on the
    first validation batch, as that test does), its decoded keypoints
    within INT8_LOOP_PX of the float model's for more than INT8_LOOP_SHARE
    of the joints; both models' COCO AP on the fixture through
    ``run_validation``."""
    import contextlib
    import io

    from flowtrack_tpu_torch.data import BatchLoader, COCODataset
    from flowtrack_tpu_torch.models.quantize import quantize_pose_model
    from flowtrack_tpu_torch.ops.decode import get_final_preds
    from flowtrack_tpu_torch.tools.test import run_validation

    model = model.eval()
    batch = next(iter(BatchLoader(
        COCODataset(cfg, cfg.data.root, "val2017", is_train=False), 8)))
    x = torch.as_tensor(batch["input"], device=dev).permute(0, 3, 1, 2)
    center, scale = (torch.as_tensor(batch[k], device=dev)
                     for k in ("center", "scale"))
    qmodel = quantize_pose_model(model, cfg.model, [x.contiguous()])
    with torch.inference_mode():
        preds = [get_final_preds(m(x.contiguous()).permute(0, 2, 3, 1),
                                 center, scale)[0] for m in (model, qmodel)]
    dist = (preds[0] - preds[1]).norm(dim=-1)
    share = (dist <= INT8_LOOP_PX).float().mean().item()
    with contextlib.redirect_stdout(io.StringIO()):
        ap_float = run_validation(cfg, model, device=dev)["AP"]
        ap_int8 = run_validation(cfg, qmodel, device=dev)["AP"]
    require(share > INT8_LOOP_SHARE,
            f"int8 closed loop: {share} of the joints within "
            f"{INT8_LOOP_PX} px of the float model's")
    SUMMARY["int8_closed_loop"] = (round(share, 4), round(ap_float, 4),
                                   round(ap_int8, 4))
    log("int8", check="closed_loop", within_px=INT8_LOOP_PX,
        share_within=share, mean_px=dist.mean().item(), ap_float=ap_float,
        ap_int8=ap_int8, card=card_f)


# the train phase: pose at the config's batch (32) on 256x192 crops from
# a synthetic COCO set; FlowNetC and the FlowNet2 fine-tune at the flow
# training crop, 320x448, batch 8
TRAIN_POSE_IMAGES, TRAIN_LOADER_STEPS, TRAIN_TIMED_STEPS = 48, 3, 10
FLOW_TRAIN_HW, FLOW_TRAIN_BATCH, FLOW_TIMED_STEPS = (320, 448), 8, 5
# kernel route against plain route, one kernel at a time (K2 in FlowNetC,
# the warp in FlowNet2): each parameter's gradient, max |diff| over its max
# |gradient|. Only K2's summation order differs (the warp is bitwise), so
# float32: under 1e-3. bf16: the volume's last-bit differences flip bf16
# roundings of the activations, which the layers after it carry, so the
# bound is what bf16 itself moves the gradients: the route may move them no
# more than the float32 model's gradients lie from the bf16 model's (same
# weights and batch). Both kernels' routes at once through the cascade are
# logged, not bounded: its four warps turn K2's last-bit differences into
# other taps wherever a sample sits near a pixel edge or the frame's
ROUTE_GRAD_F32_TOL = 1e-3
# the gradient check of K2 and the warp alone: <g, (f(x + e v) - f(x - e v))
# / 2e> against <backward(g), v>, relative. K2 is bilinear in (f1, f2) and
# the warp linear in the image and, inside a cell, bilinear in the flow, so
# central differences are exact but for float32 rounding (the flow's: the
# coordinates' ulp at 448 px over the 0.05 px step)
FD_REL_TOL = {"correlation": 1e-3, "resample2d_img": 1e-4,
              "resample2d_flow": 5e-3}


def coco_fixture():
    """The repository's synthetic COCO writer, tests/fixtures.py (json,
    numpy and cv2 or PIL), loaded by its path: a ``tests`` package installed
    on the card's machine would shadow the repository's."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "coco_fixture", Path(__file__).resolve().parent / "tests" / "fixtures.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def grads_of(model, loss_fn):
    """{name: gradient (float32 copy)} of one forward and backward."""
    model.zero_grad(set_to_none=True)
    loss_fn().backward()
    return {k: p.grad.detach().float().clone()
            for k, p in model.named_parameters() if p.grad is not None}


def grad_rel_diff(got, want) -> tuple:
    """The largest, over parameters, of max |got - want| / max |want|, and
    that parameter's name."""
    worst, where = 0.0, None
    for k, w in want.items():
        err = ((got[k] - w).abs().max() / w.abs().max().clamp(min=1e-30)
               ).item()
        if err > worst:
            worst, where = err, k
    return worst, where


def plain_route(kernels=()):
    """Send the named kernels ("correlation", "resample2d") to their plain
    versions on the card's tensors, the others to their kernels: the
    Functions' dispatch rule."""
    from flowtrack_tpu_torch.ops import correlation as corr_mod
    from flowtrack_tpu_torch.ops import warp as warp_mod

    for name, mod in (("correlation", corr_mod), ("resample2d", warp_mod)):
        mod._runs_kernel = ((lambda t: False) if name in kernels
                            else (lambda t: t.device.type != "cpu"))


def flow_batch(rng, n, hw, dev):
    """n preprocessed pairs (N, H, W, 6) of random uint8 frames and a
    smooth ground-truth flow (N, H, W, 2) of up to +-8 px, on ``dev``."""
    from flowtrack_tpu_torch.models.flownet import preprocess_pair

    h, w = hw
    frames = torch.as_tensor(rng.integers(0, 256, (2, n, h, w, 3), np.uint8),
                             device=dev)
    gt = smooth_flow(rng, n, h, w, 8.0, dev).permute(0, 2, 3, 1).contiguous()
    return {"input": preprocess_pair(frames[0], frames[1]).contiguous(),
            "flow": gt}


def route_check(tag, model, model32, batch, div_flow, kernels, card_f):
    """The gradients of one train-mode forward and backward of the bf16
    ``model`` and of ``model32`` (float32, the same weights), same batch,
    cuDNN deterministic: through the kernels (twice: the floor the library
    leaves), with ``kernels`` sent to their plain versions (bounded), and
    with both sent there (logged). Returns {dtype: max relative route
    difference of ``kernels``}."""
    from flowtrack_tpu_torch.engine.loss import epe, multiscale_epe

    x = batch["input"].permute(0, 3, 1, 2).contiguous()

    def loss_of(net):
        def loss():
            out = net.train()(x)
            if isinstance(out, tuple):
                return multiscale_epe([f.permute(0, 2, 3, 1) for f in out],
                                      batch["flow"], div_flow=div_flow)
            return epe(out.permute(0, 2, 3, 1), batch["flow"])
        return loss

    routes = {"kernel": (), "again": (), "plain": kernels,
              "both_plain": ("correlation", "resample2d")}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    grads = {}
    try:
        for dtype, net in (("bfloat16", model), ("float32", model32)):
            for route, plain in routes.items():
                plain_route(plain)
                grads[dtype, route] = grads_of(net, loss_of(net))
    finally:
        plain_route()
        torch.backends.cudnn.deterministic = deterministic
    bf16_vs_f32, _ = grad_rel_diff(grads["bfloat16", "kernel"],
                                   grads["float32", "kernel"])
    out = {}
    for dtype in ("bfloat16", "float32"):
        kernel = grads[dtype, "kernel"]
        err, where = grad_rel_diff(kernel, grads[dtype, "plain"])
        floor, _ = grad_rel_diff(grads[dtype, "again"], kernel)
        both, _ = grad_rel_diff(kernel, grads[dtype, "both_plain"])
        tol = bf16_vs_f32 if dtype == "bfloat16" else ROUTE_GRAD_F32_TOL
        log("train", check="route_gradients", net=tag, dtype=dtype,
            plain=",".join(kernels), max_rel_diff=err, worst_param=where,
            repeat_rel_diff=floor, both_plain_rel_diff=both, tol=tol,
            params=len(kernel), card=card_f)
        require(err <= tol, f"{tag} {dtype}: gradients through the "
                            f"{kernels} kernels differ from the plain "
                            f"route's by {err} ({where}) > {tol}")
        out[dtype] = err
    log("train", check="route_gradients", net=tag,
        bf16_vs_float32_rel_diff=bf16_vs_f32, card=card_f)
    return out


def fd_check(dev, rng, card_f):
    """K2 and the warp alone at the paths' shapes, float32: the plain
    backward's directional derivative against central differences of the
    kernel's forward; the backward's time beside the forward's."""
    from flowtrack_tpu_torch.ops import correlation as corr_mod
    from flowtrack_tpu_torch.ops import warp as warp_mod

    h, w = FLOW_TRAIN_HW
    n = FLOW_TRAIN_BATCH
    shape = (n, 256, h // 8, w // 8)
    f1, f2, v1, v2 = (torch.as_tensor(rng.standard_normal(shape),
                                      dtype=torch.float32, device=dev)
                      for _ in range(4))
    out = corr_mod.correlation_cuda(f1, f2)
    g = torch.as_tensor(rng.standard_normal(out.shape), dtype=torch.float32,
                        device=dev)
    d1, d2 = corr_mod.correlation_backward(f1, f2, g)
    eps = 1e-2
    fd = ((corr_mod.correlation_cuda(f1 + eps * v1, f2 + eps * v2)
           - corr_mod.correlation_cuda(f1 - eps * v1, f2 - eps * v2))
          .double() * g.double()).sum() / (2 * eps)
    an = (d1.double() * v1.double()).sum() + (d2.double() * v2.double()).sum()
    errs = {"correlation": abs((fd - an) / an).item()}
    times = {"correlation": (
        time_ms(lambda: corr_mod.correlation_cuda(f1, f2), 10),
        time_ms(lambda: corr_mod.correlation_backward(f1, f2, g), 3))}
    bf1, bf2 = f1.to(torch.bfloat16), f2.to(torch.bfloat16)
    times["correlation_bf16"] = (
        time_ms(lambda: corr_mod.correlation_cuda(bf1, bf2), 10),
        time_ms(lambda: corr_mod.correlation_backward(bf1, bf2, g), 3))

    img = torch.as_tensor(rng.normal(0, 0.3, (n, 3, h, w)),
                          dtype=torch.float32, device=dev)
    # a cascade-like flow moved so that every sample lies inside the frame
    # at a fraction in [0.3, 0.7] of its cell: steps of up to 0.05 px along
    # vf cross no cell edge, where the bilinear weights bend, and the warp
    # is bilinear along them, so central differences are exact but for
    # rounding
    flow = smooth_flow(rng, n, h, w, 8.0, dev)
    grid = torch.stack(torch.meshgrid(
        torch.arange(w, dtype=torch.float32, device=dev),
        torch.arange(h, dtype=torch.float32, device=dev), indexing="xy"))
    hi = torch.tensor([w - 2.0, h - 2.0], device=dev).view(2, 1, 1)
    at = torch.minimum((grid + flow).clamp(min=1.0), hi).floor()
    frac = torch.as_tensor(rng.uniform(0.3, 0.7, flow.shape),
                           dtype=torch.float32, device=dev)
    flow = at + frac - grid
    vi = torch.as_tensor(rng.standard_normal(img.shape), dtype=torch.float32,
                         device=dev)
    vf = torch.as_tensor(rng.uniform(-1.0, 1.0, flow.shape),
                         dtype=torch.float32, device=dev)
    gw = torch.as_tensor(rng.standard_normal(img.shape), dtype=torch.float32,
                         device=dev)
    di, dfl = warp_mod.resample2d_backward(img, flow, gw)
    warp = warp_mod.resample2d_cuda
    for key, e, args in (
            ("resample2d_img", 1e-2, lambda s: (img + s * vi, flow)),
            ("resample2d_flow", 0.05, lambda s: (img, flow + s * vf))):
        fd = ((warp(*args(e)) - warp(*args(-e))).double() * gw.double()
              ).sum() / (2 * e)
        an = ((di * vi) if key == "resample2d_img" else (dfl * vf)
              ).double().sum()
        errs[key] = abs((fd - an) / an).item()
    times["resample2d"] = (
        time_ms(lambda: warp(img, flow), 20),
        time_ms(lambda: warp_mod.resample2d_backward(img, flow, gw), 5))
    torch.cuda.synchronize()
    for key, err in errs.items():
        require(err <= FD_REL_TOL[key], f"{key}: directional derivative "
                f"off central differences by {err} > {FD_REL_TOL[key]}")
    log("train", check="kernel_alone_central_differences", rel_err=errs,
        tol=FD_REL_TOL, card=card_f)
    for key, (fwd, bwd) in times.items():
        log("train", check="kernel_alone", kernel=key,
            shape="x".join(map(str, shape if "corr" in key else img.shape)),
            forward_ms=fwd, backward_plain_ms=bwd, card=card_f)
    SUMMARY["backward_ms"] = {k: round(b, 3) for k, (_, b) in times.items()}
    return times


# -- the eval phase: the port's CLIs and the closed loops ---------------------

# the track CLIs' PoseTrack set: slice 1's frame size, 2 videos x 16
# frames, 4 persons; eval_flow on 4 pairs; the GT-heatmap loop's 8 images of
# PERSONS persons; the dropout loop's 6-frame clip, a miss at frame 3
EVAL_VIDEOS, EVAL_FRAMES, EVAL_PERSONS = 2, 16, 4
EVAL_FLOW_PAIRS = 4
LOOP_IMAGES = 8
DROP_FRAMES, DROP_AT, DROP_VEL = 6, 3, (6.0, 3.0)


def cli_config(name, opts):
    """The config a CLI builds from ``--cfg name`` and its overrides."""
    from flowtrack_tpu_torch.config import apply_overrides, get_config

    return apply_overrides(get_config(name), opts)


def write_npz_weights(path, model, convert) -> str:
    """A port model's weights as the reference's .npz tree, which the CLIs
    read through their own loaders."""
    from flowtrack_tpu_torch.engine.checkpoint import save_npz_variables

    save_npz_variables(path, convert(model.state_dict()))
    return path


def run_cli(main, argv, counters, total, traced=False, check=None):
    """One CLI run with every launch count set to 0 just before and read
    just after (and added to ``total``); its stdout (its json line, its
    log) kept out of the smoke's. ``traced``: the counts come from the
    run's device trace (``counted``, held to ``check(launches)``), as a
    CLI whose programs replay graphs launches kernels without their
    wrappers; else from the wrappers. -> (main's return value, launches,
    seconds)."""
    import contextlib
    import io

    def run():
        with contextlib.redirect_stdout(io.StringIO()):
            return main(argv)

    if traced:
        out, seconds, launches = counted(argv[0], run, check)
    else:
        t0 = time.perf_counter()
        out = zero_counts(run)()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
    for k, n in launches.items():
        total[k] += n
    return out, launches, seconds


def heatmap_loop(dev):
    """``bench.py``'s GT-heatmap closed loop on ``dev``: gaussian heatmaps
    planted at known joints of LOOP_IMAGES x PERSONS persons (the port's
    generate_target_np on each person's crop), get_final_preds and rescore
    on ``dev``, scored by the port's COCOKeypointEval. -> (stats, largest
    decode error in image pixels, decoded joints)."""
    from flowtrack_tpu_torch.config import get_config
    from flowtrack_tpu_torch.eval.coco_eval import COCOKeypointEval
    from flowtrack_tpu_torch.ops.affine import (affine_transform,
                                                get_affine_transform)
    from flowtrack_tpu_torch.ops.decode import get_final_preds, rescore
    from flowtrack_tpu_torch.ops.heatmap import generate_target_np
    from flowtrack_tpu_torch.pipeline import batched_box_to_center_scale

    cfg = get_config("coco_res50_256x192")
    ih, iw = cfg.model.image_size
    hh, hw = cfg.model.heatmap_size
    k = cfg.model.num_joints
    rng = np.random.default_rng(SEED)
    gts, hms, centers, scales, img_ids, gt_joints = [], [], [], [], [], []
    for img in range(LOOP_IMAGES):
        boxes = np.stack([rng.uniform(10, 300, PERSONS),
                          rng.uniform(10, 300, PERSONS),
                          rng.uniform(80, 160, PERSONS),
                          rng.uniform(120, 220, PERSONS)], axis=1)
        c, s = batched_box_to_center_scale(boxes, iw / ih)
        for i in range(PERSONS):
            x0, y0, w, h = boxes[i]
            joints = np.stack([rng.uniform(x0 + 0.15 * w, x0 + 0.85 * w, k),
                               rng.uniform(y0 + 0.15 * h, y0 + 0.85 * h, k)],
                              axis=1)
            trans = get_affine_transform(c[i], s[i], 0.0, (iw, ih))
            hm, _ = generate_target_np(affine_transform(joints, trans),
                                       np.ones(k), (hh, hw), (ih, iw),
                                       cfg.model.sigma)
            hms.append(hm)
            gt_joints.append(joints)
            kp = np.concatenate([joints, np.full((k, 1), 2.0)], 1)
            gts.append({"image_id": img, "area": float(w * h),
                        "bbox": [float(x0), float(y0), float(w), float(h)],
                        "keypoints": kp.reshape(-1).tolist(), "iscrowd": 0,
                        "num_keypoints": k})
            centers.append(c[i])
            scales.append(s[i])
            img_ids.append(img)
    preds, maxvals = get_final_preds(
        torch.as_tensor(np.stack(hms), device=dev),
        torch.as_tensor(np.stack(centers), dtype=torch.float32, device=dev),
        torch.as_tensor(np.stack(scales), dtype=torch.float32, device=dev))
    scores = rescore(torch.ones(len(hms), device=dev), maxvals,
                     cfg.test.in_vis_thre)
    preds, maxvals = preds.cpu().numpy(), maxvals.cpu().numpy()
    scores = scores.cpu().numpy()
    err = float(np.abs(preds - np.stack(gt_joints)).max())
    dts = [{"image_id": img_ids[i], "score": float(scores[i]),
            "keypoints": np.concatenate([preds[i], maxvals[i][:, None]],
                                        1).reshape(-1).tolist()}
           for i in range(len(hms))]
    return COCOKeypointEval(gts, dts).evaluate(), err, preds


def dropout_loop(dev):
    """``bench.py``'s dropout-recovery closed loop on ``dev``: the planted
    pose and constant flow stubs through ClipTracker on a 6-frame clip
    (persons A and B moving at DROP_VEL, 30x30 boxes, 64x64 crops), B's
    detection missed at frame DROP_AT; the ground truth is the same run
    with no miss. -> (direct stats, motmetrics-style stats)."""
    from flowtrack_tpu_torch.config import Config, ModelConfig
    from flowtrack_tpu_torch.eval.posetrack_eval import (
        evaluate_posetrack, evaluate_posetrack_mot)
    from flowtrack_tpu_torch.tracking.clip_pipeline import (ClipTracker,
                                                            pad_detections)

    cfg = Config(model=ModelConfig(image_size=(64, 64), heatmap_size=(16, 16),
                                   dtype="float32"))
    cfg = replace(cfg, test=replace(cfg.test, flip_test=False),
                  track=replace(cfg.track, max_persons=4, pose_score_thre=0.1,
                                track_oks_thre=0.3))
    tracker = ClipTracker(cfg, PlantedPose(cfg.model.heatmap_size, dev),
                          ConstantFlow(DROP_VEL, cfg.flow.div_flow, dev),
                          device=dev)
    vx, vy = DROP_VEL
    frames = np.zeros((DROP_FRAMES, 128, 160, 3), np.float32)

    def run(drop):
        boxes, scores = [], []
        for t in range(DROP_FRAMES):
            bs = [[40 + vx * t - 15, 50 + vy * t - 15, 30, 30]]
            if t != drop:
                bs.append([90 + vx * t - 15, 60 + vy * t - 15, 30, 30])
            boxes.append(bs)
            scores.append([0.9, 0.8][:len(bs)])
        return tracker.track_clip(frames, *pad_detections(
            boxes, scores, cfg.track.max_persons))

    full, out = run(None), run(DROP_AT)
    k = full["joints"].shape[2]
    gt_seq = [[{"track_id": pid, "head_size": 20.0,
                "keypoints": np.concatenate([full["joints"][t, pid],
                                             np.ones((k, 1))], 1)}
               for pid in range(2)] for t in range(DROP_FRAMES)]
    pred_seq = [[{"track_id": int(out["ids"][t, s]),
                  "keypoints": np.concatenate(
                      [out["joints"][t, s], out["maxvals"][t, s][:, None]], 1),
                  "score": float(out["scores"][t, s])}
                 for s in range(out["valid"].shape[1]) if out["valid"][t, s]]
                for t in range(DROP_FRAMES)]
    return (evaluate_posetrack([gt_seq], [pred_seq]),
            evaluate_posetrack_mot([gt_seq], [pred_seq]))


def phase_eval(card, dev=None):
    """The port's CLIs on the card, through their own ``main``: ``track``
    (flowtrack_posetrack, R152 256x192 with FlowNetC, bf16, seeded random
    weights written as the reference's .npz) over a PoseTrack set of
    EVAL_VIDEOS x EVAL_FRAMES frames of 384x640 with EVAL_PERSONS persons,
    under both engines, K1 and K2 launched by each; ``test``
    (coco_res50_256x192) on a synthetic COCO set, its AP table finite;
    ``track_video`` with two streams, ``demo`` on one frame and
    ``eval_flow`` with FlowNetC on EVAL_FLOW_PAIRS pairs with a .flo ground
    truth, each with its launches read; then the closed loops through the
    port's evaluators: planted heatmaps decoded on the card (AP 1.0, decode
    error under a heatmap cell, equal to the CPU's within 1e-3 px), and the
    dropout clip (MOTA 1.0 and no switch from both PoseTrack backends).
    Returns the launch counts summed over the phase's CLI runs."""
    import tempfile
    from pathlib import Path

    from flowtrack_tpu_torch.eval.flow_eval import write_flo
    from flowtrack_tpu_torch.models.flownet import get_flow_net
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from flowtrack_tpu_torch.tools import (demo, eval_flow, test, track,
                                           track_video)
    from flowtrack_tpu_torch.utils.convert import (convert_flownet_s,
                                                   convert_pose_resnet)

    dev = torch.device("cuda") if dev is None else dev
    card_f = f"'{card}'"
    counters = kernel_counters()
    total = dict.fromkeys(counters, 0)
    # the CLIs that track (clips, or frame by frame), pose a frame or take
    # flow replay their graphs on the card: their launches come from the
    # device trace
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    pt_opts = ["flow.variant=flownet_c", "track.pose_score_thre=0.0"]
    pt_cfg = cli_config("flowtrack_posetrack", pt_opts)
    coco_cfg = cli_config("coco_res50_256x192", [])
    require(pt_cfg.model.dtype == pt_cfg.flow.dtype == "bfloat16",
            "the track CLI's nets run in bf16")
    gen = torch.Generator().manual_seed(SEED)
    fixtures = coco_fixture()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        pose152 = write_npz_weights(
            str(tmp / "r152.npz"), get_pose_net(pt_cfg.model, None, gen),
            convert_pose_resnet)
        flownet_c = write_npz_weights(
            str(tmp / "flownet_c.npz"), get_flow_net(pt_cfg.flow, None, gen),
            convert_flownet_s)
        pose50 = write_npz_weights(
            str(tmp / "r50.npz"), get_pose_net(coco_cfg.model, None, gen),
            convert_pose_resnet)
        root, ann_file = fixtures.make_posetrack_fixture(
            tmp / "pt", n_videos=EVAL_VIDEOS, n_frames=EVAL_FRAMES,
            persons=EVAL_PERSONS, img_hw=(FRAME_H, FRAME_W), seed=SEED)
        log("eval", setup_s=time.perf_counter() - t0,
            config="flowtrack_posetrack_flownet_c", model=
            f"R{pt_cfg.model.num_layers}_{pt_cfg.model.dtype}",
            frames=f"{EVAL_VIDEOS}x{EVAL_FRAMES}", frame_hw=f"{FRAME_H}x"
            f"{FRAME_W}", persons=EVAL_PERSONS)

        # -- track, both engines; the tracking alone timed a frame
        spent, originals = {}, {n: getattr(track, n) for n in
                                ("track_all", "track_all_clips")}

        def timed(name):
            def run(*args, **kwargs):
                t = time.perf_counter()
                out = originals[name](*args, **kwargs)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                spent[name] = time.perf_counter() - t
                return out
            return run

        for name in originals:
            setattr(track, name, timed(name))
        try:
            for engine, name in (("stream", "track_all"),
                                 ("clip", "track_all_clips")):
                out_dir = tmp / f"track_{engine}"
                stats, launches, seconds = run_cli(track.main, [
                    "--cfg", "flowtrack_posetrack", "--pose-weights", pose152,
                    "--flow-weights", flownet_c, "--out", str(out_dir),
                    "--engine", engine, "--device", dev.type, *pt_opts,
                    f"data.root={root}", "data.test_set=val"], counters,
                    total, traced=on_card)
                require(launches["crop_resize_normalize"] > 0
                        and launches["correlation"] > 0,
                        f"track --engine {engine}: K1 or K2 never launched: "
                        f"{launches}")
                with open(out_dir / "tracks.json") as f:
                    anns = json.load(f)["annotations"]
                require(anns and all(set(a) == {
                    "image_id", "track_id", "keypoints", "scores", "score",
                    "category_id"} and len(a["keypoints"]) == 51
                    for a in anns), f"track {engine}: tracks.json")
                scalars = {k: v for k, v in stats.items()
                           if not hasattr(v, "shape")}
                require(all(np.isfinite(v) for v in scalars.values()),
                        f"track {engine}: {scalars}")
                n_frames = EVAL_VIDEOS * EVAL_FRAMES
                ms = spent[name] / n_frames * 1e3
                SUMMARY.setdefault("eval_track_ms_per_frame", {})[engine] = \
                    round(ms, 2)
                log("eval", cli="track", engine=engine, frames=n_frames,
                    poses=len(anns), ms_per_frame=ms, main_s=seconds,
                    launches=launches, mAP=scalars["mAP"],
                    MOTA=scalars["MOTA"], card=card_f)
        finally:
            for name, fn in originals.items():
                setattr(track, name, fn)

        # -- test: the AP table of coco_res50_256x192 on a synthetic set
        coco_root, _, det = fixtures.make_coco_fixture(
            tmp / "coco", n_images=LOOP_IMAGES, persons=2)
        stats, launches, seconds = run_cli(test.main, [
            "--weights", pose50, "--out", str(tmp / "eval"),
            "--device", dev.type, f"data.root={coco_root}",
            f"test.bbox_file={det}"], counters, total)
        require(len(stats) == 10 and all(np.isfinite(v)
                                         for v in stats.values()),
                f"test: AP table {stats}")
        log("eval", cli="test", config="coco_res50_256x192",
            persons=2 * LOOP_IMAGES, seconds=seconds, launches=launches,
            ap_table={k: round(v, 4) for k, v in stats.items()}, card=card_f)

        # -- track_video: the two videos as two streams, GT boxes
        with open(ann_file) as f:
            ann = json.load(f)
        per_image = {}
        for a in ann["annotations"]:
            per_image.setdefault(a["image_id"], []).append(
                {"bbox": a["bbox"], "score": 1.0})
        videos, dets = [], []
        for vid in range(EVAL_VIDEOS):
            images = sorted((im for im in ann["images"]
                             if im["vid_id"] == f"{vid:06d}"),
                            key=lambda im: im["frame_id"])
            path = tmp / f"dets_{vid}.json"
            path.write_text(json.dumps([per_image[im["id"]]
                                        for im in images]))
            videos.append(str(Path(root) / "images" / "val" / f"{vid:06d}"))
            dets.append(str(path))
        out, launches, seconds = run_cli(track_video.main, [
            "--cfg", "flowtrack_posetrack", "--pose-weights", pose152,
            "--flow-weights", flownet_c, "--video", *videos,
            "--detections", *dets, "--out", str(tmp / "video"),
            "--clip-len", str(EVAL_FRAMES), "--device", dev.type, *pt_opts],
            counters, total, traced=on_card)
        require(launches["crop_resize_normalize"] > 0
                and launches["correlation"] > 0,
                f"track_video: K1 or K2 never launched: {launches}")
        require(out["streams"] == EVAL_VIDEOS and out["instances"] > 0,
                f"track_video: {out}")
        log("eval", cli="track_video", streams=out["streams"],
            instances=out["instances"], seconds=seconds, launches=launches,
            card=card_f)

        # -- demo: the first frame and its boxes
        boxes = tmp / "boxes.json"
        boxes.write_text(json.dumps(
            [d["bbox"] for d in json.loads(Path(dets[0]).read_text())[0]]))
        out, launches, seconds = run_cli(demo.main, [
            "--weights", pose50, "--image", str(Path(videos[0]) /
                                                 "000000.png"),
            "--boxes", str(boxes), "--out", str(tmp / "demo.png"),
            "--device", dev.type], counters, total, traced=on_card)
        require(launches["crop_resize_normalize"] > 0,
                f"demo: K1 never launched: {launches}")
        require(out["persons"] == EVAL_PERSONS
                and np.isfinite(out["scores"]).all()
                and (tmp / "demo.png").exists(), f"demo: {out}")
        log("eval", cli="demo", persons=out["persons"], seconds=seconds,
            launches=launches, card=card_f)

        # -- eval_flow: FlowNetC on the first pairs, a zero-flow truth
        frames_dir, flo_dir = tmp / "flow_frames", tmp / "flo"
        frames_dir.mkdir()
        flo_dir.mkdir()
        for t in range(EVAL_FLOW_PAIRS + 1):
            (frames_dir / f"{t:06d}.png").symlink_to(
                Path(videos[0]) / f"{t:06d}.png")
        for t in range(EVAL_FLOW_PAIRS):
            write_flo(str(flo_dir / f"{t:06d}.flo"),
                      np.zeros((FRAME_H, FRAME_W, 2), np.float32))
        out, launches, seconds = run_cli(eval_flow.main, [
            "--cfg", "flownet_c", "--weights", flownet_c,
            "--frames", str(frames_dir), "--gt-flow", str(flo_dir),
            "--device", dev.type], counters, total, traced=on_card)
        require(launches["correlation"] > 0,
                f"eval_flow: K2 never launched: {launches}")
        require(out["n_frames"] == EVAL_FLOW_PAIRS
                and np.isfinite(out["epe"]), f"eval_flow: {out}")
        log("eval", cli="eval_flow", pairs=out["pairs"], epe=out["epe"],
            seconds=seconds, launches=launches, card=card_f)

    # -- closed loops through the port's evaluators
    stats, err, preds = heatmap_loop(dev)
    _, cpu_err, cpu_preds = heatmap_loop(torch.device("cpu"))
    cpu_diff = float(np.abs(preds - cpu_preds).max())
    cell = coco_cfg.model.image_size[0] / coco_cfg.model.heatmap_size[0]
    require(stats["AP"] == 1.0, f"heatmap loop: AP {stats}")
    require(err < cell, f"heatmap loop: decode error {err} px")
    require(cpu_diff <= 1e-3, f"heatmap loop: card against CPU {cpu_diff}")
    SUMMARY["eval_heatmap_loop_ap_err_px"] = (stats["AP"], round(err, 4))
    log("eval", loop="gt_heatmap", poses=LOOP_IMAGES * PERSONS,
        AP=stats["AP"], AP50=stats["AP50"], AP75=stats["AP75"],
        max_decode_err_px=err, cpu_max_decode_err_px=cpu_err,
        card_vs_cpu_px=cpu_diff, card=card_f)
    direct, mot = dropout_loop(dev)
    for name, s in (("direct", direct), ("mot", mot)):
        require(s["MOTA"] == 1.0 and s["num_switches"] == 0,
                f"dropout loop, {name} backend: {s}")
    SUMMARY["eval_dropout_loop_mota"] = (direct["MOTA"], mot["MOTA"])
    log("eval", loop="dropout_recovery", frames=DROP_FRAMES,
        miss_at=DROP_AT, MOTA=direct["MOTA"], MOTA_mot=mot["MOTA"],
        mAP=direct["mAP"], switches=direct["num_switches"],
        misses=direct["num_misses"], fps=direct["num_fps"], card=card_f)
    SUMMARY["eval_phase_s"] = round(time.perf_counter() - t_phase, 1)
    log("eval", phase_s=time.perf_counter() - t_phase, launches=total,
        card=card_f)
    return total


def phase_train(card, dev=None):
    """The training slice at full width with seeded random weights. Pose:
    coco_res50_256x192's train section (R50 256x192, batch 32, Adam, bf16)
    taking TRAIN_LOADER_STEPS steps from BatchLoader over a synthetic COCO
    set, then timed steps on one batch kept on the device; the loss must
    fall over them and the batch norms' running statistics move. Flow: a
    FlowNetC step and a FlowNet2 fine-tune step at 320x448, batch 8, each
    launching K2 (and the FlowNet2 one the warp); kernel-route gradients
    against plain-route ones in float32 and bf16 (K2 in FlowNetC, the warp
in FlowNet2); FlowNetC's conv1 gradient
    with the cost volume detached, which must differ; K2 and the warp alone
    against central differences, with the backward's time. Returns the
    launch counts of the phase's train steps."""
    import tempfile

    from flowtrack_tpu_torch.config import get_config
    from flowtrack_tpu_torch.data.coco import COCODataset
    from flowtrack_tpu_torch.data.loader import BatchLoader, device_prefetch
    from flowtrack_tpu_torch.engine.flow_train import flow_train_step
    from flowtrack_tpu_torch.engine.loss import multiscale_epe
    from flowtrack_tpu_torch.engine.train import create_train_state, train_step
    from flowtrack_tpu_torch.models import flownet
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    dev = torch.device("cuda") if dev is None else dev
    card_f = f"'{card}'"
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def peak_gb():
        """Peak device memory since the last call, GiB."""
        if not on_card:
            return None
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        return peak

    peak_gb()
    gen = torch.Generator().manual_seed(SEED)
    rng = np.random.default_rng(SEED + 7)
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0

    # -- pose: loader steps, then timed steps on one batch on the device
    cfg = get_config("coco_res50_256x192")
    bs = cfg.train.batch_size
    require(cfg.model.dtype == "bfloat16" and cfg.train.optimizer == "adam"
            and bs == 32, "coco_res50_256x192 trains R50 bf16, Adam, 32")
    model = get_pose_net(cfg.model, dev, gen)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        _, ann, _ = coco_fixture().make_coco_fixture(
            root, n_images=TRAIN_POSE_IMAGES, persons=2)
        data = COCODataset(cfg, root, "val2017", True, ann)
        loader = BatchLoader(data, bs, shuffle=True, drop_last=True)
        state = create_train_state(model, cfg, steps_per_epoch=len(loader))
        set_up_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loader_losses = []
        for i, batch in enumerate(device_prefetch(loader, dev)):
            if i == TRAIN_LOADER_STEPS:
                break
            state, metrics = train_step(state, batch)
            loader_losses.append(metrics["loss"])
        sync()
        loader_s = time.perf_counter() - t0
    require(len(loader_losses) == TRAIN_LOADER_STEPS,
            f"{len(loader_losses)} loader batches")
    fixed = {k: batch[k] for k in ("input", "target", "target_weight")}
    require(fixed["input"].shape == (bs, *cfg.model.image_size, 3)
            and fixed["target"].shape == (bs, *cfg.model.heatmap_size, 17),
            f"batch {fixed['input'].shape} {fixed['target'].shape}")
    bn = model.bn1.running_mean.clone()
    for _ in range(2):
        state, metrics = train_step(state, fixed)
    sync()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED_STEPS):
        state, metrics = train_step(state, fixed)
        losses.append(metrics["loss"])
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED_STEPS
    losses = [float(x) for x in loader_losses + losses]
    require(all(np.isfinite(losses)), f"pose losses {losses}")
    require(losses[-1] < losses[TRAIN_LOADER_STEPS],
            f"pose loss did not fall on a fixed batch: {losses}")
    require(not torch.equal(model.bn1.running_mean, bn),
            "pose batch norm running statistics did not move")
    SUMMARY["train_pose_ms_per_step"] = round(step_ms, 2)
    SUMMARY["train_pose_samples_per_s"] = round(bs * 1e3 / step_ms, 1)
    log("train", net=f"pose_resnet{cfg.model.num_layers}",
        crop="x".join(map(str, cfg.model.image_size)), batch=bs,
        dtype=cfg.model.dtype, optimizer=cfg.train.optimizer,
        set_up_s=set_up_s, loader_steps=TRAIN_LOADER_STEPS,
        loader_s=loader_s, timed_steps=TRAIN_TIMED_STEPS,
        ms_per_step=step_ms, samples_per_s=bs * 1e3 / step_ms,
        loss_first=losses[0], loss_fixed_first=losses[TRAIN_LOADER_STEPS],
        loss_last=losses[-1], acc=float(metrics["acc"]),
        peak_mem_gb=peak_gb(), card=card_f)
    del model, state, fixed, batch, loader, data

    # -- flow: FlowNetC and the FlowNet2 fine-tune, timed
    n, (h, w) = FLOW_TRAIN_BATCH, FLOW_TRAIN_HW
    fbatch = flow_batch(rng, n, (h, w), dev)
    nets = {}
    for tag, fcfg in (("flownet_c", get_config("flownet_c").flow),
                      ("flownet2", flownet2_config().flow)):
        require(fcfg.dtype == "bfloat16", f"{tag} trains in bf16")
        net = flownet.get_flow_net(fcfg, dev, gen)
        nets[tag] = net
        state = create_train_state(net, get_config("flownet_c"))
        before = {k: fn.launches for k, fn in counters.items()}
        state, metrics = flow_train_step(state, fbatch, fcfg.div_flow)
        sync()
        step = {k: fn.launches - before[k] for k, fn in counters.items()}
        require(step["correlation"] > 0, f"{tag}: K2 did not launch: {step}")
        require(tag != "flownet2" or step["resample2d"] == 4,
                f"{tag}: the warp launched {step['resample2d']} times, not 4")
        t0 = time.perf_counter()
        losses = []
        for _ in range(FLOW_TIMED_STEPS):
            state, metrics = flow_train_step(state, fbatch, fcfg.div_flow)
            losses.append(metrics["loss"])
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / FLOW_TIMED_STEPS
        losses = [float(x) for x in losses]
        require(all(np.isfinite(losses)) and np.isfinite(float(metrics["epe"])),
                f"{tag}: losses {losses}")
        SUMMARY[f"train_{tag}_ms_per_step"] = round(ms, 2)
        log("train", net=tag, shape=f"{n}x{h}x{w}", dtype=fcfg.dtype,
            glue=fcfg.glue_dtype, ms_per_step=ms,
            pairs_per_s=n * 1e3 / ms, launches_per_step=step,
            loss_first=losses[0], loss_last=losses[-1],
            epe=float(metrics["epe"]), peak_mem_gb=peak_gb(), card=card_f)
        del state
    launches = {name: fn.launches for name, fn in counters.items()}

    # -- the gradient goes through the cost volume
    fnc = nets["flownet_c"]
    x = fbatch["input"].permute(0, 3, 1, 2).contiguous()

    def conv1_grad():
        fnc.zero_grad(set_to_none=True)
        out = fnc.train()(x)
        multiscale_epe([f.permute(0, 2, 3, 1) for f in out],
                       fbatch["flow"]).backward()
        return fnc.conv1[0].weight.grad.float().clone()

    through = conv1_grad()
    corr = flownet.correlation_nchw
    flownet.correlation_nchw = lambda a, b, md, s2: corr(a.detach(),
                                                         b.detach(), md, s2)
    try:
        detached = conv1_grad()
    finally:
        flownet.correlation_nchw = corr
    moved = ((through - detached).abs().max() / through.abs().max()).item()
    require(moved > 1e-3, f"FlowNetC conv1's gradient with the cost volume "
                          f"detached moved only {moved}")
    log("train", check="gradient_through_cost_volume",
        conv1_rel_change_when_detached=moved, card=card_f)

    # -- kernel route against plain route, bf16 and float32
    route = {}
    for tag, net in nets.items():
        fcfg = flownet2_config().flow if tag == "flownet2" \
            else get_config("flownet_c").flow
        f32 = flownet.get_flow_net(replace(fcfg, dtype="float32"), dev)
        f32.load_state_dict(net.state_dict())
        kernels = ("resample2d",) if tag == "flownet2" else ("correlation",)
        for dtype, err in route_check(tag, net, f32, fbatch, fcfg.div_flow,
                                      kernels, card_f).items():
            route[f"{tag}_{dtype}"] = float(f"{err:.3g}")
        del f32
    SUMMARY["route_grad_rel_diff"] = route
    fd_check(dev, rng, card_f)
    return launches


# -- the compiled phase: the reference's jitted programs outside the clip ---

# the per-frame engine at coco_res50_256x192's bucket of 32 persons:
# slice 1's nets, 8 persons a frame, and at frame COMPILED_CROWD_AT one of
# COMPILED_CROWD detections (a second bucket); the train steps:
# COMPILED_STEPS a route, the schedule's milestone at step
# COMPILED_MILESTONE (lr_steps (1,) at that many steps an epoch), a run
# saved there and resumed; COMPILED_TIMED steps a timed turn
COMPILED_BUCKET, COMPILED_CROWD, COMPILED_CROWD_AT = 32, 33, 8
COMPILED_STEPS, COMPILED_MILESTONE, COMPILED_TIMED = 6, 3, 3
COMPILED_VAL_BATCH = 4


@contextlib.contextmanager
def eager_programs():
    """Every ``utils/graphs.GraphCache`` runs its program eagerly on the
    card, under ``torch.cuda.set_sync_debug_mode("error")``: the graphs'
    plain versions (the per-frame engine's, the validation steps'), the
    eager route of the ``[compiled]`` phase, which runs after the graph
    route made the ops' cached constants; a host sync inside a program
    raises, one between programs (a fetch) does not."""
    from flowtrack_tpu_torch.utils.graphs import GraphCache

    run = GraphCache.run
    GraphCache.run = lambda self, key, fn, args, *a, **k: no_sync(
        lambda: fn(*args))
    try:
        yield
    finally:
        GraphCache.run = run


def no_sync(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def graph_caches(**caches) -> dict:
    """Each named (GraphCache, label of a key): its graphs by label, their
    capture ms, the shared pool's MiB."""
    return {name: {"graphs": [label(k) for k in c],
                   "capture_ms": [round(g.capture_ms, 1)
                                  for g in c.values()],
                   "pool_mib": round(sum(g.pool_bytes for g in c.values())
                                     / 2 ** 20, 1)}
            for name, (c, label) in caches.items()}


def same_tracks(what, got, want) -> int:
    """FlowTracker outputs bit for bit, frame by frame: ids, joints,
    maxvals, scores. Returns the tracks compared."""
    require(len(got) == len(want), f"{what}: {len(got)} != {len(want)}")
    n = 0
    for t, (g, w) in enumerate(zip(got, want)):
        require([x.track_id for x in g] == [x.track_id for x in w],
                f"{what}: frame {t}'s ids differ")
        for a, b in zip(g, w):
            require(np.array_equal(a.joints, b.joints)
                    and np.array_equal(a.maxvals, b.maxvals)
                    and a.score == b.score,
                    f"{what}: frame {t} track {a.track_id} differs")
            n += 1
    require(n > 0, f"{what}: no track to compare")
    return n


def traced(tag, run, check=None) -> dict:
    """``run()`` as ``counted`` runs it: wall ms, device busy ms, idle
    share and the kernels by name."""
    _, wall_ms, device = traced_run(tag, run, check)
    busy_ms = sum(e.device_time_total for e in device) / 1e3
    return {"wall_ms": round(wall_ms, 2), "busy_ms": round(busy_ms, 2),
            "idle_share": round(1 - busy_ms / wall_ms, 4),
            "launches": kernel_events(device)}


def compiled_frames(card_f, dev) -> dict:
    """FlowTracker over PosePredictor and FlowPredictor with slice 1's nets
    at coco_res50_256x192's bucket of 32: FRAMES frames of 384x640, 8
    persons a frame and one frame of 33 detections. The graph route (every
    program a CUDA graph per bucket, captured in the first run) against the
    eager route (the same programs run eagerly on the same padded batches,
    ``eager_programs``): tracks equal bit for bit; ms a frame in turns;
    each route traced (K1 once a frame, K2 once a pair, by name); the
    graphs by bucket; the padded rows' share of the pose program's device
    time at 8 persons in a bucket of 32. Returns the graph route's
    launches."""
    from flowtrack_tpu_torch.models.flownet import get_flow_net
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from flowtrack_tpu_torch.pipeline import FlowPredictor, PosePredictor
    from flowtrack_tpu_torch.tracking import FlowTracker

    t_part = time.perf_counter()
    base = slice_config()
    cfg = replace(base, track=replace(base.track, max_persons=COMPILED_BUCKET,
                                      pose_score_thre=0.0))
    gen = torch.Generator().manual_seed(SEED)
    pose_net = get_pose_net(cfg.model, dev, gen)
    flow_net = get_flow_net(cfg.flow, dev, gen)
    rng = np.random.default_rng(SEED + 13)
    video = rng.integers(0, 256, (FRAMES, FRAME_H, FRAME_W, 3), np.uint8)
    boxes, scores, _ = video_detections(rng, FRAMES, PERSONS, FRAME_H,
                                        FRAME_W, PLANTED_VEL)
    dets = list(zip(boxes, scores))
    # the crowd on a grid of 3 rows, apart, so that the suppression keeps
    # every one
    cols = -(-COMPILED_CROWD // 3)
    cw, ch = FRAME_W / cols, FRAME_H / 3
    crowd = np.array([[(i % cols + 0.1) * cw, (i // cols + 0.1) * ch,
                       0.8 * cw, 0.8 * ch] for i in range(COMPILED_CROWD)],
                     np.float32)
    dets[COMPILED_CROWD_AT] = (crowd, rng.uniform(0.6, 0.95, COMPILED_CROWD)
                               .astype(np.float32))
    ft = {route: FlowTracker(cfg, PosePredictor(cfg, pose_net, device=dev),
                             FlowPredictor(cfg, flow_net, device=dev),
                             device=dev)
          for route in ("graph", "eager")}

    def run(route):
        with (eager_programs() if route == "eager"
              else contextlib.nullcontext()):
            out = ft[route].track_sequence(video, dets)
        torch.cuda.synchronize()
        return out

    stage_s = {"set_up": time.perf_counter() - t_part}
    t0 = time.perf_counter()
    got = run("graph")      # captures every bucket
    stage_s["graph_captures"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = run("eager")
    stage_s["eager_first"] = time.perf_counter() - t0
    compared = same_tracks("compiled FlowTracker graph vs eager", got, want)
    ms = {"eager": [], "graph": []}
    for route in ("eager", "graph", "graph", "eager"):
        t0 = time.perf_counter()
        out = run(route)
        ms[route].append((time.perf_counter() - t0) * 1e3 / FRAMES)
        same_tracks(f"compiled FlowTracker {route} turn", out, want)

    def once_a_frame(launches):
        require(launches["crop_resize_normalize"] == FRAMES
                and launches["correlation"] == FRAMES - 1,
                f"FlowTracker: one crop launch a frame and one correlation "
                f"launch a pair, got {launches}")

    t0 = time.perf_counter()
    routes = {route: traced(f"compiled_frames_{route}",
                            lambda route=route: run(route), once_a_frame)
              for route in ("graph", "eager")}
    stage_s["traces"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pose, flow, trk = (ft["graph"].pose_fn, ft["graph"].flow_fn,
                       ft["graph"])
    buckets = sorted({k[-1] for k in pose.graphs})
    require(len(buckets) >= 2 and COMPILED_BUCKET in buckets,
            f"PosePredictor captured the buckets {buckets}")
    # the padded rows' share of the pose program's device time: 8 persons
    # in a bucket of 32 against a bucket of 8, each a replayed graph
    p8 = PosePredictor(replace(cfg, track=replace(cfg.track,
                                                  max_persons=PERSONS)),
                       pose_net, device=dev)
    frame, (b8, s8) = video[0], dets[0]
    device_ms = {}
    for name, pred in (("bucket_32", pose), ("bucket_8", p8)):
        _, by_name = device_events(lambda pred=pred: pred(frame, b8, s8))
        device_ms[name] = round(sum(by_name.values()), 4)
    padded_share = 1 - device_ms["bucket_8"] / device_ms["bucket_32"]
    stage_s["padded_share"] = time.perf_counter() - t0
    fields = {"frames": FRAMES, "persons": PERSONS,
              "crowd_frame": (COMPILED_CROWD_AT, COMPILED_CROWD),
              "bucket": COMPILED_BUCKET, "bitwise_tracks": compared,
              "live_tracks": [len(t) for t in got],
              "eager_ms_per_frame": [round(x, 2) for x in ms["eager"]],
              "graph_ms_per_frame": [round(x, 2) for x in ms["graph"]],
              "order": "eager,graph,graph,eager", **{
                  f"{r}_wall_busy_idle": (f["wall_ms"], f["busy_ms"],
                                          f["idle_share"])
                  for r, f in routes.items()},
              "launches": routes["graph"]["launches"],
              "graphs": graph_caches(
                  pose=(pose.graphs, lambda k: k[-1]),
                  flow=(flow.graphs, lambda k: k[-1]),
                  tracker=(trk.graphs, lambda k: (
                      k[0], k[1] if isinstance(k[1], int) else k[1][0]))),
              "pose_device_ms": device_ms,
              "padded_rows_share_of_pose_device_ms": round(padded_share, 4),
              "seconds": round(time.perf_counter() - t_part, 1),
              "stage_s": {k: round(v, 1) for k, v in stage_s.items()}}
    log("compiled", part="per_frame", **fields, card=card_f)
    SUMMARY["compiled_frame_ms_graph_eager"] = (fields["graph_ms_per_frame"],
                                                fields["eager_ms_per_frame"])
    SUMMARY["compiled_frame_idle_graph_eager"] = (
        routes["graph"]["idle_share"], routes["eager"]["idle_share"])
    SUMMARY["compiled_padded_rows_share"] = round(padded_share, 4)
    return routes["graph"]["launches"]


def weights_of(state) -> dict:
    """Copies of the model's parameters and buffers, on its device."""
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def steps_apart(a, b, base) -> dict:
    """How far two train runs (state, losses, weights) ended apart: the
    losses' largest difference relative to ``b``'s, step by step, and the
    floating weights' (parameters and running statistics) distance as a
    share of what ``b`` moved them from ``base`` (norms over every
    tensor); the integer buffers (batch counts) must be equal."""
    la, lb = np.asarray(a[1]), np.asarray(b[1])
    apart = moved = 0.0
    for k, w in b[2].items():
        if not w.is_floating_point():
            require(torch.equal(a[2][k], w), f"{k}: {a[2][k]} != {w}")
            continue
        apart += float(((a[2][k].double() - w.double()) ** 2).sum())
        moved += float(((w.double() - base[k].double()) ** 2).sum())
    return {"losses": float(np.max(np.abs(la - lb) / np.abs(lb))),
            "weights": (apart / moved) ** 0.5}


def host_saved(path) -> None:
    """Rewrite the checkpoint at ``path`` as a run on the CPU (or a tree
    whose rate was a float) saves it: every tensor on the host, the rate a
    float, Adam's capturable off."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for group in ckpt["optimizer"]["param_groups"]:
        group["lr"] = float(group["lr"])
        group["capturable"] = False
    torch.save(ckpt, path)


def compiled_train_net(tag, card_f, make_model, base, cfg, batches,
                       graph_step, eager_step, tmp, kernels=()) -> dict:
    """One net's train step, graphed (``graph_step()`` makes a step as the
    CLIs make theirs) against eager (``eager_step``), from the weights
    ``base`` (loaded into ``make_model()``) over the same COMPILED_STEPS
    batches, the schedule's milestone at step COMPILED_MILESTONE. The
    losses and the weights (``steps_apart``) each within
    REMAT_REPEAT_FACTOR times the most that eager runs differ by in it (0:
    bit for bit; two runs, four where the first two differ); the device
    rate the schedule's after the milestone. A graph whose rate stays at
    the first step's (a rate frozen into the graph) must fall outside the
    bounds. A graphed run saved before the milestone
    (``CheckpointManager``), its file rewritten as the CPU saves one
    (``host_saved``: a float rate, which ``make_optimizer``'s
    ``device_rate`` must turn back into a device tensor), restored into a
    fresh state and stepped on across the milestone by a new step, within
    the same bounds of the uninterrupted run. Before these two, ms a step
    in turns, and COMPILED_TIMED replayed steps traced (``kernels``: (name,
    launches a step) by name). Returns their launches."""
    from flowtrack_tpu_torch.engine.checkpoint import CheckpointManager
    from flowtrack_tpu_torch.engine.train import create_train_state

    t_part = time.perf_counter()
    cfg = replace(cfg, train=replace(cfg.train, lr_steps=(1,)))

    def fresh():
        model = make_model()
        model.load_state_dict(base)
        return create_train_state(model, cfg, COMPILED_MILESTONE)

    def steps(state, step, first, last):
        losses = []
        for i, b in enumerate(batches[first:last], first):
            if step is eager_step and i > 0:
                # past its warm-up the eager step syncs with nothing
                state, m = no_sync(lambda: step(state, b))
            else:
                state, m = step(state, b)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        return state, [float(x) for x in losses]

    def run(step):
        state, losses = steps(fresh(), step, 0, COMPILED_STEPS)
        require(state.step == COMPILED_STEPS, f"{tag}: step {state.step}")
        return state, losses, weights_of(state)

    def apart(a, b):
        return steps_apart(a, b, base)

    graph_fn = graph_step()
    runs = {"eager": run(eager_step)}
    # the eager route's own spread: one repeat, and where it is not bit for
    # bit (FlowNet2's warp backward adds with atomics) two more, since one
    # sample of the spread may fall several times under another
    repeats = [run(eager_step)]
    if max(apart(repeats[0], runs["eager"]).values()) > 0:
        repeats.append(run(eager_step))
        repeats.append(run(eager_step))
    spread = [runs["eager"]] + repeats
    pairs = [apart(a, b) for i, a in enumerate(spread) for b in spread[i + 1:]]
    repeat = {m: max(d[m] for d in pairs) for m in pairs[0]}
    del repeats, spread
    runs["graph"] = run(graph_fn)
    bound = {m: REMAT_REPEAT_FACTOR * v for m, v in repeat.items()}
    diff = apart(runs["graph"], runs["eager"])
    require(all(diff[m] <= bound[m] for m in bound),
            f"{tag}: graph against eager {diff} > {bound} "
            f"({REMAT_REPEAT_FACTOR}x the eager repeats' {repeat})")
    state = runs["graph"][0]
    lr = state.optimizer.param_groups[0]["lr"]
    require(isinstance(lr, torch.Tensor) and float(lr) == np.float32(
        state.schedule(COMPILED_STEPS - 1)) and float(lr) < cfg.train.lr,
        f"{tag}: the device rate {lr} after the milestone")
    routes = {"eager": eager_step, "graph": graph_fn}

    def timed(name):
        state = runs[name][0]
        for _ in range(COMPILED_TIMED):
            state, _ = routes[name](state, batches[-1])

    ms = {"eager": [], "graph": []}
    for name in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed(name)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3 / COMPILED_TIMED)

    def launched(launches):
        for k, per_step in kernels:
            require(launches[k] == per_step * COMPILED_TIMED,
                    f"{tag}: {k} launched {launches[k]} times in "
                    f"{COMPILED_TIMED} steps, not {per_step} a step")

    # traced before the stale-rate and resume graphs are captured and
    # dropped: a traced replay of the FlowNet2 graph after two more of its
    # graphs came and went crashed the process (a segmentation fault in
    # CUDAGraph.replay on an H100, with and without the host's ops traced)
    trace = traced(f"compiled_train_{tag}", lambda: timed("graph"),
                   launched)
    step = graph_step()

    def stale_rate(state, b):
        out = step(state, b)
        state.set_rate = lambda: None   # the first step's rate kept
        return out

    stale = apart(run(stale_rate), runs["eager"])
    require(any(stale[m] > bound[m] for m in bound),
            f"{tag}: a graph whose rate stays at the first step's reads "
            f"{stale}, within the bounds {bound}")
    step = graph_step()
    saved_at = COMPILED_MILESTONE - 1
    part, losses = steps(fresh(), step, 0, saved_at)
    mgr = CheckpointManager(str(tmp / f"compiled_{tag}"))
    mgr.save(0, part)
    host_saved(mgr._path(0))
    del part
    step = graph_step()
    state, _ = mgr.restore(fresh())
    lr = state.optimizer.param_groups[0]["lr"]
    require(state.step == saved_at and isinstance(lr, torch.Tensor)
            and lr.device == next(state.model.parameters()).device,
            f"{tag}: resumed at {state.step}, rate {lr}")
    state, more = steps(state, step, saved_at, COMPILED_STEPS)
    resumed = apart((state, losses + more, weights_of(state)),
                    runs["graph"])
    require(all(resumed[m] <= bound[m] for m in bound),
            f"{tag}: the resumed run against the uninterrupted one "
            f"{resumed} > {bound}")
    del state, step
    n = batches[0][next(iter(batches[0]))].shape[0]
    fields = {"batch": n, "steps": COMPILED_STEPS,
              "milestone_step": COMPILED_MILESTONE,
              "losses": [round(x, 6) for x in runs["graph"][1]],
              "eager_repeat_apart": repeat, "bound": bound,
              "graph_vs_eager_apart": diff,
              "stale_rate_graph_vs_eager_apart": stale,
              "saved_at_step": saved_at,
              "resumed_vs_uninterrupted_apart": resumed,
              "eager_ms_per_step": [round(x, 2) for x in ms["eager"]],
              "graph_ms_per_step": [round(x, 2) for x in ms["graph"]],
              "order": "eager,graph,graph,eager",
              "graph_samples_per_s": round(n * 1e3 / min(ms["graph"]), 1),
              "eager_samples_per_s": round(n * 1e3 / min(ms["eager"]), 1),
              "graph_traced_wall_busy_idle": (trace["wall_ms"],
                                              trace["busy_ms"],
                                              trace["idle_share"]),
              "launches_in_replays": trace["launches"],
              "graph": graph_caches(step=(graph_fn.graphs, lambda k: "x".join(
                  map(str, k[0][1]))))["step"],
              "seconds": round(time.perf_counter() - t_part, 1)}
    log("compiled", part="train", net=tag, **fields, card=card_f)
    SUMMARY.setdefault("compiled_train_ms_graph_eager", {})[tag] = (
        fields["graph_ms_per_step"], fields["eager_ms_per_step"])
    SUMMARY.setdefault("compiled_train_idle_graph", {})[tag] = \
        trace["idle_share"]
    return trace["launches"]


def compiled_train(card_f, dev, tmp) -> dict:
    """The train steps as the CLIs make them: ``make_jit_train_step`` for
    R50 256x192 b32 bf16 Adam, ``train_flow.flow_step`` for FlowNetC and
    FlowNet2 at 320x448 b8 (K2; K2 and the warp), each against its eager
    step (``compiled_train_net``). Returns the replays' launches."""
    from flowtrack_tpu_torch.config import get_config
    from flowtrack_tpu_torch.engine.flow_train import flow_train_step
    from flowtrack_tpu_torch.engine.train import (make_jit_train_step,
                                                  train_step)
    from flowtrack_tpu_torch.models import flownet
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from flowtrack_tpu_torch.tools import train_flow

    rng = np.random.default_rng(SEED + 17)
    gen = torch.Generator().manual_seed(SEED)
    total = dict.fromkeys(kernel_counters(), 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    cfg = get_config("coco_res50_256x192")
    bs = cfg.train.batch_size
    hh, hw = cfg.model.heatmap_size
    batches = [{"input": torch.as_tensor(rng.normal(
                    size=(bs, *cfg.model.image_size, 3)).astype(np.float32),
                    device=dev),
                "target": torch.as_tensor(rng.uniform(
                    0, 1, (bs, hh, hw, 17)).astype(np.float32), device=dev),
                "target_weight": torch.as_tensor((rng.uniform(
                    0, 1, (bs, 17)) > 0.2).astype(np.float32), device=dev)}
               for _ in range(COMPILED_STEPS)]
    add(compiled_train_net(
        "pose_resnet50", card_f, lambda: get_pose_net(cfg.model, dev),
        get_pose_net(cfg.model, dev, gen).state_dict(), cfg, batches,
        make_jit_train_step, train_step, tmp))
    del batches
    n, (h, w) = FLOW_TRAIN_BATCH, FLOW_TRAIN_HW
    flow_batches = []
    for _ in range(COMPILED_STEPS):
        frames = torch.as_tensor(rng.integers(0, 256, (2, n, h, w, 3),
                                              np.uint8), device=dev).float()
        flow_batches.append({"im1": frames[0], "im2": frames[1],
                             "flow": smooth_flow(rng, n, h, w, 8.0, dev)
                             .permute(0, 2, 3, 1).contiguous()})
    fcfg_c = get_config("flownet_c")
    for tag, cfg, kernels in (
            ("flownet_c", fcfg_c, (("correlation", 1),)),
            ("flownet2", replace(fcfg_c, flow=flownet2_config().flow),
             (("correlation", 1), ("resample2d", 4)))):
        div_flow, rgb_max = cfg.flow.div_flow, cfg.flow.rgb_max

        def eager_step(state, b, div_flow=div_flow, rgb_max=rgb_max):
            return flow_train_step(state, {
                "input": flownet.preprocess_pair(b["im1"], b["im2"],
                                                 rgb_max),
                "flow": b["flow"]}, div_flow=div_flow)

        add(compiled_train_net(
            tag, card_f, lambda cfg=cfg: flownet.get_flow_net(cfg.flow, dev),
            flownet.get_flow_net(cfg.flow, dev, gen).state_dict(), cfg,
            flow_batches,
            lambda d=div_flow, r=rgb_max: train_flow.flow_step(d, r),
            eager_step, tmp, kernels=kernels))
        gc.collect()
        torch.cuda.empty_cache()
    return total


def compiled_validation(card_f, dev, tmp) -> dict:
    """The validation steps: ``run_validation`` (coco_res50_256x192 on a
    synthetic COCO set, batches of COMPILED_VAL_BATCH) and
    ``train_flow.validate`` (FlowNetC at 320x448 on a planted-flow corpus),
    each graph route (one CUDA graph a batch shape) against its eager
    route, bit for bit: the arrays handed to the evaluator, the EPE. The
    flow validation's replays traced (K2 once a batch). Returns their
    launches."""
    import io

    from flowtrack_tpu_torch.config import get_config
    from flowtrack_tpu_torch.data.flow_dataset import FlowPairDataset
    from flowtrack_tpu_torch.models.flownet import get_flow_net
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from flowtrack_tpu_torch.tools.test import (build_val_dataset,
                                                run_validation)
    from flowtrack_tpu_torch.tools.train_flow import validate

    t_part = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    fixtures = coco_fixture()
    cfg = get_config("coco_res50_256x192")
    model = get_pose_net(cfg.model, dev, gen)
    root, _, det = fixtures.make_coco_fixture(tmp / "compiled_coco",
                                              n_images=LOOP_IMAGES, persons=2)
    cfg = replace(cfg, data=replace(cfg.data, root=str(root)),
                  test=replace(cfg.test, bbox_file=det,
                               batch_size=COMPILED_VAL_BATCH))
    dataset = build_val_dataset(cfg)
    arrays = {}
    for route in ("graph", "eager"):
        # the evaluator's AP table kept out of the smoke's output
        with (eager_programs() if route == "eager"
              else contextlib.nullcontext()), \
                contextlib.redirect_stdout(io.StringIO()):
            _, arrays[route] = evaluated(dataset, lambda: run_validation(
                cfg, model, output_dir=str(tmp / f"compiled_{route}"),
                dataset=dataset, device=dev))
    rows = len(arrays["graph"]["image_id"])
    require(rows == len(dataset) and rows > COMPILED_VAL_BATCH,
            f"compiled validation: {rows} rows of {len(dataset)}")
    for k, v in arrays["eager"].items():
        require(np.array_equal(arrays["graph"][k], v),
                f"compiled validation: the graph's {k} differ from eager")
    del model
    fcfg = get_config("flownet_c")
    net = get_flow_net(fcfg.flow, dev, gen)
    corpus = write_flow_corpus(tmp / "compiled_chairs", 2 * COMPILED_VAL_BATCH,
                               np.random.default_rng(SEED + 19),
                               fixtures.save_image)
    val_ds = FlowPairDataset(root=corpus, crop_size=FLOW_TRAIN_HW,
                             is_train=False)
    epe = {}
    for route in ("graph", "eager"):
        with (eager_programs() if route == "eager"
              else contextlib.nullcontext()):
            epe[route] = validate(net, val_ds, fcfg, FLOW_TRAIN_HW,
                                  COMPILED_VAL_BATCH, dev)
    require(epe["graph"] == epe["eager"] and np.isfinite(epe["graph"]),
            f"compiled flow validation: graph {epe['graph']} against eager "
            f"{epe['eager']}")
    batches = len(val_ds) // COMPILED_VAL_BATCH

    def once_a_batch(launches):
        # the net's graphs, captured by its first validation, replay: one
        # K2 a batch
        require(launches["correlation"] == batches,
                f"flow validation: K2 launched {launches['correlation']} "
                f"times over {batches} batches")

    flow_trace = traced("compiled_flow_validation",
                        lambda: validate(net, val_ds, fcfg, FLOW_TRAIN_HW,
                                         COMPILED_VAL_BATCH, dev),
                        once_a_batch)
    log("compiled", part="validation", pose_rows=rows, pose_bitwise=True,
        flow_pairs=len(val_ds), flow_epe=epe, flow_bitwise=True,
        flow_validation_trace=flow_trace,
        seconds=round(time.perf_counter() - t_part, 1), card=card_f)
    return flow_trace["launches"]


def phase_compiled(card, dev=None):
    """The reference's compiled programs outside the clip, each a CUDA
    graph per shape against its eager program on the card: the per-frame
    engine (``compiled_frames``), the train steps (``compiled_train``) and
    the validation steps (``compiled_validation``). Returns the launches
    of their graph routes' traced runs."""
    import tempfile
    from pathlib import Path

    dev = torch.device("cuda") if dev is None else dev
    card_f = f"'{card}'"
    t_phase = time.perf_counter()
    launches = dict.fromkeys(kernel_counters(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        parts = (compiled_frames(card_f, dev),
                 compiled_train(card_f, dev, tmp),
                 compiled_validation(card_f, dev, tmp))
    for part in parts:
        for k, v in part.items():
            launches[k] += v
    log("compiled", seconds=time.perf_counter() - t_phase,
        launches=launches, card=card_f)
    return launches


# -- the train_cli phase: the train CLIs through their own main ------------

# train_flow's corpus: TRAIN_CLI_PAIRS FlyingChairs-style pairs and
# TRAIN_CLI_VAL_PAIRS for validation at TRAIN_CLI_FLOW_HW, a smooth flow of
# up to +-TRAIN_CLI_FLOW_PX px planted in each (the second frame is the first
# warped by it), cropped to FLOW_TRAIN_HW; eval_flow on 3 frames of one such
# flow; the closed loop's epochs; the timed R152 steps of the remat check
TRAIN_CLI_PAIRS, TRAIN_CLI_VAL_PAIRS = 16, 8
TRAIN_CLI_FLOW_HW, TRAIN_CLI_FLOW_PX = (384, 512), 6.0
LOOP_EPOCHS, REMAT_TIMED_STEPS = 60, 3
# remat: one R152 step's gradients and running statistics with remat may
# differ from the step without by at most REMAT_REPEAT_FACTOR times what two
# runs without differ by (cuDNN may choose other algorithms from one run to
# the next); when those repeat bit for bit, the bound is 0
REMAT_REPEAT_FACTOR = 4


def _bilinear(img, x, y):
    """(H, W, C) float32 ``img`` sampled at float coordinates, clamped."""
    h, w = img.shape[:2]
    x = np.clip(x, 0, w - 1.001)
    y = np.clip(y, 0, h - 1.001)
    x0, y0 = x.astype(np.int64), y.astype(np.int64)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    top = img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx
    bottom = img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx
    return top * (1 - fy) + bottom * fy


def planted_flow_pair(rng, hw):
    """A smooth random texture, a smooth flow (u, v) of up to
    TRAIN_CLI_FLOW_PX px, and the texture moved by it: frame 2 at x + flow(x)
    shows what frame 1 shows at x. -> (im1, im2) uint8, flow float32."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    coarse = rng.uniform(0, 255, (h // 8 + 2, w // 8 + 2, 3)).astype(
        np.float32)
    im1 = _bilinear(coarse, xx / 8, yy / 8)
    a = rng.uniform(-1, 1, (2, 3)) * TRAIN_CLI_FLOW_PX / 2
    flow = np.stack([c[0] + c[1] * np.sin(2 * np.pi * yy / h + c[2])
                     for c in a], axis=-1).astype(np.float32)
    im2 = _bilinear(im1, xx - flow[..., 0], yy - flow[..., 1])
    return (im1.round().astype(np.uint8), im2.round().astype(np.uint8),
            flow)


def write_flow_corpus(root, n, rng, save_image):
    from flowtrack_tpu_torch.eval.flow_eval import write_flo

    root.mkdir(parents=True)
    for i in range(n):
        im1, im2, flow = planted_flow_pair(rng, TRAIN_CLI_FLOW_HW)
        save_image(str(root / f"{i:05d}_img1.png"), im1)
        save_image(str(root / f"{i:05d}_img2.png"), im2)
        write_flo(str(root / f"{i:05d}_flow.flo"), flow)
    return str(root)


def jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def flow_step_profile(tag, state, batch, div_flow, card_f):
    """One flow_train_step under torch.profiler: the step's device ms, and
    the device ms of K2's forward, K2's plain backward, the warp's forward
    and plain backward, and the convolutions (forward and backward). A
    backward's ms is the device time launched from its autograd node."""
    from flowtrack_tpu_torch.engine.flow_train import flow_train_step

    flow_train_step(state, batch, div_flow)
    prof, wall_ms, device = profile_run(
        f"train_cli_{tag}", lambda: flow_train_step(state, batch, div_flow))
    by_key = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()}

    def kernels(*names):
        return sum(e.device_time_total for e in device
                   if any(n in e.name for n in names)) / 1e3

    def node(name):
        return sum(v for k, v in by_key.items()
                   if k.startswith("autograd::engine::evaluate_function")
                   and k.endswith(name))

    parts = {"step": sum(e.device_time_total for e in device) / 1e3,
             "k2_forward": kernels("correlation_mma_kernel",
                                   "correlation_kernel"),
             "k2_backward_plain": node("_CorrelationBackward"),
             "warp_forward": kernels("resample2d_kernel"),
             "warp_backward_plain": node("_Resample2dBackward"),
             "convolutions": by_key.get("aten::convolution", 0.0)
             + by_key.get("aten::convolution_backward", 0.0)}
    SUMMARY.setdefault("train_cli_step_device_ms", {})[tag] = {
        k: round(v, 2) for k, v in parts.items()}
    log("train_cli", check="step_profile", net=tag, wall_ms=wall_ms,
        device_ms=parts, share_of_step={k: v / parts["step"] for k, v in
                                        parts.items() if k != "step"},
        card=card_f)
    return parts


def max_rel_diff(a, b):
    """Largest of max |a - b| / max |b| over the tensors of ``b``."""
    return max(float((a[k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
               for k, v in b.items())


def remat_step(tag, model_cfg, cfg, base, batch, dev, sync):
    """A fresh pose net of ``model_cfg`` from the state dict ``base`` takes
    one train step on ``batch``: its loss, gradients and batch norm buffers
    (on the CPU) and the peak memory of that step; then its ms a step over
    REMAT_TIMED_STEPS, one forward and one backward timed apart, and on the
    card one step profiled (wall ms, device busy ms, device events)."""
    from flowtrack_tpu_torch.engine.loss import joints_mse_loss
    from flowtrack_tpu_torch.engine.train import create_train_state
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from flowtrack_tpu_torch.engine.train import train_step

    on_card = dev.type == "cuda"
    model = get_pose_net(model_cfg, dev)
    model.load_state_dict(base)
    state = create_train_state(model, cfg)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state, metrics = train_step(state, batch)
    out = {"loss": float(metrics["loss"]),
           "peak_gb": (torch.cuda.max_memory_allocated() / 2 ** 30
                       if on_card else None),
           "bn_counts": sorted({int(m.num_batches_tracked)
                                for m in model.modules()
                                if isinstance(m, torch.nn.BatchNorm2d)}),
           "grads": {k: p.grad.float().cpu()
                     for k, p in model.named_parameters()},
           "stats": {k: b.float().cpu() for k, b in model.named_buffers()
                     if not k.endswith("num_batches_tracked")}}
    sync()
    t0 = time.perf_counter()
    for _ in range(REMAT_TIMED_STEPS):
        state, metrics = train_step(state, batch)
    sync()
    out["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / REMAT_TIMED_STEPS
    x = batch["input"].permute(0, 3, 1, 2).contiguous()
    sync()
    t0 = time.perf_counter()
    hm = model.train()(x).permute(0, 2, 3, 1)
    sync()
    t1 = time.perf_counter()
    joints_mse_loss(hm, batch["target"], batch["target_weight"]).backward()
    sync()
    out["forward_ms"] = (t1 - t0) * 1e3
    out["backward_ms"] = (time.perf_counter() - t1) * 1e3
    del hm
    if on_card:
        _, wall_ms, device = profile_run(
            f"train_cli_{tag}", lambda: train_step(state, batch))
        busy_ms = sum(e.device_time_total for e in device) / 1e3
        out["profiled"] = {"wall_ms": wall_ms, "busy_ms": busy_ms,
                           "idle": 1 - busy_ms / wall_ms,
                           "device_events": len(device)}
    return out


def phase_train_cli(card, dev=None):
    """The train CLIs as a user starts them, through their own ``main``,
    the launch counts read around each run. ``train_flow``: FlowNetC at the
    320x448 crop, batch 8, bf16, 2 epochs with validation and checkpoints
    (K2 launched, val_epe finite each epoch), ``--resume`` to a third, the
    saved .npz through ``eval_flow`` (K2 launched), one step profiled; the
    FlowNet2 variant one epoch (K2 and the warp launched, finite). ``train``:
    coco_res50_256x192 (R50 256x192, batch 32, bf16) 2 epochs with
    validation returning each epoch, ``--resume`` to a third, the step
    count carried; ``--imagenet-backbone`` with a torchvision-named .pth:
    the backbone on the card equal to the file bit for bit, the head the
    CLI's own init. ``remat``: one R152 step of flowtrack_posetrack with
    and without (``remat_step``), gradients and running statistics held to
    the repeat of the step without, every batch norm counted once. The
    closed loop of ``bench.py`` (R18 64x64, 60 epochs) through ``train``:
    AP > max(0.3, AP before + 0.25). Returns the CLI runs' launch counts."""
    import argparse
    import contextlib
    import io
    import tempfile
    from pathlib import Path

    from flowtrack_tpu_torch.config import apply_overrides, get_config
    from flowtrack_tpu_torch.data.flow_dataset import (FlowPairDataset,
                                                       flow_batches)
    from flowtrack_tpu_torch.eval.flow_eval import write_flo
    from flowtrack_tpu_torch.models.flownet import preprocess_pair
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from flowtrack_tpu_torch.tools import eval_flow, train, train_flow

    dev = torch.device("cuda") if dev is None else dev
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    card_f = f"'{card}'"
    counters = kernel_counters()
    total = dict.fromkeys(counters, 0)
    fixtures = coco_fixture()
    rng = np.random.default_rng(SEED + 11)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        chairs = write_flow_corpus(tmp / "chairs", TRAIN_CLI_PAIRS, rng,
                                   fixtures.save_image)
        chairs_val = write_flow_corpus(tmp / "chairs_val",
                                       TRAIN_CLI_VAL_PAIRS, rng,
                                       fixtures.save_image)
        log("train_cli", setup_s=time.perf_counter() - t0,
            pairs=TRAIN_CLI_PAIRS, val_pairs=TRAIN_CLI_VAL_PAIRS,
            frame_hw="x".join(map(str, TRAIN_CLI_FLOW_HW)))

        # -- train_flow, FlowNetC: 2 epochs, then --resume to 3
        h, w = FLOW_TRAIN_HW
        npz = str(tmp / "flownet_c.npz")
        args = ["--cfg", "flownet_c", "--triplets", chairs, "--val-triplets",
                chairs_val, "--crop", str(h), str(w), "--batch",
                str(FLOW_TRAIN_BATCH), "--ckpt-dir", str(tmp / "flow_ckpt"),
                "--out", npz, "--device", dev.type]
        require(get_config("flownet_c").flow.dtype == "bfloat16",
                "flownet_c trains in bf16")
        steps = -(-TRAIN_CLI_PAIRS // FLOW_TRAIN_BATCH)
        val_batches = -(-TRAIN_CLI_VAL_PAIRS // FLOW_TRAIN_BATCH)

        def flow_launches(what, epochs, validations, warps=0):
            """The K2 (and warp) launches a train_flow run must show: one
            K2 a step (its backward is plain; a step's first call is
            itself a step), ``warps`` warps a step, one K2 a validation
            batch and one for the first validation's warm-up (the run's
            later validations replay its graphs)."""
            def check(launches):
                k2 = (epochs * steps + validations * val_batches
                      + (validations > 0))
                require(launches["correlation"] == k2 and
                        launches["resample2d"] == warps * epochs * steps,
                        f"{what}: {launches}, not {k2} K2 and "
                        f"{warps * epochs * steps} warps")
            return check

        state, launches, seconds = run_cli(train_flow.main, args + [
            "--epochs", "2"], counters, total, traced=on_card,
            check=flow_launches("train_flow", 2, 2))
        lines = jsonl(tmp / "flow_ckpt" / "metrics.jsonl")
        require(launches["correlation"] > 0,
                f"train_flow: K2 never launched: {launches}")
        require(len(lines) == 2 and all(np.isfinite(x["val_epe"])
                                        for x in lines),
                f"train_flow: {lines}")
        require(state.step == 2 * steps, f"train_flow: step {state.step}")
        log("train_cli", cli="train_flow", net="flownet_c", epochs=2,
            steps=state.step, seconds=seconds, launches=launches,
            epe=[x["epe"] for x in lines],
            val_epe=[x["val_epe"] for x in lines], card=card_f)
        data = FlowPairDataset(root=chairs, crop_size=(h, w), is_train=True)
        b = next(flow_batches(data, FLOW_TRAIN_BATCH, seed=0))
        im1, im2, flow = (torch.as_tensor(b[k], device=dev)
                          for k in ("im1", "im2", "flow"))
        fbatch = {"input": preprocess_pair(im1, im2), "flow": flow}
        if on_card:
            flow_step_profile("flownet_c", state, fbatch,
                              get_config("flownet_c").flow.div_flow, card_f)
        del state
        state, launches, seconds = run_cli(train_flow.main, args + [
            "--epochs", "3", "--resume"], counters, total, traced=on_card,
            check=flow_launches("train_flow --resume", 1, 1))
        lines = jsonl(tmp / "flow_ckpt" / "metrics.jsonl")
        require([x["step"] for x in lines] == [0, 1, 2]
                and state.step == 3 * steps,
                f"train_flow --resume: epochs {[x['step'] for x in lines]}, "
                f"step {state.step}")
        log("train_cli", cli="train_flow", resume=True, epochs_run=1,
            steps=state.step, seconds=seconds, launches=launches,
            val_epe=lines[-1]["val_epe"], card=card_f)
        del state

        # -- eval_flow on the saved .npz
        frames, flo = tmp / "eval_frames", tmp / "eval_flo"
        frames.mkdir()
        flo.mkdir()
        im1, im2, flow = planted_flow_pair(rng, TRAIN_CLI_FLOW_HW)
        for t, im in enumerate((im1, im2, im1)):
            fixtures.save_image(str(frames / f"{t:06d}.png"), im)
        write_flo(str(flo / "000000.flo"), flow)
        write_flo(str(flo / "000001.flo"), -flow)
        def once_a_pair(launches):
            # two pairs of one shape: the capture's warm-up, then a replay
            # a pair
            require(launches["correlation"] == 3,
                    f"eval_flow: {launches}, not 3 K2")

        out, launches, seconds = run_cli(eval_flow.main, [
            "--cfg", "flownet_c", "--weights", npz, "--frames", str(frames),
            "--gt-flow", str(flo), "--device", dev.type], counters, total,
            traced=on_card, check=once_a_pair)
        require(launches["correlation"] > 0,
                f"eval_flow: K2 never launched: {launches}")
        require(out["n_frames"] == 2 and np.isfinite(out["epe"]),
                f"eval_flow: {out}")
        log("train_cli", cli="eval_flow", weights="train_flow's .npz",
            epe=out["epe"], seconds=seconds, launches=launches, card=card_f)

        # -- train_flow, the FlowNet2 variant: 1 epoch. The corpus's smooth
        # frames hold pixels equal in both frames, whose brightness error
        # is 0: the channel norm's gradient there must stay finite
        npz2 = str(tmp / "fn2" / "flownet2.npz")
        (tmp / "fn2").mkdir()
        state, launches, seconds = run_cli(train_flow.main, [
            "--cfg", "flownet_c", "--triplets", chairs, "--crop", str(h),
            str(w), "--batch", str(FLOW_TRAIN_BATCH), "--epochs", "1",
            "--out", npz2, "--device", dev.type, "flow.variant=flownet2"],
            counters, total, traced=on_card,
            check=flow_launches("train_flow flownet2", 1, 0, warps=4))
        lines = jsonl(tmp / "fn2" / "metrics.jsonl")
        with np.load(npz2) as f:
            finite = all(np.isfinite(f[k]).all() for k in f.files)
            n_arrays = len(f.files)
        require(launches["correlation"] > 0 and launches["resample2d"] > 0,
                f"train_flow flownet2: K2 or the warp never launched: "
                f"{launches}")
        require(np.isfinite(lines[0]["epe"]) and finite,
                f"train_flow flownet2: epe {lines}, weights finite {finite}")
        log("train_cli", cli="train_flow", net="flownet2", epochs=1,
            steps=state.step, seconds=seconds, launches=launches,
            epe=lines[0]["epe"], saved_arrays=n_arrays, card=card_f)
        if on_card:
            flow_step_profile("flownet2", state, fbatch,
                              get_config("flownet_c").flow.div_flow, card_f)
        del state, fbatch

        # -- train: R50 256x192, batch 32, bf16, 2 epochs, then --resume
        cfg = get_config("coco_res50_256x192")
        require(cfg.model.dtype == "bfloat16" and cfg.train.batch_size == 32,
                "coco_res50_256x192 trains R50 bf16 at batch 32")
        coco_root, _, _ = fixtures.make_coco_fixture(
            tmp / "coco", n_images=TRAIN_POSE_IMAGES, persons=2)
        def pose_args(out, *extra):
            return ["--cfg", "coco_res50_256x192", "--device", dev.type,
                    "--out", str(tmp / out), *extra,
                    f"data.root={coco_root}", "data.train_set=val2017",
                    "test.use_gt_bbox=true", "train.print_freq=100"]

        steps = TRAIN_POSE_IMAGES * 2 // cfg.train.batch_size
        spent, validated = [], []
        make_step, validate_fn = train.make_jit_train_step, train.run_validation

        def timed_steps(*a, **k):
            step_fn = make_step(*a, **k)

            def timed_step(*a, **k):
                sync()
                t = time.perf_counter()
                out = step_fn(*a, **k)
                sync()
                spent.append(time.perf_counter() - t)
                return out

            return timed_step

        def counted_validation(*a, **k):
            # main catches a failed validation and scores it 0, as the
            # reference does; only a return lands here
            stats = validate_fn(*a, **k)
            validated.append(stats["AP"])
            return stats

        train.make_jit_train_step = timed_steps
        train.run_validation = counted_validation
        try:
            state, launches, seconds = run_cli(train.main, pose_args(
                "pose", "train.end_epoch=2"), counters, total)
            validations, first_spent = len(validated), spent[:]
            lines = jsonl(tmp / "pose" / "metrics.jsonl")
            state_resumed, _, resume_s = run_cli(train.main, pose_args(
                "pose", "--resume", "train.end_epoch=3"), counters, total)
        finally:
            train.make_jit_train_step, train.run_validation = (
                make_step, validate_fn)
        require(validations == 2 and len(validated) == 3
                and np.isfinite(validated).all(),
                f"train: validation returned {validations} of 2 times, then "
                f"{len(validated) - validations} of 1 after --resume: "
                f"{validated}")
        keys = {"step", "time", "train_loss", "train_acc", "val_perf",
                "best_perf", "lr"}
        require(len(lines) == 2 and all(set(x) == keys
                                        and np.isfinite(x["val_perf"])
                                        and np.isfinite(x["train_loss"])
                                        for x in lines),
                f"train: metrics {lines}")
        require(state.step == 2 * steps, f"train: step {state.step}")
        # the first step of the run is the warm-up (cuDNN's choices) and
        # the capture of the step's graph; the rest replay it
        step_ms = float(np.mean(first_spent[1:])) * 1e3
        SUMMARY["train_cli_pose_ms_per_step"] = round(step_ms, 2)
        log("train_cli", cli="train", net="pose_resnet50",
            crop="x".join(map(str, cfg.model.image_size)),
            batch=cfg.train.batch_size, dtype=cfg.model.dtype, epochs=2,
            steps=state.step, seconds=seconds, ms_per_step=step_ms,
            samples_per_s=cfg.train.batch_size * 1e3 / step_ms,
            train_loss=[x["train_loss"] for x in lines],
            val_perf=[x["val_perf"] for x in lines],
            validations_returned=validations, launches=launches,
            card=card_f)
        state = state_resumed
        lines = jsonl(tmp / "pose" / "metrics.jsonl")
        require([x["step"] for x in lines] == [0, 1, 2]
                and state.step == 3 * steps,
                f"train --resume: epochs {[x['step'] for x in lines]}, "
                f"step {state.step}")
        log("train_cli", cli="train", resume=True, epochs_run=1,
            steps=state.step, seconds=resume_s,
            validations_returned=len(validated) - validations, card=card_f)
        del state, state_resumed

        # -- train --imagenet-backbone: a torchvision-named R50 .pth
        gen = torch.Generator().manual_seed(SEED + 5)
        source = get_pose_net(cfg.model, None, gen).state_dict()
        head = ("deconv_layers", "final_layer")
        sd = {k: v for k, v in source.items() if not k.startswith(head)}
        sd["fc.weight"] = torch.randn(1000, 2048, generator=gen)
        sd["fc.bias"] = torch.zeros(1000)
        torch.save(sd, tmp / "r50_imagenet.pth")
        state, _, _ = run_cli(train.main, pose_args(
            "bb", "--imagenet-backbone", str(tmp / "r50_imagenet.pth"),
            "train.end_epoch=0"), counters, total)
        own = state.model.state_dict()
        fresh = get_pose_net(cfg.model, generator=torch.Generator()
                             .manual_seed(cfg.train.seed)).state_dict()
        backbone = [k for k in own if not k.startswith(head)]
        require(all(own[k].device.type == dev.type for k in own),
                "--imagenet-backbone: the net is not on the device")
        require(all(torch.equal(own[k].cpu(), sd[k]) for k in backbone
                    if not k.endswith("num_batches_tracked")),
                "--imagenet-backbone: the backbone differs from the file")
        heads = [k for k in own if k.startswith(head)]
        require(all(torch.equal(own[k].cpu(), fresh[k]) for k in heads)
                and not all(torch.equal(own[k].cpu(), source[k])
                            for k in heads),
                "--imagenet-backbone: the head is not the CLI's own init")
        log("train_cli", cli="train", imagenet_backbone="bitwise",
            backbone_tensors=len(backbone), head_tensors=len(heads),
            card=card_f)
        del state, own

        # -- remat: one R152 step (flowtrack_posetrack) without, again
        # without (the repeat sets the tolerance), and with
        rcfg = get_config("flowtrack_posetrack")
        n = rcfg.train.batch_size
        require(rcfg.model.num_layers == 152 and rcfg.model.dtype ==
                "bfloat16" and n == 32,
                "flowtrack_posetrack trains R152 bf16 at batch 32")
        base = get_pose_net(rcfg.model, None, gen).state_dict()
        hh, hw = rcfg.model.heatmap_size
        batch = {"input": torch.as_tensor(rng.normal(
                     0, 1, (n, *rcfg.model.image_size, 3)),
                     dtype=torch.float32, device=dev),
                 "target": torch.as_tensor(rng.uniform(
                     0, 1, (n, hh, hw, 17)), dtype=torch.float32, device=dev),
                 "target_weight": torch.ones(n, 17, device=dev)}
        remat = {tag: remat_step(tag, replace(rcfg.model, remat=on), rcfg,
                                 base, batch, dev, sync)
                 for tag, on in (("plain", False), ("repeat", False),
                                 ("remat", True))}
        plain = remat["plain"]
        diffs = {tag: {"loss": abs(r["loss"] - plain["loss"]),
                       "grads": max_rel_diff(r["grads"], plain["grads"]),
                       "running_stats": max_rel_diff(r["stats"],
                                                     plain["stats"])}
                 for tag, r in remat.items() if tag != "plain"}
        tol = {k: REMAT_REPEAT_FACTOR * v for k, v in diffs["repeat"].items()}
        for tag, r in remat.items():
            require(r["bn_counts"] == [1],
                    f"{tag}: num_batches_tracked after one step "
                    f"{r['bn_counts']}")
        require(all(diffs["remat"][k] <= tol[k] for k in tol),
                f"remat: differs from the step without by {diffs['remat']}, "
                f"two steps without by {diffs['repeat']}")
        require(not on_card or remat["remat"]["peak_gb"]
                < plain["peak_gb"],
                f"remat did not lower the peak memory: "
                f"{remat['remat']['peak_gb']} against {plain['peak_gb']}")
        # the batch norms' guard in the recomputation is host work alone:
        # its time on the host, a block at a time
        from flowtrack_tpu_torch.models.pose_resnet import (
            Bottleneck, _running_stats_kept)
        block = Bottleneck(1024, 256, downsample=True)
        t0 = time.perf_counter()
        for _ in range(1000):
            with _running_stats_kept(block):
                pass
        guard_us = (time.perf_counter() - t0) * 1e3
        blocks = sum(1 for m in get_pose_net(rcfg.model).modules()
                     if isinstance(m, Bottleneck))
        SUMMARY["train_cli_remat_peak_gb_ms"] = {
            tag: (r["peak_gb"] and round(r["peak_gb"], 2),
                  round(r["ms_per_step"], 2))
            for tag, r in remat.items() if tag != "repeat"}
        log("train_cli", check="remat", net="pose_resnet152",
            crop="x".join(map(str, rcfg.model.image_size)), batch=n,
            dtype=rcfg.model.dtype,
            **{tag: {k: v for k, v in r.items() if k not in
                     ("grads", "stats")} for tag, r in remat.items()},
            diff_remat=diffs["remat"], diff_repeat=diffs["repeat"], tol=tol,
            bn_guard_us_per_block=guard_us, blocks=blocks, card=card_f)
        del batch, base, remat, plain

        # -- the train-to-eval closed loop through the train CLI
        loop_root, _, _ = fixtures.make_coco_fixture(tmp / "loop",
                                                     n_images=4, persons=2)
        opts = ["model.num_layers=18", "model.image_size=64,64",
                "model.heatmap_size=16,16", "model.sigma=1.5",
                "model.dtype=float32", "train.batch_size=8", "train.lr=2e-3",
                "train.flip_prob=0", "train.rot_factor=0",
                "train.scale_factor=0", f"train.end_epoch={LOOP_EPOCHS}",
                "train.print_freq=1000", "test.batch_size=8",
                "test.use_gt_bbox=true", "test.flip_test=false",
                f"data.root={loop_root}", "data.train_set=val2017",
                "data.test_set=val2017"]
        lcfg = apply_overrides(get_config("coco_res50_256x192"), opts)
        start = train.initial_model(argparse.Namespace(
            init_weights=None, imagenet_backbone=None), lcfg)
        with contextlib.redirect_stdout(io.StringIO()):
            ap_before = train.run_validation(lcfg, start, device=dev)["AP"]
        state, launches, seconds = run_cli(train.main, [
            "--cfg", "coco_res50_256x192", "--out", str(tmp / "loop_ckpt"),
            "--device", dev.type, *opts], counters, total)
        lines = jsonl(tmp / "loop_ckpt" / "metrics.jsonl")
        ap_after = lines[-1]["val_perf"]
        require(len(lines) == LOOP_EPOCHS
                and ap_after > max(0.3, ap_before + 0.25),
                f"closed loop: AP {ap_before} -> {ap_after} after "
                f"{len(lines)} epochs")
        SUMMARY["train_cli_closed_loop_ap"] = (round(ap_before, 4),
                                               round(ap_after, 4))
        int8_closed_loop(lcfg, state.model, dev, card_f)
        log("train_cli", metric="coco_ap_train_to_eval_closed_loop_on_device",
            value=round(ap_after, 4), ap_before=round(ap_before, 4),
            unit=f"AP after {LOOP_EPOCHS} epochs on the synthetic fixture",
            platform=dev.type, final_loss=round(lines[-1]["train_loss"], 6),
            train_seconds=round(seconds, 1), card=card_f)
        del state
    SUMMARY["train_cli_phase_s"] = round(time.perf_counter() - t_phase, 1)
    log("train_cli", phase_s=time.perf_counter() - t_phase, launches=total,
        card=card_f)
    return total


MESH_LANES, MESH_TRAIN_BATCH, MESH_FLOW_BATCH = 4, 16, 2
MESH_TIMED = 3
# the sharded train step against the unsharded one: the reference's bound
# (tests/test_sharded_eval.py:89-94)
MESH_TRAIN_ATOL, MESH_TRAIN_RTOL = 1e-6, 1e-5
# the frame-sharded clip against the whole clip, px: each slot's flows and
# pose pass run at half the clip's batch, where the library convs may round
# otherwise (ROADMAP Queue 3: 0.0598 px of flow); a wrong pass or a frame
# out of place moves a joint by far more
MESH_FRAME_JOINT_PX = 1.0


def serve_groups(tracker, streams, groups, sharding):
    """``streams`` through MultiStreamTracker(s) of 16-frame clips: one
    tracker of all streams with ``sharding``, or, without it, one tracker
    per group of stream ids, each batching its group; every frame submitted
    in turns, then flushed. -> {stream: per-frame tracks}."""
    from flowtrack_tpu_torch.serving import MultiStreamTracker

    n = len(next(iter(streams.values()))[0])
    msts = ([(MultiStreamTracker(tracker, clip_len=FRAMES,
                                 batch_streams=len(streams),
                                 sharding=sharding), list(streams))]
            if sharding is not None else
            [(MultiStreamTracker(tracker, clip_len=FRAMES,
                                 batch_streams=len(g)), g) for g in groups])
    emitted = []
    for t in range(n):
        for mst, sids in msts:
            for sid in sids:
                frames, boxes, scores = streams[sid]
                mst.submit(sid, frames[t], boxes[t], scores[t])
            emitted += mst.step()
    for mst, _ in msts:
        emitted += mst.flush()
    got = {sid: [None] * n for sid in streams}
    for sid, first, tracks in emitted:
        for i, fr in enumerate(tracks):
            got[sid][first + i] = fr
    require(all(fr is not None for per in got.values() for fr in per),
            "mesh: a served frame was never emitted")
    return got


def evaluated(dataset, run):
    """``run()`` (a validation over ``dataset``) and the arrays it handed to
    ``dataset.evaluate``: (stats, {preds, maxvals, scores, image_id})."""
    seen = {}
    evaluate = dataset.evaluate

    def spy(preds, maxvals, scores, ids, **kw):
        seen.update(preds=preds, maxvals=maxvals, scores=scores, image_id=ids)
        return evaluate(preds, maxvals, scores, ids, **kw)

    dataset.evaluate = spy
    try:
        return run(), seen
    finally:
        del dataset.evaluate


def kernel_events_by_device(device_events) -> dict:
    """Device events of each counted kernel, by device index."""
    out = {}
    for e in device_events:
        for k, rule in KERNEL_FUNCTIONS.items():
            if rule.search(e.name):
                per = out.setdefault(e.device_index, dict.fromkeys(
                    KERNEL_FUNCTIONS, 0))
                per[k] += 1
    return out


def mesh_train(card_f, dev, mesh, tag):
    """The sharded train step on ``mesh`` (one rank a slot:
    ``train_steps_on_mesh``) against the unsharded step on the global
    batch in this process: R50 256x192 float32 (TF32 off), a per-device
    batch of MESH_TRAIN_BATCH, one SGD step; FlowNetC float32 at
    FLOW_TRAIN_HW, MESH_FLOW_BATCH a device, one SGD step (K2's forward
    under autograd in every rank). Loss within MESH_TRAIN_RTOL relative,
    every parameter and running statistic within MESH_TRAIN_ATOL +
    MESH_TRAIN_RTOL relative; the measured differences are logged."""
    import copy

    from flowtrack_tpu_torch.config import Config, FlowConfig, get_config
    from flowtrack_tpu_torch.engine.flow_train import flow_train_step
    from flowtrack_tpu_torch.engine.train import (create_train_state,
                                                  train_step)
    from flowtrack_tpu_torch.models.flownet import get_flow_net
    from flowtrack_tpu_torch.models.layers import apply_precision_policy
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from flowtrack_tpu_torch.parallel.distributed import (backend_for,
                                                          train_steps_on_mesh)

    base = get_config("coco_res50_256x192")
    sgd = replace(base.train, optimizer="sgd")
    pose_cfg = replace(base, model=replace(base.model, dtype="float32"),
                       train=sgd)
    flow_cfg = Config(flow=FlowConfig(variant="flownet_c", dtype="float32"),
                      train=sgd)
    gen = torch.Generator().manual_seed(SEED)
    pose = get_pose_net(pose_cfg.model, None, gen)
    flow = get_flow_net(flow_cfg.flow, None, gen)
    rng = np.random.default_rng(SEED + 11)
    n = mesh.size
    ih, iw = pose_cfg.model.image_size
    hh, hw = pose_cfg.model.heatmap_size
    pose_batch = {
        "input": rng.normal(size=(MESH_TRAIN_BATCH * n, ih, iw, 3)
                            ).astype(np.float32),
        "target": rng.uniform(0, 1, (MESH_TRAIN_BATCH * n, hh, hw, 17)
                              ).astype(np.float32),
        "target_weight": np.ones((MESH_TRAIN_BATCH * n, 17), np.float32)}
    fh, fw = FLOW_TRAIN_HW
    flow_batch = {
        "input": rng.normal(0, 0.3, (MESH_FLOW_BATCH * n, fh, fw, 6)
                            ).astype(np.float32),
        "flow": rng.normal(0, 2.0, (MESH_FLOW_BATCH * n, fh, fw, 2)
                           ).astype(np.float32)}
    jobs = [{"kind": "pose", "model": pose, "cfg": pose_cfg,
             "batches": [pose_batch]},
            {"kind": "flow", "model": flow, "cfg": flow_cfg,
             "batches": [flow_batch]}]
    t0 = time.perf_counter()
    got = train_steps_on_mesh(mesh, jobs)
    spawn_s = time.perf_counter() - t0
    apply_precision_policy(torch.float32)
    for job, res in zip(jobs, got):
        model = copy.deepcopy(job["model"]).to(dev)
        state = create_train_state(model, job["cfg"])
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in job["batches"][0].items()}
        if job["kind"] == "pose":
            state, m = train_step(state, batch)
        else:
            state, m = flow_train_step(state, batch)
        loss_rel = abs(res["metrics"][0]["loss"] - float(m["loss"])) / abs(
            float(m["loss"]))
        worst_abs, worst_excess = 0.0, 0.0
        for k, v in model.state_dict().items():
            if not v.is_floating_point():
                require(torch.equal(res["state"][k], v.cpu()),
                        f"{tag}: {k} differs")
                continue
            d = (res["state"][k].double() - v.double().cpu()).abs()
            worst_abs = max(worst_abs, d.max().item())
            bound = MESH_TRAIN_ATOL + MESH_TRAIN_RTOL * v.double().cpu().abs()
            worst_excess = max(worst_excess, (d - bound).max().item())
        log("mesh", check=f"train_{job['kind']}", mesh=tag,
            backend=backend_for(mesh), ranks=n,
            global_batch=len(job["batches"][0]["input"]),
            loss=res["metrics"][0]["loss"], loss_rel_diff=loss_rel,
            max_abs_diff=worst_abs, bound_atol=MESH_TRAIN_ATOL,
            bound_rtol=MESH_TRAIN_RTOL, rank0_launches=res["launches"],
            spawn_and_steps_s=spawn_s, card=card_f)
        require(loss_rel <= MESH_TRAIN_RTOL,
                f"{tag}: sharded {job['kind']} loss differs by {loss_rel}")
        require(worst_excess <= 0.0,
                f"{tag}: sharded {job['kind']} step off by {worst_abs}")
    require(dev.type != "cuda" or got[1]["launches"]["correlation"] > 0,
            f"{tag}: K2 never launched in the ranks' FlowNetC step")


def phase_mesh(card, dev=None):
    """Multi-device execution: slice 1's tracker (R50 256x192 + FlowNetC,
    bf16, flip test, recovery, every candidate kept) on the mesh of every
    card (``make_mesh()``) and on a 2-slot mesh that repeats the first, so
    that the split, the per-slot dispatch and the gather run on one card.
    On each: ``track_clips(sharding=)`` of MESH_LANES 16-frame 384x640
    clips, bit for bit against ``run_prepared_lanes`` on each slot's lanes
    alone, its K1 and K2 launches per device from its own trace, and
    sharded against unsharded frames/s in turns (on one card the cost of
    split and gather, not scaling); on the repeated mesh also one clip's
    frames split over it (``track_clip(frame_sharding=)``: ids and valid
    equal to the whole clip's, joints within MESH_FRAME_JOINT_PX),
    MultiStreamTracker(sharding=) with four 40-frame streams, each
    stream's emissions equal to the same groups of streams served
    unsharded, ``run_validation(mesh=)`` on a synthetic COCO set with its
    gathered joints, maxvals, scores and image ids bit for bit those of
    the one-slot run, and the sharded train step in two gloo ranks
    against the unsharded one (``mesh_train``); with two cards or more the
    train step also on two cards over nccl. Returns the launch counts of
    the traced sharded runs."""
    import tempfile
    from pathlib import Path

    from flowtrack_tpu_torch.config import get_config
    from flowtrack_tpu_torch.models.flownet import get_flow_net
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from flowtrack_tpu_torch.parallel import batch_sharding, make_mesh
    from flowtrack_tpu_torch.tools.test import (build_val_dataset,
                                                run_validation)
    from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker

    dev = torch.device("cuda", 0) if dev is None else dev
    on_card = dev.type == "cuda"
    card_f = f"'{card}'"
    t_phase = time.perf_counter()
    base = slice_config()
    cfg = replace(base, track=replace(base.track, pose_score_thre=0.0))
    gen = torch.Generator().manual_seed(SEED)
    tracker = ClipTracker(cfg, get_pose_net(cfg.model, dev, gen),
                          get_flow_net(cfg.flow, dev, gen),
                          max_persons=PERSONS, device=dev)
    meshes = {"repeated": make_mesh(0, devices=[dev, dev])}
    if on_card:
        meshes["cards"] = make_mesh()
    rng = np.random.default_rng(SEED + 9)
    c = MESH_LANES
    frames = rng.integers(0, 256, (c, FRAMES, FRAME_H, FRAME_W, 3), np.uint8)
    dets = [video_detections(rng, FRAMES, PERSONS, FRAME_H, FRAME_W,
                             (2.0, 1.0), drop=[(3,), (7, 8)])
            for _ in range(c)]
    clips = (frames, *(np.stack(x) for x in zip(*dets)))
    launches = dict.fromkeys(kernel_counters(), 0)
    for tag, mesh in meshes.items():
        sharding = batch_sharding(mesh)
        t0 = time.perf_counter()
        tracker.track_clips(*clips, sharding=sharding)   # captures
        warm_s = time.perf_counter() - t0
        result = {}

        def sharded_run():
            result["out"] = tracker.track_clips(*clips, sharding=sharding)

        if on_card:
            _, wall_ms, events = profile_run(f"mesh_{tag}",
                                             zero_counts(sharded_run))
            per_device = kernel_events_by_device(events)
            run_launches = kernel_events(events)
            for d in mesh.distinct():
                got = per_device.get(d.index, {})
                require(got.get("crop_resize_normalize", 0) > 0
                        and got.get("correlation", 0) > 0,
                        f"mesh {tag}: K1 or K2 never ran on {d}: "
                        f"{per_device}")
        else:
            t0 = time.perf_counter()
            zero_counts(sharded_run)()
            wall_ms = (time.perf_counter() - t0) * 1e3
            run_launches = {k: fn.launches
                            for k, fn in kernel_counters().items()}
            per_device = {"cpu": run_launches}
        for k in launches:
            launches[k] += run_launches[k]
        got = result["out"]
        per = c // mesh.size
        for g, d in enumerate(mesh.flat()):
            rep = tracker.replica(d)
            lanes = slice(g * per, (g + 1) * per)
            alone = rep.to_host(rep.run_prepared_lanes(rep.prepare_lanes(
                *(x[lanes] for x in clips))))
            for key, v in alone.items():
                require(np.array_equal(got[key][lanes], v),
                        f"mesh {tag}: slot {g}'s {key} differ from its lanes "
                        f"alone")
        require(got["ids"].shape == (c, FRAMES, PERSONS + RECOVERED)
                and np.isfinite(got["joints"]).all(),
                f"mesh {tag}: outputs {got['ids'].shape}")
        times = {"sharded": [], "unsharded": []}
        tracker.track_clips(*clips)
        for _ in range(MESH_TIMED):
            for route, kw in (("sharded", {"sharding": sharding}),
                              ("unsharded", {})):
                t0 = time.perf_counter()
                tracker.track_clips(*clips, **kw)
                times[route].append(time.perf_counter() - t0)
        fps = {r: c * FRAMES / float(np.median(t)) for r, t in times.items()}
        SUMMARY.setdefault("mesh_frames_per_s", {})[tag] = {
            r: round(v, 2) for r, v in fps.items()}
        log("mesh", check="track_clips", mesh=tag, slots=mesh.size,
            devices=[str(d) for d in mesh.distinct()], lanes=c,
            frames_per_clip=FRAMES, frame_hw=f"{FRAME_H}x{FRAME_W}",
            bitwise_per_slot=True, warm_s=warm_s, traced_wall_ms=wall_ms,
            launches=run_launches, launches_by_device=per_device,
            sharded_frames_per_s=fps["sharded"],
            unsharded_frames_per_s=fps["unsharded"], timed_turns=MESH_TIMED,
            card=card_f)

    # one clip's frames over the repeated mesh, against the whole clip
    mesh = meshes["repeated"]
    one = tuple(x[0] for x in clips)
    t0 = time.perf_counter()
    got = tracker.track_clip(*one, frame_sharding=batch_sharding(mesh))
    frame_s = time.perf_counter() - t0
    want = tracker.track_clip(*one)
    require(got["ids"].shape == want["ids"].shape
            and np.isfinite(got["joints"]).all(),
            f"mesh: frame-sharded clip {got['ids'].shape}")
    require(np.array_equal(got["valid"], want["valid"])
            and np.array_equal(got["ids"], want["ids"]),
            "mesh: the frame-sharded clip's ids or valid differ from the "
            "whole clip's")
    valid = want["valid"]
    require(valid[:, PERSONS:].any(),
            "mesh: the frame-sharded clip recovered no person")
    joint_px = float(np.abs(got["joints"] - want["joints"])[valid].max())
    log("mesh", check="frame_sharded_clip", slots=mesh.size,
        frames=FRAMES, seconds=frame_s, ids_valid_equal=True,
        max_joint_diff_px=joint_px, bound_px=MESH_FRAME_JOINT_PX,
        recovered=int(valid[:, PERSONS:].sum()), card=card_f)
    require(joint_px <= MESH_FRAME_JOINT_PX,
            f"mesh: frame-sharded joints off by {joint_px} px")

    # serving: one sharded tracker of four streams against the same
    # groups of two served unsharded
    streams = {}
    for i in range(SERVE_STREAMS):
        video = rng.integers(0, 256, (SERVE_FRAMES, FRAME_H, FRAME_W, 3),
                             np.uint8)
        det = video_detections(rng, SERVE_FRAMES, PERSONS, FRAME_H, FRAME_W,
                               (2.0, 1.0), drop=[(FRAMES - 1,), (5, 6)])
        streams[f"s{i}"] = (video, *ragged(*det))
    sids = list(streams)
    half = len(sids) // mesh.size
    groups = [sids[i:i + half] for i in range(0, len(sids), half)]
    # the first turn captures the graphs (the tails' among them); the
    # second is timed: sharded, unsharded, sharded, unsharded
    seconds = {"sharded": [], "unsharded": []}
    for _ in range(2):
        for route, sharding in (("sharded", batch_sharding(mesh)),
                                ("unsharded", None)):
            t0 = time.perf_counter()
            got = serve_groups(tracker, streams, groups, sharding)
            seconds[route].append(time.perf_counter() - t0)
            if route == "sharded":
                sharded = got
    tracks = sum(same_emissions(f"mesh serving {sid}", sharded[sid],
                                got[sid], 0.0) for sid in streams)
    require(tracks > 0, "mesh serving: no track emitted")
    log("mesh", check="MultiStreamTracker", slots=mesh.size,
        streams=len(streams), frames=SERVE_FRAMES, groups=groups,
        bitwise=True, tracks=tracks, sharded_s=seconds["sharded"],
        unsharded_s=seconds["unsharded"],
        sharded_frames_per_s=len(streams) * SERVE_FRAMES
        / seconds["sharded"][1],
        unsharded_frames_per_s=len(streams) * SERVE_FRAMES
        / seconds["unsharded"][1], card=card_f)

    # validation over the mesh against one slot: the arrays it gathers
    # (random weights score AP 0 on both, so the table alone would prove
    # nothing); every box's joints differ, so a slot's results out of
    # order, twice or missing would show
    vcfg = get_config("coco_res50_256x192")
    vcfg = replace(vcfg, test=replace(vcfg.test, batch_size=8))
    model = get_pose_net(vcfg.model, dev, gen)
    with tempfile.TemporaryDirectory() as tmp:
        root, _, det = coco_fixture().make_coco_fixture(
            Path(tmp) / "coco", n_images=LOOP_IMAGES, persons=2)
        vcfg = replace(vcfg, data=replace(vcfg.data, root=str(root)),
                       test=replace(vcfg.test, bbox_file=det))
        dataset = build_val_dataset(vcfg)
        want, one_slot = evaluated(dataset, lambda: run_validation(
            vcfg, model, output_dir=str(Path(tmp) / "a"), dataset=dataset,
            mesh=make_mesh(0, devices=[dev])))
        got, sharded = evaluated(dataset, lambda: run_validation(
            vcfg, model, output_dir=str(Path(tmp) / "b"), dataset=dataset,
            mesh=mesh))
    rows = len(one_slot["image_id"])
    require(rows == len(dataset) and rows > 8,
            f"mesh: run_validation gathered {rows} rows of {len(dataset)}")
    require(len(np.unique(one_slot["preds"].reshape(rows, -1), axis=0))
            == rows, "mesh: run_validation's rows are not distinct")
    for k, v in one_slot.items():
        require(np.array_equal(sharded[k], v),
                f"mesh: run_validation's gathered {k} differ from one slot's")
    require(got == want, f"mesh: run_validation {got} != {want}")
    log("mesh", check="run_validation", slots=mesh.size,
        images=LOOP_IMAGES, boxes=rows, batch_per_slot=8, ap=got["AP"],
        gathered_bitwise=True, card=card_f)

    mesh_train(card_f, dev, mesh, "repeated")
    if on_card and torch.cuda.device_count() >= 2:
        mesh_train(card_f, dev, make_mesh(2), "cards")
    log("mesh", seconds=time.perf_counter() - t_phase,
        cards=torch.cuda.device_count() if on_card else 0, card=card_f)
    return launches


def time_phases(module, seconds: dict) -> None:
    """Wrap every ``phase_*`` function of ``module`` (this script, or
    another checkout's copy of it loaded by path, to set the two side by
    side) so that its wall seconds add up in ``seconds`` under the phase's
    name (``tracking`` runs twice and sums)."""
    for name in [n for n in vars(module) if n.startswith("phase_")]:
        def timed(*args, _fn=getattr(module, name), _name=name[6:], **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                seconds[_name] = (seconds.get(_name, 0.0)
                                  + time.perf_counter() - t0)
        setattr(module, name, timed)


def main() -> int:
    phase_s = {}
    time_phases(sys.modules[__name__], phase_s)
    card = phase_device()
    phase_build()
    kernels = phase_kernels()
    slice_ = phase_slice(card)
    torch.cuda.synchronize()
    # the kernels line reports each kernel's launches on the path that runs
    # it: correlation and resample2d on FlowNet2's, crop and fused_stage on
    # the fused one's
    fn2 = phase_flownet2(card)
    torch.cuda.synchronize()
    fused = phase_fused(card)
    torch.cuda.synchronize()
    int8 = phase_int8(card)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    phase_aot(card)
    torch.cuda.empty_cache()
    phase_tracking(card, "flownet_c", (FRAME_H, FRAME_W))
    phase_tracking(card, "flownet2", (FN2_H, FN2_W))
    torch.cuda.synchronize()
    eval_ = phase_eval(card)
    torch.cuda.synchronize()
    serving = phase_serving(card)
    torch.cuda.synchronize()
    phase_precision()
    torch.cuda.empty_cache()
    mesh = phase_mesh(card)
    torch.cuda.synchronize()
    gc.collect()   # the mesh's replicas and their graph pools
    torch.cuda.empty_cache()
    train = phase_train(card)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    compiled = phase_compiled(card)
    torch.cuda.synchronize()
    gc.collect()   # the compiled programs' graphs and their pools
    torch.cuda.empty_cache()
    train_cli = phase_train_cli(card)
    torch.cuda.synchronize()
    by_path = {"slice": slice_, "flownet2": fn2, "fused": fused,
               "int8": int8, "eval": eval_, "serving": serving, "mesh": mesh,
               "train": train, "compiled": compiled, "train_cli": train_cli}
    for k in kernels:
        k["launches"] = (fn2 if k["name"] in ("correlation", "resample2d")
                         else fused)[k["name"]]
        k["launches_by_path"] = {p: n[k["name"]] for p, n in by_path.items()}
    SUMMARY["phase_s"] = {k: round(v, 1) for k, v in phase_s.items()}
    log("summary", **SUMMARY)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
