"""Offline tracking of recorded video: a backlog of videos fed to the
program's ``serving.MultiStreamTracker`` as fast as it takes them.

``streams`` streams each play one video of the pool after another (a new
stream id for each video); before each ``step`` every stream is given the
frames of its next clip, so every step runs ``batch_streams`` lanes of
``clip_len`` frames. A video has ``1 + k (clip_len - 1)`` frames, so its
clips fill exactly. The end-to-end metric is the frames whose tracks
reached the host in the window over the window's seconds.

With ``trace``, the last ``TRACE_S`` seconds of the window run under
torch.profiler, and after the window one clip of the same batch runs on
the eager route (``ClipTracker._clip``, the graph's plain version) under
the profiler for its ``clip.*`` ranges. Rates of the traced run (``mfu``)
are taken over the part of the window before the profiler started.
"""

from __future__ import annotations

import gc
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from portbench import check, spec, trace, video, weights
from portbench.reference import nets
from portbench.reference.clip import ClipReference

TRACE_S = 3.0
# batched steps before the window (the first captures the clip's graph),
# where the traffic file leaves ``warmup_steps`` out
WARMUP_STEPS = 2
# eager clips run before the profiled one, after the graphs' pool is let go
EAGER_WARMUPS = 2


def reference_nets(config: dict, device):
    """The configuration's pose and flow nets of the reference."""
    m, f = config["model"], config["flow"]
    pose = nets.PoseResNet(m["num_layers"], m["num_joints"],
                           m["num_deconv_filters"], m["num_deconv_kernels"],
                           m["final_conv_kernel"])
    flow = nets.flow_net(f["variant"], f["div_flow"],
                         f["corr_max_displacement"], f["corr_stride2"])
    return pose.to(device).eval(), flow.to(device).eval()


def states(config: dict, seed: int, device) -> tuple:
    """The seeded state dicts of the configuration's pose and flow nets."""
    with torch.device("meta"):
        pose, flow = reference_nets(config, "meta")
    rules = config["weights"]
    return (weights.make_state(pose, seed, 1, rules["pose"], device),
            weights.make_state(flow, seed, 2, rules["flow"], device))


class Spy:
    """Wraps the tracker's public ``prepare_lanes`` (a host span a batched
    step, with its detections kept) and ``to_host`` (each fetched batch's
    reported outputs kept for the check)."""

    def __init__(self, tracker):
        self.prepare_s = []
        self.batches = []       # per dispatch: det_valid (C, F, P)
        self.fetched = []       # per fetch: the to_host dict (lane axis kept)
        self.last_args = None
        prepare, to_host = tracker.prepare_lanes, tracker.to_host

        def prepare_lanes(*args, **kw):
            with record_function("portbench.prepare_lanes"):
                t0 = time.perf_counter()
                out = prepare(*args, **kw)
                self.prepare_s.append(time.perf_counter() - t0)
            self.batches.append(np.asarray(args[3]))
            self.last_args = (args, kw)
            return out

        def host(device_out):
            out = to_host(device_out)
            self.fetched.append(out)
            return out

        tracker.prepare_lanes = prepare_lanes
        tracker.to_host = host


class Backlog:
    """The streams' feed: which video each plays, and how far."""

    def __init__(self, pool, streams: int, clip_len: int):
        self.pool = pool
        self.clip_len = clip_len
        self.slots = [[s, s, 0] for s in range(streams)]  # video, sid, frames
        self.next_sid = streams
        self.video_of = {s: s % len(pool) for s in range(streams)}
        self.slot_of = {s: s for s in range(streams)}

    def feed(self, mst) -> int:
        """Submit each stream's next clip; returns the frames submitted."""
        n_video = len(self.pool[0].boxes)
        sent = 0
        for n, slot in enumerate(self.slots):
            v, sid, pos = slot
            if pos == n_video:
                v = (v + len(self.slots)) % len(self.pool)
                sid, pos = self.next_sid, 0
                self.next_sid += 1
                self.video_of[sid] = v
                self.slot_of[sid] = n
            video_v = self.pool[v]
            need = self.clip_len if pos == 0 else self.clip_len - 1
            for f in range(pos, pos + need):
                mst.submit(sid, video_v.frames[f], video_v.boxes[f],
                           video_v.scores[f])
            slot[:] = [v, sid, pos + need]
            sent += need
        return sent


def _lanes(fetched: list) -> list:
    """The fetched batches' lanes in emission order: (batch, lane)."""
    return [(b, lane) for b, out in enumerate(fetched)
            for lane in range(out["valid"].shape[0])]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool,
        started: float, dev=torch.device("cuda")):
    """One run of an offline cell on ``dev`` (the card; the CPU runs the
    program's plain versions, for the benchmark's own tests). Returns the
    run's namespace (what the metrics read) and the check's readings."""
    from flowtrack_tpu_torch.models.flownet import get_flow_net
    from flowtrack_tpu_torch.models.pose_resnet import get_pose_net
    from flowtrack_tpu_torch.serving import MultiStreamTracker
    from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker

    tr, config = cell.traffic, cell.config
    cfg = spec.port_config(config)
    marks = [("imports", time.perf_counter())]
    pose_sd, flow_sd = states(config, seed, dev)
    pose = get_pose_net(cfg.model, dev)
    pose.load_state_dict(pose_sd)
    flow = get_flow_net(cfg.flow, dev)
    flow.load_state_dict(flow_sd)
    del pose_sd, flow_sd
    tracker = ClipTracker(cfg, pose, flow, device=dev)
    marks.append(("weights", time.perf_counter()))
    pool = video.make_videos(tr, seed, dev)
    marks.append(("videos", time.perf_counter()))
    padded = [video.padded(v, tracker.max_persons) for v in pool]
    spy = Spy(tracker)
    mst = MultiStreamTracker(tracker, clip_len=tr["clip_len"],
                             batch_streams=tr["streams"],
                             pipeline_depth=tr["pipeline_depth"])
    backlog = Backlog(pool, tr["streams"], tr["clip_len"])
    emitted = []            # (sid, first frame, tracks) in emission order

    def step(force=False):
        with record_function("portbench.step"):
            return mst.step(force=force)

    # warm-up: the cell's one geometry, captured, then the pipeline drained
    for _ in range(tr.get("warmup_steps", WARMUP_STEPS)):
        backlog.feed(mst)
        emitted += step()
    emitted += step(force=True)
    _sync(dev)
    warm = (len(spy.batches), len(emitted))

    t0 = time.perf_counter()
    setup_s = t0 - started
    marks.append(("warm-up", t0))
    print("setup s: " + ", ".join(
        f"{name} {t - prev:.2f}" for (name, t), prev in
        zip(marks, [started] + [t for _, t in marks])), file=sys.stderr)
    frames = submitted = 0
    returns = []
    prof = None
    t_trace = None
    while time.perf_counter() - t0 < seconds:
        if traced and prof is None and \
                time.perf_counter() - t0 >= seconds - TRACE_S:
            t_trace = time.perf_counter()
            frames_before_trace = frames
            n_before = len(spy.batches)
            prof = trace.profiler().__enter__()
            rec = record_function("portbench.trace").__enter__()
        with record_function("portbench.feed"):
            submitted += backlog.feed(mst)
        out = step()
        emitted += out
        frames += sum(len(tracks) for _, _, tracks in out)
        returns.append(time.perf_counter())
    t_end = time.perf_counter()
    steps = np.diff([t0] + returns)
    print(f"window: {len(steps)} steps, mean {steps.mean():.4f} s, sd "
          f"{steps.std():.4f} s, first {steps[0]:.4f} s", file=sys.stderr)
    emitted += step(force=True)
    if prof is not None:
        _sync(dev)
        rec.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    window_s = t_end - t0
    returned = sum(len(t) for _, _, t in emitted[warm[1]:])

    ns = SimpleNamespace(cell=cell, config=config, traffic=tr, seed=seed,
                         window_s=window_s, frames=frames,
                         prepare_s=spy.prepare_s[warm[0]:],
                         memory_peak_bytes=peak, traced=traced,
                         attempted=submitted,
                         failed=max(0, submitted - returned),
                         end_to_end={"frames_per_s": frames / window_s,
                                     "setup_s": setup_s})

    # the reported outputs of every lane, by stream, in clip order
    lanes = _lanes(spy.fetched)
    clips_of = {}
    for (b, lane), (sid, _, _) in zip(lanes, emitted):
        clips_of.setdefault(sid, []).append(
            {k: v[lane] for k, v in spy.fetched[b].items()})
        clips_of[sid][-1]["det_valid"] = spy.batches[b][lane]
    n_clips = (len(pool[0].boxes) - 1) // (tr["clip_len"] - 1)

    if traced:
        _read_trace(ns, prof, tracker, spy, n_before, t_trace - t0,
                    frames_before_trace, emitted, warm)
    del mst, tracker, pose, flow, spy
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = judge(cell, seed, pool, padded, clips_of, backlog, n_clips,
                     dev)
    return ns, readings


def _read_trace(ns, prof, tracker, spy, n_before, pre_s, pre_frames, emitted,
                warm):
    """What the per-layer metrics read: the traced steps' device operations
    and the work they held, the eager clip's stage ranges, and the useful
    work of the window before the profiler started."""
    lo, hi = trace.host_range(prof, "portbench.trace")
    ops = trace.device_ops(prof)
    busy, gaps = trace.busy_and_gaps(ops, lo, hi)
    ns.trace_ops = [o for o in ops if o[2] > lo and o[1] < hi]
    ns.busy_s, ns.trace_window_s = busy, (hi - lo) / 1e6
    ns.breakdown = trace.breakdown(prof, ns.trace_ops, gaps)
    # the batches dispatched inside the trace, with their reported outputs
    ns.traced_batches = [(spy.batches[i], spy.fetched[i])
                         for i in range(n_before, len(spy.batches))]

    # the useful work of the window before the trace: every detection and
    # every recovered person reported, each posed twice (flip test), and
    # one flow pair per new frame of a video
    p = tracker.max_persons
    det = rec = pairs = 0
    lanes = _lanes(spy.fetched)
    count = 0
    for (b, lane), (sid, first, tracks) in list(zip(lanes, emitted))[warm[1]:]:
        if count >= pre_frames:
            break
        out = spy.fetched[b]
        skip = out["valid"].shape[1] - len(tracks)
        det += int(spy.batches[b][lane][skip:].sum())
        rec += int(out["valid"][lane, skip:, p:].sum())
        pairs += len(tracks) - (1 if first == 0 else 0)
        count += len(tracks)
    ns.useful = SimpleNamespace(pose_forwards=2 * (det + rec), pairs=pairs,
                                seconds=pre_s)

    # one clip of the last batch on the eager route, its stages profiled;
    # the graphs' pool is let go first, so that the eager clip fits
    tracker.graphs.clear()
    gc.collect()
    if tracker.device.type == "cuda":
        torch.cuda.empty_cache()
    args, kw = spy.last_args
    dev_args = tracker.prepare_lanes(*args, **kw)
    with torch.inference_mode():
        empty = tracker.empty_seed()
        seed = [torch.stack(leaves)
                for leaves in zip(*[empty] * dev_args[0].shape[0])]
        for _ in range(EAGER_WARMUPS):
            tracker._clip(*dev_args, *seed)
        _sync(dev_args[0].device)
        with trace.profiler() as eager:
            tracker._clip(*dev_args, *seed)
            _sync(dev_args[0].device)
    ns.stage_s = trace.range_device_s(eager)
    c, f = dev_args[0].shape[:2]
    ns.stage_frames = c * (f - 1)


def judge(cell, seed, pool, padded, clips_of, backlog, n_clips, dev):
    """The check: of each stream (each lane of the batched steps), one video
    whose every clip came back, drawn from the seed, held to the float32
    reference on the card."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 5]))
    sample = []
    for slot in range(len(backlog.slots)):
        done = [sid for sid, clips in clips_of.items()
                if len(clips) == n_clips and backlog.slot_of[sid] == slot]
        if done:
            sample.append(done[int(rng.integers(len(done)))])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pose_sd, flow_sd = states(cell.config, seed, dev)
    pose, flow = reference_nets(cell.config, dev)
    pose.load_state_dict(pose_sd)
    flow.load_state_dict(flow_sd)
    ref = ClipReference(cell.config, pose, flow, dev)
    readings = check.Readings()
    for sid in sample:
        v = backlog.video_of[sid]
        boxes, scores, valid = padded[v]
        check.judge_video(ref, pool[v].frames, boxes, scores, valid,
                          clips_of[sid], cell.traffic["clip_len"], readings)
    return readings
