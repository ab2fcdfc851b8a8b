"""Old against new, in turns, for the redesigned kernels of the port.

    git archive <commit before the redesign> | tar -x -C build/parent
    python3 kernel_ab.py --old build/parent [--quick] [--only crop|correlation|fused_stage]

On one NVIDIA GPU (an H100), inside one call, so that both sides see the
same card, clocks and neighbours: four worker processes in the order old,
new, new, old, each importing ``flowtrack_tpu_torch`` from its own tree (the
old one from the checkout ``--old`` names, the new one from beside this
file), building that tree's kernels and timing

  K5 ``fused_stage``: each batch-256 chunk of ``chip_smoke.FUSED_CHUNKS``
  through ``fused_stage_cuda``, first held to ``fused_stage_plain``;

  K2 ``correlation``: the path's 15 pairs of 48x80x256 bfloat16 features
  through ``correlation_cuda``, first held to ``correlation_plain``.

  K1 ``crop``: a clip's 128 detector crops and the recovery pass's 16, from
  uint8 frames of 384x640 to 256x192 bfloat16, through ``crop_frames_cuda``,
  first held to ``crop_frames_plain``: the wrapper's time by events around
  eager calls, the device time of a call alone (20 calls in one CUDA graph),
  the crop kernel's own time and the device events of a profiled call.

It prints the card's name and power limit, what ``ptxas -v`` said of each
kernel of the new tree (registers, spills), one line per worker with the
bounds worked out by ``chip_smoke``'s functions, and a last JSON line with
each kernel's times as [first, second] per side. ``--quick`` checks and
skips the timing. Inputs, tolerances, timing and bounds are ``chip_smoke``'s,
from beside this file, on both sides; nothing of jax is imported.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

HERE = Path(__file__).resolve().parent
KERNELS = ("block_wgmma_kernel", "conv_wgmma_kernel", "fused_conv_kernel",
           "correlation_mma_kernel", "correlation_kernel",
           "crop_band_kernel", "resample2d_kernel")


TYPE_CODES = {"h": "uint8", "f": "float", "i": "int"}


def kernel_name(mangled: str) -> str:
    """``block_wgmma_kernel<64,1>`` or ``crop_band_kernel<uint8,
    __nv_bfloat16,0>`` from an entry's mangled name."""
    for name in KERNELS:
        at = mangled.find(name)
        if at < 0:
            continue
        rest, args = mangled[at + len(name):], []
        if rest[:1] == "I":
            rest = rest[1:]
            while rest and rest[0] != "E":
                m = re.match(r"L[ib](\d+)E", rest)
                n = re.match(r"\d+", rest)
                if m:
                    args.append(m.group(1))
                    rest = rest[m.end():]
                elif n:
                    end = n.end() + int(n.group())
                    args.append(rest[n.end():end])
                    rest = rest[end:]
                elif rest[0] in TYPE_CODES:
                    args.append(TYPE_CODES[rest[0]])
                    rest = rest[1:]
                else:
                    break
        return name + (f"<{','.join(args)}>" if args else "")
    return mangled[:60]


def ptxas_report(path) -> list:
    """(kernel, registers, spill stores, spill loads) of each entry in a
    ``ptxas -v`` log."""
    text = path.with_suffix(".ptxas.txt").read_text()
    rows, name, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = kernel_name(m.group(1)), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spill))
            name = None
    return rows


def k5(quick: bool) -> dict:
    from flowtrack_tpu_torch.ops import fused_resnet as fr

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED + 3)
    out = {}
    for name, shape, f, nblocks, projection in cs.FUSED_CHUNKS:
        blocks = fr.CheckedBlocks(
            cs.random_blocks(gen, shape[-1], f, nblocks, projection, dev))
        x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
        if name not in cs.R50_CHUNKS:
            continue
        want = fr.fused_stage_plain(x, blocks, 1)
        before = fr.fused_stage_cuda.launches
        got = fr.fused_stage_cuda(x, blocks)
        torch.cuda.synchronize()
        row = {"launches": fr.fused_stage_cuda.launches - before,
               "rel_err": ((got.float() - want.float()).abs().max()
                           / want.float().abs().max()).item()}
        cs.require(row["rel_err"] <= cs.FUSED_REL_TOL,
                   f"{name}: {row['rel_err']} > {cs.FUSED_REL_TOL}")
        if not quick:
            bound, by = cs.fused_bound_ms(shape, blocks)
            row.update(ms=cs.time_ms(lambda: fr.fused_stage_cuda(x, blocks),
                                     20),
                       bound_ms=bound, bound_by=by)
        out[name] = row
    if not quick:
        out["layers1-4"] = {k: sum(r[k] for r in out.values())
                            for k in ("ms", "bound_ms")}
    return out


def k2(quick: bool) -> dict:
    import numpy as np

    from flowtrack_tpu_torch.ops import correlation as corr

    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    shape = (cs.FRAMES - 1, cs.FRAME_H // 8, cs.FRAME_W // 8, 256)
    f1 = torch.as_tensor(rng.standard_normal(shape), device=dev).to(torch.bfloat16)
    f2 = torch.as_tensor(rng.standard_normal(shape), device=dev).to(torch.bfloat16)
    f1n = f1.permute(0, 3, 1, 2).contiguous()
    f2n = f2.permute(0, 3, 1, 2).contiguous()
    want = corr.correlation_plain(f1, f2, 20, 2).permute(0, 3, 1, 2)
    got = corr.correlation_cuda(f1n, f2n, 20, 2)
    torch.cuda.synchronize()
    row = {"max_abs_err": (got - want).abs().max().item()}
    cs.require(row["max_abs_err"] <= cs.CORR_TOL,
               f"correlation: {row['max_abs_err']} > {cs.CORR_TOL}")
    if not quick:
        bound, by = cs.correlation_bound_ms(*f1n.shape, 21)
        row.update(ms=cs.time_ms(
            lambda: corr.correlation_cuda(f1n, f2n, 20, 2), 50),
            bound_ms=bound, bound_by=by)
    return row


def k1(quick: bool) -> dict:
    """K1 at the path's two launches (a clip's 128 detector crops, and the
    recovery pass's 16) from uint8 frames to bfloat16 crops: held to
    ``crop_frames_plain``; then the wrapper's time by events, the device
    time of a call with no host work between launches (a CUDA graph of 20
    calls), and from one profiled call the device events it makes and the
    crop kernel's own device time."""
    import numpy as np

    from flowtrack_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
    from flowtrack_tpu_torch.ops import crop as crop_mod

    dev = torch.device("cuda")
    out = {}
    for name, persons in (("clip_128", cs.PERSONS), ("recovery_16", 1)):
        rng = np.random.default_rng(cs.SEED)
        pixels, idx, centers, scales = cs.crop_case(rng, dev, persons)
        frames = torch.as_tensor(pixels, device=dev).contiguous()
        args = (frames, idx, centers, scales, (256, 192), IMAGENET_MEAN,
                IMAGENET_STD, 255.0, torch.bfloat16)
        got = crop_mod.crop_frames_cuda(*args)
        want = crop_mod.crop_frames_plain(*args)
        torch.cuda.synchronize()
        row = {"crops": got.shape[0],
               "max_abs_err": (got.float() - want.float()).abs().max().item()}
        cs.require(row["max_abs_err"] <= cs.CROP_BF16_TOL,
                   f"crop {name}: {row['max_abs_err']} > {cs.CROP_BF16_TOL}")
        if not quick:
            def call():
                return crop_mod.crop_frames_cuda(*args)

            bound, by = cs.bound_ms(10.0 * got.numel(), "float32",
                                    (frames, idx, centers, scales, got))
            events, by_name = cs.device_events(call)
            row.update(
                wrapper_ms=cs.time_ms(call, 200),
                device_ms=cs.graph_ms(call),
                kernel_ms=sum(v for k, v in by_name.items() if "crop" in k),
                device_events=events, bound_ms=bound, bound_by=by)
        out[name] = row
    return out


def worker(tree: str, side: str, quick: bool, only) -> int:
    """One side's checks and timings with ``tree``'s port."""
    root = Path(tree).resolve()
    # only this tree's port: the package has no __init__.py of its own, so
    # two trees on the path would merge into one namespace
    sys.path[:] = [str(root)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != HERE]
    from flowtrack_tpu_torch import kernels

    cs.require(Path(kernels.__file__).resolve().is_relative_to(root),
               f"{side}: the port came from {kernels.__file__}")
    card = cs.phase_device()
    cs.phase_build()
    if side == "new":
        for row in ptxas_report(kernels.library_path()):
            cs.log("ptxas", kernel=row[0], registers=row[1],
                   spill_stores=row[2], spill_loads=row[3])
    checks = {"crop": k1, "correlation": k2, "fused_stage": k5}
    result = {"side": side, "card": card,
              **{name: fn(quick) for name, fn in checks.items()
                 if only in (None, name)}}
    print(json.dumps(result), flush=True)
    return 0


def main() -> int:
    args = sys.argv[1:]
    quick = "--quick" in args
    only = args[args.index("--only") + 1] if "--only" in args else None
    if only not in (None, "crop", "correlation", "fused_stage"):
        raise SystemExit(__doc__)
    if "--side" in args:
        return worker(args[args.index("--tree") + 1],
                      args[args.index("--side") + 1], quick, only)
    if "--old" not in args:
        raise SystemExit(__doc__)
    trees = {"old": args[args.index("--old") + 1], "new": str(HERE)}
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    rows = []
    for side in ("old", "new", "new", "old"):
        cmd = [sys.executable, str(HERE / "kernel_ab.py"), "--side", side,
               "--tree", trees[side]] + (["--quick"] if quick else []) \
            + (["--only", only] if only else [])
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            return proc.returncode
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    result = {"card": rows[0]["card"]}
    if not quick:
        for side in ("old", "new"):
            mine = [r for r in rows if r["side"] == side]
            if "correlation" in mine[0]:
                result[f"correlation_{side}_ms"] = [r["correlation"]["ms"]
                                                    for r in mine]
            for case in mine[0].get("crop", ()):
                for key in ("wrapper_ms", "device_ms", "kernel_ms",
                            "device_events"):
                    result[f"crop_{case}_{side}_{key}"] = [
                        r["crop"][case][key] for r in mine]
            for chunk in mine[0].get("fused_stage", ()):
                result[f"fused_stage_{chunk}_{side}_ms"] = [
                    r["fused_stage"][chunk]["ms"] for r in mine]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
