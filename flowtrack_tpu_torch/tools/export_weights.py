"""Convert lineage torch checkpoints to the JAX package's .npz trees, and
back.

Port of ``tools/export_weights.py`` (``CONVERTERS`` :25, ``REVERSERS``
:38, ``main`` :50), with the same ``--kind`` choices and arguments and the
same printed json line, on ``utils/convert.py``. The port's own modules
load a lineage state dict as it is, so this tool is for moving weights
between the port and the JAX package: forward, a ``.pth`` (pose, FlowNet,
or a torchvision ImageNet ResNet whose ``fc`` is dropped) to the ``.npz``
tree; ``--reverse``, an ``.npz`` tree to a ``.pth`` that the port and the
lineage's torch code load with ``strict=True``.

    python3 -m flowtrack_tpu_torch.tools.export_weights --kind pose \\
        --pth model_best.pth --out pose.npz
    python3 -m flowtrack_tpu_torch.tools.export_weights --kind pose \\
        --reverse --npz pose.npz --out pose.pth
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from flowtrack_tpu_torch.engine.checkpoint import (load_npz_variables,
                                                   save_npz_variables)
from flowtrack_tpu_torch.utils import convert as cv

CONVERTERS = {
    "pose": cv.convert_pose_resnet,
    "backbone_imagenet": cv.convert_resnet_backbone,
    "flownet_fusion": cv.convert_flownet_fusion,
    **{k: c.convert for k, c in cv.FLOW_CONVERTERS.items()},
}


REVERSERS = {
    "pose": cv.reverse_pose_resnet,
    "flownet_fusion": cv.reverse_flownet,
    **{k: c.reverse for k, c in cv.FLOW_CONVERTERS.items()},
}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", required=True, choices=sorted(CONVERTERS))
    ap.add_argument("--pth", help="torch checkpoint in (forward mode)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--npz", help="flax npz in (with --reverse)")
    ap.add_argument("--reverse", action="store_true",
                    help="convert the OTHER way: flax .npz -> torch .pth "
                         "(deploy TPU-trained weights on the torch stack)")
    args = ap.parse_args(argv)

    if args.reverse:
        if args.kind not in REVERSERS:
            ap.error(f"--reverse unsupported for kind {args.kind!r}")
        if not args.npz:
            ap.error("--reverse needs --npz")
        variables = load_npz_variables(args.npz)
        sd = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in REVERSERS[args.kind](variables).items()}
        torch.save(sd, args.out)
        out = {"kind": args.kind, "out": args.out, "reverse": True,
               "num_arrays": len(sd)}
    else:
        if not args.pth:
            ap.error("forward mode needs --pth")
        variables = CONVERTERS[args.kind](cv.load_torch_file(args.pth))
        save_npz_variables(args.out, variables)
        out = {"kind": args.kind, "out": args.out,
               "num_arrays": sum(1 for _ in _leaves(variables)),
               "num_params": int(sum(v.size for v in _leaves(variables)))}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
