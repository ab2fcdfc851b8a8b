"""Checkpoints: the train state in a torch format, and the reference's
portable .npz trees.

Port of ``flowtrack_tpu/engine/checkpoint.py``: ``CheckpointManager``
(:19-70) keeps one ``epoch_<n>.pt`` a save (``torch.save`` of the model's
and the optimizer's state dicts, the step, the epoch and its score) in
``directory``, with an index of the scores beside them. It keeps the
``max_to_keep`` best by score, the newest always among them, and
``best_epoch`` names the best; ``restore`` loads the newest (or a given
epoch) into a ``TrainState``. Saves are synchronous (the reference's orbax
saves in the background). ``load_npz_variables`` (:87) reads the
reference's flat .npz ("/"-joined paths) into its nested tree, which
``utils/convert.load_*`` load into the port's modules;
``save_npz_variables`` (:101) writes such a tree, as
``utils/convert.convert_*`` make it from a port state dict, for the
reference to read.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch


class CheckpointManager:
    """The train state by epoch, the best by score kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._index_path = os.path.join(self._dir, "index.json")
        self._perf = {}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._perf = {int(k): v for k, v in json.load(f).items()}

    def _path(self, epoch: int) -> str:
        return os.path.join(self._dir, f"epoch_{epoch:06d}.pt")

    def save(self, epoch: int, state, perf: float = 0.0):
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": state.step, "epoch": epoch, "perf": float(perf)},
                   self._path(epoch))
        self._perf[epoch] = float(perf)
        newest = max(self._perf)
        while len(self._perf) > self.max_to_keep:
            worst = min((e for e in self._perf if e != newest),
                        key=lambda e: (self._perf[e], e))
            os.remove(self._path(worst))
            del self._perf[worst]
        with open(self._index_path, "w") as f:
            json.dump(self._perf, f)

    def restore(self, state, epoch: Optional[int] = None):
        """Load the newest checkpoint, or ``epoch``'s, into ``state``'s
        model and optimizer; -> (state, epoch), epoch -1 if there is none."""
        if epoch is None:
            epoch = self.latest_epoch
        if epoch is None:
            return state, -1
        device = next(state.model.parameters()).device
        ckpt = torch.load(self._path(epoch), map_location=device,
                          weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        return state, epoch

    @property
    def latest_epoch(self) -> Optional[int]:
        return max(self._perf) if self._perf else None

    @property
    def best_epoch(self) -> Optional[int]:
        if not self._perf:
            return None
        return max(self._perf, key=lambda e: (self._perf[e], -e))


def load_npz_variables(path: str) -> dict:
    """A flat .npz of "/"-joined paths -> the nested numpy tree."""
    tree: dict = {}
    with np.load(path) as flat:
        for k in flat.files:
            node = tree
            parts = k.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[k]
    return tree


def save_npz_variables(path: str, variables: Any):
    """A nested tree of arrays -> a flat .npz of "/"-joined paths."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (k,))
        else:
            flat["/".join(prefix)] = np.asarray(node)

    walk(variables, ())
    np.savez(path, **flat)
