"""Device mesh and sharding helpers (data parallelism over devices).

Port of ``flowtrack_tpu/parallel/mesh.py`` (:19-61). The reference lays a
1-D ``jax.sharding.Mesh`` over its chips and lets XLA split a batch on its
leading axis; here one process holds a :class:`Mesh` of ``torch.device``
slots, and a :class:`NamedSharding` says which tensor axis is split over
which mesh axis. ``device_put`` cuts a tensor into the shards of every slot
and puts each on its slot's device; a sharded entry point dispatches every
slot's work before it fetches any (CUDA work is asynchronous, so distinct
cards overlap) and gathers on the host. Inference is per example, so no
collective is needed, as the reference needs none; training, whose batch
norms need the global batch, runs one process a slot
(``parallel/distributed.py``).

A mesh may repeat a device: its slots then run one after another on it,
and ``replicated`` keeps one copy per distinct device. A mesh of the CPU
is asked for explicitly (``devices=[torch.device("cpu")] * n``); with no
``devices`` ``make_mesh`` takes every CUDA device and raises without one.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"


def normal_device(device) -> torch.device:
    """``device`` as a torch.device with its index: a bare 'cuda' is the
    current CUDA device, so that equal devices compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass(frozen=True, eq=False)
class Mesh:
    """An N-d array of ``torch.device`` slots with one name per axis (the
    counterpart of ``jax.sharding.Mesh``)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        given = np.asarray(self.devices, dtype=object)
        devices = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(given.shape):
            devices[idx] = normal_device(given[idx])
        if devices.size == 0:
            raise ValueError("a mesh needs at least one device")
        names = tuple(self.axis_names)
        if len(names) != devices.ndim or len(set(names)) != len(names):
            raise ValueError(f"{devices.ndim}-d mesh needs as many distinct "
                             f"axis names, got {names}")
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "axis_names", names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def flat(self) -> list:
        """The slots' devices in row-major order."""
        return list(self.devices.reshape(-1))

    def distinct(self) -> list:
        """Each device once, in the order of its first slot."""
        return list(dict.fromkeys(self.flat()))

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.flat()]})")


def make_mesh(num_devices: int = 0, axis: str = DATA_AXIS,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D data-parallel mesh over ``devices`` (default: every CUDA device,
    which raises without one); ``num_devices`` > 0 takes the first that
    many, more than there are raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh found no CUDA device; pass "
                               "devices=[torch.device('cpu')] * n for a "
                               "mesh of the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if num_devices:
        if num_devices > len(devices):
            raise ValueError(f"mesh of {num_devices} devices asked for, "
                             f"{len(devices)} given")
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices, dtype=object), (axis,))


def mesh_for(device, num_devices: int = 0, axis: str = DATA_AXIS) -> Mesh:
    """The mesh an entry point runs on when asked for ``device``: a bare
    'cuda' is every CUDA device (``make_mesh``); a device with an index, or
    the CPU, is that device, repeated ``num_devices`` times."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return make_mesh(num_devices, axis)
    return make_mesh(0, axis, [device] * max(1, num_devices))


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """Which mesh axis splits which leading tensor axis: ``spec[d]`` is a
    mesh axis name (tensor axis d is cut into that many equal parts) or
    None; mesh axes no entry names replicate (the counterpart of
    ``NamedSharding(mesh, PartitionSpec(*spec))``)."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()

    def __post_init__(self):
        spec = tuple(self.spec)
        named = [a for a in spec if a is not None]
        for a in named:
            if a not in self.mesh.axis_names:
                raise ValueError(f"{a!r} is not an axis of {self.mesh}")
        if len(set(named)) != len(named):
            raise ValueError(f"a mesh axis splits one tensor axis: {spec}")
        object.__setattr__(self, "spec", spec)

    def parts(self, dim: int) -> int:
        """Into how many parts tensor axis ``dim`` is cut."""
        if dim >= len(self.spec) or self.spec[dim] is None:
            return 1
        return self.mesh.shape[self.spec[dim]]


def batch_sharding(mesh: Mesh, axis: Optional[str] = None) -> NamedSharding:
    """Split the leading (batch) axis over ``axis``, by default the mesh's
    own first axis name."""
    return NamedSharding(mesh, (axis if axis is not None
                                else mesh.axis_names[0],))


def replicated(mesh: Mesh) -> NamedSharding:
    """Every slot holds the whole value (``device_put`` keeps one copy per
    distinct device)."""
    return NamedSharding(mesh, ())


def pad_to_multiple(arr, multiple: int, axis: int = 0):
    """Pad ``arr`` with zeros at the end of ``axis`` so that its length
    divides ``multiple``; returns (arr, n_valid), ``arr`` itself when it
    already does."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, rem)
    return np.pad(arr, pad), n


def part(x, i: int, n: int, axis: int = 0):
    """The ``i``-th of ``n`` equal parts of ``x`` (a tensor, an array or,
    on axis 0, a sequence) along ``axis``; raises when ``n`` does not
    divide it. Every split of a batch over a mesh's slots or a group's
    ranks is this one."""
    size = len(x) if axis == 0 else x.shape[axis]
    if size % n:
        raise ValueError(f"axis {axis} of length {size} does not divide "
                         f"into {n} parts")
    step = size // n
    cut = slice(i * step, (i + 1) * step)
    return x[cut] if axis == 0 else x[(slice(None),) * axis + (cut,)]


def _to(x, device):
    if isinstance(x, torch.nn.Module):
        return copy.deepcopy(x).to(device)
    return torch.as_tensor(x).to(device, non_blocking=True)


def _shard_of(x, sharding: NamedSharding, index: tuple):
    """The part of ``x`` that the slot at mesh ``index`` holds."""
    mesh = sharding.mesh
    for dim, name in enumerate(sharding.spec):
        if name is not None:
            x = part(x, index[mesh.axis_names.index(name)], mesh.shape[name],
                     dim)
    return x


def device_put(x, sharding: NamedSharding) -> np.ndarray:
    """``x`` (a tensor, a numpy array or, replicated only, a module) placed
    by ``sharding``: an object array of the mesh's shape holding each slot's
    part on the slot's device. Equal parts on one device (a repeated device
    under a replicated axis) share one copy; a part already on its device is
    not copied."""
    mesh = sharding.mesh
    if isinstance(x, torch.nn.Module) and sharding.spec:
        raise ValueError("a module is replicated, not split")
    out = np.empty(mesh.devices.shape, dtype=object)
    made = {}
    for index in np.ndindex(mesh.devices.shape):
        dev = mesh.devices[index]
        part_key = tuple(index[mesh.axis_names.index(a)]
                         for a in sharding.spec if a is not None)
        key = (dev, part_key)
        if key not in made:
            part = x if isinstance(x, torch.nn.Module) else _shard_of(
                x, sharding, index)
            on_dev = (isinstance(part, torch.Tensor) and part.device == dev
                      or isinstance(part, torch.nn.Module)
                      and _module_device(part) == dev)
            made[key] = part if on_dev else _to(part, dev)
        out[index] = made[key]
    return out


def _module_device(module) -> Optional[torch.device]:
    t = next(iter(module.parameters()), None)
    if t is None:
        t = next(iter(module.buffers()), None)
    return None if t is None else normal_device(t.device)


def replicas(mesh: Mesh, module: torch.nn.Module) -> list:
    """``module`` on each slot of the mesh (``device_put`` replicated), in
    slot order: the module itself on its own device, one copy on each other
    distinct device."""
    return list(device_put(module, replicated(mesh)).reshape(-1))


def shard_batch(mesh: Mesh, batch, axis: Optional[str] = None) -> list:
    """A batch (a tensor or array, or a dict, tuple or list of them) split
    on its leading axis over the mesh: one batch of the same structure per
    slot, in slot order, each part on its slot's device. Leaves that are not
    arrays (an ``n_valid`` int) go to every slot unchanged."""
    sharding = batch_sharding(mesh, axis)
    if len(mesh.axis_names) != 1:
        raise ValueError("shard_batch takes a 1-D mesh")

    def split(x):
        if isinstance(x, dict):
            parts = {k: split(v) for k, v in x.items()}
            return [{k: p[i] for k, p in parts.items()}
                    for i in range(mesh.size)]
        if isinstance(x, (tuple, list)):
            parts = [split(v) for v in x]
            return [type(x)(p[i] for p in parts) for i in range(mesh.size)]
        if isinstance(x, (torch.Tensor, np.ndarray)) and np.ndim(x) > 0:
            return list(device_put(x, sharding))
        return [x] * mesh.size

    return split(batch)
