"""Multi-device execution: the device mesh and its sharding helpers
(``mesh.py``), and data-parallel training, one process a mesh slot
(``distributed.py``).

Port of ``flowtrack_tpu/parallel``. The reference lays a 1-D mesh over its
chips and lets XLA split batches and insert the gradient reduction; the
port's inference paths split a batch over the mesh's devices from one
process, and its training runs one ``torch.distributed`` rank per slot.
"""

from flowtrack_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    NamedSharding,
    batch_sharding,
    device_put,
    make_mesh,
    mesh_for,
    pad_to_multiple,
    part,
    replicas,
    replicated,
    shard_batch,
)
