"""PyTorch ports of flowtrack_tpu/ops: crop, correlation, decode, geometry.

The hand-written kernels are custom ops of the ``flowtrack`` namespace
(``torch.ops.flowtrack.crop_frames``, ``correlation``, ``resample2d``,
``fused_stage``), registered when their modules are imported."""

from torch.utils._python_dispatch import _get_current_dispatch_mode


def cached_constant(cache: dict, key, make):
    """``make()``, a small constant tensor, made once per ``key`` and kept
    in ``cache``, so that later calls copy nothing from the host (a CUDA
    graph capture refuses such a copy). While a dispatch mode is active
    (``torch.export`` traces with fake tensors) it is made and not kept."""
    t = cache.get(key)
    if t is None:
        t = make()
        if _get_current_dispatch_mode() is None:
            cache[key] = t
    return t

