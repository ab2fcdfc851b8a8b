"""The benchmark of ``flowtrack_tpu_torch`` on an NVIDIA H100 (see
``run.py``). It imports neither JAX nor the JAX package."""
