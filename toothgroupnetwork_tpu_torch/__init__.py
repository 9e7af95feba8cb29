"""toothgroupnetwork_tpu_torch — the PyTorch + CUDA port of toothgroupnetwork_tpu.

The tgnet two-stage inference pipeline in PyTorch, with its TPU Pallas
kernels re-written by hand in CUDA C++ for Hopper (``csrc/``, wrapped in
``ops/kernels/``). The JAX package ``toothgroupnetwork_tpu`` is the reference
this package is tested against; this package never imports JAX or flax.
"""

__version__ = "0.1.0"
