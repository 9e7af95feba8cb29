"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) and their plain twins.

Each wrapper takes its plain PyTorch twin for CPU tensors only; for a CUDA
tensor it builds the library on first use (``build.py``), launches the kernel
or raises, and adds one to its ``launches`` counter.
"""
