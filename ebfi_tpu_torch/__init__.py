"""PyTorch/CUDA port of the EVFIAutoEx blurry-frame interpolation system.

Sits beside the JAX package and is held against it.  Public functions keep
the JAX package's NHWC layout and tap-major kernel-bank order; the three
Pallas TPU kernels are hand-written CUDA C++ for Hopper (``csrc/``), built
with ``nvcc`` on first use and bound with ``ctypes`` (``ops/cuda/``).  On a
CPU tensor every kernel wrapper runs its plain PyTorch version instead.
"""
__version__ = "0.1.0"
