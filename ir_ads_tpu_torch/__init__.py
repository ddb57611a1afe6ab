"""PyTorch/CUDA port of ir_ads_tpu for one NVIDIA H100.

The JAX package ``ir_ads_tpu`` is the reference; nothing here imports it or
JAX.  Kernels are hand-written CUDA C++ (csrc/), each beside a plain PyTorch
version of the same function in ops/.
"""
