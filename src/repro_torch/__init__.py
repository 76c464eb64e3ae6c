"""PyTorch/CUDA port of the counting system, for an NVIDIA Hopper GPU.

``repro_torch`` mirrors the JAX package ``repro`` module by module
(``core/``, ``kernels/``, ``obs/``) and imports nothing of it, nor JAX.
The hot loops run as hand-written CUDA kernels (``kernels/csrc``) on the
card and as their plain PyTorch versions on the host.
"""
