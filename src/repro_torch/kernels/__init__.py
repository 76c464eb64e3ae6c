"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), their plain
PyTorch versions, and the routing wrappers in :mod:`.ops`.

    K1 segsum_ones  segment sum of weights      csrc/segsum.cu
    K2 segsum_rows  segment sum of rows         csrc/segsum.cu
    K3 mobius       batched superset Möbius     csrc/mobius.cu
    K4 bdeu         batched BDeu family score   csrc/bdeu.cu

Nothing here compiles or imports CUDA code at import time: the library is
built by :mod:`.build` at the first launch.
"""
