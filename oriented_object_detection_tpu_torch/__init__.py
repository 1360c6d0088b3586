"""PyTorch/CUDA port of the oriented-object-detection package.

Runs beside the JAX package and holds to its outputs. Plain tensor code is
PyTorch; the two exact-EDT passes of the DT-Edge channel are CUDA C++
kernels (``csrc/edt.cu``) built with ``nvcc`` at first use and bound through
``ctypes``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
