"""PyTorch/CUDA port of the ScaleLLM serving system.

Module names mirror ``repro`` (the JAX package, which stays the reference):
``configs``, ``models``, ``kernels`` and ``core``. The hot kernels are CUDA
C++ for Hopper (``csrc/``), built with ``nvcc`` at first use and bound with
``ctypes``; each has a plain PyTorch version beside it that runs only on CPU
tensors. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
