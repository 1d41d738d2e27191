"""PyTorch/CUDA port of the MCOP offloading framework.

Same layout and public names as the JAX package ``repro`` (``core``,
``kernels``, ``obs``, ``service``); imports ``torch`` and ``numpy`` only.
Entry points take ``device`` (default ``"cuda"``); the solve kernels are
CUDA C++ under ``kernels/csrc`` and are compiled at first use.
"""
