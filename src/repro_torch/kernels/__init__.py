"""Hand-written CUDA kernels (``csrc/``), the build script, and the plain
PyTorch version that stands beside each.  Importing this package compiles
nothing; a kernel is built the first time its wrapper gets a CUDA tensor.
"""

from repro_torch.kernels.mcop_phase import (
    FUSED_MODEL_KINDS,
    LAUNCHES,
    fused_solve_plain,
    mcop_fused_solve_kernel,
    mcop_stoer_wagner_kernel,
    reset_launches,
    stoer_wagner_plain,
)

__all__ = [
    "FUSED_MODEL_KINDS",
    "LAUNCHES",
    "fused_solve_plain",
    "mcop_fused_solve_kernel",
    "mcop_stoer_wagner_kernel",
    "reset_launches",
    "stoer_wagner_plain",
]
