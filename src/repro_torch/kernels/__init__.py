"""Hand-written CUDA kernels (``csrc/``), the build script, and the plain
PyTorch version that stands beside each.  Importing this package compiles
nothing; a kernel is built the first time its wrapper gets a CUDA tensor.
The model-layout wrappers are in ``kernels.ops`` (not re-exported here, so
that ``kernels.flash_attention`` names the kernel's module); its MCOP host
loop ``mcop_min_cut`` is, as in the JAX package.
"""

from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.mamba_scan import mamba_chunk_scan_kernel
from repro_torch.kernels.mcop_phase import (
    FUSED_MODEL_KINDS,
    LAUNCHES,
    fused_solve_plain,
    mcop_fused_solve_kernel,
    mcop_phase_kernel,
    mcop_stoer_wagner_kernel,
    reset_launches,
    stoer_wagner_plain,
)
from repro_torch.kernels.ops import mcop_min_cut
from repro_torch.kernels.ref import (
    flash_attention_plain,
    mamba_chunk_scan_plain,
    mcop_phase_plain,
)

__all__ = [
    "FUSED_MODEL_KINDS",
    "LAUNCHES",
    "flash_attention_kernel",
    "flash_attention_plain",
    "fused_solve_plain",
    "mamba_chunk_scan_kernel",
    "mamba_chunk_scan_plain",
    "mcop_fused_solve_kernel",
    "mcop_min_cut",
    "mcop_phase_kernel",
    "mcop_phase_plain",
    "mcop_stoer_wagner_kernel",
    "reset_launches",
    "stoer_wagner_plain",
]
