"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W limit).  A roofline share or an MFU is
stated against these, with the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {
    "bf16": 989e12,     # tensor cores, bfloat16 and float16
    "tf32": 495e12,     # tensor cores, TF32 (the products of B5 and B5-bwd)
    "f32": 67e12,       # CUDA cores
}
