"""Model stack: the hybrid (zamba2) family, layer by layer, in PyTorch."""
