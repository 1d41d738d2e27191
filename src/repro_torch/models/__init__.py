"""Model stack: every family of the JAX package (dense, MoE with GQA or MLA,
VLM, encoder-decoder, hybrid, SSM), layer by layer, in PyTorch."""
