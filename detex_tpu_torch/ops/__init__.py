"""Block decoders: CUDA kernel wrappers and their plain PyTorch versions."""
