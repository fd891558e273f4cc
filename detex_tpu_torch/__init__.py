"""PyTorch port of detex_tpu for NVIDIA GPUs (Hopper, sm_90a).

Imports torch and never jax.  Hand-written CUDA kernels live under csrc/
and are built at first use by _build; each has a plain PyTorch version
beside its wrapper, which CPU tensors go through.
"""
