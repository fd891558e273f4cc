"""PyTorch port of detex_tpu for NVIDIA GPUs (Hopper, sm_90a).

Imports torch and never jax, and nothing of detex_tpu: the host modules it
needs (formats, texture, hdr, convert, io, native and the BPTC tables) are
its own copies.  Hand-written CUDA kernels live under csrc/ and are built
at first use by _build; each has a plain PyTorch version beside its
wrapper, which CPU tensors go through.  Entry points run on the card
unless the caller asks for the CPU (device="cpu").
"""

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device where there is no card
    raises, so nothing carries on on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for, but "
                           "torch.cuda.is_available() is false (pass "
                           "device='cpu' to run the plain versions)")
    return device
