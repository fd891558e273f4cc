"""The least time a texture's decode can take on the card (each block's 16
bytes read once and its 64 bytes of RGBA8 written once, at HBM's 3.35e12
B/s; dtxbench.flops) over the device time of a call's kernels: decode,
zeroing and assembly, from the device trace.  What the implementation
keeps besides (valid flags, intermediate tiles) is not counted, so a fused
kernel is read against the same work."""

from dtxbench import flops
from dtxbench.metrics import device_time


def read(summary):
    kernel = device_time(summary, "kernel_s")
    work = (summary or {}).get("work", {})
    if not kernel or not work.get("calls"):
        return None
    least = flops.texture_least_s(work["blocks_per_call"])
    return 100.0 * least / (kernel / work["calls"])
