"""Hand-written kernels: per-sample spectra on Hopper GPUs (Pallas/Triton)."""

from .spectra_triton import (
    KernelConfig,
    forward_block_pallas,
    forward_block_power,
    kernel_platform,
    plan_supported,
    use_kernel,
)

__all__ = [
    "KernelConfig",
    "forward_block_pallas",
    "forward_block_power",
    "kernel_platform",
    "plan_supported",
    "use_kernel",
]
