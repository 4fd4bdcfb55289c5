"""Hand-written Hopper kernels for the block-sparse products.

* ``bcsr_spmm`` — block-CSR x dense (the SpMV/SpMSpM family), replacing
  the Pallas kernel ``repro/kernels/bcsr_spmm``.
* ``sddmm_blocks`` — block-sampled dense-dense matmul (sparse-attention
  SDDMM), replacing the Pallas kernel ``repro/kernels/sddmm``.

Each wrapper launches its CUDA kernel (``csrc/*.cu``, built with ``nvcc``
at first use) on CUDA tensors, runs its plain PyTorch version on CPU
tensors, and counts its launches in ``<wrapper>.launches``.
"""
from repro_torch.kernels.bcsr_spmm import bcsr_spmm, bcsr_spmm_plain  # noqa: F401
from repro_torch.kernels.sddmm import sddmm_blocks, sddmm_blocks_plain  # noqa: F401

__all__ = ["bcsr_spmm", "bcsr_spmm_plain", "sddmm_blocks",
           "sddmm_blocks_plain"]
