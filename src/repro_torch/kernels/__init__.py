"""Hand-written Hopper kernels for the block-sparse and MoE expert products.

* ``bcsr_spmm`` — block-CSR x dense (the SpMV/SpMSpM family), replacing
  the Pallas kernel ``repro/kernels/bcsr_spmm``.
* ``sddmm_blocks`` — block-sampled dense-dense matmul (sparse-attention
  SDDMM), replacing the Pallas kernel ``repro/kernels/sddmm``.
* ``group_matmul`` / ``grouped_expert_matmul`` — ragged grouped matmul
  (MoE expert compute), replacing the Pallas kernel
  ``repro/kernels/group_matmul``.

Each wrapper launches its CUDA kernel (``csrc/*.cu``, built with ``nvcc``
at first use) on CUDA tensors, runs its plain PyTorch version on CPU
tensors, and counts its launches in ``<wrapper>.launches``.
"""
from repro_torch.kernels.bcsr_spmm import bcsr_spmm, bcsr_spmm_plain  # noqa: F401
from repro_torch.kernels.group_matmul import (  # noqa: F401
    group_matmul, group_matmul_plain, grouped_expert_matmul)
from repro_torch.kernels.sddmm import sddmm_blocks, sddmm_blocks_plain  # noqa: F401

__all__ = ["bcsr_spmm", "bcsr_spmm_plain", "group_matmul",
           "group_matmul_plain", "grouped_expert_matmul", "sddmm_blocks",
           "sddmm_blocks_plain"]
