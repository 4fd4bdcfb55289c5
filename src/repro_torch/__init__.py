"""PyTorch/CUDA port of the Nexus Machine reproduction.

A second package beside the JAX reference ``repro``: it imports ``torch``
and numpy only, never JAX and nothing of ``repro``.

* :mod:`repro_torch.core` — the batched cycle-level fabric simulator
  (copies of the host-side compiler modules plus the torch engine).
* :mod:`repro_torch.kernels` — hand-written CUDA kernels for the
  block-sparse products (``bcsr_spmm``, ``sddmm_blocks``), each with its
  plain PyTorch version.
* :mod:`repro_torch.bench` — the benchmark grid and kernel legs.
* :mod:`repro_torch.convert` — numpy carry-across of reference state.
"""
