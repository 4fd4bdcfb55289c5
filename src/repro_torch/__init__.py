"""PyTorch/CUDA port of the Nexus Machine reproduction.

A second package beside the JAX reference ``repro``: it imports ``torch``
and numpy only, never JAX and nothing of ``repro``.

* :mod:`repro_torch.core` — the batched cycle-level fabric simulator
  (copies of the host-side compiler modules plus the torch engine).
* :mod:`repro_torch.kernels` — hand-written CUDA kernels for the
  block-sparse products (``bcsr_spmm``, ``sddmm_blocks``) and the MoE
  expert products (``group_matmul``), each with its plain PyTorch version.
* :mod:`repro_torch.models`, :mod:`repro_torch.configs`,
  :mod:`repro_torch.sparse`, :mod:`repro_torch.serve`,
  :mod:`repro_torch.launch` — the dense / MoE language models and their
  serving launcher (``launch.serve.serve_batch``).
* :mod:`repro_torch.bench` — the benchmark grid, kernel legs, golden
  records and profiles.
* :mod:`repro_torch.convert` — numpy carry-across of reference state and
  parameters.
"""
