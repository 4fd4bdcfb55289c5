"""The port's sparse containers (``CSR``, ``BCSR``, ``random_csr``) and the
float oracles of :mod:`repro_torch.sparse.ops`."""
from repro_torch.sparse.formats import BCSR, CSR, random_csr  # noqa: F401

__all__ = ["BCSR", "CSR", "random_csr"]
