"""Nexus Machine core in PyTorch: the paper's primary contribution.

* :mod:`repro_torch.core.am` — Active Message word format (Fig. 7).
* :mod:`repro_torch.core.partition` — data placement (Algorithm 1).
* :mod:`repro_torch.core.compiler` — static compiler + runtime manager.
* :mod:`repro_torch.core.machine` — batched cycle-level fabric simulator.
* :mod:`repro_torch.core.fastforward` — its event-compressed tick.
* :mod:`repro_torch.core.batch` — padding, packing and wave planners.
* :mod:`repro_torch.core.sweep` — ``sweep(cfg, SweepRequest(...))``.
* :mod:`repro_torch.core.baselines` — systolic / generic-CGRA models.
* :mod:`repro_torch.core.metrics` — MOPS / MOPS-per-mW accounting.

``am``, ``partition``, ``compiler``, ``baselines``, ``metrics`` and
``batch`` are numpy-only copies of the reference modules of the same
names.
"""
from repro_torch.core.batch import BatchedWorkloads, stack_workloads  # noqa: F401
from repro_torch.core.machine import (  # noqa: F401
    MachineConfig, RunResult, run, run_many,
)
from repro_torch.core.sweep import (  # noqa: F401
    EngineTelemetry, PackStats, ShardStats, SweepReport, SweepRequest, sweep,
)
