"""The decode-step profile (``repro_torch.bench.profile_serve``) runs its
serving loop end to end on the reduced Phi-3.5-MoE, here on the CPU.

On the CPU the profiler records no device kernels, so only the loop and
the shape of the row are checked; the device numbers come from a run on
the card (``python -m repro_torch.bench.profile_serve``).
"""
import pytest

pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.bench.profile_serve import decode_profile  # noqa: E402


def test_decode_profile_runs_the_serving_loop_on_cpu():
    cfg = configs.get_arch("phi35_moe_42b").reduced()
    row = decode_profile(cfg, "cpu", steps=2)
    assert row["device"] == "cpu" and row["steps"] == 2
    assert row["wall_ms_per_step"] > 0
    assert row["kernel_launches_per_step"] == 0
    assert set(row) >= {"device_ms_per_step", "device_busy_share",
                        "group_matmul_device_share", "top_kernels",
                        "top_device_ops"}
