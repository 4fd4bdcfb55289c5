"""The decode-step and training-step profiles
(``repro_torch.bench.profile_serve``, ``repro_torch.bench.profile_train``)
run their loops end to end on reduced configs (the decode step on
Phi-3.5-MoE and on each other decoder family), here on the CPU.

On the CPU the profiler records no device kernels, so only the loops and
the shape of the rows are checked; the device numbers come from a run on
the card (``python -m repro_torch.bench.profile_serve`` and
``python -m repro_torch.bench.profile_train``).
"""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.bench.profile_serve import (decode_profile,  # noqa: E402
                                             serve_config)


@pytest.mark.parametrize("arch", ["phi35_moe_42b", "deepseek_v2_lite_16b",
                                  "zamba2_1p2b", "xlstm_350m",
                                  "llava_next_mistral_7b"])
def test_decode_profile_runs_the_serving_loop_on_cpu(arch):
    cfg = configs.get_arch(arch).reduced()
    row = decode_profile(cfg, "cpu", steps=2)
    assert row["device"] == "cpu" and row["steps"] == 2
    assert row["arch"] == cfg.name
    assert row["wall_ms_per_step"] > 0
    assert row["kernel_launches_per_step"] == 0
    assert set(row) >= {"device_ms_per_step", "device_busy_share",
                        "group_matmul_device_share", "top_kernels",
                        "top_device_ops"}


def test_serve_config_cuts_only_phi():
    """``--arch`` builds the full-width config, cut in depth only where
    ``chip_smoke.py``'s serving run cuts it (Phi-3.5-MoE, 32 -> 4)."""
    assert serve_config("phi3.5-moe-42b-a6.6b").n_layers == 4
    cfg = serve_config("deepseek-v2-lite-16b")
    assert cfg == configs.get_arch("deepseek_v2_lite_16b")
    assert cfg.n_layers == 27 and cfg.d_model == 2048


def test_train_profile_runs_the_train_step_on_cpu():
    """The training-step profile (``repro_torch.bench.profile_train``) on
    the reduced Phi-3.5-MoE: the timed steps, the two halves and the
    profiled steps run; the CPU launches no kernel."""
    from repro_torch.bench.profile_train import LEGS, train_profile
    cfg = configs.get_arch("phi35_moe_42b").reduced()
    row = train_profile(cfg, "cpu", batch=2, seq=16, lr=3e-4, steps=2)
    assert row["device"] == "cpu" and row["steps"] == 2
    assert row["wall_ms_per_step"] > 0 and row["adamw_wall_ms"] > 0
    assert row["fwd_bwd_wall_ms"] > 0 and row["tokens_per_s"] > 0
    assert row["group_matmul_launches_per_step"] == 0
    assert row["kernel_launches_per_step"] == 0
    assert set(row) >= {"device_ms_per_step", "device_busy_share",
                        "group_matmul_device_share", "top_kernels",
                        "top_device_ops", "peak_mem_bytes"}
    assert LEGS["moe"][0].d_model == 4096 and LEGS["moe"][0].n_layers == 2
    assert LEGS["moe"][1]["lr"] == 3e-4 and LEGS["dense"][1]["lr"] == 1e-3


@pytest.mark.parametrize("arch", ["hubert-xlarge", "llava-next-mistral-7b",
                                  "deepseek-v2-lite-16b", "zamba2-1.2b",
                                  "xlstm-350m"])
def test_family_train_legs_profile_on_cpu(arch):
    """``profile_train --arch``: each family's leg is full width (depth cut
    only where stated) and its profile runs on the reduced config with one
    ``synth_batch`` at every step."""
    from repro_torch.bench.profile_train import FAMILY_LEGS, train_profile
    cfg, traffic = FAMILY_LEGS[arch]
    full = configs.get_arch(configs.ALIASES[arch])
    assert dataclasses.replace(cfg, n_layers=full.n_layers,
                               remat=full.remat) == full
    assert cfg.n_layers == {"llava-next-mistral-7b": 8,
                            "deepseek-v2-lite-16b": 4}.get(arch,
                                                           full.n_layers)
    assert traffic["lr"] == (2e-5 if arch == "llava-next-mistral-7b"
                             else 3e-4) and traffic["steps"] == 4
    row = train_profile(cfg.reduced(), "cpu", batch=2, seq=16, lr=3e-4,
                        steps=1, synth=True)
    assert row["arch"] == cfg.name and row["wall_ms_per_step"] > 0
    assert row["group_matmul_launches_per_step"] == 0
