"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build every CUDA kernel under ``src/repro_torch/csrc`` with ``nvcc``
   (in parallel) and print the build seconds and ptxas reports;
2. print the card's name and power limit, and turn TF32 off;
   then the engine chunk (``[cycle]``, :func:`run_cycle`): grid A's batch
   and the chain's, at both speeds, stepped from one initial state by
   the kernel ``csrc/cycle.cu`` (``kernels.cycle.cycle_chunk``) and by
   its plain version in 512-tick chunks, every leaf of the state equal
   bit for bit after each of the first two chunks; the kernel's chunk
   timed with CUDA events beside the plain version's, its bound and its
   barrier floor (``cycle_floor``), and so are the chain's compressed
   chunk and one chunk of the first packed wave of the fig17 sweep leg;
3. the simulator and kernel-leg path, every launch count set to 0 just
   before it and read just after (``cycle_chunk``'s before and after each
   of ``[sim]``, ``[sweep]``, ``[service]``, ``[figures]`` and
   ``[shard]``, each of which must have stepped its engine chunks on the
   kernel, and ``[static]``, which must not: the static golden engines
   are oracles that run the plain loop): the paper grids (grid A: 13 workloads x
   nexus/tia/tia_valiant at 4x4; grid B: spmv/sddmm/bfs under nexus at
   2x2, 4x4, 8x8) through ``repro_torch.bench.harness``, then the
   ``bcsr_spmm``, ``sddmm`` and ``group_matmul`` benchmark legs in f32 and
   bf16; every lane must complete, pass its workload's numpy oracle and
   equal the JAX reference's golden records
   (``src/repro_torch/golden/paper_grid.json``) bit for bit, each leg must
   agree with its kernel's plain PyTorch version (rtol = atol = 1e-4 in
   f32, 2e-2 in bf16), and each of the three kernels must have been
   launched; then ``group_matmul``'s tensor-core shape on integer-valued
   bf16 operands (``bench.kernels.tc_exact``: tile_m 17 to 130, sums exact
   in f32), with w as stored and transposed, must equal the plain version
   bit for bit, and so must its TMA weight stream
   (``bench.kernels.stream_exact``: tile_m 1, 8, 13 and 16, bf16 and f32,
   units whole and cut over several CTAs).  Between the grids and the kernel legs, the ``[sweep]``
   legs run through ``repro_torch.core.sweep.sweep(..., device="cuda")``
   and are held to ``src/repro_torch/golden/sweeps.json`` (every lane bit
   for bit, the packing schedule and the engine telemetry field for
   field): the packed Fig. 17 grid, the 256-node pointer chase (8 lanes
   at 8x8) on the fast-forward and on the plain engine, and a packed leg
   with a per-lane deadline (:data:`SWEEP_LEGS`); each prints its wall, engine ticks, lane-cycles/s,
   dead-step fraction, waves, packing efficiency and peak memory.  After
   the ``[sweep]`` legs, the ``[service]`` phase drives the resident
   sweep service (``repro_torch.serve.SweepService``) on the card: the
   chaos soak of ``repro_torch.bench.chaos_soak`` (seed 5: the
   ``fig17_traffic(copies=2)`` lanes at chunk 8 with seeded transients
   and a scheduler kill, a deadline lane cut at half its cycles,
   duplicates, a checkpoint every 2 slices, then a restore from the
   middle checkpoint that finishes the in-flight lanes) and one clean
   ``serve_bench.soak`` round of the same traffic; every survivor,
   duplicate and restored lane must equal its record in
   ``src/repro_torch/golden/service.json`` bit for bit, the deadline
   lane must freeze exactly at its bound with the reference's frozen
   record, both a transient and a kill must have fired, and the clean
   soak must have run on one cached engine.  After the kernel legs, the
   paper-figure drivers (``[figures]``, :func:`run_figures`): grid A's
   rows from this phase's run (not run again) with the host CGRA and
   systolic models through ``harness.build_table``, then the Figs. 11-14
   and Table 2 formatters, each dict and printed text equal to the same
   formatter's over the table of ``paper_grid.json``'s grid A records
   (the headline ratios printed); Fig. 16's simulated sparsity axis
   (SpMSpM n = 24 at 0.30 / 0.60 / 0.85 on 4x4, one packed sweep) and
   ``fabric_autotune("bfs")`` over the five ``FABRIC_SIZES``, both equal
   to the reference's records in ``src/repro_torch/golden/bench_drivers
   .json``; and ``repro_torch.bench.bench_ci --skip-fig17`` (the smoke
   grid against ``golden/bench_smoke.json``, the shard leg, one cached
   engine, the static cost model's correlation, the smoke service and the
   128-node pointer chase on both engines), which must exit 0;
4. the serving path, launch counts again from 0: Phi-3.5-MoE at full
   width (d 4096, 32/8 heads of 128, 16 experts top-2 of 6400, vocab
   32064), depth cut to 4 layers, bf16 parameters from a seeded
   generator, serving the 6 requests of ``examples/serve_moe.py`` (8 new
   tokens, 3 slots, cache 128) through ``repro_torch.launch.serve``, three
   times on the same parameters (median and spread of the speeds); every
   request must get its 8 tokens in [0, vocab), the same in every serve,
   the prefill logits must be finite, ``group_matmul`` must have been
   launched, and its outputs in the first prefill's and first decode
   step's three expert products of layer 0 must agree with the plain
   version (rtol = atol = 2e-2, and max |err| within 2e-2 of the plain
   product's max |value|);
5. the reduced Phi-3.5-MoE (2 layers, d 128, 4 experts) served with f32
   parameters on the card, its greedy tokens held to the reference's in
   ``src/repro_torch/golden/serve_reduced.json`` up to each request's
   first token won by a top-2 logit margin under 1e-3;
6. the training path (``[train]``), after the serving parameters are
   freed, through ``repro_torch.launch.train.train`` on the card, each
   leg with the launch counts from 0: Phi-3.5-MoE at full width, depth
   cut to 2 layers, bf16 parameters from a generator seeded with 0, 6
   AdamW steps of ``train()``'s default traffic (batch 8, seq 128, lr
   3e-4) on the synthetic Zipf stream; every loss must be finite, the
   last two losses' mean under the first two's, ``group_matmul`` launched
   3 times a layer a step forward and 3 times for the backward's dx, and
   layer 0's three forward products and three dx products of the second
   step must agree with the plain version (rtol = atol = 2e-2, and max
   |err| within 2e-2 of the plain product's max |value|, since the dx of
   a mean loss is orders of magnitude below 2e-2); then the reduced
   Phi-3.5-MoE in f32 held to the reference's losses, aux losses and
   gradient norms in ``src/repro_torch/golden/train_reduced.json`` (rtol
   ``golden.TRAIN_RTOL``, 1e-5, the CPU tests'), the same run with TF32
   products read against that limit (not held), and again with a
   checkpoint every 2 steps and a failure at step 5, whose restart must
   end on the clean run's loss (rtol 1e-5); then the 100M example's
   model (``repro-100m``) for 30 steps (batch 4, seq 128, lr 1e-3), its
   last three losses' mean under the first three's (the full-width and
   100M legs are ``repro_torch.bench.profile_train.LEGS``);
7. the other model families (``[families]``), one at a time with memory
   freed between them and the launch counts from 0 in each serve, at full
   width and depth with bf16 parameters from a generator seeded with 0:
   DeepSeek-V2-Lite (27 layers, MLA, 64 experts top-6 with 2 shared),
   Zamba2-1.2B (38 Mamba-2 layers and the shared attention), xLSTM-350M
   (24 layers) and LLaVA-NeXT-Mistral-7B (32 layers, text) each serve the
   6 requests once (every request its 8 tokens in [0, vocab));
   ``group_matmul`` must have been launched on DeepSeek's path and its
   layer-0 expert products of the first prefill and decode step must
   agree with the plain version as the Phi products do, and no other
   family may launch it; LLaVA prefills 2,880 anyres patches of 1,024
   before 16 tokens (logits (1, 2896, 32000)) and HuBERT-XLarge encodes 2
   x 512 frames (logits (2, 512, 504)), both finite; then the reduced
   families in f32 are held to ``src/repro_torch/golden/families_reduced
   .json`` (served tokens up to the 1e-3 margin, encode and vision
   logits within 1e-4);
8. the families' training (``[train-families]``), one at a time with
   memory freed between them and the launch counts from 0 in each, each
   leg of ``repro_torch.bench.profile_train.FAMILY_LEGS``: bf16 parameters
   from a generator seeded with 0 and 4 AdamW steps (lr 3e-4; LLaVA's
   2e-5, its own fine-tuning rate) of
   ``make_train_step`` on one ``synth_batch`` of that generator:
   HuBERT-XLarge whole (2 x 512 frames), LLaVA-NeXT-Mistral-7B cut to 8
   layers (its 2,880 patches and 16 tokens), DeepSeek-V2-Lite cut to 4
   layers, Zamba2-1.2B and xLSTM-350M whole (4 x 128 tokens each; the
   xLSTM recomputes each layer in the backward); every loss finite and
   the last under the first, ``group_matmul`` launched for each of
   DeepSeek's expert products forward and for its dx, its layer-0
   products of the second step held to the plain version as the Phi
   ones, and no other family launching it; then the reduced families in
   f32 held to ``src/repro_torch/golden/train_families_reduced.json``
   (rtol ``golden.TRAIN_RTOL``, 1e-5);
9. the static golden engine (``[static]``): grid A's 13 nexus lanes at
   4x4 through ``MachineConfig(traced_modes=False, traced_geometry=
   False)``, every lane equal to ``paper_grid.json`` bit for bit and
   ``machine.is_idle`` of the final state true, with the wall, the engine
   ticks and the launches and milliseconds of a static tick beside a
   traced tick of the same lanes; then the scale layer's oracles
   (``[sparse]``): the six ops of ``repro_torch.sparse.ops`` on
   ``random_csr`` matrices of 1,024 x 1,024 at 1% against float64 numpy
   within 1e-4 (the f32 ``bcsr_spmm`` leg of phase 3 is also held to
   ``sparse.ops.bcsr_spmm``);
10. the multi-device slice on logical shards of the one card
   (``repro_torch.bench.multidevice``; ``[shard]``): the legs of
   ``src/repro_torch/golden/shard.json`` (the reference's ``sweep(...,
   shard=True)`` under four forced host devices: the 18-lane workload x
   mode x size grid, 5 lanes with 3 inert pad lanes, 2 lanes capping the
   split at 2, and the grid packed) through ``sweep(..., devices=
   [cuda:0] * 4)``, each held to its record bit for bit (lanes, the
   shard plan, the packing schedule and the per-shard telemetry) and to
   its workloads' oracles, with its wall, each engine call's ticks per
   shard and the engine cache's size; then a ``SweepService`` with 4 super-lanes over
   ``[cuda:0] * 2`` (two shards, ``slice_chunks=1``) on the lanes of
   ``fig17_traffic(copies=1)``, every lane held to its record in
   ``service.json``; then the AM dispatch (``[dispatch]``):
   ``spmv_sharded`` over 8 logical shards of an 8,192 x 8,192 power-law
   matrix (``repro_torch.launch.sparse_dispatch``'s generator) within
   1e-3 of a float64 ``a @ x``, plain and with ``opportunistic=True`` at
   the worst bucket's capacity, and ``psum_compressed`` over 4 shards of
   seeded f32 gradients of the ``repro-100m`` parameter tree's shapes,
   each shard's sum held to the float64 sum of the dequantized payloads
   (within 1e-6 of the sum of the terms' magnitudes) and each shard's
   error to ``compress_tree``'s bit for bit, with the max errors, wall
   ms and bytes moved;
11. model parallelism (``[mesh]``), launch counts from 0 in each serve:
   four ranks as threads of this process on the card (torch's
   ``threaded`` process group, :func:`thread_ranks`) over a (2, 2)
   ``("data", "model")`` ``DeviceMesh``.  Two full-width MoE configs
   serve the 6 requests at 4 slots (:data:`MESH_TRAFFIC`) through
   ``serve_batch(mesh=)`` after the same serve unsharded
   (:func:`run_mesh_serve`): Phi-3.5-MoE at :data:`SERVE_CFG`'s width and
   depth (8 local experts a rank), then DeepSeek-V2-Lite with its MLA
   (:data:`MESH_DEEPSEEK_CFG`, 4 of 27 layers, 32 local experts a rank),
   each from a generator seeded with 0; every rank must launch
   ``group_matmul`` on its local experts (and the launches sum to the
   ranks' expert products), rank 0's layer-0 products of the first
   prefill and decode step must agree with the plain version, every
   rank must serve the same tokens, the serve is run once more unsharded,
   fed the mesh's tokens and replaying its routing, and every forward's
   last logits must lie within 2e-2 of max |plain| (the first forward's
   residual stream is compared block by block, and the free unsharded
   serve's tokens up to the first whose top-2 margin is below the logit
   error); wall, peak memory and launches are printed.  Then the reduced
   Phi-3.5-MoE and Minitron-4B in f32 over (2, 2): logits within 1e-5 of
   the unsharded forward, ``serve_batch(mesh=)``'s tokens equal, two
   ``train(mesh=)`` steps within 1e-5 relative of the unsharded run
   (Phi's also of ``train_reduced.json``), and Phi's checkpoint written
   under (2, 2) restored onto (1, 4) and (4, 1) bit for bit, training
   resumed on each to the clean run's loss; then the reduced
   DeepSeek-V2-Lite (MLA), Zamba2-1.2B (Mamba-2 hybrid), xLSTM-350M,
   HuBERT-XLarge (audio encoder) and LLaVA-NeXT (vision prefill) in f32
   over (2, 2) (:func:`run_mesh_families_reduced`): the forward within
   1e-5 of unsharded (HuBERT's encode, LLaVA's patches, Zamba2 also
   sequence-parallel), for the decoders a prefill and a decode step over
   f32 caches and the caches after them within 1e-5 and
   ``serve_batch(mesh=)``'s tokens equal (the record's traffic), two steps of
   the training record within 1e-5 relative; and rank 0 held to the
   reference's ``families_reduced.json`` (served tokens, encode and
   vision logits) and ``train_families_reduced.json``;
12. the dry run and the roofline (``[dryrun]``), after the ``[mesh]``
   ranks are gone: the counter's rule for ``DTensor``s on this torch
   (a product of two split matrices on 512 fake ranks counts rank 0's
   1,048,576 FLOPs and its redistribution a 2,048-byte all-gather); one
   greedy decode step of Phi-3.5-MoE at full width, 2 of 32 layers, 4
   slots against a 512-token cache, on the card under
   ``repro_torch.launch.roofline.Counter`` with ``group_matmul``
   launched 3 times a layer, whose FLOPs and eager bytes must equal
   the same step's on fake ``cuda`` tensors exactly, and its median
   CUDA-event time over 10 steps beside its bound at the H100 constants
   (``t_compute``, ``t_memory``, the bound's share of the time), and
   the host time the ``repro_torch::group_matmul`` operator adds to a
   call over its implementation; then ``dryrun.run_cell(device="cuda")`` of Phi-3.5-MoE's
   ``decode_32k`` on the 16 x 16 mesh of 256 fake ranks and Zamba2's
   ``long_500k`` on the 2 x 16 x 16 mesh of 512 (every record printed),
   which must allocate nothing on the card and leave no process group;
13. time each kernel and its plain version with CUDA events over
   CUDA-graph replays, and one PyTorch library call of the same function
   with CUDA events over back-to-back calls (median of 21 each; fewer at
   the training shapes, whose plain version takes tens of ms), at the
   f32 legs' shapes and, for ``group_matmul``, also at the serving
   paths' decode and prefill shapes and the training paths' forward and
   dx shapes (the dx as the training path runs it: one transposed
   product reading ``w`` in place), each with the CTA shape the launcher
   took (``cta_shape``; on the weight stream with its split: CTAs, stages
   a CTA, CTAs a unit); compute each kernel's bound from the bytes and FLOPs its
   data needs, its share of that bound (``bound_share``) and its time
   over the library call's (``vs_library``);
14. print the kernels line (a row per leg with the legs' launches, a
   ``cycle_chunk`` row (the ``[cycle]`` timings, the ``[sim]`` grids'
   launches and every phase's),
   ``bcsr_spmm``'s with the cluster split ``S`` its wrapper launched, a
   ``group_matmul_serve`` row at Phi's decode shape, with ``wo`` and the
   prefill's ``prefill_wg`` / ``prefill_wo`` in it, with the serving
   path's launches, ``group_matmul_train`` / ``group_matmul_train_dx``
   rows at the training leg's ``wg`` shapes, with ``wo`` in each, with the
   training path's forward and dx launches, and a
   ``group_matmul_deepseek_serve`` row as the Phi one at DeepSeek's
   shapes with its serve's launches, and ``group_matmul_deepseek_train``
   / ``group_matmul_deepseek_train_dx`` rows as the Phi training ones at
   DeepSeek's training shapes, with their launches a step, and a
   ``group_matmul_mesh_serve`` and a ``group_matmul_deepseek_mesh_serve``
   row at rank 0's local shapes of the ``[mesh]`` serves with the
   launches of their four ranks), the card line and, last, the ok line.

Needs one card, and exits non-zero without printing a result when CUDA
is not available.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.bench import golden, harness, multidevice  # noqa: E402
from repro_torch.bench import chaos_soak, serve_bench  # noqa: E402
from repro_torch.bench import (bench_ci, fig11_performance,  # noqa: E402
                               fig12_perf_watt, fig13_utilization,
                               fig14_congestion, fig16_bandwidth,
                               hillclimb, table2_efficiency)
from repro_torch.bench import dryrun_check  # noqa: E402
from repro_torch.bench import kernels as bench_kernels  # noqa: E402
from repro_torch.bench.profile_serve import serve_config  # noqa: E402
from repro_torch.bench.profile_engine import (  # noqa: E402
    chain_batch, event_ms, fig17_wave_batch, floor_ms, grid_a_batch,
    grid_a_engine, lone_speed, profile_ticks)
from repro_torch.bench.profile_train import FAMILY_LEGS  # noqa: E402
from repro_torch.bench.profile_train import LEGS as TRAIN_LEGS  # noqa: E402
from repro_torch.bench.workloads import make_all  # noqa: E402
from repro_torch.checkpoint.store import restore_checkpoint  # noqa: E402
from repro_torch.core import machine  # noqa: E402
from repro_torch.core.sweep import SweepRequest, sweep  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.distributed import context as dctx  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels import (_build, bcsr_spmm, group_matmul,  # noqa: E402
                                 group_matmul_plain, sddmm_blocks)
from repro_torch.kernels.bcsr_spmm import launch_split  # noqa: E402
from repro_torch.kernels.cycle import (  # noqa: E402
    chunk_bytes, clone_state, cycle_chunk, cycle_chunk_plain,
    first_difference)
from repro_torch.kernels.group_matmul import (  # noqa: E402
    expert_product, launch_plan, launch_shape, tile_by_expert)
from repro_torch.launch import dryrun, serve  # noqa: E402
from repro_torch.launch import train as trainer  # noqa: E402
from repro_torch.launch.mesh import device_mesh  # noqa: E402
from repro_torch.launch.train_100m import tokens_per_s  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.serve.steps import encode_step, make_prefill_step  # noqa: E402
from repro_torch.sparse import ops as sparse_ops  # noqa: E402
from repro_torch.sparse.formats import BCSR, random_csr  # noqa: E402
from repro_torch.train.optimizer import (AdamWState, adamw_init,  # noqa: E402
                                         tree_leaves)
from repro_torch.train.step import make_train_step, synth_batch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s outside the
# tensor cores and dense bf16 FLOP/s on them.  A bound takes the peak of
# the inputs' type (the kernels run plain f32 FMA and widen bf16 inputs,
# so for bf16 the bound is the card's, not the kernel's design's)
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
#: the full-width serving run: Phi-3.5-MoE, depth cut 32 -> 4 layers (the
#: 41.9 B parameters are 83.7 GB in bf16, more than the card's 80 GB): the
#: config that ``repro_torch.bench.profile_serve`` profiles
SERVE_CFG = serve_config("phi35_moe_42b")
SERVE_TRAFFIC = dict(max_new_tokens=8, batch_slots=3, cache_len=128)
#: serves of that traffic in one run (one pass is ~1.5 s, too short to
#: read the speed from once): their median and spread are reported
SERVE_REPEATS = 3
#: the full-width training run (Phi-3.5-MoE, depth cut 32 -> 2 layers)
#: and the 100M example's model, with their traffic: the legs that
#: ``repro_torch.bench.profile_train`` profiles
TRAIN_CFG, TRAIN_TRAFFIC = TRAIN_LEGS["moe"]
DENSE_CFG, DENSE_TRAFFIC = TRAIN_LEGS["dense"]
#: the step of the training run whose layer-0 expert products are held to
#: the plain version (the second)
TRAIN_RECORD_STEP = 1
#: the ``[families]`` phase at full width and depth (the archs of
#: ``golden.FAMILIES_SPEC``): HuBERT-XLarge encodes seeded frames (batch,
#: frames of 512) and LLaVA-NeXT prefills its 2,880 anyres patches before
#: seeded tokens
ENCODE_FRAMES = (2, 512)
VISION_TOKENS = 16
#: the ``[sweep]`` legs of ``golden.SWEEPS`` run here: every leg, since
#: the engine chunk kernel took the packed Fig. 17 grid (116-189 s on the
#: torch-op engine, cut from the script until then) to seconds
SWEEP_LEGS = ("fig17", "chain", "deadline")
#: the bf16 tolerance of a recorded expert product against its plain
#: version: elementwise (rtol = atol) and, since a backward's dx is many
#: orders of magnitude below 1, also max |err| over max |plain|
BF16_TOL = 2e-2
#: the ``[sparse]`` oracles against float64 numpy (rtol = atol), the f32
#: tolerance of the kernel legs
SPARSE_TOL = 1e-4
KERNELS = {
    "bcsr_spmm": dict(wrapper=bcsr_spmm,
                      source="src/repro_torch/csrc/bcsr_spmm.cu",
                      replaces="src/repro/kernels/bcsr_spmm/kernel.py:40"),
    "sddmm_blocks": dict(wrapper=sddmm_blocks,
                         source="src/repro_torch/csrc/sddmm.cu",
                         replaces="src/repro/kernels/sddmm/kernel.py:39"),
    "group_matmul": dict(wrapper=group_matmul,
                         source="src/repro_torch/csrc/group_matmul.cu",
                         replaces="src/repro/kernels/group_matmul/"
                                  "kernel.py:42"),
}


def thread_ranks(fn, world_size: int = 4, timeout: float = 1500.0) -> list:
    """``fn(rank)`` on ``world_size`` ranks, each a thread of this process
    in torch's ``threaded`` process group, whose collectives are copies
    between the threads' tensors: every rank may use the one card.
    Returns each rank's result; a rank's error is raised here (the other
    ranks are woken and stopped first).  The group comes from torch's own
    test harness (``torch.testing._internal``), which only this script
    and the tests import; the package never does."""
    import threading
    import torch.distributed as dist
    from torch.testing._internal.distributed.multi_threaded_pg import (
        ProcessLocalGroup, _install_threaded_pg, _uninstall_threaded_pg)
    _install_threaded_pg()
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    store = dist.HashStore()
    out, errs = [None] * world_size, [None] * world_size
    card = torch.cuda.current_device() if torch.cuda.is_available() else None

    def work(rank):
        try:
            if card is not None:
                torch.cuda.set_device(card)
            dist.init_process_group("threaded", rank=rank,
                                    world_size=world_size, store=store)
            out[rank] = fn(rank)
        except BaseException as e:  # noqa: BLE001 — raised by the caller
            errs[rank] = e
            ProcessLocalGroup.exception_handle(e)

    threads = [threading.Thread(target=work, args=(r,), daemon=True)
               for r in range(world_size)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
        if any(t.is_alive() for t in threads):
            raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        ProcessLocalGroup.reset()
        _uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
    err = next((e for e in errs if e is not None
                and not isinstance(e, SystemExit)), None) or \
        next((e for e in errs if e is not None), None)
    if err is not None:
        raise err
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 21, inner: int = 10) -> float:
    """Median device milliseconds of one ``fn()`` call: ``inner`` calls
    are captured in a CUDA graph, and each of ``reps`` replays is timed
    with CUDA events (so the wrappers' host overhead does not count)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(nbytes: int, flops: int, dtype) -> dict:
    """The least time the card could take: bytes over HBM's rate against
    FLOPs over the peak of ``dtype``."""
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def library_call(name: str, args: dict):
    """One PyTorch call computing the leg's function (the yardstick;
    the port never calls it): a BSR sparse-dense product, or a batched
    matmul of the pre-gathered panels or of the expert-grouped rows."""
    if name == "bcsr_spmm":
        a, b = args["a"], args["b"]
        live = a.n_blocks
        sp = torch.sparse_bsr_tensor(
            a.indptr, a.indices[:live], a.blocks[:live], size=a.shape,
            check_invariants=True)
        return lambda: torch.sparse.mm(sp, b)
    if name == "group_matmul":
        w = args["w"]
        xe = args["x"].reshape(w.shape[0], -1, w.shape[1])
        return lambda: torch.bmm(xe, w)
    bm, bn = args["bm"], args["bn"]
    a, b = args["a"], args["b"]
    d = a.shape[1]
    arows = a.reshape(-1, bm, d)[args["brow"].long()]
    bcols = b.reshape(d, -1, bn).permute(1, 0, 2)[args["bcol"].long()]
    return lambda: torch.bmm(arows, bcols)


def library_ms(fn, reps: int = 21, inner: int = 10) -> float:
    """Median device milliseconds of one library call, timed with CUDA
    events around ``inner`` back-to-back calls (no graph capture: a
    library may allocate inside the call)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def run_grids() -> tuple[dict, tuple]:
    """Grids A and B on the card, held to the golden records.  Returns the
    stats and grid A's ``(lanes, wall)``."""
    want = golden.load_golden()
    all_wls = make_all()
    stats = {}
    kept = {}
    for name, spec in golden.GRIDS.items():
        wls = golden.grid_workloads(spec, all_wls)
        torch.cuda.reset_peak_memory_stats()
        tel: dict = {}
        lanes, wall = harness.run_grid_lanes(
            wls, spec["modes"], max_cycles=golden.MAX_CYCLES,
            sizes=spec["sizes"], device="cuda", telemetry=tel)
        got = {golden.lane_key(ln.workload.name, ln.mode, ln.size):
               golden.lane_record(ln.result) for ln in lanes}
        golden.check_lanes(got, want[name]["lanes"])
        kept[name] = lanes, wall
        cycles = [ln.result.cycles for ln in lanes]
        # one engine call over every lane, each padded to the widest mesh
        rows = len(lanes) * max(int(np.prod(ln.size or (4, 4)))
                                for ln in lanes)
        ticks = tel["stepped_pe_ticks"] // rows
        stats[name] = dict(
            lanes=len(lanes), wall_s=wall, lane_cycles=sum(cycles),
            engine_ticks=ticks, lane_cycles_per_s=sum(cycles) / wall,
            engine_ticks_per_s=ticks / wall,
            dead_step_fraction=tel["dead_step_fraction"],
            peak_mem_bytes=torch.cuda.max_memory_allocated())
        print(f"[sim] {name}: {len(lanes)} lanes match the golden records; "
              f"{json.dumps(stats[name])}", flush=True)
    return stats, kept["grid_a"]


#: the ``[figures]`` formatters over the Figs. 11-14 table
FIGURES = {"fig11": fig11_performance, "fig12": fig12_perf_watt,
           "fig13": fig13_utilization, "fig14": fig14_congestion,
           "table2": table2_efficiency}


def _quiet(fn, *args, **kw):
    """``fn``'s result and the text it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def run_figures(grid_a: tuple, device="cuda") -> dict:
    """The paper-figure drivers on the card: the Figs. 11-14 and Table 2
    formatters over grid A's rows (held to the same formatters over the
    reference's records), Fig. 16's simulated axis and the fabric
    autotuner (held to ``bench_drivers.json``), and ``bench_ci
    --skip-fig17`` (its gates, exit 0)."""
    lanes, wall = grid_a
    wls = make_all()
    t0 = time.time()
    card = harness.build_table(wls, harness.grid_table(lanes, wall),
                               verbose=False)
    ref = harness.build_table(wls, golden.grid_rows(
        golden.load_golden()["grid_a"]["lanes"], wls,
        list(machine.FABRIC_MODES)), verbose=False)
    figures = {}
    for name, mod in FIGURES.items():
        got, got_text = _quiet(mod.main, card)
        want, want_text = _quiet(mod.main, ref)
        if got != want or got_text != want_text:
            raise AssertionError(f"[figures] {name} differs from the "
                                 f"reference's records: {got} vs {want}")
        figures.update(got)
    stats = dict(figures=figures, table_s=time.time() - t0)
    print(f"[figures] Figs. 11-14 and Table 2 from the card's grid A equal "
          f"the reference's records: {json.dumps(figures)}", flush=True)

    want = golden.load_bench_drivers_golden()
    t0 = time.time()
    f16 = fig16_bandwidth.simulate_sparsity_axis(device=device)
    stats["fig16_s"] = time.time() - t0
    golden.check_bench_drivers(golden.fig16_record(f16), None, want)
    t0 = time.time()
    tuned = hillclimb.fabric_autotune("bfs", save=False, device=device)
    stats["autotune_s"] = time.time() - t0
    golden.check_bench_drivers(None, golden.autotune_record(tuned), want)
    stats.update(
        fig16_cycles={f"{sp:.2f}": r["cycles"] for sp, r in f16.items()},
        autotune_best=[tuned["best_latency"], tuned["best_efficiency"]],
        autotune_waves=tuned["pack_stats"]["n_waves"])
    print(f"[figures] Fig. 16's simulated axis ({stats['fig16_s']:.1f} s) "
          f"and the bfs autotune ({stats['autotune_s']:.1f} s) equal "
          "bench_drivers.json", flush=True)

    out = os.path.join(HERE, "experiments", "ci_torch")
    t0 = time.time()
    rc = bench_ci.main(["--skip-fig17", "--out", out, "--device",
                        str(device)])
    stats["bench_ci_s"] = time.time() - t0
    if rc != 0:
        raise AssertionError(f"[figures] bench_ci --skip-fig17 exited {rc}")
    with open(os.path.join(out, "BENCH_fig11.json")) as f:
        smoke = json.load(f)
    stats["bench_ci"] = dict(
        wall_s=smoke["wall_s"], wall_shard_s=smoke["wall_shard_s"],
        n_devices=smoke["n_devices"],
        engine_cache_size=smoke["engine_cache_size"],
        rank_corr=smoke["static_cost"]["rank_corr"],
        service_speedup=smoke["service"]["speedup"],
        chain_smoke_speedup=smoke["fast_forward"]["speedup"],
        chain_smoke_dead_step_fraction=smoke["fast_forward"][
            "dead_step_fraction"])
    print(f"[figures] {json.dumps(stats)}", flush=True)
    return stats


def sweep_rows(report, workloads) -> int:
    """PE rows one engine call of a sweep steps a tick: the super-lanes of
    a wave times the packing mesh, or the lanes times the widest mesh."""
    if report.pack is not None:
        per_wave = report.pack.n_super_lanes // report.pack.n_waves
        return per_wave * max(int(np.prod(w["super_geom"]))
                              for w in report.pack.plan)
    return len(workloads) * max(int(np.prod(wl.geom)) for wl in workloads)


def run_sweeps() -> dict:
    """The ``[sweep]`` legs on the card through ``sweep(..., device=
    "cuda")``, held to ``sweeps.json``: every lane bit for bit, the
    packing schedule and the engine telemetry field for field; the chain
    also on the plain engine (``fast_forward=False``), whose lanes must
    equal the same golden lanes and which compresses nothing."""
    want = golden.load_sweep_golden()
    stats = {}
    for name in SWEEP_LEGS:
        cfg, kw, keys = golden.port_sweep_leg(name)
        engines = [("ff", cfg)]
        if name == "chain":
            engines.append(("plain", dataclasses.replace(
                cfg, fast_forward=False)))
        for eng, run_cfg in engines:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            report = sweep(run_cfg, SweepRequest(**kw), device="cuda")
            torch.cuda.synchronize()
            wall = time.time() - t0
            got = golden.sweep_record(name, keys, report)
            golden.check_sweep(got, want[name], telemetry=eng == "ff")
            tel = report.telemetry
            if eng == "plain" and not (
                    tel.stepped_pe_ticks == tel.plain_pe_ticks
                    == want[name]["telemetry"]["plain_pe_ticks"]):
                raise AssertionError(f"plain engine telemetry {tel}")
            for key, wl, r in zip(keys, kw["workloads"], report):
                if r.completed and not wl.check(r.mem_val):
                    raise AssertionError(f"{name} {key}: WRONG RESULT")
            cycles = [r.cycles for r in report]
            ticks = tel.stepped_pe_ticks // sweep_rows(report,
                                                       kw["workloads"])
            row = dict(
                leg=name, engine=eng, lanes=len(keys), wall_s=wall,
                engine_ticks=ticks, engine_ticks_per_s=ticks / wall,
                lane_cycles=sum(cycles), lane_cycles_per_s=sum(cycles) / wall,
                dead_step_fraction=tel.dead_step_fraction,
                stepped_pe_ticks=tel.stepped_pe_ticks,
                plain_pe_ticks=tel.plain_pe_ticks,
                n_waves=None if report.pack is None else report.pack.n_waves,
                packing_efficiency=(None if report.pack is None
                                    else report.pack.packing_efficiency),
                peak_mem_bytes=torch.cuda.max_memory_allocated())
            stats[f"{name}/{eng}"] = row
            print(f"[sweep] {name} ({eng}): {len(keys)} lanes match the "
                  f"golden records; {json.dumps(row)}", flush=True)
    chain_ff, chain_plain = stats["chain/ff"], stats["chain/plain"]
    print(f"[sweep] chain fast-forward speedup "
          f"{chain_plain['wall_s'] / chain_ff['wall_s']:.3f}x "
          f"({chain_plain['wall_s']:.3f} s plain, {chain_ff['wall_s']:.3f} "
          f"s fast-forward)", flush=True)
    return stats


def run_service() -> dict:
    """The ``[service]`` phase: the chaos soak (with its restore) and one
    clean soak round of the service traffic on the card, held to
    ``service.json``."""
    want = golden.load_service_golden()
    keys = list(want["lanes"])
    t0 = time.time()
    chaos = chaos_soak.run(5, golden=want, device="cuda", verbose=False)
    chaos_s = time.time() - t0
    if chaos["failures"]:
        raise AssertionError(f"chaos soak: {chaos['failures']}")
    kinds = {k for _, _, k in chaos["fired"]}
    if not {"transient", "kill"} <= kinds:
        raise AssertionError(f"chaos soak fired {chaos['fired']}")
    if chaos["restored_lanes"] == 0:
        raise AssertionError("the restore finished no in-flight lane")
    cfg, lanes = serve_bench.fig17_traffic(golden.SERVICE["copies"])
    rounds: list = []
    t0 = time.time()
    clean = serve_bench.soak(cfg, lanes, rounds=1, slice_chunks=1,
                             device="cuda", results=rounds)
    clean_s = time.time() - t0
    if clean["drift"]:
        raise AssertionError(f"clean soak: {clean['drift']}")
    if clean["engine_cache_size"] != 1:
        raise AssertionError(f"clean soak used "
                             f"{clean['engine_cache_size']} engines")
    golden.check_lanes({keys[i]: golden.lane_record(r)
                        for i, r in sorted(rounds[0].items())},
                       want["lanes"])
    row = dict(
        lanes=len(lanes),
        chaos=dict((k, chaos[k]) for k in (
            "n_slices", "engine_ticks", "n_retries", "n_restarts",
            "n_checkpoints", "refill_occupancy", "dead_step_fraction",
            "fired", "deadline_lane", "deadline_cycles", "restored_lanes",
            "restored_from_step", "reference_s", "soak_s", "restore_s")),
        chaos_wall_s=chaos_s,
        clean=dict((k, clean[k]) for k in (
            "n_slices", "engine_ticks", "n_refills", "refill_occupancy",
            "dead_step_fraction", "engine_cache_size", "service_wall_s")),
        clean_wall_s=clean_s)
    print(f"[service] {len(lanes)} lanes of fig17_traffic(copies=2): the "
          "chaos soak, its restore and the clean soak match the golden "
          f"records; {json.dumps(row)}", flush=True)
    return row


def plain_grouped(xe: torch.Tensor, w: torch.Tensor, *,
                  trans_w: bool = False) -> torch.Tensor:
    """``grouped_expert_matmul`` (``trans_w``: its dx's product) through
    the plain version: the same capacity padding and tiles, then
    :func:`group_matmul_plain`."""
    e, c, _ = xe.shape
    x, eid, tile_m = tile_by_expert(xe)
    out = group_matmul_plain(x, eid, w, tile_m=tile_m, trans_w=trans_w)
    return out.reshape(e, -1, w.shape[1 if trans_w else 2])[:, :c]


def check_expert(name: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """Holds a recorded expert product (or its dx) to its plain version in
    bf16: elementwise within :data:`BF16_TOL`, and max |got - want| within
    :data:`BF16_TOL` of max |want| (a check that zeros or noise of the
    product's own size fail, however small the product); returns the
    max |err|, max |want| and their ratio."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    rel = err / scale if scale else float(err > 0)
    if not torch.allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL) or \
            not rel <= BF16_TOL:
        raise AssertionError(f"group_matmul ({name}): max |err| {err} "
                             f"against max |plain| {scale}")
    return dict(max_abs_err=err, max_abs_want=scale, rel_err=rel)


class _Tap(torch.autograd.Function):
    """Identity whose backward hands the gradient passing through it to
    ``sink`` (the dx the expert product's backward computed)."""

    @staticmethod
    def forward(ctx, x, sink):
        ctx.sink = sink
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        ctx.sink["dx"] = g.detach().clone()
        return g, None


class ExpertCalls:
    """Counts the ``grouped_expert_matmul`` calls of ``moe_apply`` (one
    kernel launch each in the forward) and records chosen calls (by call
    index): their operands and output and, where autograd records the
    call (training), their cotangent ``dy``, the ``dx`` their backward
    returned and a copy of the weights the optimizer then updates in
    place, while the calls run as they would."""

    def __init__(self, keep):
        self.keep, self.n, self.calls = set(keep), 0, {}
        self.inner = moe.grouped_expert_matmul

    def __call__(self, xe, w, **kw):
        n, self.n = self.n, self.n + 1
        if n not in self.keep:
            return self.inner(xe, w, **kw)
        grad = torch.is_grad_enabled() and xe.requires_grad
        rec = dict(xe=xe.detach().clone(),
                   w=w.detach().clone() if grad else w)
        out = self.inner(_Tap.apply(xe, rec) if grad else xe, w, **kw)
        rec["out"] = out.detach().clone()
        if grad:
            out.register_hook(
                lambda g: rec.__setitem__("dy", g.detach().clone()))
        self.calls[n] = rec
        return out


def check_served(res, cfg) -> None:
    """Every request got its new tokens, each in [0, vocab)."""
    n_new = SERVE_TRAFFIC["max_new_tokens"]
    for i, out in enumerate(res.outputs):
        if len(out) != n_new or out.min() < 0 or out.max() >= cfg.vocab:
            raise AssertionError(f"{cfg.name} request {i}: bad tokens "
                                 f"{out.tolist()}")


def serve_expert_checks(rec: ExpertCalls, per_fwd: int, path: str):
    """The kernel against its plain version on a serve's own operands: the
    recorded ``wg`` / ``wi`` / ``wo`` of layer 0 in the first prefill
    (calls 0-2) and the first decode step (``per_fwd`` on); returns max
    |err| and max |err| / max |plain| by product."""
    errs, rel = {}, {}
    for n, r in sorted(rec.calls.items()):
        name = ("prefill" if n < per_fwd else "decode") + \
            f"_{['wg', 'wi', 'wo'][n % 3]}"
        got = check_expert(f"{path}, {name}", r["out"],
                           plain_grouped(r["xe"], r["w"]))
        errs[name], rel[name] = got["max_abs_err"], got["rel_err"]
    if len(errs) != 6:
        raise AssertionError(f"recorded {sorted(rec.calls)} expert calls")
    return errs, rel


def run_serve() -> tuple[dict, dict]:
    """Phi-3.5-MoE at full width, depth cut as in :data:`SERVE_CFG`,
    served :data:`SERVE_REPEATS` times on the card, every launch count
    from 0; returns the stats and the expert products recorded for the
    kernel checks."""
    cfg = SERVE_CFG
    reqs = golden.serve_requests()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init_params(cfg, gen)
    torch.cuda.synchronize()
    # first prefill's and first decode step's wg / wi / wo of layer 0
    per_fwd = 3 * cfg.n_layers
    rec = ExpertCalls([0, 1, 2, per_fwd, per_fwd + 1, per_fwd + 2])
    moe.grouped_expert_matmul = rec
    torch.cuda.reset_peak_memory_stats()
    for meta in KERNELS.values():
        meta["wrapper"].launches = 0
    runs = []
    try:
        for _ in range(SERVE_REPEATS):
            runs.append(serve.serve_batch(cfg, reqs, reduced=False,
                                          device="cuda", params=params,
                                          **SERVE_TRAFFIC))
        torch.cuda.synchronize()
    finally:
        moe.grouped_expert_matmul = rec.inner
    launches = group_matmul.launches
    peak = torch.cuda.max_memory_allocated()
    res = runs[0]
    check_served(res, cfg)
    for k, other in enumerate(runs[1:], 1):
        if [o.tolist() for o in other.outputs] != \
                [o.tolist() for o in res.outputs]:
            raise AssertionError(f"serve {k} gave other tokens than serve 0")
    if launches <= 0:
        raise AssertionError("group_matmul was not launched on the "
                             "serving path")
    # the first wave's prefill again: finite logits, and its greedy tokens
    # are the first tokens served (no kernel sums with atomics)
    slots = SERVE_TRAFFIC["batch_slots"]
    toks = golden.first_wave_tokens(slots, "cuda")
    with torch.inference_mode():
        last, _ = make_prefill_step(cfg, SERVE_TRAFFIC["cache_len"])(
            params, toks)
    if not torch.isfinite(last).all():
        raise AssertionError("prefill logits are not finite")
    first = torch.argmax(last, dim=-1).cpu().tolist()
    if first != [int(res.outputs[i][0]) for i in range(slots)]:
        raise AssertionError(f"prefill tokens {first} differ from the "
                             "first served tokens")
    errs, rel = serve_expert_checks(rec, per_fwd, "serving path")
    speed = {}
    for key in ("prefill_s", "decode_s", "decode_tok_s"):
        vals = [getattr(r, key) for r in runs]
        speed[key] = dict(median=statistics.median(vals), min=min(vals),
                          max=max(vals), runs=vals)
    stats = dict(
        arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_experts=cfg.moe.n_experts, d_expert=cfg.moe.d_expert,
        vocab=cfg.vocab, params=cfg.param_count(),
        requests=len(reqs), tokens=res.tokens_generated,
        serves=SERVE_REPEATS, **speed, group_matmul_launches=launches,
        launches_per_serve=launches / SERVE_REPEATS,
        peak_mem_bytes=peak, max_abs_err=errs, rel_err=rel,
        outputs=[o.tolist() for o in res.outputs])
    print(f"[serve] {json.dumps(stats)}", flush=True)
    return stats, rec.calls


def run_reduced_serve() -> int:
    """The reduced Phi-3.5-MoE with f32 parameters, held to the
    reference's golden tokens; returns how many tokens were compared."""
    spec = golden.SERVE_SPEC
    cfg = configs.get_arch(configs.ALIASES[spec["arch"]]).reduced()
    params = params_from_numpy(
        golden.serve_params_numpy(cfg, spec["param_seed"]), cfg, "cuda")
    res = serve.serve_batch(
        spec["arch"], golden.serve_requests(), device="cuda", params=params,
        max_new_tokens=spec["max_new_tokens"],
        batch_slots=spec["batch_slots"], cache_len=spec["cache_len"])
    compared = golden.check_serve_tokens(res.outputs,
                                         golden.load_serve_golden())
    print(f"[serve-reduced] {compared} of {res.tokens_generated} tokens "
          "compared, all equal to the reference's golden tokens",
          flush=True)
    return compared


def check_train_launches(rec: ExpertCalls, launches: int, per_step: int,
                         steps: int) -> int:
    """``group_matmul`` launched once for each expert product of the
    forwards (``per_step`` a step) and once for each one's dx; returns the
    forward launches."""
    forward = rec.n
    if forward != per_step * steps or launches != 2 * forward:
        raise AssertionError(
            f"group_matmul launched {launches} times for {forward} expert "
            f"products in {steps} steps (want {per_step} forward and "
            f"{per_step} dx launches a step)")
    return forward


def train_expert_checks(rec: ExpertCalls, path: str) -> tuple[dict, dict]:
    """The recorded layer-0 ``wg`` / ``wi`` / ``wo`` products of a training
    step and their backward's dx held to the plain version (dx as ``dy @
    w^T``); returns max |err| and the full check by product."""
    errs, held = {}, {}
    for n, r in sorted(rec.calls.items()):
        tag = ["wg", "wi", "wo"][n % 3]
        if "dy" not in r or "dx" not in r:
            raise AssertionError(f"no gradient reached the {tag} product")
        w = r["w"]
        checks = {
            f"forward_{tag}": (r["out"], plain_grouped(r["xe"], w)),
            f"dx_{tag}": (r["dx"].float(), plain_grouped(
                r["dy"].to(w.dtype), w.transpose(1, 2).contiguous()))}
        for name, (got, want) in checks.items():
            held[name] = check_expert(f"{path}, {name}", got, want)
            errs[name] = held[name]["max_abs_err"]
    if len(errs) != 6:
        raise AssertionError(f"recorded {sorted(rec.calls)} expert calls")
    return errs, held


def run_train_moe() -> tuple[dict, dict]:
    """Phi-3.5-MoE at full width, depth cut as in :data:`TRAIN_CFG`,
    trained :data:`TRAIN_TRAFFIC` steps through ``train()`` on the card,
    every launch count from 0; returns the stats and layer 0's recorded
    expert products of step :data:`TRAIN_RECORD_STEP`."""
    cfg = TRAIN_CFG
    per_step = 3 * cfg.n_layers          # expert products a forward
    first = per_step * TRAIN_RECORD_STEP
    rec = ExpertCalls([first, first + 1, first + 2])
    moe.grouped_expert_matmul = rec
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for meta in KERNELS.values():
        meta["wrapper"].launches = 0
    try:
        res = trainer.train(cfg, reduced=False, device="cuda", log_every=1,
                            **TRAIN_TRAFFIC)
        torch.cuda.synchronize()
    finally:
        moe.grouped_expert_matmul = rec.inner
    launches = group_matmul.launches
    peak = torch.cuda.max_memory_allocated()
    steps = TRAIN_TRAFFIC["steps"]
    losses = res.losses
    if res.restarts or res.steps_done != steps or len(losses) != steps:
        raise AssertionError(f"training ran {res.steps_done} steps with "
                             f"{res.restarts} restarts: {losses}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    if not np.mean(losses[-2:]) < np.mean(losses[:2]):
        raise AssertionError(f"the loss did not fall: {losses}")
    forward = check_train_launches(rec, launches, per_step, steps)
    errs, held = train_expert_checks(rec, "training path")
    steady = res.step_s[1:]
    tokens = TRAIN_TRAFFIC["batch"] * TRAIN_TRAFFIC["seq"]
    ms = statistics.median(steady) * 1e3
    stats = dict(
        arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_experts=cfg.moe.n_experts, d_expert=cfg.moe.d_expert,
        vocab=cfg.vocab, params=cfg.param_count(), **TRAIN_TRAFFIC,
        tokens_per_step=tokens, step_ms=dict(
            median=ms, min=min(steady) * 1e3, max=max(steady) * 1e3,
            first=res.step_s[0] * 1e3, runs=[t * 1e3 for t in res.step_s]),
        tokens_per_s=tokens / (ms / 1e3), peak_mem_bytes=peak,
        losses=losses, aux_losses=res.aux_losses,
        grad_norms=res.grad_norms, group_matmul_launches=launches,
        launches_forward=forward, launches_dx=launches - forward,
        launches_per_step=launches / steps, max_abs_err=errs,
        held_to_plain=held)
    print(f"[train] moe {json.dumps(stats)}", flush=True)
    return stats, rec.calls


class RouterMargins:
    """Wraps ``moe_apply`` to log, per call, the smallest gap between a
    token's neighbouring router probabilities among its top k + 1 (the
    margin by which its expert choice and order were won)."""

    def __init__(self):
        self.inner, self.margins = moe.moe_apply, []

    def __call__(self, p, x, cfg, **kw):
        with torch.no_grad():
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                  @ p["router"], dim=-1)
            top = torch.sort(probs, dim=-1, descending=True).values
            gaps = top[:, :cfg.top_k] - top[:, 1:cfg.top_k + 1]
            self.margins.append(gaps.min().item())
        return self.inner(p, x, cfg, **kw)


def run_train_reduced() -> dict:
    """The reduced Phi-3.5-MoE in f32 through ``train()``, held to the
    reference's golden record; then the same run with a checkpoint every
    2 steps and a failure at step 5, which must end on the clean run's
    loss."""
    spec = golden.TRAIN_SPEC
    cfg = configs.get_arch(spec["arch"]).reduced()
    params = params_from_numpy(
        golden.serve_params_numpy(cfg, spec["param_seed"]), cfg, "cuda")
    kw = dict(steps=spec["steps"], batch=spec["batch"], seq=spec["seq"],
              lr=spec["lr"], device="cuda", params=params, log_every=0)
    margins = RouterMargins()
    moe.moe_apply = margins
    try:
        clean = trainer.train(spec["arch"], **kw)
    finally:
        moe.moe_apply = margins.inner
    per_step = [min(margins.margins[i:i + cfg.n_layers]) for i in
                range(0, len(margins.margins), cfg.n_layers)]
    want = golden.load_train_golden()
    try:
        rel = golden.check_train(clean.losses, clean.aux_losses,
                                 clean.grad_norms, want)
    except AssertionError as e:
        raise AssertionError(f"{e}; smallest router top-2 margin a step "
                             f"{per_step}") from e
    # the same run with TF32 products: how far it lands from the record,
    # against golden.TRAIN_RTOL (read, not held: it says whether the limit
    # sees a lost 13 bits of every f32 product's inputs)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = trainer.train(spec["arch"], **kw)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    tf32_rel = golden.train_rel_errs(tf32.losses, tf32.aux_losses,
                                     tf32.grad_norms, want)
    with tempfile.TemporaryDirectory() as d:
        failed = trainer.train(spec["arch"], ckpt_dir=d, save_every=2,
                               fail_at_step=5, **kw)
    if failed.restarts != 1 or failed.steps_done != spec["steps"]:
        raise AssertionError(f"recovery: {failed.restarts} restarts, "
                             f"{failed.steps_done} steps")
    if not np.isclose(failed.final_loss, clean.final_loss, rtol=1e-5,
                      atol=0):
        raise AssertionError(f"recovered final loss {failed.final_loss!r} "
                             f"!= clean {clean.final_loss!r}")
    stats = dict(steps=spec["steps"], losses=clean.losses,
                 rtol=golden.TRAIN_RTOL, max_rel_err=rel,
                 max_loss_rel_err=rel["loss"], tf32_max_rel_err=tf32_rel,
                 tf32_within_rtol=max(tf32_rel.values())
                 <= golden.TRAIN_RTOL,
                 min_router_margin=per_step,
                 recovered_final_loss=failed.final_loss,
                 clean_final_loss=clean.final_loss,
                 restarts=failed.restarts)
    print(f"[train-reduced] losses, aux losses and grad norms match the "
          f"golden record; {json.dumps(stats)}", flush=True)
    return stats


def run_train_dense() -> dict:
    """The 100M example's model (``repro-100m``) trained on the card for
    :data:`DENSE_TRAFFIC`; the loss must fall."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = trainer.train(DENSE_CFG, reduced=False, device="cuda",
                        log_every=10, **DENSE_TRAFFIC)
    losses = res.losses
    if res.restarts or len(losses) != DENSE_TRAFFIC["steps"]:
        raise AssertionError(f"dense run: {res.restarts} restarts, "
                             f"{len(losses)} steps")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise AssertionError(f"the dense loss did not fall: {losses}")
    tokens = DENSE_TRAFFIC["batch"] * DENSE_TRAFFIC["seq"]
    stats = dict(arch=DENSE_CFG.name, params=DENSE_CFG.param_count(),
                 **DENSE_TRAFFIC, tokens_per_s=tokens_per_s(res, tokens),
                 step_ms_median=statistics.median(res.step_s[1:]) * 1e3,
                 first_step_ms=res.step_s[0] * 1e3,
                 peak_mem_bytes=torch.cuda.max_memory_allocated(),
                 first_losses=losses[:3], last_losses=losses[-3:])
    print(f"[train-dense] {json.dumps(stats)}", flush=True)
    return stats


def serve_family(name: str, gen: torch.Generator):
    """One family at full width and depth, bf16 parameters from ``gen``,
    serving the requests once with the launch counts from 0; returns the
    stats, the parameters and, for an MoE family, layer 0's expert
    products of the first prefill and decode step held to the plain
    version (then ``group_matmul`` must have been launched)."""
    cfg = configs.get_arch(name)
    params = lm.init_params(cfg, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_fwd = 3 * cfg.n_layers
    rec = ExpertCalls([0, 1, 2, per_fwd, per_fwd + 1, per_fwd + 2])
    moe.grouped_expert_matmul = rec
    for meta in KERNELS.values():
        meta["wrapper"].launches = 0
    try:
        res = serve.serve_batch(cfg, golden.serve_requests(), reduced=False,
                                device="cuda", params=params,
                                **SERVE_TRAFFIC)
        torch.cuda.synchronize()
    finally:
        moe.grouped_expert_matmul = rec.inner
    launches = group_matmul.launches
    check_served(res, cfg)
    stats = dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
                 vocab=cfg.vocab, params=cfg.param_count(),
                 prefill_s=res.prefill_s, decode_s=res.decode_s,
                 decode_tok_s=res.decode_tok_s,
                 tokens=res.tokens_generated,
                 peak_mem_bytes=torch.cuda.max_memory_allocated(),
                 group_matmul_launches=launches,
                 outputs=[o.tolist() for o in res.outputs])
    if cfg.moe is not None:
        if launches <= 0:
            raise AssertionError(f"group_matmul was not launched serving "
                                 f"{cfg.name}")
        stats["max_abs_err"], stats["rel_err"] = serve_expert_checks(
            rec, per_fwd, f"{cfg.name} serving path")
    elif launches or rec.n:
        raise AssertionError(f"{cfg.name} has no MoE layer, yet "
                             f"group_matmul was launched {launches} times")
    print(f"[families] serve {json.dumps(stats)}", flush=True)
    return stats, params, rec.calls


@torch.inference_mode()
def timed_forward(fn, *args) -> tuple[torch.Tensor, dict]:
    """``fn(*args)``'s logits, with its wall s and peak memory; the logits
    must be finite."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    logits = fn(*args)
    torch.cuda.synchronize()
    stats = dict(wall_s=time.time() - t0, shape=list(logits.shape),
                 peak_mem_bytes=torch.cuda.max_memory_allocated())
    if not torch.isfinite(logits).all():
        raise AssertionError(f"non-finite logits of shape {stats['shape']}")
    return logits, stats


def run_families() -> tuple[dict, dict]:
    """The ``[families]`` phase at full width and depth, one family at a
    time with memory freed between them: each decoder family of
    ``golden.FAMILIES_SPEC`` served once (DeepSeek-V2-Lite's expert
    products held to the plain ``group_matmul``), LLaVA-NeXT's vision
    prefill on its serving parameters, and HuBERT-XLarge's encode.
    Returns the stats by arch (and ``vision``, ``encode``) and the MoE
    family's recorded expert products."""
    spec = golden.FAMILIES_SPEC
    gen = torch.Generator(device="cuda").manual_seed(0)
    stats, calls = {}, None
    for arch in spec["serve"]:
        cfg = configs.get_arch(arch)
        stats[arch], params, recorded = serve_family(arch, gen)
        if cfg.moe is not None:
            calls = recorded
        if arch == spec["vision"]["arch"]:
            batch = {
                "patches": torch.randn(
                    (1, cfg.n_patches, cfg.d_frontend), generator=gen,
                    device="cuda").to(torch.bfloat16),
                "tokens": torch.randint(
                    0, cfg.vocab, (1, VISION_TOKENS), generator=gen,
                    device="cuda", dtype=torch.int32)}
            _, stats["vision"] = timed_forward(
                lambda: lm.forward(params, cfg, batch)[0])
            want = [1, cfg.n_patches + VISION_TOKENS, cfg.vocab]
            if stats["vision"]["shape"] != want:
                raise AssertionError(f"vision logits {stats['vision']}")
            print(f"[families] vision {json.dumps(stats['vision'])}",
                  flush=True)
        del params, recorded
        torch.cuda.empty_cache()
    cfg = configs.get_arch(spec["encode"]["arch"])
    params = lm.init_params(cfg, gen)
    frames = torch.randn((*ENCODE_FRAMES, 512), generator=gen,
                         device="cuda").to(torch.bfloat16)
    _, stats["encode"] = timed_forward(encode_step(cfg), params, frames)
    if stats["encode"]["shape"] != [*ENCODE_FRAMES, cfg.vocab]:
        raise AssertionError(f"encode logits {stats['encode']}")
    print(f"[families] encode {json.dumps(stats['encode'])}", flush=True)
    del params
    torch.cuda.empty_cache()
    return stats, calls


def run_families_reduced() -> dict:
    """The reduced families with f32 parameters on the card, held to the
    reference's ``families_reduced.json``: each decoder family's served
    tokens up to the first one won by a top-2 margin under
    :data:`golden.SERVE_MARGIN`, HuBERT's encode and LLaVA's vision
    logits within :data:`golden.FAMILIES_TOL`."""
    want = golden.load_families_golden()
    spec = golden.FAMILIES_SPEC
    out = {}
    for arch in spec["serve"]:
        cfg = configs.get_arch(configs.ALIASES[arch]).reduced()
        params = params_from_numpy(
            golden.serve_params_numpy(cfg, spec["param_seed"]), cfg, "cuda")
        res = serve.serve_batch(arch, golden.serve_requests(), device="cuda",
                                params=params, **want["traffic"])
        out[arch] = golden.check_serve_tokens(res.outputs,
                                              want["serve"][arch])
    for kind in ("encode", "vision"):
        cfg = configs.get_arch(
            configs.ALIASES[spec[kind]["arch"]]).reduced()
        params = params_from_numpy(
            golden.serve_params_numpy(cfg, spec["param_seed"]), cfg, "cuda")
        inp = {k: torch.as_tensor(v, device="cuda") for k, v in
               golden.family_inputs(cfg, kind).items()}
        with torch.inference_mode():
            logits = (encode_step(cfg)(params, inp["frames"])
                      if kind == "encode" else
                      lm.forward(params, cfg, inp)[0])
        out[f"{kind}_max_abs_err"] = golden.check_logits(logits, want[kind])
    print(f"[families-reduced] tokens compared per family and logits' max "
          f"|err|, all within the golden record; {json.dumps(out)}",
          flush=True)
    return out


def run_train_family(arch: str) -> tuple[dict, dict]:
    """One family's ``[train-families]`` leg (:data:`FAMILY_LEGS`): bf16
    parameters from a generator seeded with 0, one ``synth_batch`` from it
    passed at every step, AdamW through ``make_train_step``, every launch
    count from 0; every loss finite and the last under the first.  For the
    MoE family ``group_matmul`` must run each expert product forward and
    for its dx, and layer 0's products of step :data:`TRAIN_RECORD_STEP`
    are held to the plain version; no other family may launch it.
    Returns the stats and the recorded expert products."""
    cfg, traffic = FAMILY_LEGS[arch]
    steps = traffic["steps"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init_params(cfg, gen)
    n_params = sum(p.numel() for p in tree_leaves(params.tree()))
    batch = synth_batch(cfg, traffic["batch"], traffic["seq"], gen)
    state = adamw_init(params.tree())
    step = make_train_step(cfg, lr=traffic["lr"])
    per_step = 3 * cfg.n_layers if cfg.moe is not None else 0
    first = per_step * TRAIN_RECORD_STEP
    rec = ExpertCalls([first, first + 1, first + 2] if per_step else [])
    moe.grouped_expert_matmul = rec
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for meta in KERNELS.values():
        meta["wrapper"].launches = 0
    step_s, metrics = [], []
    try:
        for _ in range(steps):
            t0 = time.time()
            params, state, m = step(params, state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            step_s.append(time.time() - t0)
    finally:
        moe.grouped_expert_matmul = rec.inner
    launches = group_matmul.launches
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name}: losses {losses}")
    positions = traffic["batch"] * (
        batch["tokens"].shape[1] + cfg.n_patches
        if cfg.frontend == "vision" else traffic["seq"])
    ms = statistics.median(step_s[1:]) * 1e3
    stats = dict(
        arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        remat=cfg.remat, params=n_params, **traffic,
        positions_per_step=positions,
        step_ms=dict(median=ms, min=min(step_s[1:]) * 1e3,
                     max=max(step_s[1:]) * 1e3, first=step_s[0] * 1e3,
                     runs=[t * 1e3 for t in step_s]),
        tokens_per_s=positions / (ms / 1e3), peak_mem_bytes=peak,
        losses=losses, aux_losses=[m["aux_loss"] for m in metrics],
        grad_norms=[m["grad_norm"] for m in metrics],
        group_matmul_launches=launches)
    if per_step:
        forward = check_train_launches(rec, launches, per_step, steps)
        stats["max_abs_err"], stats["held_to_plain"] = train_expert_checks(
            rec, f"{cfg.name} training path")
        stats.update(launches_forward=forward, launches_dx=launches - forward)
    elif launches or rec.n:
        raise AssertionError(f"{cfg.name} has no MoE layer, yet "
                             f"group_matmul was launched {launches} times")
    print(f"[train-families] {json.dumps(stats)}", flush=True)
    return stats, rec.calls


def run_train_families() -> tuple[dict, dict]:
    """The ``[train-families]`` phase: each family's leg, one at a time
    with memory freed between them; returns the stats by arch and the MoE
    family's recorded expert products."""
    stats, calls = {}, None
    for arch in FAMILY_LEGS:
        stats[arch], recorded = run_train_family(arch)
        if recorded:
            calls = recorded
        del recorded
        torch.cuda.empty_cache()
    return stats, calls


def run_train_families_reduced() -> dict:
    """The reduced families in f32 on the card, each held to the
    reference's losses, aux losses and gradient norms in
    ``train_families_reduced.json`` (rtol ``golden.TRAIN_RTOL``)."""
    want = golden.load_train_families_golden()
    out = {}
    for arch in golden.TRAIN_FAMILIES_SPEC["archs"]:
        got = golden.train_family_run(arch, "cuda")
        out[arch] = golden.check_train(got["loss"], got["aux_loss"],
                                       got["grad_norm"], want["archs"][arch])
    print(f"[train-families-reduced] each family's losses, aux losses and "
          f"grad norms within {golden.TRAIN_RTOL} of the golden record; "
          f"largest relative errors {json.dumps(out)}", flush=True)
    return out


def run_static() -> dict:
    """The ``[static]`` phase: grid A's nexus lanes at 4x4 through the
    static golden engine (``traced_modes=False``, ``traced_geometry=
    False``) on the card, every lane held to ``paper_grid.json`` bit for
    bit and ``is_idle`` of the final state true; then the launches and
    milliseconds of one static tick beside one traced tick of the same
    lanes (``profile_engine --static``)."""
    want = golden.load_golden()["grid_a"]["lanes"]
    wls = golden.grid_workloads(golden.GRIDS["grid_a"], make_all())
    base = machine.MachineConfig(traced_modes=False, traced_geometry=False)
    cap = multidevice.EngineCalls()
    machine._get_engine = cap
    tel: dict = {}
    torch.cuda.reset_peak_memory_stats()
    try:
        lanes, wall = harness.run_grid_lanes(
            wls, ["nexus"], base_cfg=base, max_cycles=golden.MAX_CYCLES,
            device="cuda", telemetry=tel)
    finally:
        machine._get_engine = cap.inner
    got = {golden.lane_key(ln.workload.name, ln.mode, ln.size):
           golden.lane_record(ln.result) for ln in lanes}
    if len(got) != 13 or not set(got) <= set(want):
        raise AssertionError(f"static lanes {sorted(got)}")
    golden.check_lanes(got, {k: want[k] for k in got})
    if not cap.outs or not bool(machine.is_idle(cap.outs[-1][0])):
        raise AssertionError("the static engine's final state is not idle")
    dev = torch.device("cuda")
    ticks = {name: profile_ticks(*grid_a_engine(dev, ["nexus"], static), 4,
                                 dev)
             for name, static in (("static", True), ("traced", False))}
    row = dict(lanes=len(lanes), wall_s=wall,
               engine_ticks=tel["stepped_pe_ticks"] // (len(lanes) * 16),
               is_idle=True, peak_mem_bytes=torch.cuda.max_memory_allocated(),
               **{f"{k}_{f}": v[f] for k, v in ticks.items() for f in (
                   "wall_ms_per_tick", "device_ms_per_tick",
                   "kernel_launches_per_tick")})
    print(f"[static] {len(lanes)} nexus lanes of grid A on the static engine "
          "(an oracle: its chunks run the plain loop, cycle_chunk_plain, "
          "not the kernel) match the golden records, final state idle; "
          f"{json.dumps(row)}", flush=True)
    return row


#: the ``[cycle]`` phase: the engine's chunk, and the chunks compared
CYCLE_TICKS = 512
CYCLE_CHUNKS = 2


def _copy_state(dst, src) -> None:
    for k in machine.MachineState._fields:
        getattr(dst, k).copy_(getattr(src, k))


def run_cycle(reps: int = 11) -> dict:
    """The ``[cycle]`` phase: grid A's batch (39 lanes at 4x4) and the
    chain's (8 lanes of the 256-node pointer chase at 8x8), each at both
    speeds, stepped from one initial state by ``cycle_chunk`` (the
    kernel) and by ``cycle_chunk_plain`` at the engine's chunk, every
    leaf compared after each of the first two chunks.  Then the kernel's
    time for a chunk of grid A's first 512 ticks (CUDA-event median of
    ``reps`` launches, the initial state copied back before each), for
    the chain's compressed chunk and for the first packed wave of the
    fig17 sweep leg (one 8x8 super-lane, mem_words 8192, at the speed the
    engine picks; only timed: ``[sweep]`` holds fig17's records bit for
    bit), each beside the kernel's barrier floor for the same launch
    shape and ticks (``kernels.cycle.barrier_floor``: its four barriers a
    tick and nothing else, the latency floor of a chunk); beside grid
    A's, the plain version's first chunk (CUDA events around its ~900
    launches a tick, as context) and the bound: the bytes the timed
    chunk's data must move (``kernels.cycle.chunk_bytes``: the per-PE
    leaves once, the queue rows pushed and popped, the memory words
    changed) at the card's memory rate, a floor under the barrier floor.
    Every leaf is bit-equal or the phase fails, so ``max_abs_err`` is 0.
    Returns the ``cycle_chunk`` row of the kernels line (``launches``
    filled in by the main path)."""
    dev = torch.device("cuda")
    batches = {"grid_a": grid_a_batch(dev), "chain": chain_batch(dev)}
    legs = {}
    for name, (cfg, args, st0) in batches.items():
        for ff in (True, False):
            speed = "ff" if ff else "plain"
            st = {"plain": clone_state(st0), "kernel": clone_state(st0)}
            leg = dict(lanes=int(st0.cycle.shape[0]),
                       pes=int(st0.cycle.shape[1]), plain_ms=[],
                       kernel_ms=[], max_cycle=[])
            for i in range(CYCLE_CHUNKS):
                for key, fn in (("plain", cycle_chunk_plain),
                                ("kernel", cycle_chunk)):
                    def chunk():
                        st[key] = fn(cfg, *args, st[key], ticks=CYCLE_TICKS,
                                     fast_forward=ff)
                    leg[f"{key}_ms"].append(event_ms(chunk))
                diff = first_difference(st["plain"], st["kernel"])
                if diff is not None:
                    raise AssertionError(f"[cycle] {name} ({speed}) chunk "
                                         f"{i}: {diff}")
                leg["max_cycle"].append(int(st["kernel"].cycle.max()))
            legs[f"{name}/{speed}"] = leg
            print(f"[cycle] {name} ({speed}): the kernel equals the plain "
                  f"version on every leaf after each of {CYCLE_CHUNKS} "
                  f"chunks of {CYCLE_TICKS} ticks; {json.dumps(leg)}",
                  flush=True)
    batches["fig17_wave"] = fig17_wave_batch(dev)

    def timed(name, ff):
        """The chunk's median ms and spread, the state after it, and the
        barrier floor's ms."""
        cfg, args, st0 = batches[name]
        work = clone_state(st0)
        times = []
        for _ in range(reps):
            _copy_state(work, st0)
            times.append(event_ms(lambda: cycle_chunk(
                cfg, *args, work, ticks=CYCLE_TICKS, fast_forward=ff)))
        b, n = st0.cycle.shape
        flo = floor_ms(b, n, int(args[0].shape[1]), CYCLE_TICKS, dev)
        return statistics.median(times), times, work, flo

    ms, times, after, flo = timed("grid_a", False)
    chain_ms, _, _, chain_flo = timed("chain", True)
    _, wave_args, wave_st = batches["fig17_wave"]
    wave_ff = lone_speed(wave_args, wave_st)
    wave_ms, wave_times, _, wave_flo = timed("fig17_wave", wave_ff)
    cfg, args, st0 = batches["grid_a"]
    nbytes = chunk_bytes(cfg, args, st0, after)
    row = dict(name="cycle_chunk", route="cuda",
               source="src/repro_torch/csrc/cycle.cu",
               replaces="src/repro/core/machine.py:1328 (no Pallas kernel: "
                        "engine_fn's lax.scan chunk)",
               launches=None, max_abs_err=0, ms=ms,
               plain_ms=legs["grid_a/plain"]["plain_ms"][0],
               **bound(nbytes, 0, torch.int32), library_ms=None,
               bound_is="a floor: the bytes this chunk's data moves at "
                        "least (chunk_bytes); the kernel is latency-bound",
               floor_ms=flo, floor_share=flo / ms,
               floor_is="cycle_floor: the kernel's launch shape running "
                        "its four barriers a tick and nothing else",
               ticks=CYCLE_TICKS, lanes=int(st0.cycle.shape[0]),
               ms_per_tick=ms / CYCLE_TICKS, ms_spread=[min(times),
                                                        max(times)],
               chain_ff_ms=chain_ms, chain_ms_per_tick=chain_ms / CYCLE_TICKS,
               chain_floor_ms=chain_flo,
               chain_floor_share=chain_flo / chain_ms,
               fig17_wave_ms=wave_ms,
               fig17_wave_ms_per_tick=wave_ms / CYCLE_TICKS,
               fig17_wave_spread=[min(wave_times), max(wave_times)],
               fig17_wave_fast_forward=wave_ff,
               fig17_wave_shape=list(wave_st.mem_val.shape),
               fig17_wave_floor_ms=wave_flo,
               fig17_wave_floor_share=wave_flo / wave_ms,
               bytes=nbytes, legs=legs)
    print(f"[cycle] {json.dumps(row)}", flush=True)
    return row


def chunk_launches(phase: str, t0: float) -> int:
    """``cycle_chunk``'s launches since the count was last set to 0 (it
    is set to 0 again), printed with the phase's seconds since ``t0``:
    the phase must have stepped its engine chunks on the kernel."""
    n, cycle_chunk.launches = cycle_chunk.launches, 0
    if n <= 0:
        raise AssertionError(f"{phase} the engine chunk kernel was not "
                             "launched")
    print(f"{phase} cycle_chunk launched {n} times; phase "
          f"{time.time() - t0:.1f} s", flush=True)
    return n


def run_sparse() -> dict:
    """The ``[sparse]`` phase: the six oracles of ``sparse.ops`` on the card
    on ``random_csr`` matrices of 1,024 x 1,024 at 1%, each within
    :data:`SPARSE_TOL` (rtol = atol) of float64 numpy on the same
    values."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    m = n = 1024
    a = random_csr(gen, m, n, 0.01, cap=12_000)
    b = random_csr(gen, m, n, 0.01)
    x = torch.randn(n, generator=gen, device="cuda")
    bd = torch.randn((n, 64), generator=gen, device="cuda")
    ad = torch.randn((m, 64), generator=gen, device="cuda")
    bt = torch.randn((64, n), generator=gen, device="cuda")
    blk = BCSR.from_dense(a.to_dense().cpu().numpy(), block=(8, 128),
                          device="cuda")

    def f64(t):
        return t.double().cpu().numpy()

    a64, b64 = f64(a.to_dense()), f64(b.to_dense())
    live = np.arange(a.col.shape[0]) < a.nnz
    rows, cols = f64(a.row_ids).astype(int), f64(a.col).astype(int)
    checks = {
        "spmv": (sparse_ops.spmv(a, x), a64 @ f64(x)),
        "spmm": (sparse_ops.spmm(a, bd), a64 @ f64(bd)),
        "spmspm_via_dense": (sparse_ops.spmspm_via_dense(a, b), a64 @ b64),
        "spmadd": (sparse_ops.spmadd(a, b), a64 + b64),
        "sddmm": (sparse_ops.sddmm(ad, bt, a), np.where(
            live, (f64(ad) @ f64(bt))[rows, cols], 0)),
        "bcsr_spmm": (sparse_ops.bcsr_spmm(blk, bd), a64 @ f64(bd)),
    }
    errs = {}
    for name, (got, ref) in checks.items():
        got = f64(got)
        errs[name] = float(np.abs(got - ref).max())
        if got.shape != ref.shape or not np.allclose(
                got, ref, rtol=SPARSE_TOL, atol=SPARSE_TOL):
            raise AssertionError(f"sparse.ops.{name}: max |err| "
                                 f"{errs[name]} over {SPARSE_TOL}")
    row = dict(shape=[m, n], nnz=a.nnz, cap=int(a.col.shape[0]),
               b_nnz=b.nnz, blocks=blk.n_blocks, max_abs_err=errs)
    print(f"[sparse] the six oracles match float64 numpy within "
          f"{SPARSE_TOL}; {json.dumps(row)}", flush=True)
    return row


def run_shard() -> dict:
    """The ``[shard]`` phase: ``repro_torch.bench.multidevice.run_shard``
    over four logical shards of the card (the service over two)."""
    card = [torch.device("cuda", 0)] * golden.SHARD_DEVICES
    return multidevice.run_shard(card, card[:2])


def run_dispatch() -> dict:
    """The ``[dispatch]`` phase: ``repro_torch.bench.multidevice
    .run_dispatch`` over 8 logical shards of the card for
    ``spmv_sharded`` and 4 for ``psum_compressed``."""
    card = torch.device("cuda", 0)
    rows = multidevice.run_dispatch([card] * 8, [card] * 4)
    torch.cuda.empty_cache()
    return rows


# --- [mesh]: model parallelism over four ranks run as threads on the card ---
#: the ``[mesh]`` phase's traffic: ``SERVE_TRAFFIC`` at 4 slots, so that
#: the batch splits over ``data``
MESH_TRAFFIC = dict(SERVE_TRAFFIC, batch_slots=4)
#: the (data, model) meshes: serving and training run on the first, the
#: checkpoint it writes is restored onto the others
MESH_SHAPE = (2, 2)
RESHARD_SHAPES = ((1, 4), (4, 1))
#: the reduced legs' f32 tolerances: logits (absolute) and loss, aux loss
#: and gradient norm (relative), the CPU tests' (tests/test_torch_mesh.py)
MESH_LOGIT_ATOL = 1e-5
MESH_METRIC_RTOL = 1e-5
MESH_DENSE_ARCH = "minitron_4b"
#: the reduced serve legs: five requests through four slots (one wave,
#: then a refill replayed through decode), tokens equal to unsharded
MESH_REDUCED_SERVE = dict(max_new_tokens=3, batch_slots=4, cache_len=64)
MESH_REDUCED_REQUESTS = 5
#: the full-width MoE with MLA served over the mesh: DeepSeek-V2-Lite
#: (arXiv:2405.04434: d 2048, 16 MLA heads, kv_lora 512, 64 experts top-6
#: of 1,408 and 2 shared), depth cut 27 -> 4 layers, the cut of its
#: training leg (``profile_train.FAMILY_LEGS``): 2.76 B parameters
MESH_DEEPSEEK_CFG = FAMILY_LEGS["deepseek-v2-lite-16b"][0]


class RankExpertCalls:
    """An :class:`ExpertCalls` per rank for ranks run as threads (they
    share ``moe``'s module): each rank's ``grouped_expert_matmul`` calls
    are counted and recorded apart, with the number of experts of each
    call's operands (its own, under ``local_map``)."""

    def __init__(self, keep, world: int):
        self.ranks = [ExpertCalls(keep) for _ in range(world)]
        self.experts = [set() for _ in range(world)]
        self.inner = moe.grouped_expert_matmul

    def __call__(self, xe, w, **kw):
        import torch.distributed as dist
        rank = dist.get_rank()
        self.experts[rank].add(int(xe.shape[0]))
        return self.ranks[rank](xe, w, **kw)


class LastLogits:
    """Wraps ``lm.forward`` to keep, per call, the last position's logits
    (gathered whole on a mesh: every rank calls it, rank 0 keeps them) as
    f32 on the host."""

    def __init__(self):
        self.inner, self.logits = lm.forward, []

    def __call__(self, *args, **kw):
        import torch.distributed as dist
        out = self.inner(*args, **kw)
        last = dctx.whole(out[0][:, -1, :])
        if not dist.is_initialized() or dist.get_rank() == 0:
            self.logits.append(last.float().cpu())
        return out


class Routes:
    """Wraps ``moe._choose`` to record each call's message destinations
    (rank 0's on a mesh: every rank routes the whole batch alike), or,
    given recorded ones, to serve them in order in place of its own (the
    gates then the router's probabilities at those experts, as a stolen
    message's are) and count the messages that moved."""

    def __init__(self, replay=None):
        self.inner, self.dests, self.replay = moe._choose, [], replay
        self.moved = 0

    def __call__(self, xt, router, cfg, cap):
        import torch.distributed as dist
        probs, dest, gate = self.inner(xt, router, cfg, cap)
        if self.replay is not None:
            want = self.replay.pop(0).to(dest.device)
            self.moved += int((want != dest).sum())
            gate = torch.gather(probs, -1, want.reshape(gate.shape).long())
            return probs, want, gate / gate.sum(-1, keepdim=True).clamp(
                min=1e-9)
        if not dist.is_initialized() or dist.get_rank() == 0:
            self.dests.append(dest.cpu())
        return probs, dest, gate


class ForcedTokens(LastLogits):
    """Wraps ``lm.forward`` for an unsharded serve that follows the mesh
    serve's tokens: each call keeps its own last logits, as
    :class:`LastLogits` does, and returns logits whose last position's
    argmax is the mesh's choice at that call (the argmax of the mesh's
    recorded logits), so the slot loop feeds every slot the mesh's
    tokens."""

    def __init__(self, mesh_logits: list):
        super().__init__()
        self.choices = [torch.argmax(g, -1) for g in mesh_logits]

    def __call__(self, *args, **kw):
        logits, caches, aux = super().__call__(*args, **kw)
        pick = self.choices[len(self.logits) - 1].to(logits.device)
        forced = torch.zeros_like(logits)
        forced[:, -1, :].scatter_(-1, pick[:, None], 1)
        return forced, caches, aux


class BlockOutputs:
    """Wraps ``lm._tfm_block`` to keep the residual stream after each of
    the first ``n`` blocks a rank runs (the first forward's layers),
    gathered whole and as f32 on the host (rank 0's on a mesh)."""

    def __init__(self, n: int):
        self.inner, self.n, self.outs, self.count = lm._tfm_block, n, [], {}

    def __call__(self, *args, **kw):
        import torch.distributed as dist
        out = self.inner(*args, **kw)
        rank = dist.get_rank() if dist.is_initialized() else 0
        k = self.count.get(rank, 0)
        self.count[rank] = k + 1
        if k < self.n:
            x = dctx.whole(out[0]).float().cpu()
            if rank == 0:
                self.outs.append(x)
        return out


def rel_errs(got: list, want: list) -> list:
    """max |got - want| / max |want| of each pair."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} tensors against {len(want)}")
    return [(g - w).abs().max().item() / w.abs().max().item()
            for g, w in zip(got, want)]


def compare_served(want_logits: list, got_logits: list) -> dict:
    """Holds the mesh serve's greedy choices to the unsharded serve's, one
    ``lm.forward`` call after another (the slot loop does not depend on
    the tokens' values, so both make the same calls): every choice must
    be equal up to the first whose unsharded top-2 margin is below the
    largest logit error measured so far.  Returns the errors and the
    count of choices compared."""
    if len(want_logits) != len(got_logits):
        raise AssertionError(f"{len(got_logits)} forward calls on the mesh, "
                             f"{len(want_logits)} unsharded")
    err, compared, stop = 0.0, 0, None
    for k, (w, g) in enumerate(zip(want_logits, got_logits)):
        if not torch.isfinite(g).all():
            raise AssertionError(f"forward {k}: logits are not finite")
        err = max(err, (g - w).abs().max().item())
        top = torch.topk(w, 2, dim=-1).values
        margin = top[:, 0] - top[:, 1]
        same = torch.argmax(w, -1) == torch.argmax(g, -1)
        if not same.all():
            s = int(torch.nonzero(~same)[0, 0])
            if margin[s].item() >= err:
                raise AssertionError(
                    f"forward {k} slot {s}: the mesh chose another token "
                    f"by a margin of {margin[s].item()} >= logit error {err}")
            stop = (k, s, margin[s].item())
            compared += int(same[:s].sum())
            break
        compared += same.numel()
    return dict(logit_max_abs_err=err, choices_compared=compared,
                stopped_at=stop)


def run_mesh_serve(cfg=SERVE_CFG, device="cuda") -> tuple[dict, dict]:
    """A full-width MoE ``cfg`` (:func:`main` passes Phi-3.5-MoE,
    :data:`SERVE_CFG`, and DeepSeek-V2-Lite, :data:`MESH_DEEPSEEK_CFG`)
    served over a (2, 2) mesh of four thread-ranks on the card through
    ``serve_batch(mesh=)``,
    launch counts from 0, against the same serve on the card unsharded
    (before the counts are reset).  The routing is discrete and the two
    runs sum in other orders, so a bf16 step in a router's input can send
    a message elsewhere (and load stealing then others).  So the serve is
    run unsharded once more, fed the mesh's tokens and replaying the mesh's
    routing in every forward: each forward's last logits (the decode
    steps' read the sharded caches) are held within :data:`BF16_TOL` of
    max |plain|, and the first forward's residual stream is compared block
    by block.  The served tokens are held to the free unsharded serve by
    :func:`compare_served`.  Returns the stats and rank 0's recorded
    expert products."""
    reqs = golden.serve_requests()
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    want, free = LastLogits(), Routes()
    lm.forward, moe._choose = want, free
    try:
        ref = serve.serve_batch(cfg, reqs, reduced=False, device=device,
                                params=params, **MESH_TRAFFIC)
    finally:
        lm.forward, moe._choose = want.inner, free.inner
    per_fwd = 3 * cfg.n_layers
    rec = RankExpertCalls([0, 1, 2, per_fwd, per_fwd + 1, per_fwd + 2], 4)
    got, routes = LastLogits(), Routes()
    mesh_blocks = BlockOutputs(cfg.n_layers)
    moe.grouped_expert_matmul, lm.forward, moe._choose = rec, got, routes
    lm._tfm_block = mesh_blocks

    def rank(r):
        mesh = device_mesh(*MESH_SHAPE, device)
        return serve.serve_batch(cfg, reqs, reduced=False, mesh=mesh,
                                 params=params, **MESH_TRAFFIC)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for meta in KERNELS.values():
        meta["wrapper"].launches = 0
    t0 = time.time()
    try:
        runs = thread_ranks(rank, 4)
    finally:
        moe.grouped_expert_matmul, lm.forward, moe._choose = \
            rec.inner, got.inner, routes.inner
        lm._tfm_block = mesh_blocks.inner
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = group_matmul.launches
    peak = torch.cuda.max_memory_allocated()
    for r, res in enumerate(runs):
        check_served(res, cfg)
        if [o.tolist() for o in res.outputs] != \
                [o.tolist() for o in runs[0].outputs]:
            raise AssertionError(f"rank {r} served other tokens than rank 0")
    calls = [x.n for x in rec.ranks]
    if rec.experts != [{cfg.moe.n_experts // MESH_SHAPE[1]}] * 4 or \
            min(calls) <= 0 or launches != sum(calls):
        raise AssertionError(f"expert products by rank {calls} on "
                             f"{rec.experts} local experts; {launches} "
                             "group_matmul launches")
    # the whole serve again unsharded, fed the mesh's tokens and replaying
    # the mesh's routing in every forward: each forward's last logits
    # within BF16_TOL of its max |plain| (the sharded caches included)
    replay = Routes(replay=list(routes.dests))
    forced, ref_blocks = ForcedTokens(got.logits), BlockOutputs(cfg.n_layers)
    lm.forward, moe._choose, lm._tfm_block = forced, replay, ref_blocks
    try:
        followed = serve.serve_batch(cfg, reqs, reduced=False, device=device,
                                     params=params, **MESH_TRAFFIC)
    finally:
        lm.forward, moe._choose, lm._tfm_block = \
            forced.inner, replay.inner, ref_blocks.inner
    if replay.replay or [o.tolist() for o in followed.outputs] != \
            [o.tolist() for o in runs[0].outputs]:
        raise AssertionError(f"{len(replay.replay)} routes left; the "
                             "unsharded serve did not follow the mesh's "
                             "tokens")
    if not all(torch.isfinite(g).all() for g in got.logits):
        raise AssertionError("the mesh's logits are not finite")
    fwd_rel = rel_errs(got.logits, forced.logits)
    layer_rel = rel_errs(mesh_blocks.outs, ref_blocks.outs)
    bad = [(k, e) for k, e in enumerate(fwd_rel) if not e <= BF16_TOL]
    if bad:
        raise AssertionError(f"forwards (index, max |err| / max |plain|) "
                             f"past {BF16_TOL} on the mesh's routing and "
                             f"tokens: {bad}")
    first = (got.logits[0] - forced.logits[0]).abs().max().item()
    scale = forced.logits[0].abs().max().item()
    prefill_moved = sum(int((a != b).sum()) for a, b in zip(
        free.dests[:cfg.n_layers], routes.dests[:cfg.n_layers]))
    served = compare_served(want.logits, got.logits)
    errs, rel = serve_expert_checks(rec.ranks[0], per_fwd,
                                    "mesh serving path, rank 0")
    stats = dict(
        arch=cfg.name, n_layers=cfg.n_layers, mesh=list(MESH_SHAPE),
        ranks="4 threads on one card", requests=len(reqs),
        tokens=runs[0].tokens_generated, wall_s=wall,
        prefill_s=runs[0].prefill_s, decode_s=runs[0].decode_s,
        decode_tok_s=runs[0].decode_tok_s,
        unsharded_decode_tok_s=ref.decode_tok_s,
        group_matmul_launches=launches, launches_by_rank=calls,
        local_experts=sorted(rec.experts[0]), peak_mem_bytes=peak,
        max_abs_err=errs, rel_err=rel, prefill_max_abs_err=first,
        prefill_max_abs_plain=scale, prefill_rel_err=first / scale,
        forward_rel_errs=fwd_rel, max_forward_rel_err=max(fwd_rel),
        prefill_layer_rel_errs=layer_rel,
        replayed_messages_moved=replay.moved,
        free_prefill_messages_moved=prefill_moved,
        free_prefill_max_abs_err=(got.logits[0] - want.logits[0]).abs()
        .max().item(), **served,
        outputs=[o.tolist() for o in runs[0].outputs],
        unsharded_outputs=[o.tolist() for o in ref.outputs])
    print(f"[mesh] serve {json.dumps(stats)}", flush=True)
    del params
    return stats, rec.ranks[0].calls


def _reduced_params(arch: str, device):
    cfg = configs.get_arch(arch).reduced()
    return cfg, params_from_numpy(golden.serve_params_numpy(cfg, 0), cfg,
                                  device)


def _train_metrics(arch: str, device, **kw) -> dict:
    spec = golden.TRAIN_SPEC
    res = trainer.train(arch, batch=spec["batch"], seq=spec["seq"],
                        lr=spec["lr"], params=_reduced_params(arch, device)[1],
                        device=device, log_every=0, **kw)
    return dict(loss=res.losses, aux_loss=res.aux_losses,
                grad_norm=res.grad_norms)


def _close(got: list, want: list, what: str) -> float:
    """The largest |got - want| / |want| (|got - want| where want is 0, as
    a dense model's aux loss); raises above :data:`MESH_METRIC_RTOL`."""
    rel = max(abs(g - w) / (abs(w) or 1.0) for g, w in zip(got, want))
    if len(got) != len(want) or not rel <= MESH_METRIC_RTOL:
        raise AssertionError(f"{what}: {got} against {want}")
    return rel


def run_mesh_reduced(device="cuda") -> dict:
    """The reduced Phi-3.5-MoE and Minitron-4B in f32 over (2, 2)
    thread-ranks on the card: the forward's logits within
    :data:`MESH_LOGIT_ATOL` of the unsharded forward; ``serve_batch(mesh=)``
    giving the unsharded serve's tokens; two ``train(mesh=)``
    steps within :data:`MESH_METRIC_RTOL` of the unsharded run (and Phi's
    of ``train_reduced.json``); Phi's checkpoint of step 1 written under
    (2, 2), restored onto (1, 4) and (4, 1) bit for bit, and training
    resumed on each to the clean run's second loss."""
    spec = golden.TRAIN_SPEC
    archs = {"moe": configs.ALIASES[spec["arch"]], "dense": MESH_DENSE_ARCH}
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, 512, (spec["batch"],
                                                 spec["seq"])),
                           dtype=torch.int32, device=device)
    reqs = golden.serve_requests()[:MESH_REDUCED_REQUESTS]
    want = {}
    for key, arch in archs.items():
        cfg, params = _reduced_params(arch, device)
        with torch.no_grad():
            logits = lm.forward(params, cfg, {"tokens": toks})[0]
        served = serve.serve_batch(arch, reqs, device=device, params=params,
                                   **MESH_REDUCED_SERVE)
        want[key] = dict(logits=logits, served=[o.tolist() for o in
                                                served.outputs],
                         train=_train_metrics(arch, device, steps=2))
    ckpt = tempfile.mkdtemp(prefix="mesh_ckpt_")

    def rank(r):
        mesh = device_mesh(*MESH_SHAPE, device)
        out = {}
        for key, arch in archs.items():
            cfg, params = _reduced_params(arch, device)
            placed = shd.place_params(params, mesh)
            t = shd.place(toks, shd.batch_sharding(mesh, toks.shape))
            with torch.no_grad(), dctx.use_mesh(mesh):
                logits = dctx.whole(lm.forward(placed, cfg,
                                               {"tokens": t})[0])
            served = serve.serve_batch(arch, reqs, mesh=mesh, params=params,
                                       **MESH_REDUCED_SERVE)
            out[key] = dict(logits=logits, served=[o.tolist() for o in
                                                   served.outputs],
                            train=_train_metrics(arch, device, steps=2,
                                                 mesh=mesh))
        arch = archs["moe"]
        _train_metrics(arch, device, steps=1, mesh=mesh, ckpt_dir=ckpt,
                       save_every=1)
        _, params = _reduced_params(arch, device)
        like = (params.tree(), adamw_init(params.tree()))
        saved, step, _ = restore_checkpoint(ckpt, like, device=device)
        for shape in RESHARD_SHAPES:
            other = device_mesh(*shape, device)
            ps = shd.param_shardings(params, other)
            placed, _, _ = restore_checkpoint(
                ckpt, like, device=device,
                shardings=(ps, AdamWState(ps, ps, ps, None)))
            pairs = list(zip(tree_leaves(placed), tree_leaves(saved)))
            out[shape] = dict(
                step=step,
                equal=all(torch.equal(dctx.whole(a), b) for a, b in pairs),
                resumed=_train_metrics(arch, device, steps=2, mesh=other,
                                       ckpt_dir=ckpt))
        return out

    t0 = time.time()
    try:
        runs = thread_ranks(rank, 4)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    wall = time.time() - t0
    stats = dict(mesh=list(MESH_SHAPE), ranks="4 threads on one card",
                 wall_s=wall, logit_max_abs_err={}, served_tokens_equal={},
                 train_max_rel_err={})
    for key in archs:
        err = max((r[key]["logits"] - want[key]["logits"]).abs().max().item()
                  for r in runs)
        if not err <= MESH_LOGIT_ATOL:
            raise AssertionError(f"{key} logits over the mesh differ by "
                                 f"{err}")
        stats["logit_max_abs_err"][key] = err
        if any(r[key]["served"] != want[key]["served"] for r in runs):
            raise AssertionError(f"{key} served over the mesh "
                                 f"{runs[0][key]['served']}, unsharded "
                                 f"{want[key]['served']}")
        stats["served_tokens_equal"][key] = sum(map(len,
                                                    want[key]["served"]))
        stats["train_max_rel_err"][key] = max(
            _close(r[key]["train"][k], want[key]["train"][k],
                   f"{key} {k} over the mesh")
            for r in runs for k in ("loss", "aux_loss", "grad_norm"))
    rec = golden.load_train_golden()
    got = runs[0]["moe"]["train"]
    stats["golden_max_rel_err"] = golden.check_train(
        got["loss"], got["aux_loss"], got["grad_norm"],
        {k: rec[k][:2] for k in ("loss", "aux_loss", "grad_norm")})
    clean = want["moe"]["train"]["loss"]
    for shape in RESHARD_SHAPES:
        for r in runs:
            got = r[shape]
            if got["step"] != 1 or not got["equal"]:
                raise AssertionError(f"restore onto {shape}: step "
                                     f"{got['step']}, equal {got['equal']}")
            stats[f"resumed_{shape[0]}x{shape[1]}_rel_err"] = _close(
                got["resumed"]["loss"], clean[1:],
                f"training resumed on {shape}")
    print(f"[mesh] reduced {json.dumps(stats)}", flush=True)
    return stats


#: the reduced families of the ``[mesh]`` phase (``golden.FAMILIES_SPEC``'s
#: and ``TRAIN_FAMILIES_SPEC``'s archs), each held over (2, 2) to the
#: unsharded port and to the reference's records
MESH_FAMILIES = ("deepseek-v2-lite-16b", "zamba2-1.2b", "xlstm-350m",
                 "hubert-xlarge", "llava-next-mistral-7b")
#: the steps of each family's training record run over the mesh
MESH_TRAIN_STEPS = 2


def _family_params(cfg, device):
    return params_from_numpy(golden.serve_params_numpy(
        cfg, golden.FAMILIES_SPEC["param_seed"]), cfg, device)


def mesh_family_inputs(cfg, device) -> dict:
    """The forward's inputs of a reduced family over the mesh: HuBERT's
    and LLaVA's records' own (``golden.family_inputs``: frames, or one
    row of patches and tokens), else :func:`run_mesh_reduced`'s (4, 32)
    tokens, a batch that splits over ``data`` (and whole chunks of the
    Mamba-2 scan)."""
    kind = ("encode" if cfg.frontend == "audio" else
            "vision" if cfg.frontend == "vision" else None)
    if kind is not None:
        return {k: torch.as_tensor(v, device=device)
                for k, v in golden.family_inputs(cfg, kind).items()}
    spec = golden.TRAIN_SPEC
    rng = np.random.default_rng(1)
    return {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab, (spec["batch"], spec["seq"])), dtype=torch.int32,
        device=device)}


def _family_forward(params, cfg, inp):
    """The family's logits on ``inp`` (HuBERT through ``encode_step``),
    gathered whole."""
    if cfg.encoder_only:
        return dctx.whole(encode_step(cfg)(params, inp["frames"]))
    return dctx.whole(lm.forward(params, cfg, inp)[0])


def first_layer_leaves(tree, path=()) -> dict:
    """``"/"``-joined path -> leaf of a nested tree of dicts, the first
    layer of each group's list."""
    if isinstance(tree, list):
        tree = tree[0]
    if not isinstance(tree, dict):
        return {"/".join(path): tree}
    out = {}
    for k, v in tree.items():
        out.update(first_layer_leaves(v, path + (k,)))
    return out


def _local_shapes(tree) -> dict:
    """(local shape, global shape) of every ``DTensor`` leaf of
    :func:`first_layer_leaves`."""
    return {k: (tuple(v.to_local().shape), tuple(v.shape))
            for k, v in first_layer_leaves(tree).items()
            if dctx.is_sharded(v)}


def mesh_family_leg(arch: str, device, mesh=None) -> dict:
    """One reduced family in f32, on ``mesh`` (a named ``DeviceMesh``,
    every rank calling alike) or unsharded on ``device``: the forward's
    logits (:func:`mesh_family_inputs`), for Zamba2 also with
    ``seq_shard_acts`` on, for the decoders a prefill of the first wave
    of ``golden.serve_requests()`` and one decode step over f32 caches
    (their last logits, and the caches after them, whole) and
    ``serve_batch``'s tokens for the record's traffic, and
    :data:`MESH_TRAIN_STEPS` steps of the training record
    (``golden.train_family_run``).  On a mesh also each parameter's and
    cache's (local, global) shape."""
    cfg = configs.get_arch(configs.ALIASES[arch]).reduced()
    params = _family_params(cfg, device)
    inp = mesh_family_inputs(cfg, device)
    out = {}
    if mesh is not None:
        placed = shd.place_params(params, mesh)
        inp = {k: shd.place(v, shd.batch_sharding(mesh, v.shape))
               for k, v in inp.items()}
        out["params"] = _local_shapes(placed.tree())
    else:
        placed = params
    with torch.no_grad(), dctx.use_mesh(mesh):
        out["logits"] = _family_forward(placed, cfg, inp)
        if cfg.ssm is not None and not cfg.xlstm:
            out["seq_logits"] = _family_forward(
                placed, dataclasses.replace(cfg, seq_shard_acts=True), inp)
        if not cfg.encoder_only:
            toks = golden.first_wave_tokens(4, device)
            caches = lm.make_caches(cfg, 4, MESH_REDUCED_SERVE["cache_len"],
                                    dtype=torch.float32, device=device)
            if mesh is not None:
                toks = shd.place(toks, shd.batch_sharding(mesh, toks.shape))
                caches = shd.place_caches(caches, mesh)
            out["prefill"] = dctx.whole(lm.forward(
                placed, cfg, {"tokens": toks}, caches=caches,
                cache_index=0)[0][:, -1])
            out["decode"] = dctx.whole(lm.forward(
                placed, cfg, {"tokens": toks[:, :1]}, caches=caches,
                cache_index=toks.shape[1])[0])
            out["caches"] = {k: [dctx.whole(t) for t in group.values()]
                             for k, group in caches.items()}
            if mesh is not None:
                out["cache_shapes"] = _local_shapes(caches)
    if not cfg.encoder_only:
        res = serve.serve_batch(arch, golden.serve_requests(), device=device,
                                mesh=mesh, params=params,
                                **golden.load_families_golden()["traffic"])
        out["served"] = [o.tolist() for o in res.outputs]
    out["train"] = golden.train_family_run(arch, device, mesh=mesh,
                                           steps=MESH_TRAIN_STEPS)
    return out


def run_mesh_families(archs, device) -> tuple[dict, list]:
    """:func:`mesh_family_leg` of each of ``archs`` unsharded on
    ``device``, then over a (2, 2) mesh of four thread-ranks: (the
    unsharded legs, each rank's legs)."""
    want = {a: mesh_family_leg(a, device) for a in archs}

    def rank(r):
        mesh = device_mesh(*MESH_SHAPE, device)
        return {a: mesh_family_leg(a, device, mesh) for a in archs}

    return want, thread_ranks(rank, 4)


def cache_err(got: dict, want: dict) -> float:
    """The largest |got - want| / max(1, max |want|) over two runs' f32
    caches (group -> list of whole leaves); raises unless every element is
    within :data:`MESH_LOGIT_ATOL` of the leaf's max(1, max |want|) (a
    recurrent state grows past 1)."""
    err = 0.0
    for k, leaves in want.items():
        for g, w in zip(got[k], leaves):
            scale = max(1.0, w.abs().max().item())
            if g.shape != w.shape or (g - w).abs().max().item() > \
                    MESH_LOGIT_ATOL * scale:
                raise AssertionError(
                    f"cache {k} over the mesh differs by "
                    f"{(g - w).abs().max().item()} (max |value| {scale})")
            err = max(err, (g - w).abs().max().item() / scale)
    return err


def run_mesh_families_reduced(device="cuda", archs=MESH_FAMILIES) -> dict:
    """The reduced families in f32 over (2, 2) thread-ranks
    (:func:`run_mesh_families`), every rank held to the unsharded port:
    the forward's and the prefill's logits and the prefill's caches within
    :data:`MESH_LOGIT_ATOL` (Zamba2's sequence-parallel forward too), the
    decoders' served tokens equal, the training steps within
    :data:`MESH_METRIC_RTOL`; and rank 0 to the reference's records
    (``families_reduced.json``: the served tokens,
    HuBERT's encode and LLaVA's vision logits; the first steps of
    ``train_families_reduced.json``).  Raises on a miss."""
    t0 = time.time()
    want, runs = run_mesh_families(archs, device)
    wall = time.time() - t0
    fam = golden.load_families_golden()
    trained = golden.load_train_families_golden()["archs"]
    stats = dict(mesh=list(MESH_SHAPE), ranks="4 threads on one card",
                 wall_s=wall)
    for arch in archs:
        w, got = want[arch], [r[arch] for r in runs]
        row = {}
        for key in ("logits", "seq_logits", "prefill", "decode"):
            if key in w:
                err = max((g[key] - w[key]).abs().max().item()
                          for g in got)
                if not err <= MESH_LOGIT_ATOL:
                    raise AssertionError(f"{arch} {key} over the mesh "
                                         f"differ by {err}")
                row[f"{key}_max_abs_err"] = err
        if "caches" in w:
            row["cache_max_rel_err"] = max(
                cache_err(g["caches"], w["caches"]) for g in got)
        if "served" in w:
            if any(g["served"] != w["served"] for g in got):
                raise AssertionError(f"{arch} served over the mesh "
                                     f"{got[0]['served']}, unsharded "
                                     f"{w['served']}")
            row["served_tokens_equal"] = sum(map(len, w["served"]))
            row["golden_tokens_compared"] = golden.check_serve_tokens(
                got[0]["served"], fam["serve"][arch])
        row["train_max_rel_err"] = max(
            _close(g["train"][k], w["train"][k], f"{arch} {k} over the mesh")
            for g in got for k in ("loss", "aux_loss", "grad_norm"))
        kind = {"hubert-xlarge": "encode",
                "llava-next-mistral-7b": "vision"}.get(arch)
        if kind is not None:
            row["golden_logit_max_abs_err"] = golden.check_logits(
                got[0]["logits"], fam[kind])
        g = got[0]["train"]
        row["golden_train_max_rel_err"] = golden.check_train(
            g["loss"], g["aux_loss"], g["grad_norm"],
            {k: trained[arch][k][:MESH_TRAIN_STEPS]
             for k in ("loss", "aux_loss", "grad_norm")})
        stats[arch] = row
    print(f"[mesh] families {json.dumps(stats)}", flush=True)
    return stats


#: the ``[dryrun]`` phase's real step: the ``[serve]`` cell's Phi-3.5-MoE
#: at full width, 2 of its 32 layers, one greedy decode step of 4 slots
#: against a 512-token cache, counted on the card and on fake tensors
DRYRUN_CFG = dataclasses.replace(SERVE_CFG, n_layers=2)
DRYRUN_SLOTS, DRYRUN_CACHE = 4, 512
#: the dry run's cells run on the card's host (arch, shape, multi-pod):
#: fake tensors on the 256- and 512-rank fake process groups
DRYRUN_CELLS = (("phi35_moe_42b", "decode_32k", False),
                ("zamba2_1p2b", "long_500k", True))


def run_dryrun(card: str) -> dict:
    """The dry run and the roofline (``[dryrun]``): the counter's rule for
    ``DTensor``s on this torch (rank 0's 1,048,576 FLOPs and a 2,048-byte
    all-gather on 512 fake ranks), one real decode step of
    :data:`DRYRUN_CFG` on the card under the counter, with the kernel
    launched, whose FLOPs and eager bytes must equal the same step's on
    fake ``cuda`` tensors, timed beside its roofline bound, and the
    :data:`DRYRUN_CELLS` through ``dryrun.run_cell(device="cuda")``, which
    must allocate nothing on the card and leave no process group."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise AssertionError("a process group outlived the earlier phases")
    probe = dryrun_check.skip_rule_probe("cuda")
    print(f"[dryrun] skip rule {json.dumps(probe)}", flush=True)
    if probe["product_flops"] != 1_048_576 or probe[
            "gather_bytes"]["all-gather"] != 2 * 256 * 4:
        raise AssertionError(f"the counter's DTensor rule on torch "
                             f"{torch.__version__}: {probe}")

    disp = dryrun_check.dispatch_us("cuda")
    print(f"[dryrun] group_matmul operator dispatch {json.dumps(disp)}",
          flush=True)
    step = dryrun_check.real_vs_fake(DRYRUN_CFG, slots=DRYRUN_SLOTS,
                                     cache_len=DRYRUN_CACHE, device="cuda")
    print(f"[dryrun] step {json.dumps(step)}; {card}", flush=True)
    if (step["real_flops"], step["real_bytes"]) != (step["fake_flops"],
                                                    step["fake_bytes"]):
        raise AssertionError(f"the real step counts otherwise than the "
                             f"fake one: {step}")
    if step["group_matmul_launches"] != 3 * DRYRUN_CFG.n_layers:
        raise AssertionError(f"group_matmul launched "
                             f"{step['group_matmul_launches']} times in the "
                             f"counted step, not 3 a layer")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cells = []
    for arch, shape, multi in DRYRUN_CELLS:
        t0 = time.time()
        rec = dryrun.run_cell(arch, shape, multi, save=False, device="cuda")
        if dist.is_initialized():
            raise AssertionError("run_cell left a process group behind")
        rec["wall_s"] = time.time() - t0
        print(f"[dryrun] cell {json.dumps(rec)}", flush=True)
        cells.append({k: rec[k] for k in (
            "arch", "shape", "mesh", "flops_reported", "bytes_reported",
            "collective_total", "memory", "model_flops", "wall_s")})
    peak = torch.cuda.max_memory_allocated()
    if peak > base:
        raise AssertionError(f"the fake cells allocated on the card: peak "
                             f"{peak} B over {base} B")
    keep = ("real_flops", "real_bytes", "group_matmul_launches", "step_ms",
            "t_compute_ms", "t_memory_ms", "bound_ms", "bound_share")
    return dict(probe=probe, dispatch=disp, step={k: step[k] for k in keep},
                cells=cells, card=card)


def training_shape_times(stats: dict, calls: dict,
                         name: str = "group_matmul_train") -> list:
    """The ``<name>`` and ``<name>_dx`` rows: the kernel on a training
    leg's recorded layer-0 operands of step :data:`TRAIN_RECORD_STEP`
    (bf16; ``group_matmul_train``: Phi-3.5-MoE, tile_m 128, capacity 160
    padded to 256, 4096 <-> 6400; ``group_matmul_deepseek_train``:
    DeepSeek-V2-Lite, 64 experts, 2048 <-> 1408), forward ``wg`` in the
    row's own keys and ``wo`` beside it, and the backward's dx (``dy @
    w^T``, one ``trans_w`` launch as the training path runs it, ``w`` read
    in place) for both; each with the CTA shape the launcher took
    (``cta_shape``); launches (a step beside the leg's) and max |err| are
    the training path's."""
    meta = KERNELS["group_matmul"]
    first = 3 * stats["n_layers"] * TRAIN_RECORD_STEP
    fwd, dx = {}, {}
    few = dict(reps=7, plain_reps=3, inner=3)
    for n, tag in ((first, "wg"), (first + 2, "wo")):
        r = calls[n]
        w = r["w"]
        fwd[tag] = expert_shape_times(r["xe"], w, **few)
        dx[tag] = expert_shape_times(r["dy"].to(w.dtype), w, trans_w=True,
                                     **few)
    errs = stats["max_abs_err"]
    rows = []
    for row, times, kind, count in (
            (name, fwd, "forward", "launches_forward"),
            (f"{name}_dx", dx, "dx", "launches_dx")):
        wg = times.pop("wg")
        rows.append(dict(
            name=row, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=stats[count],
            launches_per_step=stats[count] / stats["steps"],
            max_abs_err=max(v for k, v in errs.items()
                            if k.startswith(kind)),
            dtype="bfloat16", **wg, **times))
    return rows


def shares(row: dict) -> dict:
    """The row's ranking keys: ``bound_share`` (bound_ms / ms: the share of
    the card's least time the kernel reaches) and ``vs_library`` (ms /
    library_ms: above 1 the kernel is slower than one PyTorch call)."""
    lib = row.get("library_ms")
    return dict(row, bound_share=row["bound_ms"] / row["ms"],
                vs_library=None if lib is None else row["ms"] / lib)


@torch.inference_mode()
def expert_shape_times(xe: torch.Tensor, w: torch.Tensor, *,
                       trans_w: bool = False, reps: int = 21,
                       plain_reps: int = 21, inner: int = 10) -> dict:
    """``grouped_expert_matmul(xe, w)``'s product (``trans_w``: its dx's,
    ``xe @ w^T``) on the kernel, its plain version and ``torch.bmm`` timed
    on the given operands, beside the bound of the rows the call needs
    (``c`` real rows, whatever the tiles pad) and the CTA shape the
    launcher took."""
    e, c, d = xe.shape
    f = w.shape[1] if trans_w else w.shape[2]
    nbytes = (e * c * d + e * d * f) * w.element_size() + e * c * f * 4
    flops = 2 * e * c * d * f
    wb = w.transpose(1, 2) if trans_w else w
    x, _, tile_m = tile_by_expert(xe)
    cta_shape = launch_shape(x, w, tile_m=tile_m, trans_w=trans_w)
    if cta_shape.endswith("_tma"):   # the weight stream's split
        cta_shape += f" ({launch_plan(x, w, tile_m=tile_m).describe()})"
    return shares(dict(
        shape=[e, c, d, f],
        cta_shape=cta_shape,
        ms=time_ms(lambda: expert_product(xe, w, trans_w=trans_w), reps,
                   inner),
        plain_ms=time_ms(lambda: plain_grouped(xe, w, trans_w=trans_w),
                         plain_reps, 1 if plain_reps < reps else inner),
        **bound(nbytes, flops, w.dtype),
        library_ms=library_ms(lambda: torch.bmm(xe, wb), reps, inner),
        bytes=nbytes, flops=flops))


def serving_shape_times(served: dict, calls: dict,
                        name: str = "group_matmul_serve") -> dict:
    """A serving row (``group_matmul_serve``: Phi-3.5-MoE, 16 experts,
    4096 -> 6400; ``group_matmul_deepseek_serve``: DeepSeek-V2-Lite, 64
    experts, 2048 -> 1408): the kernel on the serving path's layer-0
    operands (bf16, tile_m 8) at the first decode step (``wg``'s shape,
    ``wi``'s too, in the row's own keys and ``wo``'s beside it) and at the
    first prefill for both: kernel, plain and ``torch.bmm`` times and the
    bound of the rows each call needs; launches and max |err| are the
    serving path's."""
    meta = KERNELS["group_matmul"]
    per_fwd = 3 * served["n_layers"]
    shapes = {}
    for n, tag in ((per_fwd, "wg"), (per_fwd + 2, "wo"), (0, "prefill_wg"),
                   (2, "prefill_wo")):
        shapes[tag] = expert_shape_times(calls[n]["xe"], calls[n]["w"])
    wg = shapes.pop("wg")
    return dict(
        name=name, route="cuda", source=meta["source"],
        replaces=meta["replaces"], arch=served["arch"],
        launches=served["group_matmul_launches"],
        max_abs_err=max(served["max_abs_err"].values()), dtype="bfloat16",
        **wg, **shapes)


def check_kernels(errs: dict) -> list:
    """Each kernel timed beside its plain version and its bound; ``errs``
    is the legs' max |kernel - plain| per kernel and dtype."""
    rows = []
    legs = bench_kernels.leg_inputs(torch.float32, "cuda")
    for name, meta in KERNELS.items():
        args = legs[name]
        w = bench_kernels.work(name, args)
        row = dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=None,
            max_abs_err=errs[name]["float32"],
            ms=time_ms(lambda: bench_kernels.run_kernel(name, args)),
            plain_ms=time_ms(lambda: bench_kernels.run_plain(name, args)),
            **bound(w["bytes"], w["flops"], torch.float32),
            library_ms=None, dtype="float32",
            max_abs_err_bf16=errs[name]["bfloat16"],
            flops=w["flops"], bytes=w["bytes"])
        if name == "bcsr_spmm":   # the cluster size the wrapper launched
            row["split"] = launch_split(args["a"], args["b"])
        rows.append(row)
    # the library yardsticks last: a refused call cannot disturb the rest
    for row in rows:
        try:
            row["library_ms"] = library_ms(
                library_call(row["name"], legs[row["name"]]))
        except (RuntimeError, NotImplementedError) as e:
            row["library_error"] = f"{type(e).__name__}: {e}"[:300]
    rows = [shares(row) for row in rows]
    for row in rows:
        print(f"[kernel] {json.dumps(row)}", flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t0 = time.time()
    build_s = _build.build_all()
    print(f"[build] {build_s:.1f} s for {_build.sources()}", flush=True)
    for src, log in _build.BUILD_LOG.items():
        print(f"[build] {src}: {log.strip()}", flush=True)
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- the engine chunk: the kernel against its plain version -------------
    t_cyc = time.time()
    cycle_row = run_cycle()
    print(f"[cycle] phase {time.time() - t_cyc:.1f} s", flush=True)

    # --- the simulator and kernel-leg path, launch counts from zero ----------
    # (the engine chunk's count from zero before each simulator phase)
    for meta in KERNELS.values():
        meta["wrapper"].launches = 0
    cycle_chunk.launches = 0
    t_ph = time.time()
    sim, grid_a = run_grids()
    chunks = {"[sim]": chunk_launches("[sim]", t_ph)}
    t_ph = time.time()
    sim["sweeps"] = run_sweeps()
    chunks["[sweep]"] = chunk_launches("[sweep]", t_ph)
    t_ph = time.time()
    sim["service"] = run_service()
    chunks["[service]"] = chunk_launches("[service]", t_ph)
    errs = bench_kernels.main(device="cuda")
    torch.cuda.synchronize()
    launches = {n: m["wrapper"].launches for n, m in KERNELS.items()}
    print(f"[legs] launches {launches}; legs max |err| {errs}", flush=True)
    for n, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{n} was not launched on the legs' path")
    exact = bench_kernels.tc_exact("cuda")
    torch.cuda.synchronize()
    print(f"[kernel] group_matmul's tensor-core shape equals the exact sums "
          f"bit for bit, w as stored and transposed: {json.dumps(exact)}",
          flush=True)
    exact = bench_kernels.stream_exact("cuda")
    torch.cuda.synchronize()
    print(f"[kernel] group_matmul's weight stream equals the exact sums bit "
          f"for bit, w as stored and transposed: {json.dumps(exact)}",
          flush=True)

    # --- the paper-figure drivers over grid A's rows ------------------------
    t_fig = time.time()
    cycle_chunk.launches = 0
    figures = run_figures(grid_a)
    chunks["[figures]"] = chunk_launches("[figures]", t_fig)
    del grid_a

    # --- the serving path, launch counts from zero ---------------------------
    served, calls = run_serve()
    compared = run_reduced_serve()
    serve_row = serving_shape_times(served, calls)
    print(f"[kernel] {json.dumps(serve_row)}", flush=True)
    del calls
    torch.cuda.empty_cache()

    # --- the training path, launch counts from zero in each leg --------------
    t_train = time.time()
    trained, calls = run_train_moe()
    torch.cuda.empty_cache()
    train_reduced = run_train_reduced()
    dense = run_train_dense()
    train_rows = training_shape_times(trained, calls)
    for row in train_rows:
        print(f"[kernel] {json.dumps(row)}", flush=True)
    del calls
    torch.cuda.empty_cache()
    print(f"[train] phase {time.time() - t_train:.1f} s", flush=True)

    # --- the other families, launch counts from zero in each serve ----------
    t_fam = time.time()
    families, calls = run_families()
    families_reduced = run_families_reduced()
    deepseek_row = serving_shape_times(
        families["deepseek-v2-lite-16b"], calls,
        name="group_matmul_deepseek_serve")
    print(f"[kernel] {json.dumps(deepseek_row)}", flush=True)
    del calls
    torch.cuda.empty_cache()
    print(f"[families] phase {time.time() - t_fam:.1f} s", flush=True)

    # --- the families' training, launch counts from zero in each leg -------
    t_tf = time.time()
    fam_trained, calls = run_train_families()
    fam_train_reduced = run_train_families_reduced()
    deepseek_train_rows = training_shape_times(
        fam_trained["deepseek-v2-lite-16b"], calls,
        name="group_matmul_deepseek_train")
    for row in deepseek_train_rows:
        print(f"[kernel] {json.dumps(row)}", flush=True)
    del calls
    torch.cuda.empty_cache()
    print(f"[train-families] phase {time.time() - t_tf:.1f} s", flush=True)

    # --- the static golden engine and the scale layer's oracles -------------
    t_st = time.time()
    cycle_chunk.launches = 0
    static = run_static()
    if cycle_chunk.launches:
        raise AssertionError("[static] the static engine launched the "
                             "engine chunk kernel")
    print(f"[static] phase {time.time() - t_st:.1f} s", flush=True)
    sparse_row = run_sparse()

    # --- the multi-device slice on logical shards of the card ---------------
    t_sh = time.time()
    cycle_chunk.launches = 0
    shard_rows = run_shard()
    chunks["[shard]"] = chunk_launches("[shard]", t_sh)
    t_am = time.time()
    dispatch_rows = run_dispatch()
    print(f"[dispatch] phase {time.time() - t_am:.1f} s", flush=True)

    # --- model parallelism over thread-ranks, launch counts from zero -------
    t_mesh = time.time()
    mesh_served, calls = run_mesh_serve()
    mesh_row = serving_shape_times(mesh_served, calls,
                                   name="group_matmul_mesh_serve")
    print(f"[kernel] {json.dumps(mesh_row)}", flush=True)
    del calls
    torch.cuda.empty_cache()
    mesh_deepseek, calls = run_mesh_serve(MESH_DEEPSEEK_CFG)
    mesh_deepseek_row = serving_shape_times(
        mesh_deepseek, calls, name="group_matmul_deepseek_mesh_serve")
    print(f"[kernel] {json.dumps(mesh_deepseek_row)}", flush=True)
    del calls
    torch.cuda.empty_cache()
    mesh_reduced = run_mesh_reduced()
    mesh_families = run_mesh_families_reduced()
    print(f"[mesh] phase {time.time() - t_mesh:.1f} s", flush=True)

    # --- the dry run and the roofline on the card's host --------------------
    t_dr = time.time()
    dry = run_dryrun(card)
    print(f"[dryrun] phase {time.time() - t_dr:.1f} s", flush=True)

    rows = check_kernels(errs)
    for row in rows:
        row["launches"] = launches[row["name"]]
    # the engine chunk's launches on the main path: the grids' run
    rows.append(shares(dict(cycle_row, launches=chunks["[sim]"],
                            launches_by_phase=chunks)))
    rows.append(serve_row)
    rows += train_rows
    rows.append(deepseek_row)
    rows += deepseek_train_rows
    rows += [mesh_row, mesh_deepseek_row]
    print(f"[done] {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"simulator": sim, "serve": {
        k: served[k] for k in ("serves", "prefill_s", "decode_s",
                               "decode_tok_s", "group_matmul_launches",
                               "peak_mem_bytes")},
        "serve_reduced_tokens_compared": compared,
        "train": {k: trained[k] for k in (
            "step_ms", "tokens_per_s", "peak_mem_bytes", "losses",
            "group_matmul_launches")},
        "train_reduced": train_reduced,
        "train_dense": {k: dense[k] for k in (
            "tokens_per_s", "step_ms_median", "peak_mem_bytes")},
        "families": {k: {f: v[f] for f in (
            "prefill_s", "decode_s", "decode_tok_s", "wall_s",
            "peak_mem_bytes", "group_matmul_launches") if f in v}
            for k, v in families.items()},
        "families_reduced": families_reduced,
        "train_families": {k: {f: v[f] for f in (
            "step_ms", "tokens_per_s", "peak_mem_bytes", "losses",
            "group_matmul_launches")} for k, v in fam_trained.items()},
        "train_families_reduced": fam_train_reduced,
        "static": static, "sparse": sparse_row, "shard": shard_rows,
        "dispatch": dispatch_rows, "mesh": {
            **{key: {k: v[k] for k in (
                "arch", "wall_s", "prefill_s", "decode_s", "decode_tok_s",
                "group_matmul_launches", "launches_by_rank", "local_experts",
                "peak_mem_bytes", "prefill_rel_err", "max_forward_rel_err",
                "choices_compared")} for key, v in (
                    ("serve", mesh_served), ("deepseek", mesh_deepseek))},
            "reduced": mesh_reduced, "families": mesh_families},
        "dryrun": dry, "figures": figures, "cycle": {
            k: cycle_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "floor_ms", "chain_ff_ms",
                                      "fig17_wave_ms", "legs")},
        "cycle_chunk_launches": chunks}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
