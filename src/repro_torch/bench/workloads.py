"""Benchmark workload generators (paper §4.2).

The paper evaluates pruned-ResNet-50 matrices (unstructured sparsity with
the skew real pruning produces), a ViTCoD-style sparse-attention mask for
SDDMM, and the infect-dublin graph.  Offline we synthesize matched
surrogates: power-law row lengths for pruned weights (magnitude pruning
concentrates survivors unevenly), block-diagonal-heavy masks for sparse
attention, and small-world graphs (same regime as infect-dublin's contact
network) for the graph kernels.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Callable

import numpy as np

from repro_torch.core import baselines, compiler
from repro_torch.core.machine import MachineConfig


def powerlaw_sparse(m, n, rng, density, alpha=1.8, col_alpha=1.2):
    """Unstructured sparsity with power-law skew on BOTH row lengths and
    column choice (hot rows + hot columns) at a target density — the shape
    magnitude pruning and natural graphs actually produce."""
    target = int(round(m * n * density))
    raw = (rng.pareto(alpha, size=m) + 1)
    lens = np.maximum(1, (raw / raw.sum() * target).astype(int))
    lens = np.minimum(lens, n)
    colw = (rng.pareto(col_alpha, size=n) + 1)
    colp = colw / colw.sum()
    a = np.zeros((m, n), dtype=np.int64)
    for i in range(m):
        cols = rng.choice(n, size=lens[i], replace=False, p=colp)
        a[i, cols] = rng.integers(1, 4, size=lens[i])
    return a


def attention_mask(s, rng, density):
    """ViTCoD-like: dense diagonal band + random global tokens."""
    m = np.zeros((s, s), dtype=np.int64)
    band = max(1, int(s * density * 0.5))
    for i in range(s):
        lo = max(0, i - band)
        m[i, lo:i + 1] = 1
    n_glob = max(1, int(s * density * 0.3))
    glob = rng.choice(s, size=n_glob, replace=False)
    m[:, glob] = 1
    return m


def _watts_strogatz(nv, k, p, rnd):
    """One Watts-Strogatz draw as adjacency sets, consuming ``rnd`` exactly
    as networkx 3.x ``watts_strogatz_graph`` does (ring lattice of k // 2
    neighbours per side, then per-edge rewiring, distance-major)."""
    if k > nv:
        raise ValueError("k>n, choose smaller k or larger n")
    nodes = list(range(nv))
    if k == nv:
        return [set(nodes) - {u} for u in nodes]
    adj = [set() for _ in nodes]
    for j in range(1, k // 2 + 1):
        for u in nodes:
            v = (u + j) % nv
            adj[u].add(v)
            adj[v].add(u)
    for j in range(1, k // 2 + 1):
        for u in nodes:
            v = (u + j) % nv
            if rnd.random() < p:
                w = rnd.choice(nodes)
                # no self-loops or multi-edges; a saturated node keeps v
                while w == u or w in adj[u]:
                    w = rnd.choice(nodes)
                    if len(adj[u]) >= nv - 1:
                        break
                else:
                    adj[u].remove(v)
                    adj[v].remove(u)
                    adj[u].add(w)
                    adj[w].add(u)
    return adj


def _is_connected(adj):
    seen, todo = {0}, [0]
    while todo:
        for v in adj[todo.pop()]:
            if v not in seen:
                seen.add(v)
                todo.append(v)
    return len(seen) == len(adj)


def small_world_graph(nv, k, rng_seed, p=0.3, tries=100):
    """Connected small-world graph as CSR ``(rowptr, col)``: the edge set
    networkx 3.x ``connected_watts_strogatz_graph(nv, k, p, seed=rng_seed)``
    returns, drawn in pure Python from the same ``random.Random(rng_seed)``
    stream (redrawn until connected, at most ``tries`` times)."""
    rnd = random.Random(rng_seed)
    for _ in range(tries):
        adj = _watts_strogatz(nv, k, p, rnd)
        if _is_connected(adj):
            break
    else:
        raise RuntimeError("Maximum number of tries exceeded")
    rp = np.zeros((nv + 1,), dtype=np.int64)
    cols = []
    for v in range(nv):
        nbrs = sorted(adj[v])
        rp[v + 1] = rp[v] + len(nbrs)
        cols.extend(nbrs)
    return rp, np.array(cols, dtype=np.int64)


def pointer_chase_graph(n_nodes, seed=3):
    """A SCRAMBLED chain: node i's single successor is the next node of
    a random permutation, so BFS over it is a serial pointer chase whose
    every hop is a long lone flight across the mesh — the workload class
    the event-compressed engine (``MachineConfig.fast_forward``) exists
    for.  Returns ``(rowptr, col, src)`` for ``compiler.build_bfs``.
    """
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_nodes)
    rowptr = np.zeros((n_nodes + 1,), dtype=np.int64)
    cols = []
    succ = {int(perm[i]): int(perm[i + 1]) for i in range(n_nodes - 1)}
    for i in range(n_nodes):
        if i in succ:
            cols.append(succ[i])
        rowptr[i + 1] = len(cols)
    return rowptr, np.array(cols, dtype=np.int64), int(perm[0])


@dataclasses.dataclass
class Workload:
    name: str
    sparsity_note: str
    build: Callable[[MachineConfig, str], Any]  # (cfg, strategy) -> CompiledWorkload
    useful_ops: int
    cgra: Callable[[], Any] | None             # -> CgraResult
    systolic_cycles: float | None
    mem_words: int = 2048


def make_all(seed: int = 7) -> list[Workload]:
    rng = np.random.default_rng(seed)
    out: list[Workload] = []

    # ---- SpMSpM S1..S4 (sparsity of A / B per the paper's categories) ----
    n = 32
    for tag, (da, db) in {
        "spmspm_s1": (0.5, 0.5),     # both moderately sparse (30-60%)
        "spmspm_s2": (0.2, 0.5),     # A highly sparse (60-90%)
        "spmspm_s3": (0.5, 0.2),
        "spmspm_s4": (0.2, 0.2),
    }.items():
        a = powerlaw_sparse(n, n, rng, da)
        b = powerlaw_sparse(n, n, rng, db)
        a_rp, a_col, _ = compiler.csr_from_dense(a)
        b_rp, _, _ = compiler.csr_from_dense(b)
        prods = int(sum((b_rp[k + 1] - b_rp[k]) for k in a_col))
        out.append(Workload(
            name=tag,
            sparsity_note=f"A {100*(1-da):.0f}% B {100*(1-db):.0f}%",
            build=lambda c, s_, a=a, b=b: compiler.build_spmspm(a, b, c, strategy=s_),
            useful_ops=2 * prods,
            cgra=lambda a=a, b=b: baselines.cgra_spmspm(a, b),
            systolic_cycles=baselines.systolic_cycles(
                "spmspm", dict(m=n, k=n, n=n)),
        ))

    # ---- SpMV (pruned-weight surrogate, 70% sparse) -----------------------
    m = 96
    a = powerlaw_sparse(m, m, rng, 0.3)
    out.append(Workload(
        name="spmv", sparsity_note="70%",
        build=lambda c, s_, a=a, x=rng.integers(-3, 4, size=(m,)):
            compiler.build_spmv(a, x, c, strategy=s_),
        useful_ops=2 * int(np.count_nonzero(a)),
        cgra=lambda a=a: baselines.cgra_spmv(a),
        systolic_cycles=baselines.systolic_cycles("spmv", dict(m=m, k=m)),
    ))

    # ---- SpM+SpM ----------------------------------------------------------
    n2 = 48
    aa = powerlaw_sparse(n2, n2, rng, 0.3)
    bb = powerlaw_sparse(n2, n2, rng, 0.3)
    out.append(Workload(
        name="spmadd", sparsity_note="70%",
        build=lambda c, s_, a=aa, b=bb: compiler.build_spmadd(a, b, c, strategy=s_),
        useful_ops=int(np.count_nonzero(aa) + np.count_nonzero(bb)),
        cgra=lambda a=aa, b=bb: baselines.cgra_spmadd(a, b),
        systolic_cycles=baselines.systolic_cycles(
            "spmadd", dict(m=n2, k=n2, n=n2)),
    ))

    # ---- SDDMM (sparse-attention mask) -------------------------------------
    s, dk = 24, 16
    ad = rng.integers(-3, 4, size=(s, dk))
    bd = rng.integers(-3, 4, size=(dk, s))
    mask = attention_mask(s, rng, 0.3)
    out.append(Workload(
        name="sddmm", sparsity_note=f"{100*(1-mask.mean()):.0f}%",
        build=lambda c, s_, a=ad, b=bd, m_=mask: compiler.build_sddmm(
            a, b, m_, c, strategy=s_),
        useful_ops=2 * dk * int(mask.sum()),
        cgra=lambda a=ad, b=bd, m_=mask: baselines.cgra_sddmm(a, b, m_),
        systolic_cycles=baselines.systolic_cycles(
            "sddmm", dict(m=s, k=dk, n=s)),
    ))

    # ---- dense ------------------------------------------------------------
    dm = 16
    da_ = rng.integers(-3, 4, size=(dm, dm))
    db_ = rng.integers(-3, 4, size=(dm, dm))
    out.append(Workload(
        name="matmul", sparsity_note="dense",
        build=lambda c, s_, a=da_, b=db_: compiler.build_matmul(a, b, c, strategy=s_),
        useful_ops=2 * dm ** 3,
        cgra=lambda a=da_, b=db_: baselines.cgra_spmspm(a, b),
        systolic_cycles=baselines.systolic_cycles(
            "matmul", dict(m=dm, k=dm, n=dm)),
    ))
    mv_m = 48
    mva = rng.integers(-3, 4, size=(mv_m, mv_m))
    out.append(Workload(
        name="mv", sparsity_note="dense",
        build=lambda c, s_, a=mva, x=rng.integers(-3, 4, size=(mv_m,)):
            compiler.build_mv(a, x, c, strategy=s_),
        useful_ops=2 * mv_m * mv_m,
        cgra=lambda a=mva: baselines.cgra_spmv(a),
        systolic_cycles=baselines.systolic_cycles(
            "mv", dict(m=mv_m, k=mv_m)),
    ))
    xc = rng.integers(-2, 3, size=(8, 8, 2))
    wc = rng.integers(-2, 3, size=(3, 3, 2, 2))
    oh = ow = 6
    out.append(Workload(
        name="conv", sparsity_note="dense",
        build=lambda c, s_, x=xc, w=wc: compiler.build_conv(x, w, c, strategy=s_),
        useful_ops=2 * oh * ow * 3 * 3 * 2 * 2,
        cgra=None,   # im2col patches @ filters ≈ matmul on CGRA
        systolic_cycles=baselines.systolic_cycles(
            "conv", dict(m=oh * ow, k=3 * 3 * 2, n=2)),
        mem_words=4096,
    ))

    # ---- graphs ------------------------------------------------------------
    rp, col = small_world_graph(96, 6, 3)
    out.append(Workload(
        name="bfs", sparsity_note="graph",
        build=lambda c, s_, rp=rp, col=col: compiler.build_bfs(rp, col, 0, c, strategy=s_),
        useful_ops=2 * int(col.size),
        cgra=None, systolic_cycles=None,
    ))
    rp2, col2 = small_world_graph(96, 6, 5)
    wgt = rng.integers(1, 8, size=col2.shape)
    out.append(Workload(
        name="sssp", sparsity_note="graph",
        build=lambda c, s_, rp=rp2, col=col2, w=wgt: compiler.build_sssp(
            rp, col, w, 0, c, strategy=s_),
        useful_ops=2 * int(col2.size),
        cgra=None, systolic_cycles=None,
    ))
    rp3, col3 = small_world_graph(96, 6, 9)
    rank = np.full((rp3.shape[0] - 1,), 1024, dtype=np.int64)
    out.append(Workload(
        name="pagerank", sparsity_note="graph",
        build=lambda c, s_, rp=rp3, col=col3, r=rank: compiler.build_pagerank(
            rp, col, r, c, strategy=s_),
        useful_ops=2 * int(col3.size),
        cgra=None, systolic_cycles=None,
    ))
    return out
