"""The benchmark's inputs: every matrix, vector and graph a lane computes on.

Frozen copies of the program's traffic generators
(``repro_torch/bench/workloads.py``: ``powerlaw_sparse``,
``attention_mask``, ``small_world_graph``; the input draws of
``make_all`` and of ``bench/fig17.py``), so that a later change to the
program cannot move the yardstick.  ``test_nexusbench_inputs.py`` holds
them to the originals at the originals' sizes.

A traffic file lists kernels as data (``kind`` plus its sizes); one
function, :func:`draw`, turns each into its inputs from one generator,
in file order.  :func:`draw_traffic` fixes each kernel's structure by
the file's own seeds and draws every value from ``--seed``, so a seed
fixes every input of a run.  Nothing here imports the program.
"""
from __future__ import annotations

import random

import numpy as np


def powerlaw_sparse(m, n, rng, density, alpha=1.8, col_alpha=1.2):
    """Unstructured sparsity with power-law skew on both row lengths and
    column choice (hot rows and hot columns) at a target density."""
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
    """ViTCoD-like sparse-attention mask: a dense diagonal band plus
    random global tokens."""
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
    """One Watts-Strogatz draw as adjacency sets (ring lattice of k // 2
    neighbours a side, then per-edge rewiring, distance-major)."""
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
    """Connected small-world graph as CSR ``(rowptr, col)``, drawn from
    ``random.Random(rng_seed)`` (redrawn until connected)."""
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


def draw(spec: dict, rng: np.random.Generator, graph_seed: int) -> dict:
    """The inputs of one kernel of a traffic file, drawn from ``rng`` in
    the order ``make_all`` draws them; a graph is drawn from
    ``graph_seed``.  ``spec["kind"]`` names the computation."""
    kind = spec["kind"]
    if kind in ("spmspm", "spmadd"):
        n = spec["n"]
        return dict(a=powerlaw_sparse(n, n, rng, spec["density_a"]),
                    b=powerlaw_sparse(n, n, rng, spec["density_b"]))
    if kind == "spmv":
        m = spec["m"]
        a = powerlaw_sparse(m, m, rng, spec["density"])
        return dict(a=a, x=rng.integers(-3, 4, size=(m,)))
    if kind == "sddmm":
        s, dk = spec["s"], spec["dk"]
        a = rng.integers(-3, 4, size=(s, dk))
        b = rng.integers(-3, 4, size=(dk, s))
        return dict(a=a, b=b, mask=attention_mask(s, rng, spec["density"]))
    if kind == "matmul":
        n = spec["n"]
        return dict(a=rng.integers(-3, 4, size=(n, n)),
                    b=rng.integers(-3, 4, size=(n, n)))
    if kind == "mv":
        m = spec["m"]
        a = rng.integers(-3, 4, size=(m, m))
        return dict(a=a, x=rng.integers(-3, 4, size=(m,)))
    if kind == "conv":
        h = spec["h"]
        x = rng.integers(-2, 3, size=(h, h, spec["cin"]))
        w = rng.integers(-2, 3, size=(spec["k"], spec["k"], spec["cin"],
                                      spec["cout"]))
        return dict(x=x, w=w)
    if kind in ("bfs", "sssp", "pagerank"):
        rp, col = small_world_graph(spec["nodes"], spec["degree"], graph_seed)
        out = dict(rowptr=rp, col=col)
        if kind == "sssp":
            out["weight"] = rng.integers(1, 8, size=col.shape)
        if kind == "pagerank":
            out["rank"] = np.full((spec["nodes"],), spec["rank"],
                                  dtype=np.int64)
        return out
    raise ValueError(f"unknown kernel kind {kind!r}")


def draw_all(kernels: list, seed: int, graph_seeds=None) -> list[dict]:
    """Every kernel's inputs from one seed: one generator, drawn in file
    order; graph ``i`` from its own seed (``graph_seeds[i]`` where given,
    as ``make_all`` fixes them, else one drawn from ``seed``)."""
    rng = np.random.default_rng(seed)
    gen = np.random.default_rng([seed, 1])
    out = []
    for i, spec in enumerate(kernels):
        gs = (graph_seeds[i] if graph_seeds is not None
              else int(gen.integers(2 ** 31)))
        out.append(draw(spec, rng, gs))
    return out


def _renew(a, rng, lo, hi):
    """``a`` with each nonzero drawn anew from the nonzero integers of
    [lo, hi).  The zeros stay where they are: the compiler drops a zero
    operand (``csr_from_dense``), so where they lie is structure."""
    a = np.array(a, copy=True)
    nz = np.nonzero(a)
    spans_zero = lo <= 0 < hi
    v = rng.integers(lo, hi - 1 if spans_zero else hi, size=nz[0].size)
    if spans_zero:
        v[v >= 0] += 1
    a[nz] = v
    return a


def revalue(spec: dict, inp: dict, rng: np.random.Generator) -> dict:
    """The same structure (sparsity pattern, where a dense operand holds
    zeros, mask, graph and its edge weights, which steer how often a
    vertex relaxes) with every other value drawn anew from ``rng``, from
    the range :func:`draw` uses."""
    kind, out = spec["kind"], dict(inp)
    if kind in ("spmspm", "spmadd", "spmv"):
        for k in ("a", "b"):
            if k in inp:
                out[k] = _renew(inp[k], rng, 1, 4)
    elif kind in ("sddmm", "matmul", "mv"):
        for k in ("a", "b"):
            if k in inp:
                out[k] = _renew(inp[k], rng, -3, 4)
    elif kind == "conv":
        out["x"] = _renew(inp["x"], rng, -2, 3)
        out["w"] = _renew(inp["w"], rng, -2, 3)
    elif kind == "pagerank":
        out["rank"] = rng.integers(1, 2 * spec["rank"], size=inp["rank"].shape)
    if "x" in inp and kind in ("spmv", "mv"):
        out["x"] = rng.integers(-3, 4, size=inp["x"].shape)
    return out


def structure(traffic: dict, i: int, spec: dict | None = None) -> dict:
    """Kernel ``i`` of a traffic file (or ``spec`` in its place) as drawn
    from the file's ``pattern_seed``, from a stream of its own: the
    structure every seed runs on."""
    spec = traffic["kernels"][i] if spec is None else spec
    return draw(spec, np.random.default_rng([traffic["pattern_seed"], i]),
                spec.get("graph_seed", 0))


def draw_traffic(traffic: dict, seed: int) -> list[dict]:
    """A traffic file's inputs for one ``--seed``.  The structure of each
    kernel (sparsity pattern, where a dense operand holds zeros, mask,
    graph, edge weights) is :func:`structure`'s; every other value is
    then drawn anew from ``seed``.  So every seed runs the same work on
    other numbers: the same active messages, the same cycles."""
    rng = np.random.default_rng(seed)
    return [revalue(spec, structure(traffic, i), rng)
            for i, spec in enumerate(traffic["kernels"])]


#: ``make_all``'s kernels at its own sizes, in its order (its graphs are
#: drawn from the fixed seeds 3, 5 and 9)
MAKE_ALL = [
    dict(name="spmspm_s1", kind="spmspm", n=32, density_a=0.5, density_b=0.5),
    dict(name="spmspm_s2", kind="spmspm", n=32, density_a=0.2, density_b=0.5),
    dict(name="spmspm_s3", kind="spmspm", n=32, density_a=0.5, density_b=0.2),
    dict(name="spmspm_s4", kind="spmspm", n=32, density_a=0.2, density_b=0.2),
    dict(name="spmv", kind="spmv", m=96, density=0.3),
    dict(name="spmadd", kind="spmadd", n=48, density_a=0.3, density_b=0.3),
    dict(name="sddmm", kind="sddmm", s=24, dk=16, density=0.3),
    dict(name="matmul", kind="matmul", n=16),
    dict(name="mv", kind="mv", m=48),
    dict(name="conv", kind="conv", h=8, cin=2, cout=2, k=3),
    dict(name="bfs", kind="bfs", nodes=96, degree=6),
    dict(name="sssp", kind="sssp", nodes=96, degree=6),
    dict(name="pagerank", kind="pagerank", nodes=96, degree=6, rank=1024),
]
MAKE_ALL_GRAPH_SEEDS = [0] * 10 + [3, 5, 9]

#: ``bench/fig17.py``'s inputs at its own sizes (``default_rng(5)``)
FIG17 = [
    dict(name="spmv", kind="spmv", m=128, density=0.25),
    dict(name="spmspm", kind="spmspm", n=40, density_a=0.4, density_b=0.4),
    dict(name="bfs", kind="bfs", nodes=96, degree=4),
]
FIG17_GRAPH_SEEDS = [0, 0, 3]
