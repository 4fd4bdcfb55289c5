"""The plain reference: each kernel's answer worked out again in NumPy
from the inputs the benchmark drew, independent of the program.

A lane's answer is the output the program's compiled workload reads out
of the fabric's memory image (its ``read_result``); this module gives
the exact integer result of the same computation.  Graph distances use
the fabric's 16-bit sentinel (0x7FFF) for a vertex never reached.

:func:`control` is the benchmark's control: the reference with one
active message of the lane lost (its last nonzero or edge dropped),
which breaks the configurations' exactly-once delivery guarantee.  The
comparison has to read it as not correct.
"""
from __future__ import annotations

import heapq

import numpy as np

#: the fabric's "unvisited" / "+inf" word (int16 max)
UNSET = 0x7FFF


def _i64(a):
    return np.asarray(a, dtype=np.int64)


def _csr(a):
    """(rowptr, col) of a dense matrix's nonzeros, row-major."""
    nz = np.nonzero(a)
    rp = np.zeros((a.shape[0] + 1,), dtype=np.int64)
    np.add.at(rp, nz[0] + 1, 1)
    return np.cumsum(rp), nz[1].astype(np.int64)


def _bfs(rp, col, root):
    level = np.full((rp.shape[0] - 1,), UNSET, dtype=np.int64)
    level[root] = 0
    frontier = [root]
    while frontier:
        nxt = []
        for u in frontier:
            for w in col[rp[u]:rp[u + 1]]:
                if level[w] == UNSET:
                    level[w] = level[u] + 1
                    nxt.append(int(w))
        frontier = nxt
    return level


def _dijkstra(rp, col, wgt, src):
    dist = np.full((rp.shape[0] - 1,), UNSET, dtype=np.int64)
    dist[src] = 0
    heap = [(0, src)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        for e in range(int(rp[u]), int(rp[u + 1])):
            w, nd = int(col[e]), d + int(wgt[e])
            if nd < dist[w]:
                dist[w] = nd
                heapq.heappush(heap, (nd, w))
    return dist


def _scatter_rank(rp, col, rank):
    deg = np.diff(rp)
    acc = np.zeros((rp.shape[0] - 1,), dtype=np.int64)
    share = np.where(deg > 0, _i64(rank) // np.maximum(deg, 1), 0)
    np.add.at(acc, col, np.repeat(share, deg))
    return acc


def _conv(x, w):
    """Valid 2-D convolution, (oh * ow, cout), rows in raster order."""
    x, w = _i64(x), _i64(w)
    fh, fw, _, cout = w.shape
    oh, ow = x.shape[0] - fh + 1, x.shape[1] - fw + 1
    out = np.zeros((oh, ow, cout), dtype=np.int64)
    for i in range(fh):
        for j in range(fw):
            out += np.einsum("yxc,cd->yxd", x[i:i + oh, j:j + ow], w[i, j])
    return out.reshape(oh * ow, cout)


def answer(kind: str, inp: dict) -> np.ndarray:
    """The exact result of kernel ``kind`` on its inputs, in the shape the
    lane's answer has."""
    if kind in ("spmv", "mv"):
        return _i64(inp["a"]) @ _i64(inp["x"])
    if kind in ("spmspm", "matmul"):
        return _i64(inp["a"]) @ _i64(inp["b"])
    if kind == "spmadd":
        return _i64(inp["a"]) + _i64(inp["b"])
    if kind == "sddmm":
        dense = _i64(inp["a"]) @ _i64(inp["b"])
        return dense[np.nonzero(inp["mask"])]
    if kind == "conv":
        return _conv(inp["x"], inp["w"])
    if kind == "bfs":
        return _bfs(inp["rowptr"], inp["col"], 0)
    if kind == "sssp":
        return _dijkstra(inp["rowptr"], inp["col"], inp["weight"], 0)
    if kind == "pagerank":
        return _scatter_rank(inp["rowptr"], inp["col"], inp["rank"])
    raise ValueError(f"no reference for kernel kind {kind!r}")


def _drop_last(a):
    a = np.array(a, copy=True)
    nz = np.nonzero(a)
    if nz[0].size:
        a[nz[0][-1], nz[1][-1]] = 0
    return a


def _drop_last_edge(inp):
    rp, col = np.array(inp["rowptr"]), np.array(inp["col"])
    last = int(np.nonzero(np.diff(rp))[0][-1])
    keep = np.ones(col.shape, bool)
    keep[rp[last + 1] - 1] = False
    out = dict(inp, rowptr=np.concatenate([rp[:last + 1], rp[last + 1:] - 1]),
               col=col[keep])
    if "weight" in inp:
        out["weight"] = np.asarray(inp["weight"])[keep]
    return out


def control(kind: str, inp: dict) -> np.ndarray:
    """The reference with the lane's last active message lost: the last
    nonzero of the first operand (the mask's last entry for SDDMM, the
    input's last pixel for a convolution, the last edge of a graph)
    dropped before the answer is worked out."""
    if kind in ("spmv", "mv", "spmspm", "matmul", "spmadd"):
        return answer(kind, dict(inp, a=_drop_last(inp["a"])))
    if kind == "sddmm":
        full = answer(kind, inp)
        return full[:-1] if full.size > 1 else full + 1
    if kind == "conv":
        x = np.array(inp["x"], copy=True)
        x[-1, -1] = 0
        return answer(kind, dict(inp, x=x))
    if kind in ("bfs", "sssp", "pagerank"):
        return answer(kind, _drop_last_edge(inp))
    raise ValueError(f"no control for kernel kind {kind!r}")


def same(got, want) -> bool:
    """Exact comparison: same shape, every integer equal."""
    got, want = np.asarray(got), np.asarray(want)
    return got.shape == want.shape and bool(np.array_equal(
        got.astype(np.int64), want.astype(np.int64)))
