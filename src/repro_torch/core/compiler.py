"""Nexus Machine static compiler + runtime manager (paper §3.5–3.6, Fig. 9).

Turns each benchmark kernel into:
  * a replicated configuration-memory program (``prog``: the DFG schedule —
    one row per PC describing how a message morphs after that instruction),
  * per-PE **static AM** queues (one AM per element of the first operand,
    exactly as the paper's runtime manager emits them),
  * per-PE data-memory images (values + compiler-placed metadata words that
    guide streaming spawns: destinations and local addresses).

Data placement uses :mod:`repro_torch.core.partition` (nnz-balanced /
dissimilarity-aware, Algorithm 1); secondary tensors are co-located/aligned
with the primary tensor (§3.1.1).

Workloads (§4.2): SpMV, SpMSpM (Gustavson), SpM+SpM, SDDMM, dense MatMul /
MV / Conv (im2col), BFS, SSSP, PageRank.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core import am, partition
from repro_torch.core.am import (
    OP_ADD, OP_CHECKSET, OP_DIV, OP_LOAD1, OP_LOAD2, OP_MUL, OP_NOP,
    OP_STORE_ADD, OP_STORE_MIN, OP_STORE_SET, OP_STREAM, UNSET, cfg_entry,
    make_static_am,
)
from repro_torch.core.machine import MachineConfig

__all__ = [
    "CompiledWorkload", "csr_from_dense", "random_sparse",
    "build_spmv", "build_spmspm", "build_spmadd", "build_sddmm",
    "build_matmul", "build_mv", "build_conv", "build_bfs", "build_sssp",
    "build_pagerank",
]


# ----------------------------------------------------------------------------
# Small host-side CSR helpers (the scale layer has its own JAX formats).
# ----------------------------------------------------------------------------
def csr_from_dense(a: np.ndarray):
    """dense (m,n) int matrix -> (rowptr, col, val)."""
    m, n = a.shape
    rowptr = np.zeros((m + 1,), dtype=np.int64)
    cols, vals = [], []
    for i in range(m):
        nz = np.nonzero(a[i])[0]
        rowptr[i + 1] = rowptr[i] + nz.size
        cols.append(nz)
        vals.append(a[i, nz])
    col = np.concatenate(cols) if cols else np.zeros((0,), np.int64)
    val = np.concatenate(vals) if vals else np.zeros((0,), np.int64)
    return rowptr, col.astype(np.int64), val.astype(np.int64)


def random_sparse(m: int, n: int, density: float, rng: np.random.Generator,
                  lo: int = -4, hi: int = 5) -> np.ndarray:
    """Unstructured-sparse int matrix with ~``density`` nonzeros."""
    a = rng.integers(lo, hi, size=(m, n))
    a[a == 0] = 1
    mask = rng.random((m, n)) < density
    return (a * mask).astype(np.int64)


@dataclasses.dataclass
class CompiledWorkload:
    """Everything :func:`repro_torch.core.machine.run` needs, plus oracles."""

    prog: np.ndarray                  # (P, CFG_F) replicated config memory
    static_ams: np.ndarray            # (N, QCAP, MSG_F)
    amq_len: np.ndarray               # (N,)
    mem_val: np.ndarray               # (N, MEM)
    mem_meta: np.ndarray              # (N, MEM, 2)
    read_result: Callable[[np.ndarray], np.ndarray]   # mem_val -> output
    expected: np.ndarray              # numpy oracle
    n_static_ams: int
    name: str = ""
    # The (width, height) mesh the data placement targeted.  PE ids are
    # row-major coordinates on THIS mesh, so a lane's geometry travels with
    # the workload into mixed-size run_many batches (see
    # repro_torch.core.batch.stack_workloads).
    geom: tuple[int, int] | None = None
    # (N, MEM) bool: True where mem_meta[..., 1] holds a PE id (stream /
    # continuation destinations).  Sub-mesh lane packing rebases exactly
    # these words when it relocates the workload inside a larger fabric
    # (the reference's repro.core.batch.pack_workloads); addresses and values (and
    # mem_meta[..., 0], which is always a count/address/value) never move.
    meta_pe: np.ndarray | None = None
    # (N,) builder bump-pointer highwater: words >= alloc_top[pe] were
    # never allocated, so a static analysis can flag reads past it
    # (repro.analysis uses this to catch truncated/corrupted descriptors).
    alloc_top: np.ndarray | None = None

    def check(self, mem_val: np.ndarray) -> bool:
        return bool(np.array_equal(self.read_result(mem_val), self.expected))


class _Builder:
    """Per-PE bump allocator + AM queue accumulator."""

    def __init__(self, cfg: MachineConfig):
        self.cfg = cfg
        n = cfg.n_pes
        self.mem_val = np.zeros((n, cfg.mem_words), dtype=np.int32)
        self.mem_meta = np.zeros((n, cfg.mem_words, 2), dtype=np.int32)
        self.meta_pe = np.zeros((n, cfg.mem_words), dtype=bool)
        self.top = np.zeros((n,), dtype=np.int64)
        self.ams: list[list[np.ndarray]] = [[] for _ in range(n)]

    def set_meta_pe(self, pe: int, addr: int, target_pe: int) -> None:
        """Write a PE id into mem_meta[..., 1] and record that the word
        holds one (lane packing must rebase it)."""
        self.mem_meta[pe, addr, 1] = int(target_pe)
        self.meta_pe[pe, addr] = True

    def alloc(self, pe: int, nwords: int) -> int:
        base = int(self.top[pe])
        if base + nwords > self.cfg.mem_words:
            raise MemoryError(
                f"PE {pe}: {base + nwords} words > {self.cfg.mem_words} "
                f"(tile the workload; paper §3.1.4)")
        self.top[pe] += nwords
        return base

    def push_am(self, pe: int, m: np.ndarray) -> None:
        self.ams[pe].append(m)

    def finish(self, prog_rows, read_result, expected, name):
        n = self.cfg.n_pes
        qcap = max(1, max(len(q) for q in self.ams))
        if qcap > self.cfg.queue_cap:
            raise MemoryError(f"AM queue overflow: {qcap} > "
                              f"{self.cfg.queue_cap}")
        qcap = self.cfg.queue_cap
        sams = np.zeros((n, qcap, am.MSG_F), dtype=np.int32)
        alen = np.zeros((n,), dtype=np.int32)
        total = 0
        for p in range(n):
            for k, msg in enumerate(self.ams[p]):
                sams[p, k] = msg
            alen[p] = len(self.ams[p])
            total += len(self.ams[p])
        prog = np.zeros((max(len(prog_rows), 1), am.CFG_F), dtype=np.int32)
        for i, row in enumerate(prog_rows):
            prog[i] = row
        return CompiledWorkload(
            prog=prog, static_ams=sams, amq_len=alen, mem_val=self.mem_val,
            mem_meta=self.mem_meta, read_result=read_result,
            expected=expected, n_static_ams=total, name=name,
            geom=(self.cfg.width, self.cfg.height), meta_pe=self.meta_pe,
            alloc_top=self.top.copy())


def _place_rows(rowptr, col, n_pes, strategy, n_cols):
    return partition.partition_csr(
        np.asarray(rowptr), np.asarray(col), n_pes, strategy=strategy,
        n_cols=n_cols)


# ============================================================================
# SpMV  (Fig. 4/5):  y = A @ x
#   static AM per nonzero A[i,j]:
#     [LOAD2 x[j] @ PE(x_j)] -> [MUL en-route] -> [STORE_ADD y[i] @ PE(y_i)]
# ============================================================================
def build_spmv(a_dense: np.ndarray, x: np.ndarray, cfg: MachineConfig,
               *, strategy: str = "dissimilarity") -> CompiledWorkload:
    m, n = a_dense.shape
    rowptr, col, val = csr_from_dense(a_dense)
    b = _Builder(cfg)
    n_pes = cfg.n_pes

    place = _place_rows(rowptr, col, n_pes, strategy, n)
    x_pe = partition.uniform_partition(n, n_pes)
    # y[i] is co-located ("aligned") with A row i  (§3.1.1)
    y_pe = place.row_to_pe

    x_addr = np.array([b.alloc(int(x_pe[j]), 1) for j in range(n)])
    for j in range(n):
        b.mem_val[x_pe[j], x_addr[j]] = int(x[j])
    y_addr = np.array([b.alloc(int(y_pe[i]), 1) for i in range(m)])

    prog = [
        cfg_entry(OP_MUL, 1, rotate=1),        # after LOAD2
        cfg_entry(OP_STORE_ADD, 2),            # after MUL
        cfg_entry(OP_NOP),                     # terminal
    ]
    for i in range(m):
        for e in range(int(rowptr[i]), int(rowptr[i + 1])):
            j = int(col[e])
            b.push_am(int(place.row_to_pe[i]), make_static_am(
                dst=(int(x_pe[j]), int(y_pe[i]), -1), pc=0, opcode=OP_LOAD2,
                res=int(y_addr[i]), op1=int(val[e]), op2=int(x_addr[j]),
                tag=i))

    expected = (a_dense.astype(np.int64) @ x.astype(np.int64)).astype(np.int64)

    def read_result(mem_val):
        return mem_val[y_pe, y_addr].astype(np.int64)

    return b.finish(prog, read_result, expected, "spmv")


def build_mv(a_dense: np.ndarray, x: np.ndarray, cfg: MachineConfig,
             **kw) -> CompiledWorkload:
    """Dense matrix–vector = SpMV with a fully dense operand (§4.2)."""
    out = build_spmv(a_dense, x, cfg, **kw)
    return dataclasses.replace(out, name="mv")


# ============================================================================
# SpMSpM (Gustavson):  C = A @ B,   C[i,:] += A[i,k] * B[k,:]
#   static AM per nonzero A[i,k]:
#     [STREAM B row k @ PE(B_k)] -> spawn per nz B[k,j]:
#        [MUL en-route] -> [STORE_ADD C[i,j] @ PE(C_i)]
# ============================================================================
def build_spmspm(a_dense: np.ndarray, b_dense: np.ndarray,
                 cfg: MachineConfig, *, strategy: str = "dissimilarity",
                 name: str = "spmspm") -> CompiledWorkload:
    m, k = a_dense.shape
    k2, n = b_dense.shape
    assert k == k2
    a_rp, a_col, a_val = csr_from_dense(a_dense)
    b_rp, b_col, b_val = csr_from_dense(b_dense)
    bld = _Builder(cfg)
    n_pes = cfg.n_pes

    a_place = _place_rows(a_rp, a_col, n_pes, strategy, k)
    b_place = _place_rows(b_rp, b_col, n_pes, strategy, n)
    c_pe = a_place.row_to_pe              # C row i aligned with A row i

    # B rows: descriptor word (base,count) + element words (val, meta0=col j)
    b_desc = np.zeros((k,), dtype=np.int64)
    for r in range(k):
        pe = int(b_place.row_to_pe[r])
        cnt = int(b_rp[r + 1] - b_rp[r])
        d = bld.alloc(pe, 1 + cnt)
        b_desc[r] = d
        bld.mem_val[pe, d] = d + 1                       # base
        bld.mem_meta[pe, d, 0] = cnt                     # count
        for t, e in enumerate(range(int(b_rp[r]), int(b_rp[r + 1]))):
            bld.mem_val[pe, d + 1 + t] = int(b_val[e])
            bld.mem_meta[pe, d + 1 + t, 0] = int(b_col[e])   # j

    # dense C row buffers, aligned with A rows
    c_base = np.array([bld.alloc(int(c_pe[i]), n) for i in range(m)])

    prog = [
        # STREAM spawn: op1 keep (A val), op2 = element value (B val),
        # res = C-row base + j (meta0), dest rotates to PE(C_i).
        cfg_entry(OP_MUL, 1, op1sel=0, op2sel=1, dstsel=0, ressel=1),
        cfg_entry(OP_STORE_ADD, 2),
        cfg_entry(OP_NOP),
    ]
    for i in range(m):
        for e in range(int(a_rp[i]), int(a_rp[i + 1])):
            kk = int(a_col[e])
            bld.push_am(int(a_place.row_to_pe[i]), make_static_am(
                dst=(int(b_place.row_to_pe[kk]), int(c_pe[i]), -1), pc=0,
                opcode=OP_STREAM, res=int(c_base[i]), op1=int(a_val[e]),
                op2=int(b_desc[kk]), tag=i))

    expected = (a_dense.astype(np.int64) @ b_dense.astype(np.int64))

    def read_result(mem_val):
        out = np.zeros((m, n), dtype=np.int64)
        for i in range(m):
            out[i] = mem_val[c_pe[i], c_base[i]:c_base[i] + n]
        return out

    return bld.finish(prog, read_result, expected, name)


def build_matmul(a: np.ndarray, b: np.ndarray, cfg: MachineConfig,
                 **kw) -> CompiledWorkload:
    """Dense MatMul via the same Gustavson row-wise dataflow (§4.2)."""
    return dataclasses.replace(build_spmspm(a, b, cfg, **kw), name="matmul")


def build_conv(x: np.ndarray, w: np.ndarray, cfg: MachineConfig,
               **kw) -> CompiledWorkload:
    """Conv as im2col matmul.

    Nexus executes Conv natively by replicating filters across PEs (§5.1);
    at the dataflow level that equals the im2col product patches @ filters,
    which is what we map (the replication shows up as the filter matrix
    being streamed from many PEs).  x: (H, W_in, Cin), w: (kh, kw, Cin, Cout).
    """
    h, wid, cin = x.shape
    fh, fw, _, cout = w.shape
    oh, ow = h - fh + 1, wid - fw + 1
    patches = np.zeros((oh * ow, fh * fw * cin), dtype=np.int64)
    for oy in range(oh):
        for ox in range(ow):
            patches[oy * ow + ox] = x[oy:oy + fh, ox:ox + fw, :].reshape(-1)
    wmat = w.reshape(fh * fw * cin, cout).astype(np.int64)
    return dataclasses.replace(build_spmspm(patches, wmat, cfg, **kw),
                               name="conv")


# ============================================================================
# SpM+SpM:  C = A + B — pure scatter-add of both operands' nonzeros.
# ============================================================================
def build_spmadd(a_dense: np.ndarray, b_dense: np.ndarray,
                 cfg: MachineConfig, *, strategy: str = "dissimilarity"
                 ) -> CompiledWorkload:
    m, n = a_dense.shape
    a_rp, a_col, a_val = csr_from_dense(a_dense)
    bld = _Builder(cfg)
    n_pes = cfg.n_pes
    place = _place_rows(a_rp, a_col, n_pes, strategy, n)
    c_pe = place.row_to_pe
    c_base = np.array([bld.alloc(int(c_pe[i]), n) for i in range(m)])

    prog = [cfg_entry(OP_NOP)]  # STORE_ADD is terminal; no morphing needed
    for mat in (a_dense, b_dense):
        rp, cl, vl = csr_from_dense(mat)
        for i in range(m):
            for e in range(int(rp[i]), int(rp[i + 1])):
                j = int(cl[e])
                bld.push_am(int(c_pe[i]), make_static_am(
                    dst=(int(c_pe[i]), -1, -1), pc=0, opcode=OP_STORE_ADD,
                    res=int(c_base[i] + j), op1=int(vl[e]), op2=0, tag=i))

    expected = a_dense.astype(np.int64) + b_dense.astype(np.int64)

    def read_result(mem_val):
        out = np.zeros((m, n), dtype=np.int64)
        for i in range(m):
            out[i] = mem_val[c_pe[i], c_base[i]:c_base[i] + n]
        return out

    return bld.finish(prog, read_result, expected, "spmadd")


# ============================================================================
# SDDMM:  out[i,j] = sum_k A[i,k] * B[k,j]   for (i,j) in mask.
#   Three destinations (the paper's R1/R2/R3 motivation):
#     [STREAM A row i @ PE(A_i)] -> per k:
#       [LOAD2 B[k,j] @ PE(B_k)] -> [MUL en-route] -> [STORE_ADD @ PE(out_ij)]
# ============================================================================
def build_sddmm(a: np.ndarray, b: np.ndarray, mask: np.ndarray,
                cfg: MachineConfig, *, strategy: str = "dissimilarity"
                ) -> CompiledWorkload:
    m, k = a.shape
    k2, n = b.shape
    assert k == k2 and mask.shape == (m, n)
    bld = _Builder(cfg)
    n_pes = cfg.n_pes
    a_pe = partition.uniform_partition(m, n_pes)
    b_pe = partition.uniform_partition(k, n_pes)

    # dense B rows
    b_base = np.array([bld.alloc(int(b_pe[r]), n) for r in range(k)])
    for r in range(k):
        bld.mem_val[b_pe[r], b_base[r]:b_base[r] + n] = b[r].astype(np.int32)

    # dense A rows stored behind a stream descriptor; element meta points at
    # the corresponding B row (local base addr + owner PE).
    a_desc = np.zeros((m,), dtype=np.int64)
    for i in range(m):
        pe = int(a_pe[i])
        d = bld.alloc(pe, 1 + k)
        a_desc[i] = d
        bld.mem_val[pe, d] = d + 1
        bld.mem_meta[pe, d, 0] = k
        for kk in range(k):
            bld.mem_val[pe, d + 1 + kk] = int(a[i, kk])
            bld.mem_meta[pe, d + 1 + kk, 0] = int(b_base[kk])   # B row base
            bld.set_meta_pe(pe, d + 1 + kk, int(b_pe[kk]))      # B row owner

    # outputs: one word per mask nonzero, aligned with A rows
    mask_rp, mask_col, _ = csr_from_dense(mask.astype(np.int64))
    out_pe, out_addr, out_idx = [], [], []
    for i in range(m):
        for e in range(int(mask_rp[i]), int(mask_rp[i + 1])):
            j = int(mask_col[e])
            pe = int(a_pe[i])
            out_pe.append(pe)
            out_addr.append(bld.alloc(pe, 1))
            out_idx.append((i, j))
    out_pe = np.array(out_pe, dtype=np.int64)
    out_addr = np.array(out_addr, dtype=np.int64)

    prog = [
        # STREAM spawn: op1 = A[i,k] (element), op2 = meta0 + incoming.op1
        # (= B row base + j), dest = meta1 (B owner) keeping R2 = out PE.
        cfg_entry(OP_LOAD2, 1, op1sel=1, op2sel=3, dstsel=1, ressel=0),
        cfg_entry(OP_MUL, 2, rotate=1),       # after LOAD2: head to out PE
        cfg_entry(OP_STORE_ADD, 3),
        cfg_entry(OP_NOP),
    ]
    for t, (i, j) in enumerate(out_idx):
        bld.push_am(int(a_pe[i]), make_static_am(
            dst=(int(a_pe[i]), int(out_pe[t]), -1), pc=0, opcode=OP_STREAM,
            res=int(out_addr[t]), op1=j, op2=int(a_desc[i]), tag=i))

    dense = a.astype(np.int64) @ b.astype(np.int64)
    expected = np.array([dense[i, j] for (i, j) in out_idx], dtype=np.int64)

    def read_result(mem_val):
        return mem_val[out_pe, out_addr].astype(np.int64)

    return bld.finish(prog, read_result, expected, "sddmm")


# ============================================================================
# Graph kernels — CSR adjacency distributed across PEs; vertex state words
# carry compiler metadata pointing at the adjacency descriptors (§3.6).
# ============================================================================
def _graph_layout(adj_rp, adj_col, weights, cfg, init_word,
                  strategy: str = "nnz"):
    """Common placement: vertex state + adjacency co-located per vertex."""
    nv = adj_rp.shape[0] - 1
    bld = _Builder(cfg)
    # "dissimilarity" degrades to degree(nnz)-balance for adjacency lists
    # (bank signatures of graph rows are near-uniform); map it to "nnz".
    if strategy == "dissimilarity":
        strategy = "nnz"
    v_pe = partition.partition_csr(
        adj_rp, adj_col, cfg.n_pes, strategy=strategy).row_to_pe
    state_addr = np.zeros((nv,), dtype=np.int64)
    desc_addr = np.zeros((nv,), dtype=np.int64)
    for v in range(nv):
        pe = int(v_pe[v])
        state_addr[v] = bld.alloc(pe, 1)
        bld.mem_val[pe, state_addr[v]] = init_word
    for v in range(nv):
        pe = int(v_pe[v])
        cnt = int(adj_rp[v + 1] - adj_rp[v])
        d = bld.alloc(pe, 1 + cnt)
        desc_addr[v] = d
        bld.mem_val[pe, d] = d + 1
        bld.mem_meta[pe, d, 0] = cnt
        for t, e in enumerate(range(int(adj_rp[v]), int(adj_rp[v + 1]))):
            w = int(adj_col[e])
            bld.mem_val[pe, d + 1 + t] = int(weights[e])
            bld.mem_meta[pe, d + 1 + t, 0] = 0  # filled below (state addr)
            bld.set_meta_pe(pe, d + 1 + t, int(v_pe[w]))
    # second pass: element meta0 = state addr of the edge target
    for v in range(nv):
        pe = int(v_pe[v])
        d = int(desc_addr[v])
        for t, e in enumerate(range(int(adj_rp[v]), int(adj_rp[v + 1]))):
            w = int(adj_col[e])
            bld.mem_meta[pe, d + 1 + t, 0] = int(state_addr[w])
    # vertex-state meta points back at the adjacency descriptor (for
    # conditional continuations: discovered vertex -> stream its edges).
    for v in range(nv):
        pe = int(v_pe[v])
        bld.mem_meta[pe, state_addr[v], 0] = int(desc_addr[v])
        bld.set_meta_pe(pe, int(state_addr[v]), pe)
    return bld, v_pe, state_addr, desc_addr


def build_bfs(adj_rp: np.ndarray, adj_col: np.ndarray, root: int,
              cfg: MachineConfig, *, strategy: str = "nnz"
              ) -> CompiledWorkload:
    """BFS levels via asynchronous min-relaxation over unit weights.

    First-arrival CHECKSET would label vertices with *a* spanning tree's
    depth (arrival order is dynamic), so exact levels use the STORE_MIN
    relax: level(w) = min(level(w), level(v)+1) — same AM structure, the
    data-driven frontier expansion the paper targets.
    """
    nv = adj_rp.shape[0] - 1
    ones = np.ones_like(adj_col)
    bld, v_pe, s_addr, d_addr = _graph_layout(adj_rp, adj_col, ones, cfg,
                                              int(UNSET), strategy)
    prog = [
        # pc0: STREAM spawn: op1 = level(v) + 1; relax at the target's owner
        cfg_entry(OP_STORE_MIN, 1, op1sel=2, dstsel=1, ressel=2),
        # pc1: improved-relax continuation -> STREAM the vertex's adjacency
        cfg_entry(OP_STREAM, 0),
    ]
    bld.push_am(int(v_pe[root]), make_static_am(
        dst=(int(v_pe[root]), -1, -1), pc=1, opcode=OP_STORE_MIN,
        res=int(s_addr[root]), op1=0, op2=0, tag=root))

    # numpy BFS oracle (levels; UNSET if unreachable)
    level = np.full((nv,), int(UNSET), dtype=np.int64)
    level[root] = 0
    frontier = [root]
    while frontier:
        nxt = []
        for u in frontier:
            for e in range(int(adj_rp[u]), int(adj_rp[u + 1])):
                w = int(adj_col[e])
                if level[w] == int(UNSET):
                    level[w] = level[u] + 1
                    nxt.append(w)
        frontier = nxt

    def read_result(mem_val):
        return mem_val[v_pe, s_addr].astype(np.int64)

    return bld.finish(prog, read_result, level, "bfs")


def build_sssp(adj_rp: np.ndarray, adj_col: np.ndarray, wgt: np.ndarray,
               src: int, cfg: MachineConfig, *, strategy: str = "nnz"
               ) -> CompiledWorkload:
    nv = adj_rp.shape[0] - 1
    bld, v_pe, s_addr, d_addr = _graph_layout(adj_rp, adj_col, wgt, cfg,
                                              int(UNSET), strategy)
    prog = [
        # pc0: STREAM spawn: op1 = dist(u) + w(u,v); relax at owner of v
        cfg_entry(OP_STORE_MIN, 1, op1sel=2, dstsel=1, ressel=2),
        # pc1: improved-relax continuation -> re-stream v's adjacency
        cfg_entry(OP_STREAM, 0),
    ]
    bld.push_am(int(v_pe[src]), make_static_am(
        dst=(int(v_pe[src]), -1, -1), pc=1, opcode=OP_STORE_MIN,
        res=int(s_addr[src]), op1=0, op2=0, tag=src))

    # numpy Bellman-Ford oracle
    dist = np.full((nv,), int(UNSET), dtype=np.int64)
    dist[src] = 0
    for _ in range(nv):
        changed = False
        for u in range(nv):
            if dist[u] >= int(UNSET):
                continue
            for e in range(int(adj_rp[u]), int(adj_rp[u + 1])):
                w, c = int(adj_col[e]), int(wgt[e])
                if dist[u] + c < dist[w]:
                    dist[w] = dist[u] + c
                    changed = True
        if not changed:
            break

    def read_result(mem_val):
        return mem_val[v_pe, s_addr].astype(np.int64)

    return bld.finish(prog, read_result, dist, "sssp")


def build_pagerank(adj_rp: np.ndarray, adj_col: np.ndarray,
                   rank_fp: np.ndarray, cfg: MachineConfig, *,
                   strategy: str = "nnz") -> CompiledWorkload:
    """One PageRank scatter pass: acc[w] += rank_fp[v] // deg(v).

    Fixed-point ranks (scaled ints).  The host runtime manager applies
    damping between iterations and re-issues the pass (the paper's global
    tile synchronization, §3.1.4); the irregular on-fabric part is this
    SpMV-like scatter.
    """
    nv = adj_rp.shape[0] - 1
    ones = np.ones_like(adj_col)
    bld, v_pe, s_addr, d_addr = _graph_layout(adj_rp, adj_col, ones, cfg, 0,
                                              strategy)
    # a second state word per vertex: the rank (contribution source)
    r_addr = np.zeros((nv,), dtype=np.int64)
    for v in range(nv):
        pe = int(v_pe[v])
        r_addr[v] = bld.alloc(pe, 1)
        bld.mem_val[pe, r_addr[v]] = int(rank_fp[v])

    prog = [
        # pc0: after LOAD1 (rank fetched): DIV by deg (ALU, en-route ok)
        cfg_entry(OP_DIV, 1),
        # pc1: after DIV: STREAM the adjacency (at the same PE)
        cfg_entry(OP_STREAM, 2),
        # pc2: STREAM spawn: scatter contribution to each out-neighbor
        cfg_entry(OP_STORE_ADD, 3, op1sel=0, dstsel=1, ressel=2),
        cfg_entry(OP_NOP),
    ]
    for v in range(nv):
        deg = int(adj_rp[v + 1] - adj_rp[v])
        if deg == 0:
            continue
        pe = int(v_pe[v])
        # res carries the adjacency-descriptor address: STREAM falls back to
        # Res when Op2 holds a value (here: the degree divisor).
        bld.push_am(pe, make_static_am(
            dst=(pe, pe, -1), pc=0, opcode=OP_LOAD1, res=int(d_addr[v]),
            op1=int(r_addr[v]), op2=deg, op1_c=0, op2_c=1, tag=v))

    acc = np.zeros((nv,), dtype=np.int64)
    for v in range(nv):
        deg = int(adj_rp[v + 1] - adj_rp[v])
        if deg == 0:
            continue
        c = int(rank_fp[v]) // deg
        for e in range(int(adj_rp[v]), int(adj_rp[v + 1])):
            acc[int(adj_col[e])] += c

    def read_result(mem_val):
        return mem_val[v_pe, s_addr].astype(np.int64)

    return bld.finish(prog, read_result, acc, "pagerank")
