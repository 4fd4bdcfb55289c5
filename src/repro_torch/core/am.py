"""Active Message word format (paper §3.2, Fig. 7).

The hardware message is a single 70-bit flit:

    [R1 R2 R3 | N_PC | Opcode | Res_c | Op1_c Op2_c | Result | Op1 | Op2]
     4b 4b 4b   4b     3b       1b      1b   1b        16b     16b  16b

The simulator keeps messages as a struct-of-arrays ``int32`` tensor with one
lane per field (``MSG_F`` lanes).  This file defines the field indices, the
opcode set, the config-memory entry layout, and helpers to build message
tensors.  Values are 16-bit words held sign-extended in int32 lanes (the
paper's fabric is INT16; see DESIGN.md §2 for the bf16 adaptation at scale).
"""
from __future__ import annotations

import numpy as np

# ----------------------------------------------------------------------------
# Message field indices (struct-of-arrays lane numbers)
# ----------------------------------------------------------------------------
F_VALID = 0   # 1 = live message
F_DST0 = 1    # current destination PE id (R1 after rotation); -1 = none
F_DST1 = 2    # next destination (R2)
F_DST2 = 3    # next-next destination (R3)
F_PC = 4      # N_PC: config-memory index of the *next* instruction
F_OP = 5      # current opcode (see below)
F_RESC = 6    # Res_c: 1 = Result field holds a value, 0 = an address
F_OP1C = 7    # Op1_c: 1 = Op1 holds a value, 0 = an address
F_OP2C = 8    # Op2_c: 1 = Op2 holds a value, 0 = an address
F_RES = 9     # Result (value or local address at the final destination)
F_OP1 = 10    # Operand 1 (value or local address)
F_OP2 = 11    # Operand 2 (value or local address)
F_VIA = 12    # Valiant intermediate destination (-1 = none) [TIA-Valiant]
F_TAG = 13    # simulator-only: task/row tag for statistics & debugging
F_HOPS = 14   # simulator-only: hop counter (network cost accounting)

MSG_F = 15

# Width of the *architectural* message in bits (Fig. 7) — used by the cost
# model (link energy, bandwidth).  F_VIA/F_TAG/F_HOPS are simulator metadata.
MSG_BITS = 70

# ----------------------------------------------------------------------------
# Opcodes.  Two classes:
#   MEM-class  — must execute on the PE that owns the addressed word
#                (decode unit: dereference or streaming mode, §3.3.1)
#   ALU-class  — pure compute; may execute *opportunistically* on any idle PE
#                en route (in-network computing, §3.1.3)
# ----------------------------------------------------------------------------
OP_NOP = 0
# MEM-class (execute at the owner PE's decode unit / local SRAM)
OP_LOAD2 = 1       # dereference: Op2 <- mem[Op2]          (e.g. vec[col])
OP_LOAD1 = 2       # dereference: Op1 <- mem[Op1]
OP_STREAM = 3      # streaming: spawn one AM per element of the row at desc Op2
OP_STORE_ADD = 4   # mem[Res] += Op1   (accumulate output; terminal)
OP_STORE_SET = 5   # mem[Res] = Op1    (terminal)
OP_STORE_MIN = 6   # mem[Res] = min(.., Op1); spawn continuation iff improved
OP_CHECKSET = 7    # if mem[Res]==UNSET: store Op1, spawn continuation (BFS)
# ALU-class (pure compute: opportunistic en-route execution allowed)
OP_MUL = 8
OP_ADD = 9
OP_SUB = 10
OP_MIN = 11
OP_MAX = 12
OP_DIV = 13        # paper §3.3.1: ALU supports division
OP_MAC = 14        # Res(value) + Op1*Op2

N_OPCODES = 15

OP_NAMES = {
    OP_NOP: "nop", OP_LOAD2: "load2", OP_LOAD1: "load1", OP_STREAM: "stream",
    OP_STORE_ADD: "store_add", OP_STORE_SET: "store_set",
    OP_STORE_MIN: "store_min", OP_CHECKSET: "checkset", OP_MUL: "mul",
    OP_ADD: "add", OP_SUB: "sub", OP_MIN: "min", OP_MAX: "max",
    OP_DIV: "div", OP_MAC: "mac",
}


def is_alu_op(op):
    """Vectorized ALU-class test (jnp or np int arrays)."""
    return (op >= OP_MUL) & (op <= OP_MAC)


def is_mem_op(op):
    return (op >= OP_LOAD2) & (op <= OP_CHECKSET)


def is_store_op(op):
    """Terminal stores (no continuation message)."""
    return (op >= OP_STORE_ADD) & (op <= OP_STORE_SET)


def is_cond_op(op):
    """Conditional store + spawn (STORE_MIN relax / CHECKSET visited)."""
    return (op == OP_STORE_MIN) | (op == OP_CHECKSET)


# ----------------------------------------------------------------------------
# Config-memory entry layout (replicated per-PE program, §3.3.1 "AM NIC").
# config[pc] describes the outgoing dynamic AM produced after the instruction
# at ``pc`` executes: its opcode, next PC, destination handling, and — for
# STREAM — how each spawned AM's fields are sourced.
# ----------------------------------------------------------------------------
C_OP = 0        # opcode placed into the outgoing AM
C_NEXT_PC = 1   # N_PC written into the outgoing AM
C_ROTATE = 2    # 1 = rotate destination list (R1<-R2<-R3, R3<- -1)
C_OP1SEL = 3    # STREAM spawn Op1: 0=keep incoming, 1=element value,
                #                   2=incoming.Op1 + element value (SSSP)
C_OP2SEL = 4    # STREAM spawn Op2: 0=keep, 1=element value,
                #                   2=meta0 + incoming.Op2, 3=meta0 + incoming.Op1
C_DSTSEL = 5    # STREAM spawn dest: 0=rotate incoming list,
                #                    1=[meta1, incoming.R2, incoming.R3]
C_RESSEL = 6    # STREAM spawn Res: 0=keep, 1=incoming.Res + meta0, 2=meta0
CFG_F = 7

UNSET = np.int32(0x7FFF)  # BFS unvisited / SSSP +inf sentinel (INT16 max)


def empty_messages(shape: tuple[int, ...], xp=np):
    """All-invalid message tensor of ``shape + (MSG_F,)``."""
    return xp.zeros(shape + (MSG_F,), dtype=xp.int32)


def make_static_am(
    *,
    dst: tuple[int, int, int],
    pc: int,
    opcode: int,
    res: int,
    op1: int,
    op2: int,
    res_c: int = 0,
    op1_c: int = 1,
    op2_c: int = 0,
    tag: int = 0,
) -> np.ndarray:
    """Build one compile-time static AM (numpy row of MSG_F int32)."""
    m = np.zeros((MSG_F,), dtype=np.int32)
    m[F_VALID] = 1
    m[F_DST0], m[F_DST1], m[F_DST2] = dst
    m[F_PC] = pc
    m[F_OP] = opcode
    m[F_RESC] = res_c
    m[F_OP1C] = op1_c
    m[F_OP2C] = op2_c
    m[F_RES] = res
    m[F_OP1] = op1
    m[F_OP2] = op2
    m[F_VIA] = -1
    m[F_TAG] = tag
    return m


def cfg_entry(
    op: int,
    next_pc: int = 0,
    *,
    rotate: int = 0,
    op1sel: int = 0,
    op2sel: int = 0,
    dstsel: int = 0,
    ressel: int = 0,
) -> np.ndarray:
    e = np.zeros((CFG_F,), dtype=np.int32)
    e[C_OP], e[C_NEXT_PC], e[C_ROTATE] = op, next_pc, rotate
    e[C_OP1SEL], e[C_OP2SEL], e[C_DSTSEL], e[C_RESSEL] = (
        op1sel, op2sel, dstsel, ressel)
    return e
