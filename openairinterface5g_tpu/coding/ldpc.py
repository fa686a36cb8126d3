"""NR LDPC (TS 38.212 §5.3.2) encode + min-sum decode in JAX.

Design vs reference (openair1/PHY/CODING/nrLDPC_encoder/,
nrLDPC_decoder/nrLDPC_decoder.c):

* The reference batches 8 code blocks bit-per-byte-lane and emits
  per-(BG, Z) unrolled AVX2 kernels generated at build time.  Here the
  lifted graph is represented as static (row, col, shift) index tensors;
  all code blocks are a leading batch dim and the Z lanes are a trailing
  vector dim, so one traced program covers any batch and XLA does the
  tiling (SURVEY.md C2/C3 mapping).
* Encoding exploits the standard double-diagonal core structure: XOR of
  the four core rows isolates p0 up to a single cyclic shift (verified at
  table-build time), then forward substitution for p1..p3 and the
  identity-diagonal extension rows.  Everything is jnp.roll + XOR on
  (batch, Z) int8 lanes — no GF(2) matrix inversion, no codegen.
* Decoding is flooding normalized-min-sum on messages held in
  (batch, rows*max_deg, Z) check-node layout (pad lanes carry +inf
  magnitude), with the cyclic shifts applied by static gather indices.
  Equivalent of nrLDPC_decoder.c:172 (LDPCdecoder) + nrLDPC_cnProc.h
  min/sign kernels, with the LUT shuffling replaced by XLA gathers.
* layered_minsum is the plain reference of the GPU kernel
  (ops/ldpc_triton.py): the same row-layered schedule in jax.numpy.

Bit/LLR conventions: bits in {0,1}; LLR > 0 means bit==0 (same as the
reference's 8-bit LLR convention).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..data.tables import (
    BG_INFO_COLS,
    load_base_graph,
)

_BIG = jnp.float32(1e30)


@dataclasses.dataclass(frozen=True)
class LDPCGraph:
    """Static lifted-graph description for one (bg, Z)."""

    bg: int
    Z: int
    kc: int                      # info columns (22 / 10)
    rows: int                    # parity rows (46 / 42)
    cols: int                    # total columns (68 / 52)
    max_deg: int                 # max check-node degree
    tab: np.ndarray              # (rows, cols) shifts, -1 = no edge
    # decoder layout, (rows, max_deg) padded edge arrays
    ecol: np.ndarray             # int32 column id, pad = cols (dummy col)
    eshift: np.ndarray           # int32 shift, pad = 0
    evalid: np.ndarray           # bool
    # encoder: shift isolating p0 from the XOR of the four core rows
    p0_shift: int
    core_order: tuple            # ((row, col, vshift), ...) solve order for p1..p3

    @property
    def K(self) -> int:
        return self.kc * self.Z

    @property
    def N_full(self) -> int:
        """Full mother-code length incl. the 2Z punctured systematic cols."""
        return self.cols * self.Z

    @property
    def N(self) -> int:
        """Circular-buffer length (66Z / 50Z)."""
        return (self.cols - 2) * self.Z


def _cancel_pairs(shifts: Sequence[int]) -> list[int]:
    out: list[int] = []
    for s in shifts:
        if s in out:
            out.remove(s)
        else:
            out.append(s)
    return out


@functools.lru_cache(maxsize=64)
def build_graph(bg: int, Z: int) -> LDPCGraph:
    tab = load_base_graph(bg, Z)
    rows, cols = tab.shape
    kc = BG_INFO_COLS[bg]

    deg = (tab >= 0).sum(axis=1)
    max_deg = int(deg.max())
    ecol = np.full((rows, max_deg), cols, dtype=np.int32)
    eshift = np.zeros((rows, max_deg), dtype=np.int32)
    evalid = np.zeros((rows, max_deg), dtype=bool)
    for r in range(rows):
        js = np.nonzero(tab[r] >= 0)[0]
        ecol[r, : len(js)] = js
        eshift[r, : len(js)] = tab[r, js]
        evalid[r, : len(js)] = True

    # --- encoder core solve (TS 38.212 structure, verified here) ---
    core_shifts = [int(tab[i, kc]) for i in range(4) if tab[i, kc] >= 0]
    surviving = _cancel_pairs(core_shifts)
    if len(surviving) != 1:
        raise AssertionError(f"BG{bg} Z={Z}: core column does not reduce to one shift")
    p0_shift = surviving[0]
    # verify p1..p3 appear an even number of times across core rows (cancel)
    for j in range(kc + 1, kc + 4):
        s = [int(tab[i, j]) for i in range(4) if tab[i, j] >= 0]
        if len(_cancel_pairs(s)) != 0:
            raise AssertionError(f"BG{bg} Z={Z}: col {j} does not cancel in core sum")
    # forward-substitution order for p1..p3
    known = {kc}
    order = []
    remaining = set(range(4))
    while len(known) < 4:
        for i in sorted(remaining):
            unknowns = [j for j in range(kc, kc + 4) if tab[i, j] >= 0 and j not in known]
            if len(unknowns) == 1:
                j = unknowns[0]
                order.append((i, j, int(tab[i, j])))
                known.add(j)
                remaining.discard(i)
                break
        else:
            raise AssertionError(f"BG{bg} Z={Z}: cannot order core parity solve")
    # verify extension rows each carry exactly one shift-0 identity at kc+4+ (r-4)
    for r in range(4, rows):
        ext = [j for j in range(kc + 4, cols) if tab[r, j] >= 0]
        if ext != [kc + r] or tab[r, kc + r] != 0:
            raise AssertionError(f"BG{bg} Z={Z}: extension row {r} structure unexpected")

    return LDPCGraph(
        bg=bg, Z=Z, kc=kc, rows=rows, cols=cols, max_deg=max_deg, tab=tab,
        ecol=ecol, eshift=eshift, evalid=evalid,
        p0_shift=p0_shift, core_order=tuple(order),
    )


# --------------------------------------------------------------------------
# Encoder
# --------------------------------------------------------------------------

def encode(graph: LDPCGraph, info_bits: jnp.ndarray,
           n_cols: int | None = None) -> jnp.ndarray:
    """LDPC encode.

    info_bits: (batch, K) int8 in {0,1}; filler bits must already be 0.
    Returns (batch, n_cols*Z) mother codeword prefix (systematic first;
    the caller punctures the first 2Z bits in rate matching).
    n_cols: number of mother-code columns actually needed (defaults to
    all).  Rate matching only ever reads the first
    ceil((2Z + max_d_used)/Z) columns, so TX skips the unused extension
    parity rows — at typical rates that is most of them.
    Parity anchor: ldpc_encoder_optim8segmulti.c:46 (LDPCencoder).
    """
    g = graph
    Z, kc, tab = g.Z, g.kc, g.tab
    n_cols = g.cols if n_cols is None else min(n_cols, g.cols)
    n_ext = max(0, n_cols - kc - 4)
    B = info_bits.shape[0]
    c = info_bits.astype(jnp.uint8).reshape(B, kc, Z)
    blocks = [c[:, j] for j in range(kc)]  # each (B, Z)

    def row_acc(r: int, upto_col: int) -> jnp.ndarray:
        acc = jnp.zeros((B, Z), dtype=jnp.uint8)
        for j in range(upto_col):
            s = int(tab[r, j])
            if s >= 0:
                acc = acc ^ jnp.roll(blocks[j], -s, axis=-1)
        return acc

    # core parity p0: XOR of the four core rows' info contributions
    s_info = [row_acc(i, kc) for i in range(4)]
    U = s_info[0] ^ s_info[1] ^ s_info[2] ^ s_info[3]
    parity = {kc: jnp.roll(U, g.p0_shift, axis=-1)}
    blocks.append(parity[kc])
    # p1..p3 by forward substitution
    for (i, j, vshift) in g.core_order:
        acc = s_info[i]
        for jj in range(kc, kc + 4):
            s = int(tab[i, jj])
            if s >= 0 and jj in parity and jj != j:
                acc = acc ^ jnp.roll(parity[jj], -s, axis=-1)
        pj = jnp.roll(acc, vshift, axis=-1)
        parity[j] = pj
    for j in range(kc + 1, kc + 4):
        blocks.append(parity[j])
    # extension parities: p_{kc+r} = XOR over info+core cols of row r
    for r in range(4, 4 + n_ext):
        blocks.append(row_acc(r, kc + 4))
    return jnp.stack(blocks, axis=1).reshape(B, n_cols * Z).astype(jnp.int8)


# --------------------------------------------------------------------------
# Decoder (flooding normalized min-sum)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _decode_indices(bg: int, Z: int):
    """Static gather indices for the lifted graph at (bg, Z)."""
    g = build_graph(bg, Z)
    RE = g.rows * g.max_deg
    col_ids = g.ecol.reshape(RE)
    shifts = g.eshift.reshape(RE)
    valid = g.evalid.reshape(RE)
    k = np.arange(Z)[None, :]
    idx_cn = (k + shifts[:, None]) % Z      # vn -> cn lane map
    idx_vn = (k - shifts[:, None]) % Z      # cn -> vn lane map
    return g, col_ids.astype(np.int32), idx_cn.astype(np.int32), idx_vn.astype(np.int32), valid


def decode(
    graph: LDPCGraph,
    llr: jnp.ndarray,
    n_iters: int = 20,
    alpha: float = 0.8125,
    early_stop: bool = True,
):
    """Flooding normalized-min-sum decode.

    llr: (batch, cols*Z) float; >0 means bit 0.  Punctured positions carry 0,
    filler positions a large positive value.
    Returns (bits (batch, K) int8, parity_ok (batch,) bool, iters_used int32).
    """
    g, col_ids_np, idx_cn_np, idx_vn_np, valid_np = _decode_indices(graph.bg, graph.Z)
    B = llr.shape[0]
    Z, C, R, D = g.Z, g.cols, g.rows, g.max_deg
    RE = R * D

    col_ids = jnp.asarray(col_ids_np)
    idx_cn = jnp.asarray(idx_cn_np)[None]   # (1, RE, Z)
    idx_vn = jnp.asarray(idx_vn_np)[None]

    llr_cols = jnp.concatenate(
        [llr.reshape(B, C, Z).astype(jnp.float32), jnp.zeros((B, 1, Z), jnp.float32)], axis=1
    )  # (B, C+1, Z), dummy col for padded edges

    def vn_totals(c2v_cn):
        c2v_vn = jnp.take_along_axis(c2v_cn, jnp.broadcast_to(idx_vn, c2v_cn.shape), axis=-1)
        tot = jnp.zeros((B, C + 1, Z), jnp.float32).at[:, col_ids].add(c2v_vn)
        return llr_cols + tot, c2v_vn

    valid_rd = jnp.asarray(valid_np).reshape(1, R, D, 1)

    def cn_update(c2v_cn):
        tot, c2v_vn = vn_totals(c2v_cn)
        v2c_vn = tot[:, col_ids] - c2v_vn
        v2c_cn = jnp.take_along_axis(v2c_vn, jnp.broadcast_to(idx_cn, v2c_vn.shape), axis=-1)
        m = v2c_cn.reshape(B, R, D, Z)
        mag = jnp.where(valid_rd, jnp.abs(m), _BIG)
        neg = jnp.where(valid_rd, m < 0, False)
        min1 = jnp.min(mag, axis=2, keepdims=True)
        pos = jnp.argmin(mag, axis=2)[:, :, None, :]                      # (B,R,1,Z)
        is_min = jax.lax.broadcasted_iota(jnp.int32, (B, R, D, Z), 2) == pos
        min2 = jnp.min(jnp.where(is_min, _BIG, mag), axis=2, keepdims=True)
        sign_tot = jnp.sum(neg, axis=2, keepdims=True) & 1
        out_mag = jnp.where(is_min, min2, min1) * jnp.float32(alpha)
        out_neg = (sign_tot ^ neg.astype(jnp.int32)).astype(bool)
        c2v = jnp.where(out_neg, -out_mag, out_mag)
        c2v = jnp.where(valid_rd, c2v, 0.0)
        return c2v.reshape(B, RE, Z)

    def hard_bits(c2v_cn):
        tot, _ = vn_totals(c2v_cn)
        return (tot[:, :C] < 0).astype(jnp.int8).reshape(B, C * Z)

    def parity_ok(bits):
        b = bits.reshape(B, C, Z)
        b = jnp.concatenate([b, jnp.zeros((B, 1, Z), jnp.int8)], axis=1)
        vals = b[:, col_ids]  # (B, RE, Z)
        vals = jnp.take_along_axis(vals, jnp.broadcast_to(idx_cn, vals.shape), axis=-1)
        syn = jnp.sum(vals.reshape(B, R, D, Z), axis=2) & 1
        return jnp.all(syn == 0, axis=(1, 2))

    if early_stop:
        def cond(state):
            c2v, it, done = state
            return (it < n_iters) & jnp.logical_not(jnp.all(done))

        def body(state):
            c2v, it, _ = state
            c2v = cn_update(c2v)
            done = parity_ok(hard_bits(c2v))
            return c2v, it + 1, done

        c2v0 = jnp.zeros((B, RE, Z), jnp.float32)
        done0 = jnp.zeros((B,), bool)
        c2v, iters, done = jax.lax.while_loop(cond, body, (c2v0, jnp.int32(0), done0))
    else:
        def body(it, c2v):
            return cn_update(c2v)

        c2v = jax.lax.fori_loop(0, n_iters, body, jnp.zeros((B, RE, Z), jnp.float32))
        iters = jnp.int32(n_iters)
        done = parity_ok(hard_bits(c2v))

    bits = hard_bits(c2v)
    return bits[:, : g.K], done, iters


# --------------------------------------------------------------------------
# Layered decoder (plain reference for ops/ldpc_triton.py)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def row_edges(bg: int, Z: int) -> tuple:
    """Edges grouped by check row, in schedule order.

    Returns ((first_edge, cols, shifts), ...) per row: the row's edges are
    the flat edge ids first_edge .. first_edge + len(cols) - 1."""
    tab = build_graph(bg, Z).tab
    out, e = [], 0
    for r in range(tab.shape[0]):
        cols = np.nonzero(tab[r] >= 0)[0]
        out.append((e, tuple(int(c) for c in cols),
                    tuple(int(tab[r, c]) for c in cols)))
        e += len(cols)
    return tuple(out)


class LayeredState(NamedTuple):
    app: jnp.ndarray     # (B, cols, Z) a-posteriori LLR totals
    c2v: jnp.ndarray     # (B, E, Z) check-to-variable messages, row orientation
    ok: jnp.ndarray      # (B,) all parity checks hold
    iters: jnp.ndarray   # (B,) iterations run


def layered_minsum(graph: LDPCGraph, llr: jnp.ndarray, n_iters: int = 8,
                   alpha: float = 0.8125,
                   early_stop: bool = True) -> LayeredState:
    """Row-layered normalized min-sum, written in plain jax.numpy.

    Rows are visited in order; each row reads its columns' totals rotated
    into row orientation (lane k of edge (c, s) is column c's bit
    (k + s) mod Z), replaces its old c2v messages with new ones and writes
    the totals back.  The message for edge d is alpha * (the smallest |v2c|
    of the other edges) with the product of their signs.  With early_stop,
    a code block whose syndrome is zero after an iteration is frozen, so
    each block stops on its own — the Triton kernel's schedule exactly.
    """
    rows = row_edges(graph.bg, graph.Z)
    B = llr.shape[0]
    Z, C = graph.Z, graph.cols
    E = rows[-1][0] + len(rows[-1][1])
    k = np.arange(Z)
    lanes = [np.asarray(cs)[:, None] for _, cs, _ in rows]
    rot = [(k[None, :] + np.asarray(ss)[:, None]) % Z for _, _, ss in rows]

    def row_view(app, r):
        return app[:, lanes[r], rot[r]]                   # (B, D, Z)

    def iteration(app, c2v):
        for r, (e0, cs, _) in enumerate(rows):
            d = len(cs)
            v = row_view(app, r) - c2v[:, e0: e0 + d]
            mag = jnp.abs(v)
            m1 = jnp.min(mag, axis=1, keepdims=True)
            is_min = (jnp.arange(d)[None, :, None]
                      == jnp.argmin(mag, axis=1)[:, None, :])
            m2 = jnp.min(jnp.where(is_min, _BIG, mag), axis=1, keepdims=True)
            neg = v < 0
            out_neg = (jnp.sum(neg, axis=1, keepdims=True) % 2 == 1) ^ neg
            out = jnp.where(is_min, m2, m1) * jnp.float32(alpha)
            new = jnp.where(out_neg, -out, out)
            app = app.at[:, lanes[r], rot[r]].set(v + new)
            c2v = c2v.at[:, e0: e0 + d].set(new)
        return app, c2v

    def syndrome_ok(app):
        bad = jnp.zeros((B, Z), bool)
        for r in range(len(rows)):
            par = jnp.sum(row_view(app, r) < 0, axis=1) % 2 == 1
            bad = bad | par
        return ~jnp.any(bad, axis=1)

    def body(state):
        app, c2v, ok, iters, it = state
        new_app, new_c2v = iteration(app, c2v)
        if early_stop:
            run = ~ok
            new_app = jnp.where(run[:, None, None], new_app, app)
            new_c2v = jnp.where(run[:, None, None], new_c2v, c2v)
            iters = iters + run.astype(jnp.int32)
        else:
            iters = iters + 1
        return new_app, new_c2v, syndrome_ok(new_app), iters, it + 1

    def cond(state):
        _, _, ok, _, it = state
        if early_stop:
            return (it < n_iters) & ~jnp.all(ok)
        return it < n_iters

    app0 = llr.reshape(B, C, Z).astype(jnp.float32)
    init = (app0, jnp.zeros((B, E, Z), jnp.float32), jnp.zeros((B,), bool),
            jnp.zeros((B,), jnp.int32), jnp.int32(0))
    with jax.default_matmul_precision("highest"):
        app, c2v, ok, iters, _ = jax.lax.while_loop(cond, body, init)
    return LayeredState(app=app, c2v=c2v, ok=ok, iters=iters)


def decode_layered(graph: LDPCGraph, llr: jnp.ndarray, n_iters: int = 8,
                   alpha: float = 0.8125, early_stop: bool = True):
    """layered_minsum -> (bits (B, K) int8, parity_ok (B,), iters (B,))."""
    st = layered_minsum(graph, llr, n_iters, alpha, early_stop)
    bits = (st.app[:, : graph.kc] < 0).astype(jnp.int8)
    return bits.reshape(llr.shape[0], graph.K), st.ok, st.iters


# --------------------------------------------------------------------------
# numpy reference helpers (tests)
# --------------------------------------------------------------------------

def check_parity_np(graph: LDPCGraph, codeword: np.ndarray) -> bool:
    """Verify H @ c == 0 over GF(2) for (cols*Z,) codeword."""
    g = graph
    c = np.asarray(codeword).reshape(g.cols, g.Z)
    for r in range(g.rows):
        syn = np.zeros(g.Z, dtype=np.int64)
        for j in range(g.cols):
            s = int(g.tab[r, j])
            if s >= 0:
                syn ^= np.roll(c[j], -s)
        if syn.any():
            return False
    return True
