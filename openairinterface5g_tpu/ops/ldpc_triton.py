"""Layered min-sum LDPC decoder for NVIDIA GPUs (Pallas, Triton route).

One program decodes one code block.  Its Z lanes are a vector of ZP
lanes, Z rounded up to a power of two, with the padding lanes masked.
For each check row in turn, the kernel loads its columns' a-posteriori
totals rotated into row orientation — the cyclic shift is address
arithmetic on the load, lane k reads bit (k + s) mod Z — together with
the row's old c2v messages, computes the normalized min-sum update and
stores both back.  Only the 316 (BG1) or 197 (BG2) real edges move
bytes; the XLA flooding decoder pads every row to the largest degree.

The rows run in order as a few loops over runs of consecutive rows
(`_row_groups`), each run with the edge slots of its largest row degree
unrolled; a row's unused slots are masked and touch no memory.  Unrolling
all 316 edges instead makes the GPU compile take minutes.  The edge
table (column, shift, edge id per slot) is a small input.

Totals and messages live in device-memory scratch (two extra outputs
that the caller drops), float32, with rows padded to ZP lanes so every
masked lane has a slot of its own.  A barrier separates rows, because
the next row reads totals that other threads of the block stored.  After
every iteration the program recomputes the syndrome and stops once all
parity checks hold (the early-stop analog of nrLDPC_decoder.c:554).

`ldpc.layered_minsum` is the plain jax.numpy reference with the same
schedule, the same per-block early stop and the same arithmetic.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..coding.ldpc import LDPCGraph, build_graph, row_edges

_BIG = 1e30
# Cost of one unrolled edge slot, in padded slots, when splitting rows
# into runs: more runs pad less but unroll more code.
_SLOT_CODE_COST = 8
_NUM_WARPS = 8   # 2, 4 and 8 measured at 208 BG1 Z=384 blocks: 8 is fastest


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=64)
def _row_groups(bg: int, Z: int):
    """Runs of consecutive rows ((r0, r1, D, first_slot), ...) and the slot
    table (3, n_slots) int32 of (column or -1, shift, edge id).

    The split minimizes padded slots + _SLOT_CODE_COST * unrolled slots."""
    rows = row_edges(bg, Z)
    deg = [len(cs) for _, cs, _ in rows]
    n = len(deg)
    best, cut = [0] + [None] * n, [0] * (n + 1)
    for j in range(1, n + 1):
        for i in range(j):
            D = max(deg[i:j])
            cost = best[i] + (j - i) * D - sum(deg[i:j]) + _SLOT_CODE_COST * D
            if best[j] is None or cost < best[j]:
                best[j], cut[j] = cost, i
    runs, j = [], n
    while j:
        runs.append((cut[j], j, max(deg[cut[j]:j])))
        j = cut[j]
    groups, table = [], []
    for r0, r1, D in reversed(runs):
        groups.append((r0, r1, D, len(table)))
        for e0, cs, ss in rows[r0:r1]:
            table += [(cs[d], ss[d], e0 + d) if d < len(cs) else (-1, 0, 0)
                      for d in range(D)]
    return tuple(groups), np.asarray(table, np.int32).T.copy()


@functools.lru_cache(maxsize=32)
def _build(bg: int, Z: int, n_cb: int, n_iters: int, alpha: float,
           interpret: bool):
    g = build_graph(bg, Z)
    groups, table = _row_groups(bg, Z)
    C, K = g.cols, g.K
    E = int(table[2].max()) + 1
    ZP = _next_pow2(Z)

    def kernel(tab_ref, llr_ref, bits_ref, ok_ref, app_ref, c2v_ref):
        cb = pl.program_id(0)
        k = jax.lax.broadcasted_iota(jnp.int32, (ZP,), 0)
        lane = k < Z

        def col(c):
            return app_ref.at[cb, pl.ds(c * ZP, ZP)]

        def slot(i):
            """Slot i: (column, row-orientation view of its totals, its c2v
            messages, whether the slot holds an edge)."""
            c, s, e = tab_ref[0, i], tab_ref[1, i], tab_ref[2, i]
            valid = c >= 0
            c = jnp.maximum(c, 0)
            j = k + s
            j = jnp.where(j >= Z, j - Z, j)
            # padding lanes keep their own slot
            view = app_ref.at[cb, c * ZP + jnp.where(lane, j, k)]
            return view, c2v_ref.at[cb, pl.ds(e * ZP, ZP)], lane & valid

        def barrier():
            if not interpret:   # one program runs at a time when interpreted
                plgpu.debug_barrier()

        def init(c, carry):
            x = plgpu.load(llr_ref.at[pl.ds(cb * (C * Z) + c * Z, ZP)],
                           mask=lane, other=0.0)
            plgpu.store(col(c), x.astype(jnp.float32), mask=lane)
            return carry

        jax.lax.fori_loop(0, C, init, 0)
        barrier()

        def iteration(it):
            first = it == 0     # c2v starts at zero: skip its load

            for r0, r1, D, s0 in groups:
                def row(r, carry, r0=r0, D=D, s0=s0):
                    i0 = s0 + (r - r0) * D
                    vs = []
                    m1 = jnp.full((ZP,), _BIG, jnp.float32)
                    m2 = m1
                    neg = jnp.zeros((ZP,), jnp.bool_)
                    for d in range(D):
                        view, msg, m = slot(i0 + d)
                        v = (plgpu.load(view, mask=m, other=0.0)
                             - plgpu.load(msg, mask=m & ~first, other=0.0))
                        a = jnp.where(m, jnp.abs(v), _BIG)
                        m2 = jnp.minimum(m2, jnp.maximum(m1, a))
                        m1 = jnp.minimum(m1, a)
                        neg = neg ^ (v < 0)
                        vs.append(v)
                    for d in range(D):
                        view, msg, m = slot(i0 + d)
                        v = vs[d]
                        out = (jnp.where(jnp.abs(v) == m1, m2, m1)
                               * jnp.float32(alpha))
                        new = jnp.where(neg ^ (v < 0), -out, out)
                        plgpu.store(view, v + new, mask=m)
                        plgpu.store(msg, new, mask=m)
                    barrier()
                    return carry

                jax.lax.fori_loop(r0, r1, row, 0)

        def syndrome_ok():
            bad = jnp.zeros((ZP,), jnp.int32)
            for r0, r1, D, s0 in groups:
                def row(r, bad, r0=r0, D=D, s0=s0):
                    par = jnp.zeros((ZP,), jnp.bool_)
                    for d in range(D):
                        view, _, m = slot(s0 + (r - r0) * D + d)
                        par = par ^ (plgpu.load(view, mask=m, other=0.0) < 0)
                    return bad | (par & lane).astype(jnp.int32)

                bad = jax.lax.fori_loop(r0, r1, row, bad)
            return (jnp.sum(bad) == 0).astype(jnp.int32)

        def cond(carry):
            it, done = carry
            return (it < n_iters) & (done == 0)

        def body(carry):
            it, _ = carry
            iteration(it)
            return it + 1, syndrome_ok()

        _, done = jax.lax.while_loop(cond, body, (jnp.int32(0), jnp.int32(0)))
        ok_ref[cb] = done

        def hard(c, carry):
            t = plgpu.load(col(c), mask=lane, other=0.0)
            plgpu.store(bits_ref.at[pl.ds(cb * K + c * Z, ZP)],
                        (t < 0).astype(jnp.int8), mask=lane)
            return carry

        jax.lax.fori_loop(0, g.kc, hard, 0)

    call = pl.pallas_call(
        kernel,
        out_shape=[
            jax.ShapeDtypeStruct((n_cb * K,), jnp.int8),
            jax.ShapeDtypeStruct((n_cb,), jnp.int32),
            jax.ShapeDtypeStruct((n_cb, C * ZP), jnp.float32),
            jax.ShapeDtypeStruct((n_cb, E * ZP), jnp.float32),
        ],
        grid=(n_cb,),
        backend="triton",
        interpret=interpret,
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=1),
        name="ldpc_layered_minsum",
    )
    return call, table


def decode_state(graph: LDPCGraph, llr: jnp.ndarray, n_iters: int = 8,
                 alpha: float = 0.8125, interpret: bool = False):
    """(B, cols*Z) LLRs -> (bits (B, K) int8, ok (B,) bool, app (B, cols, Z),
    c2v (B, E, Z)): the decode plus the final totals and messages, in the
    layout of ldpc.layered_minsum."""
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the Triton LDPC kernel needs a GPU; use decoder_backend='xla' "
            f"on {jax.default_backend()!r}")
    n_cb = llr.shape[0]
    Z, ZP = graph.Z, _next_pow2(graph.Z)
    call, table = _build(graph.bg, Z, n_cb, int(n_iters), float(alpha),
                         bool(interpret))
    # llr and bits are flat, so a column's ZP-lane window may run past the
    # row end; the lanes past Z are masked
    bits, ok, app, c2v = call(jnp.asarray(table), llr.reshape(-1))
    bits = bits.reshape(n_cb, graph.K)
    app = app.reshape(n_cb, graph.cols, ZP)[..., :Z]
    c2v = c2v.reshape(n_cb, -1, ZP)[..., :Z]
    return bits, ok != 0, app, c2v


def decode(graph: LDPCGraph, llr: jnp.ndarray, n_iters: int = 8,
           alpha: float = 0.8125, interpret: bool = False):
    """(B, cols*Z) float32/bfloat16 LLRs (>0 means bit 0) ->
    (bits (B, K) int8, parity_ok (B,) bool)."""
    bits, ok, _, _ = decode_state(graph, llr, n_iters, alpha, interpret)
    return bits, ok
