"""LDPC rate matching / recovery + HARQ combining, TS 38.212 §5.4.2.

The reference walks the circular buffer bit-by-bit skipping filler NULLs
(openair1/PHY/CODING/nr_rate_matching.c:34 index_k0, :507
nr_rate_matching_ldpc_rx).  Here the whole selection is a precomputed static
index tensor per (bg, Z, rv, E, F): TX is one gather, RX de-rate-matching is
one scatter-add into the (batch, N) LLR buffer — which is also exactly HARQ
soft combining when accumulated into a persistent buffer.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from .ldpc import LDPCGraph

# TS 38.212 Table 5.4.2.1-2: k0 numerators per (bg, rv); k0 = floor(num * Ncb / (den*Z)) * Z
_K0_NUM = {1: {0: 0, 1: 17, 2: 33, 3: 56}, 2: {0: 0, 1: 13, 2: 25, 3: 43}}
_DEN = {1: 66, 2: 50}


def k0_offset(bg: int, Z: int, rv: int, Ncb: int) -> int:
    return (_K0_NUM[bg][rv] * Ncb // (_DEN[bg] * Z)) * Z


@functools.lru_cache(maxsize=256)
def selection_indices(bg: int, Z: int, kc: int, rv: int, E: int, F: int, Ncb: int | None = None) -> np.ndarray:
    """(E,) int32 indices into the length-Ncb circular buffer d_0..d_{Ncb-1}.

    d is the mother codeword minus the first 2Z punctured systematic bits.
    Filler positions (K' - 2Z .. K - 2Z - 1) are skipped per spec.
    """
    K = kc * Z
    N = Ncb if Ncb is not None else (_DEN[bg] + 2) * Z - 2 * Z  # 66Z/50Z
    k0 = k0_offset(bg, Z, rv, N)
    f_lo, f_hi = K - 2 * Z - F, K - 2 * Z  # filler range within d
    is_filler = np.zeros(N, dtype=bool)
    is_filler[f_lo:f_hi] = True
    order = (k0 + np.arange(N)) % N
    usable = order[~is_filler[order]]
    n_usable = len(usable)
    reps = -(-E // n_usable)
    sel = np.tile(usable, reps)[:E]
    return sel.astype(np.int32)


def rate_match_tx(graph: LDPCGraph, codeword: jnp.ndarray, rv: int, E: int,
                  F: int, ncb: int | None = None) -> jnp.ndarray:
    """(batch, cols*Z) mother codeword -> (batch, E) transmitted bits.

    ncb: optional limited circular-buffer size (LBRM, TS 38.212 5.4.2.1).
    """
    g = graph
    d = codeword[..., 2 * g.Z:]  # drop punctured systematic head
    sel = jnp.asarray(selection_indices(g.bg, g.Z, g.kc, rv, E, F, ncb))
    return jnp.take(d, sel, axis=-1)


def rate_match_rx(
    graph: LDPCGraph,
    llr_e: jnp.ndarray,
    rv: int,
    F: int,
    harq_buffer: jnp.ndarray | None = None,
    filler_llr: float = 1e4,
) -> jnp.ndarray:
    """(batch, E) received LLRs -> (batch, cols*Z) mother-code LLRs.

    Scatter-adds into `harq_buffer` (same shape, previous rounds' LLRs) when
    given — this IS the HARQ soft combine (nr_rate_matching.c:507 analog).
    Punctured head bits get LLR 0; fillers get a large known-zero LLR.
    """
    g = graph
    B = llr_e.shape[0]
    E = llr_e.shape[-1]
    N = g.N
    sel = jnp.asarray(selection_indices(g.bg, g.Z, g.kc, rv, E, F))
    d = jnp.zeros((B, N), llr_e.dtype).at[:, sel].add(llr_e)
    K = g.K
    if F:
        filler = jnp.zeros((N,), llr_e.dtype).at[K - 2 * g.Z - F: K - 2 * g.Z].set(filler_llr)
        d = d + filler[None]
    full = jnp.concatenate([jnp.zeros((B, 2 * g.Z), llr_e.dtype), d], axis=-1)
    if harq_buffer is not None:
        full = full + harq_buffer
    return full


def interleave_tx(bits_e: jnp.ndarray, Qm: int) -> jnp.ndarray:
    """Bit interleaver, TS 38.212 §5.4.2.2: f_{i+j*Qm} = e_{i*(E/Qm)+j}."""
    E = bits_e.shape[-1]
    lead = bits_e.shape[:-1]
    return bits_e.reshape(*lead, Qm, E // Qm).swapaxes(-1, -2).reshape(*lead, E)


def deinterleave_rx(llr_f: jnp.ndarray, Qm: int) -> jnp.ndarray:
    """Inverse of interleave_tx (operates on LLRs at RX)."""
    E = llr_f.shape[-1]
    lead = llr_f.shape[:-1]
    return llr_f.reshape(*lead, E // Qm, Qm).swapaxes(-1, -2).reshape(*lead, E)


@functools.lru_cache(maxsize=64)
def fused_rx_indices(bg: int, Z: int, kc: int, rv: int, es: tuple, qm: int,
                     F: int, ncb: int | None = None):
    """One global (G,) permutation fusing per-CB deinterleave + rate-match
    scatter: codeword-position g -> flat index into the (C*N,) LLR buffer.

    Collapses the reference's per-CB deinterleave->recover loops (and our
    previous C separate scatter-adds) into a single scatter over the whole
    transport block — one HBM pass instead of C.
    """
    N = (_DEN[bg] + 2) * Z - 2 * Z
    idx = np.empty(sum(es), dtype=np.int32)
    off = 0
    for j, E in enumerate(es):
        sel = selection_indices(bg, Z, kc, rv, E, F, ncb)     # (E,) into N
        # deinterleave: f[i + j*Qm] = e[i*(E/Qm) + j]  =>  e-index for f-pos
        f_pos = np.arange(E)
        e_idx = (f_pos % qm) * (E // qm) + (f_pos // qm)
        idx[off: off + E] = j * N + sel[e_idx]
        off += E
    return idx


@functools.lru_cache(maxsize=64)
def fused_rx_gather_layers(bg: int, Z: int, kc: int, rv: int, es: tuple,
                           qm: int, F: int, ncb: int | None = None):
    """Inverse of fused_rx_indices as GATHER layers: (L, C*N) source
    positions into the (G,)-codeword (G = sentinel for 'no source' -> the
    zero pad).  L = max repetition multiplicity (1 unless E > usable Ncb).

    A gather instead of a scatter: no index collisions to order.
    """
    N = (_DEN[bg] + 2) * Z - 2 * Z
    idx = fused_rx_indices(bg, Z, kc, rv, es, qm, F, ncb)     # (G,) -> C*N
    CN = len(es) * N
    G = len(idx)
    order = np.argsort(idx, kind="stable")
    sorted_t = idx[order]
    counts = np.bincount(idx, minlength=CN)
    L = max(1, int(counts.max()))
    first = np.searchsorted(sorted_t, np.arange(CN), side="left")
    rank = np.arange(G) - first[sorted_t]
    layers = np.full((L, CN), G, dtype=np.int32)
    layers[rank, sorted_t] = order
    return layers


@functools.lru_cache(maxsize=256)
def _rx_runs(bg: int, Z: int, kc: int, rv: int, E: int, F: int,
             ncb: int | None = None) -> tuple:
    """Contiguous runs (e_start, d_start, length) of the bit-selection map.

    The circular-buffer selection is piecewise-contiguous — breaks occur
    only at the filler window, the buffer wrap, and repetition restarts —
    so de-rate-matching is a handful of dense slice-adds instead of an
    E-element gather.
    """
    sel = selection_indices(bg, Z, kc, rv, E, F, ncb)
    runs = []
    s = 0
    for i in range(1, E + 1):
        if i == E or sel[i] != sel[i - 1] + 1:
            runs.append((s, int(sel[s]), i - s))
            s = i
    return tuple(runs)


def _cb_groups(es: tuple) -> list:
    """Contiguous groups of identical per-CB rate-matched size E."""
    groups = []
    j0 = 0
    for j in range(1, len(es) + 1):
        if j == len(es) or es[j] != es[j0]:
            groups.append((j0, j, es[j0]))
            j0 = j
    return groups


def fused_rate_match_rx(graph, llr_cw, rv: int, es: tuple, qm: int, F: int,
                        harq_buffer=None, filler_llr: float = 1e4,
                        ncb: int | None = None):
    """(B, G) codeword LLRs -> (B, C, cols*Z) mother-code LLRs.

    Fuses per-CB deinterleave (a dense (E/qm, qm) transpose) with circular-
    buffer recovery done as run-wise static slice-adds (_rx_runs) — zero
    gathers, one HBM pass.  CBs sharing the same E (all but gamma of them,
    TS 38.212 §5.4.2.1) are processed as one (B, Cg, E) tensor.

    harq_buffer: optional (B, C, cols*Z) previous-round buffer to combine.
    """
    B = llr_cw.shape[0]
    offs = np.concatenate([[0], np.cumsum(es)])

    def seg_of_group(j0, j1, E):
        seg = llr_cw[:, offs[j0]: offs[j1]].reshape(B, j1 - j0, E)
        return deinterleave_rx(seg, qm)

    return _fused_rx_body(graph, seg_of_group, B, llr_cw.dtype, es, rv, qm,
                          F, harq_buffer, filler_llr, ncb)


def _fused_rx_body(graph, seg_of_group, B, dtype, es, rv, qm, F,
                   harq_buffer, filler_llr, ncb):
    g = graph
    C = len(es)
    N = g.N
    groups = _cb_groups(tuple(es))
    group_runs = [_rx_runs(g.bg, g.Z, g.kc, rv, E, F, ncb)
                  for (_, _, E) in groups]
    # fast path: when every group's runs land at strictly increasing,
    # non-overlapping d-positions (always true at rv=0 and whenever E fits
    # the circular buffer without wrap), the whole recovery is slice
    # CONCATENATION — one buffer materialization instead of one
    # copy-on-write .at[].add pass per run
    concat_ok = all(
        all(runs[i][1] + runs[i][2] <= runs[i + 1][1]
            for i in range(len(runs) - 1))
        for runs in group_runs)
    if concat_ok:
        d_groups = []
        for (j0, j1, E), runs in zip(groups, group_runs):
            seg = seg_of_group(j0, j1, E)
            pieces, pos = [], 0
            for (e0, d0, ln) in runs:
                if d0 > pos:
                    pieces.append(jnp.zeros((B, j1 - j0, d0 - pos), dtype))
                pieces.append(seg[:, :, e0: e0 + ln])
                pos = d0 + ln
            if pos < N:
                pieces.append(jnp.zeros((B, j1 - j0, N - pos), dtype))
            d_groups.append(jnp.concatenate(pieces, axis=-1))
        d = (d_groups[0] if len(d_groups) == 1
             else jnp.concatenate(d_groups, axis=1))
    else:
        d = jnp.zeros((B, C, N), dtype)
        for (j0, j1, E), runs in zip(groups, group_runs):
            seg = seg_of_group(j0, j1, E)
            for (e0, d0, ln) in runs:
                d = d.at[:, j0:j1, d0: d0 + ln].add(seg[:, :, e0: e0 + ln])
    if F:
        K = g.K
        filler = jnp.zeros((N,), dtype).at[K - 2 * g.Z - F: K - 2 * g.Z].set(filler_llr)
        d = d + filler[None, None]
    full = jnp.concatenate([jnp.zeros((B, C, 2 * g.Z), dtype), d], axis=-1)
    if harq_buffer is not None:
        full = full + harq_buffer
    return full


def tx_cols_needed(graph, rv: int, es: tuple, F: int,
                   ncb: int | None = None) -> int:
    """Number of mother-code columns the TX bit selection actually reads
    (incl. the 2Z punctured head) — lets ldpc.encode skip the extension
    parity rows past the last transmitted bit."""
    g = graph
    max_end = 0
    for (_, _, E) in _cb_groups(tuple(es)):
        for (_, d0, ln) in _rx_runs(g.bg, g.Z, g.kc, rv, E, F, ncb):
            max_end = max(max_end, d0 + ln)
    return 2 + -(-max_end // g.Z)


def fused_rate_match_tx(graph, codeword_cbs, rv: int, es: tuple, qm: int,
                        F: int, ncb: int | None = None):
    """(B, C, cols*Z) mother codewords -> (B, G) interleaved codeword bits.

    TX twin of fused_rate_match_rx: run-wise slice concatenation replaces
    the per-CB index gather of rate_match_tx + interleave_tx.
    """
    g = graph
    B = codeword_cbs.shape[0]
    d = codeword_cbs[..., 2 * g.Z:]                     # drop punctured head
    parts = []
    for (j0, j1, E) in _cb_groups(tuple(es)):
        seg = jnp.concatenate(
            [d[:, j0:j1, d0: d0 + ln]
             for (_, d0, ln) in _rx_runs(g.bg, g.Z, g.kc, rv, E, F, ncb)],
            axis=-1)                                    # (B, Cg, E)
        parts.append(interleave_tx(seg, qm).reshape(B, -1))
    return jnp.concatenate(parts, axis=-1)
