"""LTE rate matching (TS 36.212 §5.1.4) — turbo and convolutional.

Reference: openair1/PHY/CODING/lte_rate_matching.c (per-bit C loops with
byte LUTs).  The design mirrors the NR module (coding/rate_matching.py):
the sub-block interleaver + circular buffer + NULL skipping collapse
into ONE host-precomputed gather index per (K, E, rv, Ncb, F), cached;
TX is a single gather, RX soft-combine is a single scatter-add.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

# column permutation patterns (36.212 Table 5.1.4-1 / 5.1.4-2)
_P_TURBO = np.array([0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22,
                     14, 30, 1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27,
                     7, 23, 15, 31], np.int64)
_P_CONV = np.array([1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23,
                    15, 31, 0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26,
                    6, 22, 14, 30], np.int64)


def _subblock(D: int, perm: np.ndarray, plus_one: bool = False) -> np.ndarray:
    """(Kpi,) indices into the stream (-1 = NULL pad).

    Standard sub-block interleave: prepend ND nulls, fill a R x 32 matrix
    row-wise, permute columns, read column-wise.  plus_one selects the
    turbo d2 variant pi(k) = (P[k/R] + 32*(k%R) + 1) mod Kpi.
    """
    C = 32
    R = -(-D // C)
    Kpi = R * C
    ND = Kpi - D
    y = np.concatenate([np.full(ND, -1, np.int64), np.arange(D)])
    if plus_one:
        k = np.arange(Kpi)
        src = (perm[k // R] + C * (k % R) + 1) % Kpi
        return y[src]
    r = np.arange(R)
    out = np.empty(Kpi, np.int64)
    for c in range(C):
        out[c * R: (c + 1) * R] = y[C * r + perm[c]]
    return out


@functools.lru_cache(maxsize=256)
def turbo_rm_indices(K: int, E: int, rv: int, ncb: int | None = None,
                     F: int = 0) -> np.ndarray:
    """(E,) gather indices into flat d = concat(d0, d1, d2), D = K + 4.

    Circular-buffer bit selection with NULL skipping; filler positions
    (first F of d0 AND d1, 36.212 §5.1.3.2.2) count as NULL.
    """
    D = K + 4
    v0 = _subblock(D, _P_TURBO)
    v1 = _subblock(D, _P_TURBO)
    v2 = _subblock(D, _P_TURBO, plus_one=True)
    Kpi = len(v0)
    # w maps circular-buffer position -> flat-d index (-1 = NULL)
    w = np.empty(3 * Kpi, np.int64)
    w[:Kpi] = np.where(v0 >= 0, v0, -1)
    w[Kpi::2] = np.where(v1 >= 0, v1 + D, -1)
    w[Kpi + 1:: 2] = np.where(v2 >= 0, v2 + 2 * D, -1)
    if F:
        filler = np.zeros(3 * D + 1, bool)
        filler[:F] = True                     # d0 fillers
        filler[D: D + F] = True               # d1 fillers
        w = np.where((w >= 0) & filler[np.maximum(w, 0)], -1, w)
    Ncb = 3 * Kpi if ncb is None else min(ncb, 3 * Kpi)
    R = Kpi // 32
    k0 = R * (2 * (-(-Ncb // (8 * R))) * rv + 2)
    cyc = np.roll(w[:Ncb], -(k0 % Ncb))
    valid = cyc[cyc >= 0]
    reps = -(-E // max(len(valid), 1))
    return np.tile(valid, reps)[:E]


@functools.lru_cache(maxsize=64)
def conv_rm_indices(L: int, E: int) -> np.ndarray:
    """(E,) gather indices into flat d = concat(d0, d1, d2) for the
    tail-biting convolutional code (36.212 §5.1.4.2); D = L per stream."""
    vs = [_subblock(L, _P_CONV) for _ in range(3)]
    w = np.concatenate([np.where(v >= 0, v + i * L, -1)
                        for i, v in enumerate(vs)])
    valid = w[w >= 0]
    reps = -(-E // len(valid))
    return np.tile(valid, reps)[:E]


def rate_match_tx(d_flat: jnp.ndarray, idx: np.ndarray) -> jnp.ndarray:
    """(B, 3D) coded bits + (E,) indices -> (B, E) selected bits."""
    return d_flat[:, jnp.asarray(idx)]


def rate_match_rx(llr_e: jnp.ndarray, idx: np.ndarray, n3d: int,
                  F: int = 0, D: int = 0) -> jnp.ndarray:
    """(B, E) received LLRs -> (B, 3D) soft-combined stream LLRs.

    Repeated positions accumulate (chase combining); filler positions get
    a large known-zero prior (bit 0 -> +LLR)."""
    B = llr_e.shape[0]
    out = jnp.zeros((B, n3d), llr_e.dtype)
    out = out.at[:, jnp.asarray(idx)].add(llr_e)
    if F:
        big = jnp.full((B, F), 1e4, llr_e.dtype)
        out = out.at[:, :F].set(big)
        out = out.at[:, D: D + F].set(big)
    return out


def cb_e_sizes(G: int, C: int, qm: int, n_layers: int = 1) -> list:
    """Per-code-block E (36.212 §5.1.4.1.2)."""
    gp = G // (n_layers * qm)
    gamma = gp % C
    return [n_layers * qm * (gp // C) if r <= C - 1 - gamma
            else n_layers * qm * (-(-gp // C)) for r in range(C)]
