"""LTE turbo codec (TS 36.212 §5.1.3.2) in JAX.

The reference implements the PCCC encoder with SSE bit tricks
(openair1/PHY/CODING/3gpplte_sse.c) and the max-log-MAP decoder as
hand-scheduled AVX2 kernels over 8-state trellis slices
(3gpplte_turbo_decoder_sse_16bit.c / _avx2_16bit.c), one code block per
call.  Here:

  * the 8-state RSC trellis is three (8, 2) static tables;
  * encode is a `lax.scan` over bits with a (B,) batch of states —
    all code blocks encode in one pass (the 8-segment SIMD trick C3
    becomes a real batch dim);
  * max-log-MAP decode runs alpha/beta as forward/backward `lax.scan`s
    over the (B, 8) state metrics, iterating SISO1/SISO2 with the QPP
    (de)interleaver as static index tensors;
  * everything is jit-compatible with static K from the 188-entry QPP
    table (data/lte_tables.py).

Polynomials: g0 = 1 + D^2 + D^3 (feedback), g1 = 1 + D + D^3.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..data.lte_tables import QPP_BY_K

# ---------------------------------------------------------------------------
# trellis tables (host, static)
# ---------------------------------------------------------------------------


def _step(state: int, x: int) -> tuple[int, int]:
    """One RSC step: state = (d1, d2, d3) packed as d1*4 + d2*2 + d3."""
    d1, d2, d3 = (state >> 2) & 1, (state >> 1) & 1, state & 1
    a = x ^ d2 ^ d3                  # feedback g0 = 1 + D^2 + D^3
    z = a ^ d1 ^ d3                  # parity   g1 = 1 + D + D^3
    return (a << 2) | (d1 << 1) | d2, z


@functools.lru_cache(maxsize=1)
def _tables():
    nxt = np.zeros((8, 2), np.int32)
    par = np.zeros((8, 2), np.int32)
    for s in range(8):
        for x in (0, 1):
            nxt[s, x], par[s, x] = _step(s, x)
    # termination input that zeroes the feedback: x = d2 ^ d3
    term_x = np.array([((s >> 1) & 1) ^ (s & 1) for s in range(8)], np.int32)
    return nxt, par, term_x


@functools.lru_cache(maxsize=64)
def qpp_interleaver(K: int) -> np.ndarray:
    """(K,) permutation Pi: c'_i = c_{Pi(i)} (TS 36.212 5.1.3.2.3)."""
    f1, f2 = QPP_BY_K[K]
    i = np.arange(K, dtype=np.int64)
    return ((f1 * i + f2 * i * i) % K).astype(np.int32)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _rsc_encode(bits: jnp.ndarray):
    """(B, K) bits -> (parity (B, K), final_state (B,)) via lax.scan."""
    nxt, par, _ = _tables()
    nxt_t, par_t = jnp.asarray(nxt), jnp.asarray(par)
    B = bits.shape[0]

    def body(state, x):
        z = par_t[state, x]
        return nxt_t[state, x], z

    state, zs = jax.lax.scan(body, jnp.zeros((B,), jnp.int32), bits.T.astype(jnp.int32))
    return zs.T, state


def _rsc_terminate(state: jnp.ndarray):
    """3 termination steps: returns (x_tail (B,3), z_tail (B,3))."""
    nxt, par, term_x = _tables()
    nxt_t, par_t = jnp.asarray(nxt), jnp.asarray(par)
    term_t = jnp.asarray(term_x)
    xs, zs = [], []
    for _ in range(3):
        x = term_t[state]
        xs.append(x)
        zs.append(par_t[state, x])
        state = nxt_t[state, x]
    return jnp.stack(xs, -1), jnp.stack(zs, -1)


def encode(bits: jnp.ndarray):
    """(B, K) info bits -> (d0, d1, d2) each (B, K+4) per 36.212 5.1.3.2.

    d0 = systematic, d1 = parity1, d2 = parity2; the last 4 positions of
    each stream carry the multiplexed trellis-termination bits
    (36.212 Table 5.1.3-1 mapping).
    """
    K = bits.shape[-1]
    pi = jnp.asarray(qpp_interleaver(K))
    b = bits.astype(jnp.int32)
    z1, s1 = _rsc_encode(b)
    b2 = b[:, pi]
    z2, s2 = _rsc_encode(b2)
    x1t, z1t = _rsc_terminate(s1)
    x2t, z2t = _rsc_terminate(s2)
    # 36.212 5.1.3.2.2: d0 tail = X(K) Z(K+1) X'(K) Z'(K+1)
    #                   d1 tail = Z(K) X(K+2) Z'(K) X'(K+2)
    #                   d2 tail = X(K+1) Z(K+2) X'(K+1) Z'(K+2)
    d0 = jnp.concatenate([b, jnp.stack(
        [x1t[:, 0], z1t[:, 1], x2t[:, 0], z2t[:, 1]], -1)], -1)
    d1 = jnp.concatenate([z1, jnp.stack(
        [z1t[:, 0], x1t[:, 2], z2t[:, 0], x2t[:, 2]], -1)], -1)
    d2 = jnp.concatenate([z2, jnp.stack(
        [x1t[:, 1], z1t[:, 2], x2t[:, 1], z2t[:, 2]], -1)], -1)
    return d0.astype(jnp.int8), d1.astype(jnp.int8), d2.astype(jnp.int8)


# ---------------------------------------------------------------------------
# max-log-MAP decoder
# ---------------------------------------------------------------------------

_NEG = np.float32(-1e30)


def _siso(l_sys, l_par, l_a, l_sys_tail, l_par_tail):
    """One max-log-MAP SISO pass over a terminated 8-state trellis.

    l_sys/l_par/l_a: (B, K) LLRs (positive = bit 0); *_tail: (B, 3).
    Returns extrinsic (B, K).
    """
    nxt, par, _ = _tables()
    B, K = l_sys.shape
    # branch half-metrics: m[k,s,x] = 0.5*(ls+la)*sgn(x) + 0.5*lp*sgn(z)
    xsgn = jnp.asarray(1.0 - 2.0 * np.arange(2, dtype=np.float32))  # (2,)
    zsgn = jnp.asarray((1.0 - 2.0 * par).astype(np.float32))        # (8,2)
    nxt_t = jnp.asarray(nxt)                                        # (8,2)

    ls = jnp.concatenate([l_sys + l_a, l_sys_tail], -1)             # (B,K+3)
    lp = jnp.concatenate([l_par, l_par_tail], -1)

    def gamma(k_ls, k_lp):
        # (B, 8, 2)
        return (0.5 * k_ls[:, None, None] * xsgn[None, None, :]
                + 0.5 * k_lp[:, None, None] * zsgn[None])

    # forward alphas via scan over k
    def a_body(alpha, ins):
        k_ls, k_lp = ins
        g = gamma(k_ls, k_lp)
        cand = alpha[:, :, None] + g                                # (B,8,2)
        new = jnp.full((B, 8), _NEG)
        new = new.at[:, nxt_t.reshape(-1)].max(
            cand.reshape(B, 16))
        new = new - jnp.max(new, axis=-1, keepdims=True)
        return new, alpha

    a0 = jnp.full((B, 8), _NEG).at[:, 0].set(0.0)
    _, alphas = jax.lax.scan(a_body, a0, (ls.T, lp.T))
    alphas = alphas.transpose(1, 0, 2)                              # (B,K+3,8)

    # backward betas
    def b_body(beta, ins):
        k_ls, k_lp = ins
        g = gamma(k_ls, k_lp)
        # beta_prev[s] = max_x g[s,x] + beta[next(s,x)]
        new = jnp.max(g + beta[:, nxt_t], axis=-1)
        new = new - jnp.max(new, axis=-1, keepdims=True)
        return new, new

    bK = jnp.full((B, 8), _NEG).at[:, 0].set(0.0)
    _, betas_rev = jax.lax.scan(b_body, bK, (ls.T[::-1], lp.T[::-1]))
    betas = betas_rev[::-1].transpose(1, 0, 2)                      # beta_k at step k

    # LLR over the K info steps: tot[b,k,s,x] = alpha_k[s] + g_k[s,x]
    #                                           + beta_{k+1}[nxt(s,x)]
    beta_next = jnp.concatenate([betas[:, 1:],
                                 bK[:, None, :]], axis=1)           # (B,K+3,8)
    g_all = (0.5 * ls.T[:, :, None, None] * xsgn
             + 0.5 * lp.T[:, :, None, None] * zsgn).transpose(1, 0, 2, 3)
    tot = alphas[..., None] + g_all + beta_next[:, :, nxt_t]        # (B,K+3,8,2)
    llr = (jnp.max(tot[..., 0], axis=-1) - jnp.max(tot[..., 1], axis=-1))
    llr = llr[:, :K]
    return llr - (l_sys + l_a)


def decode(l_d0, l_d1, l_d2, n_iters: int = 6, ext_scale: float = 0.75):
    """(B, K+4) stream LLRs -> (bits (B, K) int8, llr (B, K)).

    Iterative SISO1 <-> SISO2 max-log-MAP (the production turbo decoder
    loop of 3gpplte_turbo_decoder_sse_16bit.c, minus its CRC short-stop,
    which the caller layers on).  ext_scale is the usual max-log-MAP
    extrinsic damping (~0.7-0.75) that recovers most of the log-MAP gap.
    """
    B, K4 = l_d0.shape
    K = K4 - 4
    pi = jnp.asarray(qpp_interleaver(K))
    inv = jnp.zeros((K,), jnp.int32).at[pi].set(jnp.arange(K, dtype=jnp.int32))

    ls1 = l_d0[:, :K]
    lp1 = l_d1[:, :K]
    lp2 = l_d2[:, :K]
    ls2 = ls1[:, pi]
    # tail LLRs (36.212 Table 5.1.3-1 demux; see encode())
    s1_t = jnp.stack([l_d0[:, K], l_d1[:, K + 1], l_d2[:, K]], -1)
    p1_t = jnp.stack([l_d1[:, K], l_d0[:, K + 1], l_d2[:, K + 1]], -1)
    s2_t = jnp.stack([l_d0[:, K + 2], l_d1[:, K + 3], l_d2[:, K + 2]], -1)
    p2_t = jnp.stack([l_d1[:, K + 2], l_d0[:, K + 3], l_d2[:, K + 3]], -1)

    sc = np.float32(ext_scale)

    def body(carry, _):
        le21, _last = carry
        le12 = sc * _siso(ls1, lp1, le21, s1_t, p1_t)
        le21_new = sc * _siso(ls2, lp2, le12[:, pi], s2_t, p2_t)
        return (le21_new[:, inv], le12), None

    (le21, le12), _ = jax.lax.scan(
        body, (jnp.zeros_like(ls1), jnp.zeros_like(ls1)), None,
        length=n_iters)
    llr = ls1 + le12 + le21
    return (llr < 0).astype(jnp.int8), llr
