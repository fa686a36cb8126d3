"""LTE tail-biting convolutional code + Viterbi decoder (TS 36.212 §5.1.3.1).

Reference: openair1/PHY/CODING/ccoding_byte_lte.c (encoder, K=7 rate 1/3,
generators 133/171/165 octal, tail-biting) and viterbi_lte.c (SSE4 16-state
-batched add-compare-select).  Here the 64 path metrics are a lane
vector; ACS is one scan step over time with (B, 64) metrics; tail-biting is
resolved by decoding a 3x circular repetition and keeping the middle copy
(circular Viterbi approximation, exact for all practical L).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

G_OCT = (0o133, 0o171, 0o165)
K_CONSTRAINT = 7
NSTATES = 64


@functools.lru_cache(maxsize=1)
def _tables():
    """next_state (64, 2) and output bits (64, 2, 3) for input b."""
    nxt = np.zeros((NSTATES, 2), np.int32)
    out = np.zeros((NSTATES, 2, 3), np.int32)
    for s in range(NSTATES):
        for b in (0, 1):
            # shift register: newest bit enters MSB side (state = 6 prev bits)
            reg = (b << 6) | s
            nxt[s, b] = reg >> 1
            for gi, g in enumerate(G_OCT):
                out[s, b, gi] = bin(reg & g).count("1") & 1
    return nxt, out


def encode(bits: jnp.ndarray) -> jnp.ndarray:
    """(B, L) bits -> (B, 3*L) coded bits, tail-biting initialization
    (initial state = last 6 bits of the block, 36.212 §5.1.3.1)."""
    nxt, out = _tables()
    nxt_t, out_t = jnp.asarray(nxt), jnp.asarray(out)
    b = bits.astype(jnp.int32)
    B, L = b.shape
    # initial state = bits[L-1] .. bits[L-6] packed so bits[L-1] is LSB-side
    init = jnp.zeros((B,), jnp.int32)
    for i in range(6):
        init = init | (b[:, L - 1 - i] << (5 - i))

    def body(state, x):
        o = out_t[state, x]
        return nxt_t[state, x], o

    _, os = jax.lax.scan(body, init, b.T)
    return os.transpose(1, 0, 2).reshape(B, 3 * L).astype(jnp.int8)


def decode(llrs: jnp.ndarray) -> jnp.ndarray:
    """(B, 3*L) LLRs (positive = bit 0) -> (B, L) decoded bits.

    Circular Viterbi: run ACS over the 3x-repeated sequence, trace back
    from the best end state, return the middle repetition's decisions.
    """
    nxt, out = _tables()
    B = llrs.shape[0]
    L = llrs.shape[-1] // 3
    sgn = (1.0 - 2.0 * out).astype(np.float32)          # (64, 2, 3)
    sgn_t = jnp.asarray(sgn)
    nxt_t = jnp.asarray(nxt)
    # branch metric for (s, b) at step k: sum_i sgn[s,b,i] * llr[k,i] / 2
    l3 = llrs.reshape(B, L, 3)
    l3 = jnp.concatenate([l3, l3, l3], axis=1)          # (B, 3L, 3)

    # predecessor table: for each state s', list of (prev_s, b) with
    # nxt[prev_s, b] == s' — exactly 2 predecessors each
    pred = np.zeros((NSTATES, 2), np.int32)
    pred_b = np.zeros((NSTATES, 2), np.int32)
    cnt = np.zeros(NSTATES, np.int32)
    for s in range(NSTATES):
        for b in (0, 1):
            sp = nxt[s, b]
            pred[sp, cnt[sp]] = s
            pred_b[sp, cnt[sp]] = b
            cnt[sp] += 1
    pred_t, pred_b_t = jnp.asarray(pred), jnp.asarray(pred_b)

    def body(pm, lk):
        # bm[s, b] = 0.5 * sum_i sgn[s,b,i] * lk[i]
        bm = 0.5 * jnp.einsum("sbi,Bi->Bsb", sgn_t, lk, precision=jax.lax.Precision.HIGHEST)
        # cand[:, s', j] = pm[pred[s',j]] + bm[pred[s',j], pred_b[s',j]]
        cand = pm[:, pred_t] + bm[:, pred_t, pred_b_t]
        best = jnp.argmax(cand, axis=-1)                # (B, 64): which pred
        new = jnp.max(cand, axis=-1)
        new = new - jnp.max(new, axis=-1, keepdims=True)
        return new, best.astype(jnp.int8)

    pm0 = jnp.zeros((B, NSTATES))
    final_pm, bests = jax.lax.scan(body, pm0, l3.transpose(1, 0, 2))
    bests = bests.transpose(1, 0, 2)                    # (B, 3L, 64)

    # traceback from best final state
    def tb_body(state, best_k):
        sel = jnp.take_along_axis(best_k.astype(jnp.int32), state[:, None],
                                  axis=-1)[..., 0]
        prev = pred_t[state, sel]
        bit = pred_b_t[state, sel]
        return prev, bit

    end_state = jnp.argmax(final_pm, axis=-1).astype(jnp.int32)
    _, bits_rev = jax.lax.scan(tb_body, end_state,
                               bests.transpose(1, 0, 2)[::-1])
    bits = bits_rev[::-1].T                             # (B, 3L)
    return bits[:, L: 2 * L].astype(jnp.int8)
