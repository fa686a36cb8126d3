"""2-layer maximum-likelihood joint-LLR MIMO detector (rho-aware).

JAX analog of the reference's interference-aware 2-stream LLR
kernels — nr_ulsch_qpsk_qpsk (openair1/PHY/NR_TRANSPORT/
nr_ulsch_llr_computation.c:375), the 16QAM/mixed variants (:2115) and
the rho cross-correlation computation in nr_ulsch_demodulation.c:1301.

The reference expands per-RE magnitude/rho terms with hand-written AVX2
per constellation pair; here the max-log joint metric is evaluated for
ALL |S|^2 symbol pairs at once as broadcast tensor algebra over
(batch, RE, pair):

  D(s0, s1) = a00|s0|^2 + a11|s1|^2 + 2Re(s0* rho s1)
              - 2Re(s0* r0 + s1* r1)
  with r_l = h_l^H y (matched filter), a_ll = ||h_l||^2,
  rho = h_0^H h_1 — equivalent to ||y - H s||^2 up to the common |y|^2.

LLR(bit b) = min_{pairs: b=1} D - min_{pairs: b=0} D  (>0 means bit 0,
the repo-wide convention), scaled by 1/nvar.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .modulation import constellation

_BIG = np.float32(1e30)


@functools.lru_cache(maxsize=8)
def _pair_tables(qm: int):
    """Static per-constellation-pair tables for Q = 2^qm points."""
    s = constellation(qm)                     # (Q,)
    Q = len(s)
    e = (np.abs(s) ** 2).astype(np.float32)
    cross = np.conj(s)[:, None] * s[None, :]  # (Q, Q) s0* s1
    # bit masks: bit k of layer-0 index i / layer-1 index j over the pair
    # grid (Q, Q)
    i_idx = np.arange(Q)[:, None].repeat(Q, 1)
    j_idx = np.arange(Q)[None, :].repeat(Q, 0)
    bits0 = [((i_idx >> (qm - 1 - k)) & 1).astype(bool) for k in range(qm)]
    bits1 = [((j_idx >> (qm - 1 - k)) & 1).astype(bool) for k in range(qm)]
    return (s.astype(np.complex64), e, cross.astype(np.complex64),
            [b.reshape(-1) for b in bits0], [b.reshape(-1) for b in bits1])


def ml_llrs_2layer(h: jnp.ndarray, y: jnp.ndarray, qm: int,
                   nvar: jnp.ndarray) -> jnp.ndarray:
    """Joint max-log LLRs for a 2-layer transmission.

    h: (B, R, 2, M) per-subcarrier channel (block fading over symbols),
    y: (B, R, S, M) received data REs, nvar: (B,) noise variance.
    Returns (B, 2, S, M, qm) LLRs (layer, symbol, subcarrier, bit).
    """
    s_tab, e_tab, cross_tab, bits0, bits1 = _pair_tables(qm)
    Q = len(s_tab)
    h0, h1 = h[:, :, 0], h[:, :, 1]                       # (B, R, M)
    a00 = jnp.sum(jnp.abs(h0) ** 2, axis=1)               # (B, M)
    a11 = jnp.sum(jnp.abs(h1) ** 2, axis=1)
    rho = jnp.sum(jnp.conj(h0) * h1, axis=1)              # (B, M) complex
    r0 = jnp.einsum("brm,brsm->bsm", jnp.conj(h0), y, precision=jax.lax.Precision.HIGHEST)     # (B, S, M)
    r1 = jnp.einsum("brm,brsm->bsm", jnp.conj(h1), y, precision=jax.lax.Precision.HIGHEST)

    sc = jnp.asarray(s_tab)
    ec = jnp.asarray(e_tab)
    crossc = jnp.asarray(cross_tab).reshape(Q * Q)
    # pair-independent part: (B, M, Q*Q)
    base = (a00[..., None, None] * ec[None, None, :, None]
            + a11[..., None, None] * ec[None, None, None, :]
            + 2.0 * jnp.real(rho[..., None] * crossc[None, None]
                             ).reshape(*rho.shape, Q, Q)
            ).reshape(*rho.shape, Q * Q)
    inv_nv = 1.0 / jnp.maximum(nvar, 1e-12)

    out_syms = []
    for si in range(y.shape[2]):                          # per-symbol chunk
        # cross term with the matched filter: (B, M, Q*Q)
        t0 = 2.0 * jnp.real(jnp.conj(sc)[None, None, :, None]
                            * r0[:, si, :, None, None])
        t1 = 2.0 * jnp.real(jnp.conj(sc)[None, None, None, :]
                            * r1[:, si, :, None, None])
        D = base - (t0 + t1).reshape(*base.shape)
        llr_bits = []
        for lay, masks in ((0, bits0), (1, bits1)):
            for k in range(qm):
                m = jnp.asarray(masks[k])
                m1 = jnp.min(jnp.where(m[None, None], D, _BIG), axis=-1)
                m0 = jnp.min(jnp.where(m[None, None], _BIG, D), axis=-1)
                llr_bits.append(m1 - m0)                  # (B, M)
        # (B, M, 2, qm)
        out_syms.append(jnp.stack(llr_bits, axis=-1).reshape(
            *D.shape[:2], 2, qm))
    llr = jnp.stack(out_syms, axis=1)                     # (B, S, M, 2, qm)
    llr = llr * inv_nv[:, None, None, None, None]
    return llr.transpose(0, 3, 1, 2, 4)                   # (B, 2, S, M, qm)
