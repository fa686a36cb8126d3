"""Channel compensation + MRC / MMSE / ZF equalization (P21/P23/P31 analog).

The reference's per-RE SIMD loops (nr_ulsch_channel_compensation:468,
nr_ulsch_mmse_2layers:870, UE-side nr_dlsch_detection_mrc:1303,
nr_zero_forcing_rx:1726) become batched complex tensor algebra over
(rx_ant, layer, re) dims; the 2x2 MMSE inverse is a closed-form cofactor
expression evaluated per RE on the VPU.

Convention: outputs are "compensated" symbols x_mf = H^H y and channel
magnitudes A = diag(H^H H); the LLR stage consumes (x, A) pairs so the
max-log LLRs need no division (same trick as the reference).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def mrc_compensate(h: jnp.ndarray, y: jnp.ndarray):
    """Single-layer matched filter + MRC across rx antennas.

    h, y: (..., n_rx, n_re).  Returns (x_mf (..., n_re), mag (..., n_re))
    with x_mf = sum_a conj(h_a) y_a and mag = sum_a |h_a|^2.
    """
    x = jnp.sum(jnp.conj(h) * y, axis=-2)
    mag = jnp.sum(jnp.abs(h) ** 2, axis=-2).astype(jnp.float32)
    return x, mag


def mmse_equalize_2layer(h: jnp.ndarray, y: jnp.ndarray, nvar):
    """2-layer MMSE: x_hat = (H^H H + nvar I)^-1 H^H y, per RE.

    h: (..., n_rx, 2, n_re), y: (..., n_rx, n_re), nvar: scalar or (...,1).
    Returns (x_hat (..., 2, n_re), eff_mag (..., 2, n_re)) where eff_mag is
    the post-MMSE effective channel gain per layer (bias term) usable as
    the LLR magnitude.
    """
    hc = jnp.conj(h)
    # Gram matrix entries (2x2 Hermitian): g00, g11 real; g01 complex
    g00 = jnp.sum(jnp.abs(h[..., 0, :]) ** 2, axis=-2)
    g11 = jnp.sum(jnp.abs(h[..., 1, :]) ** 2, axis=-2)
    g01 = jnp.sum(hc[..., 0, :] * h[..., 1, :], axis=-2)
    # matched filter
    x0 = jnp.sum(hc[..., 0, :] * y, axis=-2)
    x1 = jnp.sum(hc[..., 1, :] * y, axis=-2)
    a00 = g00 + nvar
    a11 = g11 + nvar
    det = a00 * a11 - jnp.abs(g01) ** 2
    inv_det = 1.0 / det
    e0 = (a11 * x0 - g01 * x1) * inv_det
    e1 = (a00 * x1 - jnp.conj(g01) * x0) * inv_det
    # effective gain of layer i after MMSE (real): diag((G+nI)^-1 G).
    # e_i is already the biased MMSE estimate ~ m_i * s_i, so (e, m) IS the
    # compensated (x, mag) pair the LLR stage expects — no extra scaling.
    m0 = ((a11 * g00 - jnp.abs(g01) ** 2) * inv_det).real
    m1 = ((a00 * g11 - jnp.abs(g01) ** 2) * inv_det).real
    x_hat = jnp.stack([e0, e1], axis=-2)
    eff = jnp.stack([m0, m1], axis=-2).astype(jnp.float32)
    return x_hat, eff


def zf_equalize(h: jnp.ndarray, y: jnp.ndarray, nvar=0.0):
    """General n_layers<=4 MMSE/ZF via explicit solve per RE.

    h: (..., n_rx, L, n_re), y: (..., n_rx, n_re).
    Returns (x (..., L, n_re) compensated, eff (..., L, n_re)).
    """
    hm = jnp.moveaxis(h, -1, -3)             # (..., n_re, n_rx, L)
    ym = jnp.moveaxis(y, -1, -2)[..., None]  # (..., n_re, n_rx, 1)
    g = jnp.einsum("...al,...am->...lm", jnp.conj(hm), hm, precision=jax.lax.Precision.HIGHEST)
    L = g.shape[-1]
    a = g + nvar * jnp.eye(L, dtype=g.dtype)
    xmf = jnp.einsum("...al,...ao->...lo", jnp.conj(hm), ym, precision=jax.lax.Precision.HIGHEST)
    sol = jnp.linalg.solve(a, xmf)[..., 0]   # (..., n_re, L) ~ diag(m) s
    # effective per-layer gain: diag(A^-1 G); (sol, m) is the compensated pair
    effm = jnp.real(jnp.diagonal(jnp.linalg.solve(a, g), axis1=-2, axis2=-1))
    x = jnp.moveaxis(sol, -1, -2)
    return x, jnp.moveaxis(effm.astype(jnp.float32), -1, -2)
