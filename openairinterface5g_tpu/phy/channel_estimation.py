"""DMRS-based channel estimation (P22/P30 analog).

The reference does LS at pilot REs then applies hand-tuned interpolation
filter LUTs per alignment (openair1/PHY/NR_ESTIMATION/
nr_ul_channel_estimation.c:67, filt16a_32.h).  Here LS + interpolation are
batched tensor ops over (rx_ant, layer, pilot) dims: conj-multiply,
comb-2 linear interpolation, and a noise-variance estimate from pilot
residuals — all fused by XLA into the surrounding slot program.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def ls_estimate(y_pilots: jnp.ndarray, pilots: jnp.ndarray) -> jnp.ndarray:
    """LS estimate at pilot positions: h = y * conj(r) (|r| = 1).

    y_pilots: (..., n_pilots) received DMRS REs; pilots: (n_pilots,) or
    broadcastable reference sequence.
    """
    return y_pilots * jnp.conj(pilots)


def comb2_interpolate(h_pilots: jnp.ndarray, n_sc: int, delta: int = 0) -> jnp.ndarray:
    """Interpolate comb-2 pilot estimates (at SCs 2k+delta) to all n_sc SCs.

    Linear interpolation between pilots, edge-hold at the boundaries.
    h_pilots: (..., n_sc//2).  Returns (..., n_sc).
    """
    n_p = h_pilots.shape[-1]
    lead = h_pilots.shape[:-1]
    # neighbor average for the off-comb positions
    left = h_pilots
    right = jnp.concatenate([h_pilots[..., 1:], h_pilots[..., -1:]], axis=-1)
    mid = 0.5 * (left + right)
    if delta == 0:
        inter = jnp.stack([h_pilots, mid], axis=-1).reshape(*lead, 2 * n_p)
    else:
        mid_l = jnp.concatenate([h_pilots[..., :1], 0.5 * (h_pilots[..., :-1] + h_pilots[..., 1:])], axis=-1)
        inter = jnp.stack([mid_l, h_pilots], axis=-1).reshape(*lead, 2 * n_p)
    return inter[..., :n_sc]


def freq_average(h: jnp.ndarray, window: int = 0) -> jnp.ndarray:
    """Optional moving-average smoothing across subcarriers (noise reduction
    on flat-ish channels; the reference's filter-LUT analog). window=0: off."""
    if window <= 1:
        return h
    pad = window // 2
    hp = jnp.concatenate(
        [jnp.repeat(h[..., :1], pad, axis=-1), h, jnp.repeat(h[..., -1:], window - 1 - pad, axis=-1)],
        axis=-1,
    )
    # moving average via cumulative sum: 3 ops instead of `window` shifted
    # adds
    cs = jnp.cumsum(hp, axis=-1)
    head = cs[..., window - 1: window - 1 + h.shape[-1]]
    tail = jnp.concatenate(
        [jnp.zeros_like(cs[..., :1]), cs[..., : h.shape[-1] - 1]], axis=-1)
    return (head - tail) / window


def noise_variance(y_pilots: jnp.ndarray, h_pilots: jnp.ndarray, pilots: jnp.ndarray) -> jnp.ndarray:
    """Estimate noise variance from pilot residuals after smoothing.

    Uses the difference of adjacent LS estimates (channel ~ constant over
    adjacent pilots): var = E|h[k] - h[k+1]|^2 / 2.
    """
    d = h_pilots[..., 1:] - h_pilots[..., :-1]
    return jnp.mean(jnp.abs(d) ** 2, axis=-1) / 2.0


def estimate_slot(
    rx_grid_pilotsyms: jnp.ndarray,
    pilots: jnp.ndarray,
    pilot_sc: np.ndarray,
    n_sc: int,
    delta: int = 0,
):
    """Channel estimate for one DMRS symbol.

    rx_grid_pilotsyms: (..., n_sc) received freq-domain symbol containing DMRS.
    pilots: (n_pilots,) reference sequence.  pilot_sc: (n_pilots,) SC indices.
    Returns (h_full (..., n_sc), nvar (...)).
    """
    yp = rx_grid_pilotsyms[..., jnp.asarray(pilot_sc)]
    hp = ls_estimate(yp, pilots)
    h = comb2_interpolate(hp, n_sc, delta)
    nvar = noise_variance(yp, hp, pilots)
    return h, nvar


def delay_domain_denoise(hp: jnp.ndarray, keep_frac: float = 0.1,
                         guard_frac: float = 0.02) -> jnp.ndarray:
    """Denoise pilot-domain LS estimates via delay-domain truncation.

    IDFT the (..., P) frequency-domain estimates to the delay domain, keep
    only taps within the CP span (plus a small negative guard for timing
    error), zero the rest, and transform back.  On sparse channels this is
    the near-MMSE denoiser the reference's interpolation filter LUTs
    approximate — and it is just two batched FFTs.
    """
    P = hp.shape[-1]
    keep = max(1, int(np.ceil(keep_frac * P)))
    guard = max(1, int(np.ceil(guard_frac * P)))
    g = jnp.fft.ifft(hp, axis=-1)
    mask = np.zeros(P, np.float32)
    mask[:keep] = 1.0
    mask[P - guard:] = 1.0
    g = g * jnp.asarray(mask)
    return jnp.fft.fft(g, axis=-1).astype(hp.dtype)
