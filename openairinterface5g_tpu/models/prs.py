"""PRS positioning (TS 38.211 §7.4.1.7 / 38.215 §5.1): TX grid + UE
RSTD measurement (ToA estimation per TRP).

The reference generates PRS at the gNB (openair1/PHY/NR_TRANSPORT/
nr_prs.c) and processes it at the UE for positioning; the round-4 build
had generation only.  Design: the full comb staircase over
n_symbols is one tensor; ToA estimation is a single IFFT of the
pilot-compensated channel over the combined comb (the staircase fills
every subcarrier across a comb period, so the delay profile has the
full resolution of the sounded band), with sub-sample peak
interpolation; RSTD between two TRPs is the ToA difference.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..phy import refsig


@dataclasses.dataclass(frozen=True)
class PrsConfig:
    n_prb: int = 24
    comb_size: int = 4
    re_offset: int = 0
    n_symbols: int = 4          # one staircase period = comb_size symbols
    start_symbol: int = 2
    n_id_prs: int = 0
    slot: int = 0

    @property
    def m_per_sym(self) -> int:
        return 12 * self.n_prb // self.comb_size


def prs_tx_grid(cfg: PrsConfig, batch: int, n_sc: int) -> jnp.ndarray:
    """(B, n_symbols, n_sc) PRS staircase tile (zeros elsewhere)."""
    offs = refsig.prs_staircase_offsets(cfg.comb_size, cfg.n_symbols,
                                        cfg.re_offset)
    rows = []
    for li in range(cfg.n_symbols):
        s = cfg.start_symbol + li
        cinit = refsig.prs_cinit(cfg.slot, s, cfg.n_id_prs)
        seq = refsig.prs_sequence(cinit, cfg.m_per_sym)
        sc = np.arange(cfg.m_per_sym) * cfg.comb_size + int(offs[li])
        row = jnp.zeros((n_sc,), jnp.complex64).at[jnp.asarray(sc)].set(seq)
        rows.append(row)
    return jnp.broadcast_to(jnp.stack(rows), (batch, cfg.n_symbols, n_sc))


def prs_toa(cfg: PrsConfig, rx_syms: jnp.ndarray, fft_size: int,
            osf: int = 8):
    """UE ToA estimation from received PRS symbols.

    rx_syms: (B, n_rx, n_symbols, n_sc) frequency-domain REs of the PRS
    symbols.  Returns dict(toa_samples (B,) float — fractional sample
    delay at the carrier's sample rate, peak_power (B,), profile).

    All staircase symbols are pilot-compensated and merged into one
    channel estimate over every occupied subcarrier (the comb offsets
    tile the full grid across one period), then a zero-padded IFFT gives
    the delay profile; a 3-point parabolic fit refines the peak.
    """
    B = rx_syms.shape[0]
    n_sc = rx_syms.shape[-1]
    offs = refsig.prs_staircase_offsets(cfg.comb_size, cfg.n_symbols,
                                        cfg.re_offset)
    h = jnp.zeros((B, rx_syms.shape[1], n_sc), jnp.complex64)
    for li in range(cfg.n_symbols):
        s = cfg.start_symbol + li
        cinit = refsig.prs_cinit(cfg.slot, s, cfg.n_id_prs)
        seq = refsig.prs_sequence(cinit, cfg.m_per_sym)
        sc = np.arange(cfg.m_per_sym) * cfg.comb_size + int(offs[li])
        y = rx_syms[:, :, li, :][..., jnp.asarray(sc)]
        h = h.at[..., jnp.asarray(sc)].set(y * jnp.conj(seq))
    # coherent across rx antennas via the strongest-combining profile
    n_fft = osf * fft_size
    prof = jnp.fft.ifft(h, n=n_fft, axis=-1)
    p = jnp.sum(jnp.abs(prof) ** 2, axis=1)            # (B, n_fft)
    peak = jnp.argmax(p, axis=-1)
    # 3-point parabolic interpolation around the peak
    pm = p[jnp.arange(B), (peak - 1) % n_fft]
    p0 = p[jnp.arange(B), peak]
    pp = p[jnp.arange(B), (peak + 1) % n_fft]
    denom = jnp.maximum(pm - 2 * p0 + pp, 1e-12)
    frac = jnp.clip(0.5 * (pm - pp) / denom, -0.5, 0.5)
    # delay axis: bin k of the n_fft IFFT = k/osf samples at the
    # carrier's rate (the sounded band spans the fft_size grid)
    toa = (peak.astype(jnp.float32) + frac) * (fft_size / n_fft)
    # unwrap: delays beyond half the window are negative aliases
    toa = jnp.where(toa > fft_size / 2, toa - fft_size, toa)
    return {"toa_samples": toa, "peak_power": p0,
            "profile": p}


def rstd(cfg: PrsConfig, toa_a: jnp.ndarray, toa_b: jnp.ndarray):
    """Reference signal time difference (38.215 §5.1.29 analog)."""
    return toa_a - toa_b
