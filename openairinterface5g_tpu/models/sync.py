"""UE initial synchronization (P29 analog): PSS/SSS search + cell id.

Reference anchors: nr_initial_sync (openair1/PHY/NR_UE_TRANSPORT/
nr_initial_sync.c:182), pss_search_time_nr (pss_nr.c:562), SSS detect
(sss_nr.c).

PSS search is one batched FFT cross-correlation of the sample stream
against the 3 time-domain PSS replicas (the reference's downsampled
scalar loop with AVX dot products becomes 3 ifft(FFT(s)*conj(FFT(p)))
lanes); SSS identification is a (336, 127) correlation matmul on the MXU.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FrameParams
from ..phy import refsig

SSB_SC = 240


def ssb_time_signal(fp: FrameParams, tile: jnp.ndarray, k_offset: int = 0) -> jnp.ndarray:
    """Place a (B, 4, 240) SSB tile centered in band and OFDM-modulate the
    4 symbols (no CP, contiguous) -> (B, 4*fft) time samples.

    Simplified mapping for sync sims: SSB centered at DC + k_offset.
    """
    B = tile.shape[0]
    grid = jnp.zeros((B, 4, fp.fft_size), jnp.complex64)
    start = (fp.fft_size - SSB_SC) // 2 + k_offset
    bins = (start + np.arange(SSB_SC) - fp.fft_size // 2) % fp.fft_size
    # express relative to DC: subcarrier k maps to bin (k - fft/2 + start)
    grid = grid.at[:, :, jnp.asarray(bins)].set(tile)
    x = jnp.fft.ifft(grid, axis=-1) * np.sqrt(fp.fft_size)
    return x.reshape(B, 4 * fp.fft_size).astype(jnp.complex64)


@functools.lru_cache(maxsize=16)
def _pss_replicas(fft_size: int, k_offset: int = 0) -> np.ndarray:
    """(3, fft) time-domain PSS replicas for correlation."""
    out = np.zeros((3, fft_size), np.complex64)
    start = (fft_size - SSB_SC) // 2 + k_offset
    for nid2 in range(3):
        grid = np.zeros(fft_size, np.complex64)
        pss = refsig.pss_sequence(nid2)
        bins = (start + 56 + np.arange(127) - fft_size // 2) % fft_size
        grid[bins] = pss
        out[nid2] = np.fft.ifft(grid) * np.sqrt(fft_size)
    return out


def pss_search(fp: FrameParams, samples: jnp.ndarray, k_offset: int = 0):
    """(B, n_samples) stream -> (t0 (B,), n_id2 (B,), metric (B,)).

    FFT cross-correlation against the 3 PSS replicas.
    """
    B, n = samples.shape
    reps = _pss_replicas(fp.fft_size, k_offset)
    nfft = int(2 ** np.ceil(np.log2(n + fp.fft_size)))
    S = jnp.fft.fft(samples, n=nfft, axis=-1)
    P = jnp.fft.fft(jnp.asarray(reps), n=nfft, axis=-1)
    corr = jnp.fft.ifft(S[:, None, :] * jnp.conj(P)[None], axis=-1)
    power = jnp.abs(corr[..., : n - fp.fft_size + 1]) ** 2    # valid lags
    flat = power.reshape(B, -1)
    best = jnp.argmax(flat, axis=-1)
    n_lags = n - fp.fft_size + 1
    n_id2 = (best // n_lags).astype(jnp.int32)
    t0 = (best % n_lags).astype(jnp.int32)
    metric = jnp.max(flat, axis=-1) / (jnp.mean(flat, axis=-1) + 1e-12)
    return t0, n_id2, metric


def sss_identify(sss_re: jnp.ndarray, n_id2: jnp.ndarray):
    """(B, 127) SSS REs + (B,) n_id2 -> (n_id1 (B,), metric).

    Correlates against all 336 SSS candidates for the detected n_id2
    (dci-style coherent metric over the 127 REs).
    """
    tables = np.stack([
        np.stack([refsig.sss_sequence(n1, n2) for n1 in range(336)])
        for n2 in range(3)
    ])  # (3, 336, 127)
    T = jnp.asarray(tables)
    cand = jnp.take(T, n_id2, axis=0)                 # (B, 336, 127)
    corr = jnp.abs(jnp.einsum("bk,bnk->bn", sss_re, cand.astype(sss_re.dtype),
                               precision=jax.lax.Precision.HIGHEST)) ** 2
    n_id1 = jnp.argmax(corr, axis=-1).astype(jnp.int32)
    energy = jnp.sum(jnp.abs(sss_re) ** 2, axis=-1) * 127
    return n_id1, jnp.max(corr, axis=-1) / (energy + 1e-12)


def timing_drift_estimate(h_freq: jnp.ndarray) -> jnp.ndarray:
    """Timing-offset estimate (signed, in samples at the rate of the
    estimate's subcarrier span) from the channel impulse response peak.

    The tracking loop of the reference (nr_adjust_synch_ue.c): IDFT the
    frequency-domain channel estimate, find the max-energy tap, wrap to a
    signed offset the receiver uses to slew its sample pointer."""
    g = jnp.fft.ifft(h_freq, axis=-1)
    n = g.shape[-1]
    peak = jnp.argmax(jnp.abs(g) ** 2, axis=-1).astype(jnp.int32)
    return jnp.where(peak > n // 2, peak - n, peak)


def compensate_cfo(fp: FrameParams, samples: jnp.ndarray, cfo_hz) -> jnp.ndarray:
    """Derotate a (B, n) stream by exp(-j*2*pi*cfo*t) — the reference's
    per-sample FFO compensation loop (nr_initial_sync.c:235-249).
    cfo_hz: scalar or (B,)."""
    n = samples.shape[-1]
    t = jnp.arange(n) / fp.sample_rate
    cfo = jnp.asarray(cfo_hz)
    if cfo.ndim == 0:
        cfo = cfo[None]
    return samples * jnp.exp(-2j * np.pi * cfo[:, None] * t[None]
                             ).astype(jnp.complex64)


def estimate_cfo_pss(fp: FrameParams, samples: jnp.ndarray, t0, n_id2,
                     k_offset: int = 0):
    """Fractional CFO (Hz) from the PSS half-symbol phase ramp.

    With y = r * exp(j*2*pi*eps*t), the correlations of the two symbol
    halves against the replica differ by phase 2*pi*eps*T/2; range
    +-1 subcarrier spacing.  The freq-domain analog of the reference's
    FFO estimate feeding nr_initial_sync.c:235."""
    reps = jnp.asarray(_pss_replicas(fp.fft_size, k_offset))
    idx = t0[:, None] + jnp.arange(fp.fft_size)[None]
    sym = jnp.take_along_axis(samples, idx, axis=-1)     # (B, fft)
    prod = sym * jnp.conj(jnp.take(reps, n_id2, axis=0))
    half = fp.fft_size // 2
    c1 = jnp.sum(prod[..., :half], axis=-1)
    c2 = jnp.sum(prod[..., half:], axis=-1)
    dphi = jnp.angle(c2 * jnp.conj(c1))
    return dphi / (2 * np.pi) * fp.sample_rate / half


def initial_sync(fp: FrameParams, samples: jnp.ndarray, k_offset: int = 0,
                 cfo_scan: int = 0):
    """Full sync: PSS timing + SSS cell id from a (B, n) sample stream.

    Assumes the stream contains one SSB (4 contiguous symbols, no CP —
    the sim-level placement of ssb_time_signal).

    cfo_scan > 0 enables carrier-frequency-offset recovery over
    +-cfo_scan subcarrier spacings: every integer-SCS hypothesis is a
    derotated copy stacked on the batch axis through ONE correlation
    program (the reference's scan loop, nr_initial_sync.c:588), then the
    fractional part comes from the PSS half-symbol phase and the stream
    is digitally derotated before SSS/PBCH (nr_initial_sync.c:235).
    Returns dict(t0, n_id, metric..., cfo_hz, samples_corrected).
    """
    B, n = samples.shape
    cfo_est = jnp.zeros((B,), jnp.float32)
    work = samples
    if cfo_scan > 0:
        hyp = np.arange(-cfo_scan, cfo_scan + 1, dtype=np.float32) * fp.scs
        H = len(hyp)
        t = jnp.arange(n) / fp.sample_rate
        rot = jnp.exp(-2j * np.pi * jnp.asarray(hyp)[:, None] * t[None])
        stack = (samples[:, None, :] * rot[None]).reshape(B * H, n)
        t0h, n2h, mh = pss_search(fp, stack.astype(jnp.complex64), k_offset)
        best = jnp.argmax(mh.reshape(B, H), axis=-1)             # (B,)
        cfo_int = jnp.take(jnp.asarray(hyp), best)
        pick = best + jnp.arange(B) * H
        t0c = jnp.take(t0h, pick)
        n2c = jnp.take(n2h, pick)
        work = compensate_cfo(fp, samples, cfo_int)
        frac = estimate_cfo_pss(fp, work, t0c, n2c, k_offset)
        cfo_est = cfo_int + frac
        work = compensate_cfo(fp, samples, cfo_est)
    t0, n_id2, m_pss = pss_search(fp, work, k_offset)
    # extract the SSS symbol (symbol 2 of the SSB) at the found timing
    idx = t0[:, None] + 2 * fp.fft_size + jnp.arange(fp.fft_size)[None]
    sym = jnp.take_along_axis(work, idx, axis=-1)
    grid = jnp.fft.fft(sym, axis=-1) / np.sqrt(fp.fft_size)
    start = (fp.fft_size - SSB_SC) // 2 + k_offset
    bins = (start + 56 + np.arange(127) - fp.fft_size // 2) % fp.fft_size
    sss_re = grid[..., jnp.asarray(bins)]
    n_id1, m_sss = sss_identify(sss_re, n_id2)
    return {
        "t0": t0,
        "n_id": 3 * n_id1 + n_id2,
        "pss_metric": m_pss,
        "sss_metric": m_sss,
        "cfo_hz": cfo_est,
        "samples_corrected": work,
    }
