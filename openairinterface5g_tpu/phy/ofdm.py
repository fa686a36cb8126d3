"""OFDM modulation/demodulation (P1-P4): batched (I)FFT + cyclic prefix.

The reference hand-rolls fixed-point radix FFTs per size with AVX2
(openair1/PHY/TOOLS/oai_dfts.c) and loops symbols on a thread pool
(nr_ru_procedures.c:228 nr_fep_full / :144 nr_feptx_ofdm).  Here the
whole slot is one batched float FFT over the (antenna, symbol) dims;
the CP handling is static slicing.

Grid convention: freq-domain tensors are (..., symbols, fft_size) with
DC at index 0 and negative frequencies wrapped (standard FFT order);
`map_to_grid` places the n_sc occupied subcarriers around DC like the
reference's first_carrier_offset logic (nr_init.c).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..config import FrameParams


def map_to_grid(fp: FrameParams, re_values: jnp.ndarray) -> jnp.ndarray:
    """(..., symbols, n_sc) occupied REs -> (..., symbols, fft_size) grid.

    RE k (k=0 lowest PRB) lands at FFT bin (first_carrier + k) % fft_size.
    The wrap splits the REs into exactly two contiguous chunks, so the
    mapping is one concatenation (positive freqs | guard zeros | negative
    freqs) instead of a full-grid scatter.
    """
    n_sc = fp.n_sc
    lead = re_values.shape[:-1]
    n_hi = fp.fft_size - fp.first_carrier     # REs in the upper (neg-freq) bins
    zeros = jnp.zeros((*lead, fp.fft_size - n_sc), dtype=re_values.dtype)
    return jnp.concatenate(
        [re_values[..., n_hi:], zeros, re_values[..., :n_hi]], axis=-1)


def extract_from_grid(fp: FrameParams, grid: jnp.ndarray) -> jnp.ndarray:
    """Inverse of map_to_grid (two slices + concat)."""
    n_hi = fp.fft_size - fp.first_carrier
    return jnp.concatenate(
        [grid[..., fp.first_carrier:], grid[..., : fp.n_sc - n_hi]], axis=-1)


def _cp_segments(cps: np.ndarray):
    """Runs (l0, l1, cp) of consecutive symbols sharing a CP length."""
    segs, l = [], 0
    while l < len(cps):
        r = l + 1
        while r < len(cps) and cps[r] == cps[l]:
            r += 1
        segs.append((l, r, int(cps[l])))
        l = r
    return segs


def ofdm_modulate(fp: FrameParams, grid: jnp.ndarray, slot: int) -> jnp.ndarray:
    """(..., symbols, fft) freq grid -> (..., samples) time-domain slot.

    IFFT per symbol + CP insertion (PHY_ofdm_mod analog, ofdm_mod.c:125).
    Symbols sharing a CP length are emitted with one concat + reshape per
    run (2 runs per slot) instead of a per-symbol concat loop.
    """
    x = jnp.fft.ifft(grid, axis=-1).astype(jnp.complex64) * jnp.sqrt(jnp.float32(fp.fft_size))
    lead = x.shape[:-2]
    parts = []
    for (l0, l1, cp) in _cp_segments(fp.cp_lengths(slot)):
        seg = x[..., l0:l1, :]
        withcp = jnp.concatenate([seg[..., -cp:], seg], axis=-1)
        parts.append(withcp.reshape(*lead, (l1 - l0) * (cp + fp.fft_size)))
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=-1)


def ofdm_demodulate(fp: FrameParams, samples: jnp.ndarray, slot: int) -> jnp.ndarray:
    """(..., samples) time-domain slot -> (..., symbols, fft) freq grid.

    CP removal + FFT per symbol (nr_slot_fep_ul analog, slot_fep_nr.c:223).
    Equal-CP symbol runs are sliced with one reshape per run.
    """
    offs = fp.symbol_offsets(slot)
    cps = fp.cp_lengths(slot)
    lead = samples.shape[:-1]
    segs = []
    for (l0, l1, cp) in _cp_segments(cps):
        start = int(offs[l0])
        width = (cp + fp.fft_size) * (l1 - l0)
        chunk = samples[..., start: start + width].reshape(
            *lead, l1 - l0, cp + fp.fft_size)
        segs.append(chunk[..., cp:])
    x = segs[0] if len(segs) == 1 else jnp.concatenate(segs, axis=-2)
    return jnp.fft.fft(x, axis=-1).astype(jnp.complex64) / jnp.sqrt(jnp.float32(fp.fft_size))


def symbol_rotation(fp: FrameParams, slot: int, f0: float) -> np.ndarray:
    """Per-symbol phase compensation e^{-j 2 pi f0 t_l} (P4 analog).

    TS 38.211 §5.4 upconversion phase: each OFDM symbol l starting at
    sample offset t_l (incl. CP) accrues phase 2*pi*f0*t_l at carrier
    offset f0; the reference precomputes these rotations in
    init_symbol_rotation (nr_modulation.c:587) and applies them TX/RX
    (phy_procedures_nr_gNB.c:254).  Returns (symbols_per_slot,) complex64.
    """
    offs = fp.symbol_offsets(slot) + fp.cp_lengths(slot)
    t = offs / fp.sample_rate
    return np.exp(-2j * np.pi * f0 * t).astype(np.complex64)


def apply_rotation_tx(fp: FrameParams, grid: "jnp.ndarray", slot: int, f0: float):
    """Apply TX symbol rotation to a (..., symbols, fft) freq grid."""
    if f0 == 0.0:
        return grid
    rot = jnp.asarray(symbol_rotation(fp, slot, f0))
    return grid * rot[:, None]


def apply_rotation_rx(fp: FrameParams, grid: "jnp.ndarray", slot: int, f0: float):
    """Undo the TX rotation at RX (conjugate)."""
    if f0 == 0.0:
        return grid
    rot = jnp.asarray(np.conj(symbol_rotation(fp, slot, f0)))
    return grid * rot[:, None]
