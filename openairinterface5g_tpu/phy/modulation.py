"""QAM modulation / layer mapping / precoding (TS 38.211 §5.1, §6.3.1.3-5).

The reference maps bits through per-modulation lookup tables with SIMD
byte tricks (openair1/PHY/MODULATION/nr_modulation.c:115 nr_modulation,
NR_REFSIG/nr_mod_table.h).  Here symbols are produced by a single gather
from a 2^Qm-entry constant table, batched over the whole codeword; layer
mapping and PMI precoding are reshapes and small matmuls.

Constellations follow the spec formulas; e.g. 16QAM:
  d = 1/sqrt(10) * [(1-2b0)(2-(1-2b2)) + j(1-2b1)(2-(1-2b3))]
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

QAM_ORDERS = {"pi2bpsk": 1, "bpsk": 1, "qpsk": 2, "16qam": 4, "64qam": 6, "256qam": 8}


@functools.lru_cache(maxsize=8)
def constellation(qm: int) -> np.ndarray:
    """(2^qm,) complex64 table indexed by the bit group (b0 = MSB of index).

    Index convention: idx = sum_k b_k << (qm-1-k) (b0 most significant), so
    bits can be packed with a dot against powers of two.
    """
    n = 1 << qm
    idx = np.arange(n)
    b = ((idx[:, None] >> (qm - 1 - np.arange(qm))[None, :]) & 1).astype(np.float64)
    if qm == 1:  # BPSK: d = (1-2b)/sqrt(2) * (1+j)
        d = (1 - 2 * b[:, 0]) * (1 + 1j) / np.sqrt(2)
    elif qm == 2:  # QPSK
        d = ((1 - 2 * b[:, 0]) + 1j * (1 - 2 * b[:, 1])) / np.sqrt(2)
    elif qm == 4:  # 16QAM
        re = (1 - 2 * b[:, 0]) * (2 - (1 - 2 * b[:, 2]))
        im = (1 - 2 * b[:, 1]) * (2 - (1 - 2 * b[:, 3]))
        d = (re + 1j * im) / np.sqrt(10)
    elif qm == 6:  # 64QAM
        re = (1 - 2 * b[:, 0]) * (4 - (1 - 2 * b[:, 2]) * (2 - (1 - 2 * b[:, 4])))
        im = (1 - 2 * b[:, 1]) * (4 - (1 - 2 * b[:, 3]) * (2 - (1 - 2 * b[:, 5])))
        d = (re + 1j * im) / np.sqrt(42)
    elif qm == 8:  # 256QAM
        re = (1 - 2 * b[:, 0]) * (8 - (1 - 2 * b[:, 2]) * (4 - (1 - 2 * b[:, 4]) * (2 - (1 - 2 * b[:, 6]))))
        im = (1 - 2 * b[:, 1]) * (8 - (1 - 2 * b[:, 3]) * (4 - (1 - 2 * b[:, 5]) * (2 - (1 - 2 * b[:, 7]))))
        d = (re + 1j * im) / np.sqrt(170)
    else:
        raise ValueError(f"unsupported Qm={qm}")
    return d.astype(np.complex64)


def modulate(bits: jnp.ndarray, qm: int, pi2_bpsk: bool = False) -> jnp.ndarray:
    """(..., E) bits -> (..., E/qm) complex symbols.

    Evaluates the 38.211 §5.1 constellation formulas arithmetically on
    bit planes instead of a table gather; the elementwise form fuses with
    scrambling and layer mapping.  Whether a table gather is faster on the
    GPU is not measured (ROADMAP.md).

    pi2_bpsk applies the pi/2 rotation j^(i mod 2) per symbol index
    (TS 38.211 §5.1.1) used by transform-precoded PUSCH.
    """
    E = bits.shape[-1]
    lead = bits.shape[:-1]
    g = bits.reshape(*lead, E // qm, qm).astype(jnp.float32)
    s = [1.0 - 2.0 * g[..., k] for k in range(qm)]
    if qm == 1:  # BPSK: d = (1-2b)(1+j)/sqrt(2)
        re = s[0] * np.float32(1 / np.sqrt(2))
        im = re
    else:
        # Gray-mapped square QAM: re from even bit planes, im from odd
        k = qm // 2
        norm = np.float32(1 / np.sqrt(2 / 3 * (4 ** k - 1)))

        def nested(planes):
            # planes = [s0, s2, s4, ...] (k of them); value =
            # s0*(2^{k-1} - s2*(2^{k-2} - ... - s_{2(k-1)}))
            if k == 1:
                return planes[0]
            acc = planes[-1]
            for i in range(k - 2, 0, -1):
                acc = planes[i] * (float(1 << (k - 1 - i)) - acc)
            return planes[0] * (float(1 << (k - 1)) - acc)

        re = nested(s[0::2]) * norm
        im = nested(s[1::2]) * norm
    syms = jax.lax.complex(re, im)
    if pi2_bpsk:
        assert qm == 1
        n = syms.shape[-1]
        rot = jnp.where(jnp.arange(n) % 2 == 1, 1j, 1.0).astype(jnp.complex64)
        syms = syms * rot
    return syms


def layer_map(symbols: jnp.ndarray, n_layers: int) -> jnp.ndarray:
    """TS 38.211 §6.3.1.3 single-codeword layer mapping.

    (..., M) -> (..., n_layers, M/n_layers); symbol i goes to layer i%L.
    """
    M = symbols.shape[-1]
    lead = symbols.shape[:-1]
    return symbols.reshape(*lead, M // n_layers, n_layers).swapaxes(-1, -2)


def layer_demap(layers: jnp.ndarray) -> jnp.ndarray:
    """Inverse of layer_map: (..., L, M/L) -> (..., M)."""
    L, ml = layers.shape[-2:]
    lead = layers.shape[:-2]
    return layers.swapaxes(-1, -2).reshape(*lead, L * ml)


def precode(layers: jnp.ndarray, W: jnp.ndarray) -> jnp.ndarray:
    """Apply precoder W (n_ant, n_layers) to (..., n_layers, M) layer symbols.

    Returns (..., n_ant, M).  (nr_layer_precoder:662 analog — one matmul.)
    """
    return jnp.einsum("al,...lm->...am", W.astype(layers.dtype), layers,
                      precision=jax.lax.Precision.HIGHEST)
