"""Small block code (TS 38.212 §5.3.3): (32, K) Reed-Muller for 1..11-bit UCI.

Encode is a GF(2) matmul with the 11 basis sequences of Table 5.3.3.1-1;
ML decode correlates the received LLRs against all 2^K codewords — one
(batch, 32) @ (32, 2^K) matmul, replacing the reference's
SIMD-unrolled search (openair1/PHY/CODING/nrSmallBlock/decodeSmallBlock.c).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# TS 38.212 Table 5.3.3.1-1 basis sequences M_i,n packed LSB-first per basis
# (bit n of word i = M_{n,i}); same spec data as the reference's
# nrSmallBlockBasis (nr_small_block_defs.h:50).
_BASIS_WORDS = (
    0xFFFFFFFF, 0x4BA5A933, 0x7D910E5A, 0x6D26339C, 0x71C7C3E0,
    0x7E0FFC00, 0x731D8E64, 0x6B44F5B0, 0x7DC218EC, 0x4DA1B746, 0x42F0FFFF,
)


@functools.lru_cache(maxsize=1)
def basis_matrix() -> np.ndarray:
    """(11, 32) int8: row i = basis sequence i, bit order n = 0..31."""
    M = np.zeros((11, 32), dtype=np.int8)
    for i, w in enumerate(_BASIS_WORDS):
        for n in range(32):
            M[i, n] = (w >> n) & 1
    return M


@functools.lru_cache(maxsize=16)
def codebook(K: int) -> np.ndarray:
    """(2^K, 32) float32 BPSK codebook (+1 for bit 0) for ML decoding."""
    M = basis_matrix()[:K]
    msgs = ((np.arange(1 << K)[:, None] >> np.arange(K)[None, :]) & 1).astype(np.int8)
    cw = (msgs @ M) & 1
    return (1.0 - 2.0 * cw).astype(np.float32)


def encode(bits: jnp.ndarray) -> jnp.ndarray:
    """(..., K) bits (K<=11) -> (..., 32) codeword."""
    K = bits.shape[-1]
    M = jnp.asarray(basis_matrix()[:K], dtype=jnp.float32)
    acc = jnp.dot(bits.astype(jnp.float32), M, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    return (acc.astype(jnp.int32) & 1).astype(jnp.int8)


def decode(llr: jnp.ndarray, K: int, return_conf: bool = False):
    """ML decode (..., 32) LLRs (>0 = bit 0) -> (..., K) bits.

    With return_conf, also returns the normalized correlation of the best
    codeword (1.0 = every LLR sign matches; ~0 = noise/DTX) — the small
    block code has no CRC, so this metric is the only detection signal.
    """
    cb = jnp.asarray(codebook(K))  # (2^K, 32)
    scores = jnp.dot(llr.astype(jnp.float32), cb.T,
                     preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
    best = jnp.argmax(scores, axis=-1)
    bits = ((best[..., None] >> jnp.arange(K)) & 1).astype(jnp.int8)
    if not return_conf:
        return bits
    conf = jnp.max(scores, axis=-1) / (
        jnp.sum(jnp.abs(llr.astype(jnp.float32)), axis=-1) + 1e-9)
    return bits, conf
