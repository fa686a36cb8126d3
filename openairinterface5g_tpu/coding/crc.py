"""3GPP TS 38.212 §5.1 CRC codes as GF(2) matrix products.

The reference computes CRCs byte-wise with 256-entry lookup tables
(openair1/PHY/CODING/crc_byte.c).  Here a CRC over an A-bit message is a
GF(2) linear map, so we precompute the (A, L) remainder matrix
R[i] = x^{A-1-i+L} mod g(x) once per static message length and evaluate
crc = (bits @ R) mod 2 — one small matmul that XLA fuses into the
surrounding codec chain and that batches trivially over code blocks.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# name -> (L, generator polynomial without the x^L term)
# TS 38.212 §5.1: gCRC24A/B/C, gCRC16, gCRC11, gCRC6
CRC_POLYS: dict[str, tuple[int, int]] = {
    "24A": (24, 0x864CFB),
    "24B": (24, 0x800063),
    "24C": (24, 0xB2B117),
    "16": (16, 0x1021),
    "11": (11, 0x621),
    "6": (6, 0x21),
}


@functools.lru_cache(maxsize=None)
def remainder_matrix(n_bits: int, name: str) -> np.ndarray:
    """(n_bits, L) uint8 matrix M with crc(m) = (m @ M) mod 2.

    Row i is the remainder of x^{n_bits-1-i+L} mod g(x), MSB-first.
    """
    L, poly = CRC_POLYS[name]
    mask = (1 << L) - 1
    out = np.empty((n_bits, L), dtype=np.uint8)
    r = 1  # represents x^0; we'll walk up to x^{L}, then onwards
    # advance r to x^L mod g  (L steps of multiply-by-x)
    for _ in range(L):
        r <<= 1
        if r >> L & 1:
            r = (r & mask) ^ poly
    # r == x^L mod g, which is the contribution of the LAST message bit
    for i in range(n_bits - 1, -1, -1):
        out[i] = [(r >> (L - 1 - b)) & 1 for b in range(L)]
        r <<= 1
        if r >> L & 1:
            r = (r & mask) ^ poly
    return out


def crc_compute(bits: jnp.ndarray, name: str) -> jnp.ndarray:
    """CRC parity bits for MSB-first bit array.

    bits: (..., A) in {0,1}.  Returns (..., L) in {0,1}, MSB-first, such that
    concatenating [bits, crc] gives a codeword divisible by g(x).
    """
    A = bits.shape[-1]
    M = jnp.asarray(remainder_matrix(A, name), dtype=jnp.float32)
    acc = jnp.dot(bits.astype(jnp.float32), M, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    return (acc.astype(jnp.int32) & 1).astype(bits.dtype)


def crc_attach(bits: jnp.ndarray, name: str) -> jnp.ndarray:
    """Append CRC parity to (..., A) bits -> (..., A+L)."""
    parity = crc_compute(bits, name)
    return jnp.concatenate([bits, parity], axis=-1)


def crc_ok(bits_with_crc: jnp.ndarray, name: str) -> jnp.ndarray:
    """Boolean check: remainder of (..., A+L) codeword is zero."""
    L, _ = CRC_POLYS[name]
    payload, rx_crc = bits_with_crc[..., :-L], bits_with_crc[..., -L:]
    return jnp.all(crc_compute(payload, name) == rx_crc, axis=-1)
