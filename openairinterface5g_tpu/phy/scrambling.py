"""Gold-sequence scrambling (TS 38.211 §5.2.1) in JAX.

The reference generates Gold sequences with bit-serial LFSRs + byte LUTs
(openair1/PHY/NR_REFSIG/nr_gold.c:24, nr_scrambling.c).  Here the two
LFSRs are treated as GF(2) linear maps: x1 (cinit-independent) is a host
precomputed constant; for x2 we precompute packed state-transition powers
A^(Nc+31b) so ALL 31-bit output blocks are computed in parallel from the
traced cinit with popcount parity — no sequential scan, any slot's
sequence is one vectorized op.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

NC = 1600


def _advance_matrix(taps: tuple[int, ...]) -> np.ndarray:
    """31x31 GF(2) one-step matrix for s_i' = x(n+1+i): shift + feedback."""
    A = np.zeros((31, 31), dtype=np.uint8)
    for i in range(30):
        A[i, i + 1] = 1          # s_i' = s_{i+1}
    for t in taps:
        A[30, t] ^= 1            # s_30' = sum taps
    return A


def _matmul_gf2(A, B):
    return (A.astype(np.uint32) @ B.astype(np.uint32)) & 1


def _matpow_gf2(A, p):
    R = np.eye(31, dtype=np.uint8)
    while p:
        if p & 1:
            R = _matmul_gf2(R, A).astype(np.uint8)
        A = _matmul_gf2(A, A).astype(np.uint8)
        p >>= 1
    return R


def _pack_rows(M: np.ndarray) -> np.ndarray:
    """(31,31) GF2 matrix -> (31,) uint32 packed rows (bit j = M[i,j])."""
    return (M.astype(np.uint32) * (1 << np.arange(31, dtype=np.uint64))[None, :]).sum(axis=1).astype(np.uint32)


@functools.lru_cache(maxsize=64)
def _gold_tables(length: int):
    """Host tables: x1 bits (length,) and packed x2 block matrices, cached
    as numpy arrays so a cached value never holds a device buffer."""
    n_blocks = -(-length // 31)
    # x1: x1(n+31) = x1(n+3) + x1(n); init x1(0)=1
    A1 = _advance_matrix((0, 3))
    x1 = np.zeros(NC + n_blocks * 31 + 31, dtype=np.uint8)
    x1[0] = 1
    for n in range(len(x1) - 31):
        x1[n + 31] = x1[n + 3] ^ x1[n]
    x1_out = x1[NC: NC + n_blocks * 31]
    # x2 block matrices: state s_b = A^(Nc+31b) s0 ; output bits = state bits
    A2 = _advance_matrix((0, 1, 2, 3))
    Apow = np.empty((n_blocks, 31), dtype=np.uint32)
    M = _matpow_gf2(A2, NC)
    step = _matpow_gf2(A2, 31)
    for b in range(n_blocks):
        Apow[b] = _pack_rows(M)
        M = _matmul_gf2(step, M).astype(np.uint8)
    return x1_out.astype(np.int8), Apow


def gold_sequence_np(cinit: int, length: int) -> np.ndarray:
    """Host-side gold sequence for STATIC cinit: same tables, numpy ops.

    Pilot/scrambling sequences with config-static cinit become trace-time
    constants instead of device op chains (the small-tensor op overhead on
    the pilot path measurably costs more than the sequences' memory)."""
    x1_np, Apow_np = _gold_tables(length)
    masked = Apow_np & np.uint32(cinit)
    bits = (np.bitwise_count(masked.view(np.uint8)).reshape(-1, 4).sum(-1)
            .reshape(Apow_np.shape) & 1).astype(np.int8)
    x2 = bits.reshape(-1)[:length]
    return x1_np[:length] ^ x2


def gold_sequence(cinit, length: int) -> jnp.ndarray:
    """c(n) for n in [0, length); cinit may be a traced int32/uint32 scalar."""
    x1_np, Apow_np = _gold_tables(length)
    x1 = jnp.asarray(x1_np)
    Apow = jnp.asarray(Apow_np)
    s0 = jnp.asarray(cinit).astype(jnp.uint32)
    masked = jnp.bitwise_and(Apow, s0)            # (n_blocks, 31)
    bits = (jnp.bitwise_count(masked) & 1).astype(jnp.int8)
    x2 = bits.reshape(-1)[:length]
    return x1[:length] ^ x2


def scramble(bits: jnp.ndarray, cinit, length: int | None = None) -> jnp.ndarray:
    """(un)scramble a bit tensor: out = bits XOR c.  Involutive."""
    L = length or bits.shape[-1]
    c = gold_sequence(cinit, L)
    return bits ^ c


def scramble_llrs(llrs: jnp.ndarray, cinit) -> jnp.ndarray:
    """Descramble soft values: flip LLR sign where c(n)=1
    (nr_codeword_unscrambling:48 analog)."""
    c = gold_sequence(cinit, llrs.shape[-1])
    return llrs * (1.0 - 2.0 * c.astype(llrs.dtype))


def pusch_cinit(rnti: int, q: int, n_id: int):
    """TS 38.211 §6.3.1.1 data scrambling cinit."""
    return (jnp.asarray(rnti).astype(jnp.uint32) << 15) + (q << 14) + n_id


def pdsch_cinit(rnti: int, q: int, n_id: int):
    return (jnp.asarray(rnti).astype(jnp.uint32) << 15) + (q << 14) + n_id
