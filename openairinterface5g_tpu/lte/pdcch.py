"""LTE DL control channels: PCFICH, PHICH, PDCCH (TS 36.211 §6.7-6.9,
36.212 §5.3.1/5.3.3).

Reference: openair1/PHY/LTE_TRANSPORT/pcfich.c, phich.c, dci.c (+ the
eNB-side generation and UE-side `dci_decoding_procedure` blind search).
Design: the control region is one (n_ctrl, n_sc) tile; REG
extraction is a host-precomputed index set, the DCI codec reuses the
tail-biting Viterbi (coding/viterbi.py) and conv rate matching
(lte/rate_matching.py), and blind decoding evaluates all candidate
(CCE offset, aggregation) hypotheses as a batch.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..coding import viterbi
from ..coding.crc import crc_attach, crc_ok
from ..phy import llr as llr_mod
from ..phy import modulation as mod
from ..phy.scrambling import gold_sequence_np
from . import rate_matching as rm
from . import refsig

# ---------------------------------------------------------------------------
# REG geometry (symbol 0; 2 CRS REs per RB per port pair -> 2 REGs of 4)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def symbol0_regs(n_rb: int, cell_id: int) -> np.ndarray:
    """(n_regs, 4) subcarrier indices of the symbol-0 REGs.

    In symbol 0 the CRS of ports 0/1 occupy k mod 3 == vshift mod 3, so
    each RB contributes 2 REGs of 4 REs from the remaining 8 SCs
    (36.211 §6.2.4)."""
    vshift3 = (cell_id % 6) % 3
    regs = []
    for rb in range(n_rb):
        scs = [12 * rb + k for k in range(12) if k % 3 != vshift3]
        regs.append(scs[:4])
        regs.append(scs[4:])
    return np.array(regs, np.int64)


def pcfich_reg_indices(n_rb: int, cell_id: int) -> np.ndarray:
    """The 4 PCFICH REG indices (36.211 §6.7.4).

    Quadruplet i starts at k = (k_bar + floor(i*N_RB/2)*6) mod n_sc; each
    half-RB of 6 SCs contains exactly one symbol-0 REG, so the REG index
    is k // 6."""
    k_bar = 6 * (cell_id % (2 * n_rb))
    return np.array([((k_bar + (i * n_rb // 2) * 6) % (n_rb * 12)) // 6
                     for i in range(4)], np.int64)


def phich_reg_indices(n_rb: int, cell_id: int, n_groups: int = 1) -> np.ndarray:
    """Symbol-0 REG indices of the PHICH groups (36.211 §6.9.3, normal
    duration): n_i' = (N_ID + m' + floor(i*n0/3)) mod n0 counted among the
    n0 REGs not assigned to PCFICH (reference phich_common.c:302)."""
    pc = pcfich_reg_indices(n_rb, cell_id)
    non_pcfich = np.array([i for i in range(2 * n_rb)
                           if i not in set(pc.tolist())], np.int64)
    n0 = len(non_pcfich)
    out = []
    for m in range(n_groups):
        for i in range(3):
            out.append(int(non_pcfich[(cell_id + m + i * n0 // 3) % n0]))
    return np.array(out, np.int64)


# CFI codewords (36.212 Table 5.3.4-1)
_CFI_CW = {
    1: [0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1],
    2: [1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0],
    3: [1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1],
}


def pcfich_cinit(subframe: int, cell_id: int) -> int:
    """36.211 §6.7.1."""
    return ((subframe + 1) * (2 * cell_id + 1) << 9) + cell_id


def pcfich_encode(cfi: int, subframe: int, cell_id: int) -> jnp.ndarray:
    """CFI -> (16,) QPSK symbols."""
    cw = np.array(_CFI_CW[cfi], np.int8)
    c = gold_sequence_np(pcfich_cinit(subframe, cell_id), 32).astype(np.int8)
    return mod.modulate(jnp.asarray((cw ^ c)[None]), 2)[0]


def pcfich_decode(y: jnp.ndarray, h: jnp.ndarray, subframe: int,
                  cell_id: int) -> jnp.ndarray:
    """(B, R, 16) received PCFICH REs + channel -> (B,) CFI by ML
    correlation over the 3 codewords."""
    x = jnp.sum(jnp.conj(h) * y, axis=1)                # (B, 16)
    c = gold_sequence_np(pcfich_cinit(subframe, cell_id), 32).astype(np.int8)
    metrics = []
    for cfi in (1, 2, 3):
        cw = np.array(_CFI_CW[cfi], np.int8) ^ c
        ref = np.asarray(mod.constellation(2))[
            cw.reshape(16, 2) @ np.array([2, 1])]
        metrics.append(jnp.real(jnp.sum(x * np.conj(ref), axis=-1)))
    return jnp.argmax(jnp.stack(metrics, -1), axis=-1) + 1


# ---------------------------------------------------------------------------
# PHICH (36.211 §6.9): BPSK ACK, SF4 orthogonal spreading on 3 REGs
# ---------------------------------------------------------------------------

_PHICH_W = np.array([[1, 1, 1, 1], [1, -1, 1, -1],
                     [1, 1, -1, -1], [1, -1, -1, 1]], np.float32)


def phich_encode(ack: int, n_seq: int = 0) -> jnp.ndarray:
    """1 ACK bit -> (12,) spread BPSK symbols (3 repetitions x SF4)."""
    b = 1.0 - 2.0 * ack
    w = _PHICH_W[n_seq]
    return jnp.asarray(np.tile(b * w, 3).astype(np.complex64))


def phich_decode(y: jnp.ndarray, h: jnp.ndarray, n_seq: int = 0) -> jnp.ndarray:
    """(B, R, 12) REs + channel -> (B,) ACK decision (0=ACK sent as +1)."""
    x = jnp.sum(jnp.conj(h) * y, axis=1)                # (B, 12)
    w = np.tile(_PHICH_W[n_seq], 3)
    corr = jnp.real(jnp.sum(x * w, axis=-1))
    return (corr < 0).astype(jnp.int32)


# ---------------------------------------------------------------------------
# PDCCH (36.212 §5.3.3 coding, 36.211 §6.8 mapping)
# ---------------------------------------------------------------------------

N_REG_PER_CCE = 9
BITS_PER_CCE = 72


@functools.lru_cache(maxsize=32)
def _pdcch_avail_regs(n_rb: int, cell_id: int, n_phich_groups: int) -> tuple:
    """Symbol-0 REG indices available to PDCCH (PCFICH+PHICH excluded)."""
    used = set(pcfich_reg_indices(n_rb, cell_id).tolist())
    used |= set(phich_reg_indices(n_rb, cell_id, n_phich_groups).tolist())
    return tuple(i for i in range(2 * n_rb) if i not in used)


@functools.lru_cache(maxsize=32)
def _quad_positions(M: int, cell_id: int) -> np.ndarray:
    """(M,) REG slot j for each absolute PDCCH quadruplet m (36.211 §6.8.5).

    Quadruplets are sub-block interleaved (36.212 §5.1.4.2.1 permutation,
    nulls dropped) then cyclically shifted by N_ID^cell; slot j holds
    w_bar(j) = w(perm[(j + N_ID) mod M]), so quadruplet m lands at
    j = (perm_inv[m] - N_ID) mod M."""
    v = rm._subblock(M, rm._P_CONV)
    order = v[v >= 0]                       # out[j] = in[order[j]]
    inv = np.empty(M, np.int64)
    inv[order] = np.arange(M)
    return (inv - cell_id) % M


def dci_encode(payload: jnp.ndarray, rnti: int, E: int) -> jnp.ndarray:
    """(B, A) DCI bits -> (B, E) rate-matched coded bits.

    CRC16 masked with the RNTI, tail-biting conv 1/3, conv RM."""
    B, A = payload.shape
    with_crc = crc_attach(payload.astype(jnp.int8), "16")
    mask = np.array([(rnti >> (15 - i)) & 1 for i in range(16)], np.int8)
    with_crc = with_crc.at[:, A:].set(
        jnp.bitwise_xor(with_crc[:, A:], jnp.asarray(mask)))
    d = viterbi.encode(with_crc)                        # per-step triples
    L = A + 16
    d3 = d.reshape(B, L, 3)
    d_flat = jnp.concatenate([d3[..., 0], d3[..., 1], d3[..., 2]], -1)
    return rm.rate_match_tx(d_flat, rm.conv_rm_indices(L, E))


def dci_decode(llr_e: jnp.ndarray, A: int, rnti: int):
    """(B, E) coded LLRs -> ((B, A) payload, ok (B,))."""
    B, E = llr_e.shape
    L = A + 16
    d_flat = rm.rate_match_rx(llr_e, rm.conv_rm_indices(L, E), 3 * L)
    d3 = jnp.stack([d_flat[:, :L], d_flat[:, L: 2 * L], d_flat[:, 2 * L:]], -1)
    bits = viterbi.decode(d3.reshape(B, 3 * L))
    mask = np.array([(rnti >> (15 - i)) & 1 for i in range(16)], np.int8)
    unmasked = bits.at[:, A:].set(
        jnp.bitwise_xor(bits[:, A:], jnp.asarray(mask)))
    return bits[:, :A], crc_ok(unmasked, "16")


def pdcch_cinit(subframe: int, cell_id: int) -> int:
    """36.211 §6.8.2."""
    return (subframe << 9) + cell_id


def _cce_sc_list(n_rb: int, cell_id: int, cce0: int, aggregation: int,
                 n_phich_groups: int = 1) -> np.ndarray:
    """Subcarrier indices (aggregation*9*4,) of CCEs [cce0, cce0+agg) after
    the §6.8.5 quadruplet interleave + cell shift over the PDCCH REGs."""
    regs = symbol0_regs(n_rb, cell_id)
    avail = _pdcch_avail_regs(n_rb, cell_id, n_phich_groups)
    n_cce = len(avail) // N_REG_PER_CCE
    assert cce0 + aggregation <= n_cce, (
        f"candidate [{cce0}, {cce0 + aggregation}) exceeds the control "
        f"region's {n_cce} CCEs")
    M = n_cce * N_REG_PER_CCE
    pos = _quad_positions(M, cell_id)
    sc_list = []
    for m in range(cce0 * N_REG_PER_CCE,
                   (cce0 + aggregation) * N_REG_PER_CCE):
        sc_list.extend(regs[avail[pos[m]]].tolist())
    return np.array(sc_list)


def pdcch_tx_symbol0(n_rb: int, cell_id: int, subframe: int,
                     payload: jnp.ndarray, rnti: int,
                     aggregation: int = 4, cce0: int = 0,
                     n_phich_groups: int = 1) -> jnp.ndarray:
    """(B, A) DCI -> (B, n_sc) symbol-0 REs (PDCCH CCEs cce0..; PCFICH/
    PHICH REGs left empty for the caller)."""
    B = payload.shape[0]
    E = aggregation * BITS_PER_CCE
    e = dci_encode(payload, rnti, E)
    c = gold_sequence_np(pdcch_cinit(subframe, cell_id), E).astype(np.int8)
    syms = mod.modulate(jnp.bitwise_xor(e.astype(jnp.int8), jnp.asarray(c)), 2)
    sc_list = _cce_sc_list(n_rb, cell_id, cce0, aggregation, n_phich_groups)
    out = jnp.zeros((B, 12 * n_rb), jnp.complex64)
    return out.at[:, jnp.asarray(sc_list)].set(syms[:, : len(sc_list)])


def pdcch_blind_decode(y0: jnp.ndarray, h: jnp.ndarray, n_rb: int,
                       cell_id: int, subframe: int, rnti: int, A: int,
                       aggregations=(1, 2, 4, 8), n_cand: int = 6,
                       cce0_list=None):
    """Symbol-0 REs (B, R, n_sc) + channel (B, R, n_sc) -> best DCI.

    Evaluates the UE-specific search-space candidates per aggregation
    level (dci_decoding_procedure analog); returns (payload (B, A),
    found (B,), level (B,)).  cce0_list restricts the starting CCEs
    (e.g. to separate two same-RNTI DCIs in one subframe)."""
    B = y0.shape[0]
    avail = _pdcch_avail_regs(n_rb, cell_id, 1)
    n_cce = len(avail) // N_REG_PER_CCE

    x_full = jnp.sum(jnp.conj(h) * y0, axis=1)
    mag_full = jnp.sum(jnp.abs(h) ** 2, axis=1)
    c_by_E = {}
    best = (jnp.zeros((B, A), jnp.int8), jnp.zeros((B,), bool),
            jnp.zeros((B,), jnp.int32))
    for al in aggregations:
        if al > max(n_cce, 1):
            continue
        E = al * BITS_PER_CCE
        if E not in c_by_E:
            c_by_E[E] = gold_sequence_np(
                pdcch_cinit(subframe, cell_id), E).astype(np.float32)
        for cand in range(min(n_cand, max(n_cce // al, 1))):
            cce0 = cand * al
            if cce0_list is not None and cce0 not in cce0_list:
                continue
            idx = jnp.asarray(_cce_sc_list(n_rb, cell_id, cce0, al))
            x = x_full[:, idx]
            mag = mag_full[:, idx]
            lls = llr_mod.llrs(x[:, None], mag[:, None], 2)[:, 0]
            lls = lls * (1.0 - 2.0 * c_by_E[E][: lls.shape[-1]])
            payload, ok = dci_decode(lls, A, rnti)
            pb, fb, lb = best
            take = ok & ~fb
            best = (jnp.where(take[:, None], payload, pb), fb | ok,
                    jnp.where(take, al, lb))
    return best
