"""LTE PUCCH formats 1/1a/1b (TS 36.211 §5.4.1) — SR and 1/2-bit
HARQ-ACK on one PRB pair.

Reference: openair1/PHY/LTE_TRANSPORT/pucch.c (generate_pucch1x /
uci decoding).  Structure per slot (normal CP): the length-12 base
sequence r_{u,v} with a per-symbol cyclic shift (cell Gold-hopped),
data on symbols {0,1,5,6} spread by a length-4 Walsh cover, DMRS on
symbols {2,3,4} spread by a length-3 DFT cover; the second slot hops
to the mirrored PRB.  Design: the whole (14, 12) PRB tile is one
tensor; detection is a single matched correlation against the known
cover/shift structure (format 1a/1b symbol decided by the phase).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..phy.refsig import low_papr_sequence
from ..phy.scrambling import gold_sequence_np

_W4 = np.array([[1, 1, 1, 1], [1, -1, 1, -1], [1, 1, -1, -1]], np.float32)
_W3 = np.exp(2j * np.pi * np.outer([0, 1, 2], [0, 1, 2]) / 3).astype(np.complex64)
_DATA_SYMS = (0, 1, 5, 6)
_DMRS_SYMS = (2, 3, 4)


@dataclasses.dataclass(frozen=True)
class LtePucch1Config:
    n_rb: int = 25
    cell_id: int = 0
    prb: int = 0                  # slot-0 PRB (slot 1 mirrors)
    n_oc: int = 0                 # orthogonal cover index (0..2)
    cs0: int = 0                  # base cyclic shift alpha index (0..11)
    n_rx: int = 1

    @property
    def mirror_prb(self) -> int:
        return self.n_rb - 1 - self.prb


@functools.lru_cache(maxsize=64)
def _ncs_cell(cell_id: int) -> np.ndarray:
    """(20, 7) per-(slot, symbol) cell cyclic-shift hop (36.211 §5.4:
    n_cs^cell from the cell Gold sequence, 8 bits per symbol)."""
    c = gold_sequence_np(cell_id, 8 * 7 * 20)
    bits = c.reshape(20, 7, 8)
    return (bits * (1 << np.arange(8))).sum(-1) % 12


def _base(cfg: LtePucch1Config) -> np.ndarray:
    u = cfg.cell_id % 30
    return low_papr_sequence(u, 0, 12)


def _slot_tile(cfg: LtePucch1Config, d: jnp.ndarray, ns: int) -> jnp.ndarray:
    """One slot's (7, 12) PUCCH tile for modulation symbol d (B,)."""
    r = _base(cfg)
    ncs = _ncs_cell(cfg.cell_id)[ns % 20]
    k = np.arange(12)
    cols = []
    w4 = _W4[cfg.n_oc]
    w3 = _W3[cfg.n_oc]
    di = 0
    for l in range(7):
        alpha = 2 * np.pi * ((cfg.cs0 + int(ncs[l])) % 12) / 12
        seq = r * np.exp(1j * alpha * k)
        if l in _DMRS_SYMS:
            cols.append(jnp.asarray(seq * w3[_DMRS_SYMS.index(l)])[None]
                        * jnp.ones_like(d[:, None]))
        else:
            cols.append(d[:, None] * float(w4[di]) * jnp.asarray(seq)[None])
            di += 1
    return jnp.stack(cols, axis=1)                       # (B, 7, 12)


def pucch1_tx(cfg: LtePucch1Config, bits: jnp.ndarray | None) -> jnp.ndarray:
    """bits: None (format 1 / SR), (B,1) (1a, BPSK) or (B,2) (1b, QPSK)
    -> (B, 14, n_sc) subframe RE grid (both slots, mirrored PRB)."""
    if bits is None:
        d = jnp.ones((1,), jnp.complex64)
    elif bits.shape[-1] == 1:
        d = (1.0 - 2.0 * bits[:, 0]).astype(jnp.complex64)
    else:
        d = ((1.0 - 2.0 * bits[:, 0]) + 1j * (1.0 - 2.0 * bits[:, 1])
             ).astype(jnp.complex64) / np.sqrt(2)
    B = d.shape[0]
    n_sc = 12 * cfg.n_rb
    grid = jnp.zeros((B, 14, n_sc), jnp.complex64)
    t0 = _slot_tile(cfg, d, 0)
    t1 = _slot_tile(cfg, d, 1)
    grid = grid.at[:, 0:7, 12 * cfg.prb: 12 * cfg.prb + 12].set(t0)
    grid = grid.at[:, 7:14, 12 * cfg.mirror_prb: 12 * cfg.mirror_prb + 12].set(t1)
    return grid


def pucch1_rx(cfg: LtePucch1Config, re_grid: jnp.ndarray, n_bits: int = 1):
    """(B, R, 14, n_sc) -> dict(d_hat, bits, detected).

    Channel from the DMRS symbols (per slot), coherent combine of the
    data symbols, metric = |corr| against the DTX threshold."""
    tiles = [re_grid[:, :, 0:7, 12 * cfg.prb: 12 * cfg.prb + 12],
             re_grid[:, :, 7:14, 12 * cfg.mirror_prb: 12 * cfg.mirror_prb + 12]]
    r = _base(cfg)
    k = np.arange(12)
    z = 0.0
    e_dmrs = 0.0
    for ns, tile in enumerate(tiles):
        ncs = _ncs_cell(cfg.cell_id)[ns % 20]
        w4 = _W4[cfg.n_oc]
        w3 = _W3[cfg.n_oc]
        h = 0.0
        for i, l in enumerate(_DMRS_SYMS):
            alpha = 2 * np.pi * ((cfg.cs0 + int(ncs[l])) % 12) / 12
            seq = r * np.exp(1j * alpha * k) * w3[i]
            h = h + tile[:, :, l, :] * jnp.conj(jnp.asarray(seq))
        h = h / 3                                       # (B, R, 12)
        e_dmrs = e_dmrs + jnp.mean(jnp.abs(h) ** 2, axis=(-2, -1))
        for i, l in enumerate(_DATA_SYMS):
            alpha = 2 * np.pi * ((cfg.cs0 + int(ncs[l])) % 12) / 12
            seq = r * np.exp(1j * alpha * k) * float(w4[i])
            z = z + jnp.sum(tile[:, :, l, :] * jnp.conj(jnp.asarray(seq) )
                            * jnp.conj(h), axis=(-2, -1))
    e = jnp.maximum(e_dmrs, 1e-12)
    d_hat = z / (8 * 12 * e[..., None] if z.ndim > e.ndim else 8 * 12 * e)
    if n_bits == 0:
        bits = None
    elif n_bits == 1:
        bits = (jnp.real(d_hat) < 0).astype(jnp.int8)[:, None]
    else:
        bits = jnp.stack([(jnp.real(d_hat) < 0), (jnp.imag(d_hat) < 0)],
                         axis=-1).astype(jnp.int8)
    detected = jnp.abs(d_hat) > 0.25
    return {"d_hat": d_hat, "bits": bits, "detected": detected}


# --------------------------------------------------------------------------
# Format 2 (TS 36.211 §5.4.2): 20 coded UCI bits (CQI/PMI) on one PRB pair
# --------------------------------------------------------------------------

# TS 36.212 Table 5.2.3.3-1: basis sequences M_{i,n} of the (20, A) code
_RM20_BASIS = np.array([
    [1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0],
    [1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0],
    [1, 0, 0, 1, 0, 0, 1, 0, 1, 1, 1, 1, 1],
    [1, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1, 1, 1],
    [1, 1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 1, 1],
    [1, 1, 0, 0, 1, 0, 1, 1, 1, 0, 1, 1, 1],
    [1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1, 1, 1],
    [1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 1],
    [1, 1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1, 1],
    [1, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1, 1, 1],
    [1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1],
    [1, 1, 1, 0, 0, 1, 1, 0, 1, 0, 1, 1, 1],
    [1, 0, 0, 1, 0, 1, 0, 1, 1, 1, 1, 1, 1],
    [1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1, 1],
    [1, 0, 0, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1],
    [1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 1, 0, 1],
    [1, 1, 1, 0, 1, 1, 1, 0, 0, 1, 0, 1, 1],
    [1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0, 1, 1],
    [1, 1, 0, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
    [1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0],
], np.int8)

_F2_DATA_SYMS = (0, 2, 3, 4, 6)     # normal CP; DMRS on l = 1, 5
_F2_DMRS_SYMS = (1, 5)


def rm20_encode(bits: jnp.ndarray) -> jnp.ndarray:
    """(B, A<=13) UCI bits -> (B, 20) codeword (36.212 §5.2.3.3)."""
    A = bits.shape[-1]
    M = jnp.asarray(_RM20_BASIS[:, :A], jnp.float32)
    acc = jnp.matmul(bits.astype(jnp.float32), M.T, precision=jax.lax.Precision.HIGHEST)
    return (acc.astype(jnp.int32) & 1).astype(jnp.int8)


def rm20_decode(llrs: jnp.ndarray, A: int) -> jnp.ndarray:
    """(B, 20) LLRs (>0 = bit 0) -> (B, A) ML-decoded UCI bits.

    Exhaustive correlation over all 2^A codewords as one matmul (the
    MXU-friendly form of the reference's UCI RM decoders)."""
    idx = np.arange(1 << A)
    a = ((idx[:, None] >> np.arange(A)[None, :]) & 1).astype(np.int8)
    cw = (a @ _RM20_BASIS[:, :A].T) & 1                 # (2^A, 20)
    sgn = jnp.asarray(1.0 - 2.0 * cw.astype(np.float32))
    score = llrs.astype(jnp.float32) @ sgn.T            # (B, 2^A)
    best = jnp.argmax(score, axis=-1)
    return jnp.asarray(a)[best].astype(jnp.int8)


@dataclasses.dataclass(frozen=True)
class LtePucch2Config:
    """PUCCH format 2 (36.211 §5.4.2): QPSK-modulated (20, A) RM-coded
    CQI on one PRB pair; data on symbols {0,2,3,4,6}/slot with
    cyclically shifted base sequences, DMRS on {1,5}."""
    n_rb: int = 25
    cell_id: int = 0
    prb: int = 0
    cs0: int = 0                  # n_PUCCH(2)-derived base shift (0..11)
    rnti: int = 0x1234
    n_bits: int = 4               # A (CQI payload size)
    n_rx: int = 1

    @property
    def mirror_prb(self) -> int:
        return self.n_rb - 1 - self.prb


def _f2_cinit(cfg: LtePucch2Config, ns: int) -> int:
    # 36.211 §5.4.2 scrambling: ((ns/2+1)(2 N_ID+1) << 16) + rnti
    return (((ns // 2 + 1) * (2 * cfg.cell_id + 1) << 16) + cfg.rnti) % (1 << 31)


def pucch2_tx(cfg: LtePucch2Config, uci_bits: jnp.ndarray) -> jnp.ndarray:
    """(B, A) CQI bits -> (B, 14, n_sc) subframe grid (both slots)."""
    B = uci_bits.shape[0]
    b = rm20_encode(uci_bits)                           # (B, 20)
    scr = jnp.asarray(gold_sequence_np(_f2_cinit(cfg, 0), 20))
    b = b ^ scr
    d = ((1.0 - 2.0 * b[:, 0::2]) + 1j * (1.0 - 2.0 * b[:, 1::2])
         ).astype(jnp.complex64) / np.sqrt(2)           # (B, 10)
    r = _base(LtePucch1Config(n_rb=cfg.n_rb, cell_id=cfg.cell_id))
    k = np.arange(12)
    n_sc = 12 * cfg.n_rb
    grid = jnp.zeros((B, 14, n_sc), jnp.complex64)
    di = 0
    for ns in range(2):
        ncs = _ncs_cell(cfg.cell_id)[ns % 20]
        prb = cfg.prb if ns == 0 else cfg.mirror_prb
        sc0 = 12 * prb
        for l in range(7):
            alpha = 2 * np.pi * ((cfg.cs0 + int(ncs[l])) % 12) / 12
            seq = jnp.asarray(r * np.exp(1j * alpha * k))
            if l in _F2_DMRS_SYMS:
                col = jnp.broadcast_to(seq, (B, 12))
            else:
                col = d[:, di][:, None] * seq
                di += 1
            grid = grid.at[:, 7 * ns + l, sc0: sc0 + 12].set(col)
    assert di == 10
    return grid


def pucch2_rx(cfg: LtePucch2Config, re_grid: jnp.ndarray):
    """(B, R, 14, n_sc) -> dict(uci (B, A), llrs, detected).

    Per-slot channel from the 2 DMRS symbols, coherent demod of the 10
    data symbols, descramble, (20, A) ML decode."""
    r = _base(LtePucch1Config(n_rb=cfg.n_rb, cell_id=cfg.cell_id))
    k = np.arange(12)
    llr_list = []
    coh = 0.0          # |mean_k h|^2: coherent only when the PUCCH is there
    raw = 0.0          # raw tile power (noise floor reference)
    for ns in range(2):
        ncs = _ncs_cell(cfg.cell_id)[ns % 20]
        prb = cfg.prb if ns == 0 else cfg.mirror_prb
        sc0 = 12 * prb
        tile = re_grid[:, :, 7 * ns: 7 * ns + 7, sc0: sc0 + 12]
        h = 0.0
        for l in _F2_DMRS_SYMS:
            alpha = 2 * np.pi * ((cfg.cs0 + int(ncs[l])) % 12) / 12
            seq = jnp.asarray(r * np.exp(1j * alpha * k))
            h = h + tile[:, :, l, :] * jnp.conj(seq)
        h = h / 2                                       # (B, R, 12)
        coh = coh + jnp.sum(jnp.abs(jnp.mean(h, axis=-1)) ** 2, axis=-1)
        raw = raw + jnp.mean(jnp.abs(tile) ** 2, axis=(-3, -2, -1))
        for l in _F2_DATA_SYMS:
            alpha = 2 * np.pi * ((cfg.cs0 + int(ncs[l])) % 12) / 12
            seq = jnp.asarray(r * np.exp(1j * alpha * k))
            z = jnp.sum(tile[:, :, l, :] * jnp.conj(seq) * jnp.conj(h),
                        axis=(-2, -1))                  # (B,)
            llr_list.append(z)
    zs = jnp.stack(llr_list, axis=-1)                   # (B, 10)
    llr = jnp.stack([jnp.real(zs), jnp.imag(zs)], axis=-1).reshape(
        zs.shape[0], 20)
    scr = jnp.asarray(gold_sequence_np(_f2_cinit(cfg, 0), 20))
    llr = llr * (1.0 - 2.0 * scr.astype(jnp.float32))
    uci = rm20_decode(llr, cfg.n_bits)
    # DTX: with a real PUCCH the per-SC DMRS estimates add coherently
    # (|mean_k h|^2 ~ |h|^2 ~ raw power); on noise they average down by
    # 12, so the coherence-to-power ratio separates by ~10 dB
    detected = coh > 0.25 * jnp.maximum(raw, 1e-12)
    return {"uci": uci, "llrs": llr, "detected": detected}
