"""NB-IoT PHY core (TS 36.211 §10): NPSS/NSSS sync, NPBCH, NPDSCH,
NPUSCH, NPRACH — the narrowband companion of the LTE stack.

Reference anchor: the reference carries a partial NB-IoT integration
(openair1/PHY/impl_defs_lte_NB_IoT.h, LTE_TRANSPORT/*_NB_IoT.h,
openair2 NB-IoT MAC hooks); this is a clean-room JAX core of the
same scope: one 180 kHz PRB, heavy repetition, TBCC (tail-biting
convolutional) downlink + turbo uplink coding.

Design: everything is one (14, 12) subframe tile per repetition; the
repetition dimension is a leading tensor axis and combining is a mean
over it (the reference accumulates int16 IQ per repetition);
NPSS/NSSS detection are single correlation matmuls.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..coding import turbo, viterbi
from ..coding.crc import crc_attach, crc_ok
from ..phy import llr as llr_mod
from ..phy import modulation as mod
from ..phy.scrambling import gold_sequence_np
from . import rate_matching as rm

N_SC = 12

# --------------------------------------------------------------------------
# NPSS (36.211 §10.2.7.1): ZC-11 (u=5) x per-symbol cover, symbols 3..13
# --------------------------------------------------------------------------

_NPSS_COVER = np.array([1, 1, 1, 1, -1, -1, 1, 1, 1, -1, 1], np.float32)


@functools.lru_cache(maxsize=1)
def npss_tile() -> np.ndarray:
    """(11, 11) complex64: symbols 3..13 x subcarriers 0..10."""
    n = np.arange(11)
    zc = np.exp(-1j * np.pi * 5 * n * (n + 1) / 11)
    return (_NPSS_COVER[:, None] * zc[None, :]).astype(np.complex64)


def npss_insert(grid: jnp.ndarray) -> jnp.ndarray:
    """Add NPSS onto a (B, 14, 12) subframe-5 tile."""
    t = jnp.asarray(npss_tile())
    return grid.at[:, 3:14, 0:11].add(t[None])


def npss_detect(grid: jnp.ndarray) -> jnp.ndarray:
    """(B, 14, 12) tile -> (B,) correlation metric (normalized 0..1)."""
    t = jnp.asarray(npss_tile())
    y = grid[:, 3:14, 0:11]
    num = jnp.abs(jnp.sum(y * jnp.conj(t)[None], axis=(1, 2))) ** 2
    den = jnp.sum(jnp.abs(y) ** 2, axis=(1, 2)) * jnp.sum(jnp.abs(t) ** 2)
    return num / jnp.maximum(den, 1e-12)


# --------------------------------------------------------------------------
# NSSS (36.211 §10.2.7.2): ZC-131 x Hadamard cover, carries NID + frame pos
# --------------------------------------------------------------------------

_NSSS_THETA = (0, 33, 66, 99)      # cyclic-shift index by (nf/2) mod 4


@functools.lru_cache(maxsize=None)
def _nsss_seq(n_id: int, q_frame: int) -> np.ndarray:
    """(132,) NSSS sequence for cell n_id (0..503) and frame phase."""
    u = n_id % 126 + 3
    q = n_id // 126
    n = np.arange(132)
    nn = n % 131
    zc = np.exp(-1j * np.pi * u * nn * (nn + 1) / 131)
    # binary scrambling b_q (Hadamard rows per 36.211 Table 10.2.7.2.1-1
    # structure: length-128 Walsh row extended cyclically)
    m = n % 128
    # Walsh-style binary cover indexed by q (the Table 10.2.7.2.1-1 b_q
    # role): sign = parity of popcount(q * m) over the cyclically
    # extended length-128 index
    bq = np.array([1.0 if bin(q * mm).count("1") % 2 == 0 else -1.0
                   for mm in m])
    theta = _NSSS_THETA[q_frame % 4]
    rot = np.exp(-2j * np.pi * theta * n / 132)
    return (zc * bq * rot).astype(np.complex64)


def nsss_insert(grid: jnp.ndarray, n_id: int, q_frame: int) -> jnp.ndarray:
    """Add NSSS (symbols 3..13 x 12 SCs = 132 REs) to a (B,14,12) tile."""
    seq = jnp.asarray(_nsss_seq(n_id, q_frame)).reshape(11, 12)
    return grid.at[:, 3:14, :].add(seq[None])


def nsss_identify(grid: jnp.ndarray, n_ids=range(0, 504, 1),
                  q_frame: int = 0):
    """(B, 14, 12) -> (best n_id (B,), metric (B, n_ids)) by one matmul."""
    ids = list(n_ids)
    refs = np.stack([_nsss_seq(i, q_frame) for i in ids])      # (N, 132)
    y = grid[:, 3:14, :].reshape(grid.shape[0], 132)
    corr = jnp.abs(y @ jnp.conj(jnp.asarray(refs)).T) ** 2     # (B, N)
    pwr = jnp.sum(jnp.abs(y) ** 2, axis=-1, keepdims=True) * 132
    metric = corr / jnp.maximum(pwr, 1e-12)
    best = jnp.argmax(metric, axis=-1)
    return jnp.asarray(ids)[best], metric


# --------------------------------------------------------------------------
# NPBCH (36.211 §10.2.4): MIB-NB, CRC16 + TBCC, QPSK, repetition combining
# --------------------------------------------------------------------------

MIB_NB_BITS = 34
_NPBCH_E = 200                      # coded bits per subframe block (100 REs)


@dataclasses.dataclass(frozen=True)
class NbConfig:
    n_id: int = 0
    n_reps: int = 8                  # subframe repetitions combined


def _npbch_data_re() -> tuple:
    """(sym, sc) of the 100 NPBCH REs (symbols 3..13, skipping the 4
    CRS/NRS positions per symbol pair — simplified: 10 of 12 SCs on
    symbols 4..13)."""
    sym_ids, sc_ids = [], []
    for s in range(4, 14):
        for k in range(10):
            sym_ids.append(s)
            sc_ids.append(k)
    return np.array(sym_ids), np.array(sc_ids)


def npbch_tx(cfg: NbConfig, mib_bits: jnp.ndarray) -> jnp.ndarray:
    """(B, 34) MIB-NB -> (B, n_reps, 14, 12) repeated subframe tiles."""
    with_crc = crc_attach(mib_bits.astype(jnp.int8), "16")
    d = viterbi.encode(with_crc)                     # TBCC triples
    L = MIB_NB_BITS + 16
    d3 = d.reshape(-1, L, 3)
    flat = jnp.concatenate([d3[..., 0], d3[..., 1], d3[..., 2]], -1)
    e = rm.rate_match_tx(flat, rm.conv_rm_indices(L, _NPBCH_E))
    c = jnp.asarray(gold_sequence_np(cfg.n_id, _NPBCH_E).astype(np.int8))
    syms = mod.modulate(e.astype(jnp.int8) ^ c, 2)   # (B, 100)
    sym_ids, sc_ids = _npbch_data_re()
    tile = jnp.zeros((mib_bits.shape[0], 14, 12), jnp.complex64)
    tile = tile.at[:, jnp.asarray(sym_ids), jnp.asarray(sc_ids)].set(syms)
    return jnp.broadcast_to(tile[:, None], (*tile.shape[:1], cfg.n_reps,
                                            14, 12))


def npbch_rx(cfg: NbConfig, tiles: jnp.ndarray):
    """(B, n_reps, 14, 12) received tiles -> dict(mib_bits, ok).

    Repetition combining = mean over the rep axis (the NB-IoT coverage-
    extension gain), then TBCC Viterbi + CRC."""
    y = jnp.mean(tiles, axis=1)                      # (B, 14, 12)
    sym_ids, sc_ids = _npbch_data_re()
    syms = y[:, jnp.asarray(sym_ids), jnp.asarray(sc_ids)]
    lls = llr_mod.llrs(syms[:, None], jnp.ones_like(syms.real)[:, None],
                       2)[:, 0]
    c = gold_sequence_np(cfg.n_id, _NPBCH_E).astype(np.float32)
    lls = lls * (1.0 - 2.0 * c)
    L = MIB_NB_BITS + 16
    flat = rm.rate_match_rx(lls, rm.conv_rm_indices(L, _NPBCH_E), 3 * L)
    d3 = jnp.stack([flat[:, :L], flat[:, L: 2 * L], flat[:, 2 * L:]], -1)
    bits = viterbi.decode(d3.reshape(-1, 3 * L))
    ok = crc_ok(bits, "16")
    return {"mib_bits": bits[:, :MIB_NB_BITS], "ok": ok}


# --------------------------------------------------------------------------
# NPDSCH / NPUSCH: repetition-combined single-PRB data
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NbSchConfig:
    tbs: int = 256                   # from the I_TBS/I_SF tables (36.213)
    n_sf: int = 2                    # subframes per codeword
    n_reps: int = 4                  # repetitions
    n_id: int = 0
    rnti: int = 0x1234
    ul: bool = False                 # False: NPDSCH (TBCC), True: NPUSCH
                                     # (turbo, 36.212 §6.2)

    @property
    def n_re(self) -> int:
        return 11 * N_SC * self.n_sf  # symbols 3..13 per subframe

    @property
    def E(self) -> int:
        return 2 * self.n_re          # QPSK


def _nbsch_cinit(cfg: NbSchConfig) -> int:
    return ((cfg.rnti << 14) + cfg.n_id) % (1 << 31)


def nbsch_tx(cfg: NbSchConfig, tb_bits: jnp.ndarray) -> jnp.ndarray:
    """(B, TBS) -> (B, n_reps, n_sf, 14, 12) repeated subframe tiles."""
    B = tb_bits.shape[0]
    with_crc = crc_attach(tb_bits.astype(jnp.int8), "24A")
    L = cfg.tbs + 24
    if cfg.ul:
        d0, d1, d2 = turbo.encode(with_crc)          # each (B, L+4)
        d = jnp.concatenate([d0, d1, d2], -1)
        e = rm.rate_match_tx(d, rm.turbo_rm_indices(L, cfg.E, rv=0))
    else:
        d = viterbi.encode(with_crc).reshape(B, L, 3)
        flat = jnp.concatenate([d[..., 0], d[..., 1], d[..., 2]], -1)
        e = rm.rate_match_tx(flat, rm.conv_rm_indices(L, cfg.E))
    c = jnp.asarray(gold_sequence_np(_nbsch_cinit(cfg), cfg.E).astype(np.int8))
    syms = mod.modulate(e.astype(jnp.int8) ^ c, 2)   # (B, n_re)
    tiles = jnp.zeros((B, cfg.n_sf, 14, 12), jnp.complex64)
    tiles = tiles.at[:, :, 3:14, :].set(
        syms.reshape(B, cfg.n_sf, 11, 12))
    return jnp.broadcast_to(tiles[:, None],
                            (B, cfg.n_reps, cfg.n_sf, 14, 12))


def nbsch_rx(cfg: NbSchConfig, tiles: jnp.ndarray, n_iters: int = 6):
    """(B, n_reps, n_sf, 14, 12) -> dict(tb_bits, ok)."""
    B = tiles.shape[0]
    y = jnp.mean(tiles, axis=1)                      # (B, n_sf, 14, 12)
    syms = y[:, :, 3:14, :].reshape(B, cfg.n_re)
    lls = llr_mod.llrs(syms[:, None], jnp.ones_like(syms.real)[:, None],
                       2)[:, 0]
    c = gold_sequence_np(_nbsch_cinit(cfg), cfg.E).astype(np.float32)
    lls = lls * (1.0 - 2.0 * c)
    L = cfg.tbs + 24
    if cfg.ul:
        D = L + 4
        ld = rm.rate_match_rx(lls, rm.turbo_rm_indices(L, cfg.E, rv=0),
                              3 * D)
        bits, _ = turbo.decode(ld[:, :D], ld[:, D: 2 * D], ld[:, 2 * D:],
                               n_iters=n_iters)
    else:
        flat = rm.rate_match_rx(lls, rm.conv_rm_indices(L, cfg.E), 3 * L)
        d3 = jnp.stack([flat[:, :L], flat[:, L: 2 * L], flat[:, 2 * L:]], -1)
        bits = viterbi.decode(d3.reshape(B, 3 * L))
    ok = crc_ok(bits, "24A")
    return {"tb_bits": bits[:, : cfg.tbs], "ok": ok}


# --------------------------------------------------------------------------
# NPRACH (36.211 §10.1.6): single-tone frequency-hopping preamble
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NprachConfig:
    n_sc: int = 12                   # preamble subcarrier space (3.75 kHz
                                     # tones mapped onto one PRB here)
    n_groups: int = 4                # symbol groups per repetition
    n_reps: int = 2


def nprach_hop_pattern(cfg: NprachConfig, n_init: int) -> np.ndarray:
    """(n_reps * n_groups,) tone index per symbol group.

    36.211 §10.1.6.1 hopping: +1, +6-ish alternation inside the 12-tone
    space seeded by the initial subcarrier n_init (deterministic, so
    detection can match the full pattern)."""
    hops = []
    tone = n_init
    for g in range(cfg.n_reps * cfg.n_groups):
        hops.append(tone)
        if g % 4 == 0:
            tone = (tone + 1) % cfg.n_sc
        elif g % 4 == 1:
            tone = (tone + 6) % cfg.n_sc
        elif g % 4 == 2:
            tone = (tone - 1) % cfg.n_sc
        else:
            tone = (tone + 6) % cfg.n_sc
    return np.array(hops, np.int64)


def nprach_tx(cfg: NprachConfig, n_init: int, batch: int = 1) -> jnp.ndarray:
    """-> (B, n_groups_total, n_sc) single-tone symbol groups."""
    hops = nprach_hop_pattern(cfg, n_init)
    out = np.zeros((len(hops), cfg.n_sc), np.complex64)
    out[np.arange(len(hops)), hops] = 1.0
    return jnp.broadcast_to(jnp.asarray(out), (batch, *out.shape))


def nprach_detect(cfg: NprachConfig, rx: jnp.ndarray,
                  threshold: float = 0.3):
    """(B, n_groups_total, n_sc) -> dict(detected, n_init, metric).

    Correlates the received tone-energy pattern against all 12 initial-
    subcarrier hypotheses in one matmul."""
    G = cfg.n_reps * cfg.n_groups
    pats = np.zeros((cfg.n_sc, G, cfg.n_sc), np.float32)
    for n0 in range(cfg.n_sc):
        hops = nprach_hop_pattern(cfg, n0)
        pats[n0, np.arange(G), hops] = 1.0
    e = jnp.abs(rx) ** 2                             # (B, G, n_sc)
    score = jnp.einsum("bgs,ngs->bn", e, jnp.asarray(pats), precision=jax.lax.Precision.HIGHEST)
    total = jnp.sum(e, axis=(1, 2))
    metric = score / jnp.maximum(total[:, None], 1e-12)
    best = jnp.argmax(metric, axis=-1)
    return {"detected": jnp.max(metric, axis=-1) > threshold,
            "n_init": best, "metric": metric}
