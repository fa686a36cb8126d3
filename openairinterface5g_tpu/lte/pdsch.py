"""LTE PDSCH / DLSCH chain (TS 36.211 §6.3-6.4, 36.212 §5.3.2).

Reference: openair1/PHY/LTE_TRANSPORT/dlsch_coding.c (turbo + RM),
dlsch_modulation.c (QAM + RE mapping around CRS), and the UE side
dlsch_demodulation.c / dlsch_decoding.c.  Design: the whole
subframe is one traced program — segmentation/RM indices are host
constants, turbo code blocks decode as one batched lax.scan trellis,
CRS channel interpolation is a dense (n_sc, n_pil) matmul on the MXU.

Single antenna port (port 0) with MRC across RX antennas; the control
region (first n_ctrl symbols) and CRS REs are excluded from mapping.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..coding import turbo
from ..coding.crc import crc_attach, crc_ok, CRC_POLYS
from ..phy import llr as llr_mod
from ..phy import modulation as mod
from ..phy.scrambling import gold_sequence_np
from . import rate_matching as rm
from . import refsig
from . import segmentation as seg
from .params import LteFrameParams, make_lte_frame_params, map_to_grid, \
    extract_from_grid, ofdm_modulate, ofdm_demodulate

# 36.213 Table 7.1.7.1-1 modulation split (I_MCS -> Qm)
def lte_mcs_qm(mcs: int) -> int:
    return 2 if mcs <= 9 else 4 if mcs <= 16 else 6


# Catalog of standard peak operating points (TBS per subframe,
# 36.213 Table 7.1.7.2.1-1 at I_TBS 26): the published LTE FDD DL
# throughputs in BASELINE.md (17/34/69.9 Mb/s at 5/10/20 MHz MCS28).
PEAK_TBS = {25: 18336, 50: 36696, 100: 75376}


@dataclasses.dataclass(frozen=True)
class LtePdschConfig:
    n_rb: int = 50                  # carrier bandwidth
    n_prb: int = 50                 # allocation size (contiguous from prb_start)
    prb_start: int = 0
    mcs: int = 28
    tbs_override: int | None = None
    n_ctrl_syms: int = 1            # PDCCH control region (CFI)
    cell_id: int = 0
    rnti: int = 0x1234
    subframe: int = 1               # avoid PSS/SSS/PBCH (subframes 0/5)
    n_rx: int = 1
    n_crs_ports: int = 1            # CRS ports whose REs are reserved

    @property
    def fp(self) -> LteFrameParams:
        return make_lte_frame_params(self.n_rb)

    @property
    def qm(self) -> int:
        return lte_mcs_qm(self.mcs)

    @property
    def target_rate(self) -> float:
        """Approximate code rate for TBS derivation when no override/peak
        value applies (the exact 36.213 TBS table is data, not behavior)."""
        from ..transport import mcs_to_qm_rate
        return mcs_to_qm_rate(min(self.mcs, 27), 1)[1]

    def _crs_syms(self) -> tuple:
        """Subframe-absolute symbols carrying CRS (normal CP, ports 0/1)."""
        sps = self.fp.symbols_per_slot
        return (0, sps - 3, sps, 2 * sps - 3)

    @functools.cached_property
    def data_re_map(self) -> tuple:
        """(sym_ids, sc_ids) of PDSCH REs in mapping order (36.211 §6.3.5:
        k fastest, then l), excluding control region and CRS REs."""
        n_sc = 12 * self.n_prb
        a0 = 12 * self.prb_start
        crs_syms = self._crs_syms()
        reserved = {}
        for s in crs_syms:
            sl, l = divmod(s, self.fp.symbols_per_slot)
            scs = set()
            for p in range(max(self.n_crs_ports, 2) if self.n_crs_ports > 1 else 1):
                scs |= set((refsig.crs_sc_indices(self.n_rb, p, l, self.cell_id)).tolist())
            reserved[s] = scs
        sym_ids, sc_ids = [], []
        for s in range(self.n_ctrl_syms, self.fp.symbols_per_subframe):
            res = reserved.get(s, ())
            for k in range(a0, a0 + n_sc):
                if k in res:
                    continue
                sym_ids.append(s)
                sc_ids.append(k)
        return np.array(sym_ids, np.int64), np.array(sc_ids, np.int64)

    @property
    def n_data_re(self) -> int:
        return len(self.data_re_map[0])

    @property
    def G(self) -> int:
        return self.n_data_re * self.qm

    @property
    def tbs(self) -> int:
        if self.tbs_override is not None:
            return self.tbs_override
        if self.mcs == 28 and self.n_prb in PEAK_TBS and self.n_prb == self.n_rb:
            return PEAK_TBS[self.n_prb]
        a = int(self.G * self.target_rate) - 24
        return max((a // 8) * 8, 16)

    def seg(self) -> seg.LteSegParams:
        return seg.segment_params(self.tbs + 24)

    def scrambling_cinit(self, q: int = 0) -> int:
        """36.211 §6.3.1: c_init = n_RNTI 2^14 + q 2^13 + ns/2 2^9 + N_ID."""
        return (self.rnti << 14) + (q << 13) + (self.subframe << 9) + self.cell_id


# ---------------------------------------------------------------------------
# DLSCH coding (36.212 §5.3.2): CRC -> segment -> turbo -> RM -> concat
# ---------------------------------------------------------------------------


def dlsch_encode(cfg: LtePdschConfig, tb_bits: jnp.ndarray, rv: int = 0) -> jnp.ndarray:
    """(B, TBS) -> (B, G) rate-matched codeword bits."""
    p = cfg.seg()
    tb_crc = crc_attach(tb_bits.astype(jnp.int8), "24A")
    groups = seg.segment_tb(tb_crc, p)
    es = rm.cb_e_sizes(cfg.G, p.C, cfg.qm)
    out, r = [], 0
    for cbs in groups:                          # (B, cnt, K)
        B, cnt, K = cbs.shape
        d0, d1, d2 = turbo.encode(cbs.reshape(B * cnt, K))
        d = jnp.concatenate([d0, d1, d2], -1).reshape(B, cnt, -1)
        for i in range(cnt):
            F = p.F if r == 0 else 0
            idx = rm.turbo_rm_indices(K, es[r], rv, F=F)
            out.append(rm.rate_match_tx(d[:, i], idx))
            r += 1
    return jnp.concatenate(out, axis=-1)


def dlsch_deratematch(cfg: LtePdschConfig, llr_cw: jnp.ndarray,
                      rv: int = 0) -> list:
    """(B, G) codeword LLRs -> per-K-group (B, cnt, 3D) stream LLRs.

    Split as a list so HARQ rounds with different rv can be soft-combined
    (chase + incremental redundancy) by summing the lists elementwise."""
    p = cfg.seg()
    es = rm.cb_e_sizes(cfg.G, p.C, cfg.qm)
    offs = np.concatenate([[0], np.cumsum(es)])
    streams, r = [], 0
    for K, cnt, first in seg._groups(p):
        D = K + 4
        lls = []
        for i in range(cnt):
            F = p.F if r == 0 else 0
            idx = rm.turbo_rm_indices(K, es[r], rv, F=F)
            le = llr_cw[:, offs[r]: offs[r + 1]]
            lls.append(rm.rate_match_rx(le, idx, 3 * D, F=F, D=D))
            r += 1
        streams.append(jnp.stack(lls, axis=1))  # (B, cnt, 3D)
    return streams


def dlsch_decode_streams(cfg: LtePdschConfig, streams: list,
                         n_iters: int = 6):
    """Per-group stream LLRs (dlsch_deratematch output, possibly HARQ-
    combined) -> dict(tb_bits, tb_ok, cb_ok)."""
    p = cfg.seg()
    groups_out, cb_oks = [], []
    for (K, cnt, first), ld in zip(seg._groups(p), streams):
        D = K + 4
        B = ld.shape[0]
        ld = ld.reshape(B * cnt, 3 * D)
        bits, _ = turbo.decode(ld[:, :D], ld[:, D: 2 * D], ld[:, 2 * D:],
                               n_iters=n_iters)
        bits = bits.reshape(B, cnt, K)
        if p.cb_crc:
            cb_oks.append(crc_ok(bits, "24B"))
        groups_out.append(bits)
    tb_with_crc = seg.desegment_tb(groups_out, p)
    tb_ok = crc_ok(tb_with_crc, "24A")
    cb_ok = (jnp.concatenate(cb_oks, axis=1) if cb_oks
             else tb_ok[:, None])
    L = CRC_POLYS["24A"][0]
    return {"tb_bits": tb_with_crc[..., :-L], "tb_ok": tb_ok, "cb_ok": cb_ok}


def dlsch_decode(cfg: LtePdschConfig, llr_cw: jnp.ndarray, rv: int = 0,
                 n_iters: int = 6):
    """(B, G) codeword LLRs -> dict(tb_bits, tb_ok, cb_ok)."""
    return dlsch_decode_streams(cfg, dlsch_deratematch(cfg, llr_cw, rv),
                                n_iters=n_iters)


# ---------------------------------------------------------------------------
# TX / RX subframe chains
# ---------------------------------------------------------------------------


def pdsch_tx(cfg: LtePdschConfig, tb_bits: jnp.ndarray, rv: int = 0,
             pdcch_row=None):
    """(B, TBS) -> ((B, 1, samples) subframe waveform, scrambled bits).

    pdcch_row: optional (B, n_sc) control-region REs added onto symbol 0
    (pdcch_tx_symbol0 output) so one subframe carries PDCCH + PDSCH."""
    cw = dlsch_encode(cfg, tb_bits, rv)
    c = jnp.asarray(gold_sequence_np(cfg.scrambling_cinit(), cfg.G).astype(np.int8))
    scrambled = jnp.bitwise_xor(cw.astype(jnp.int8), c)
    syms = mod.modulate(scrambled, cfg.qm)      # (B, G/qm)
    fp = cfg.fp
    B = tb_bits.shape[0]
    grid_re = jnp.zeros((B, 1, fp.symbols_per_subframe, fp.n_sc), jnp.complex64)
    sym_ids, sc_ids = cfg.data_re_map
    grid_re = grid_re.at[:, 0, jnp.asarray(sym_ids), jnp.asarray(sc_ids)].set(syms)
    # CRS port 0 on the full carrier
    for s in cfg._crs_syms():
        sl, l = divmod(s, fp.symbols_per_slot)
        ns = 2 * cfg.subframe + sl
        pil = jnp.asarray(refsig.crs_sequence_np(ns, l, cfg.cell_id, cfg.n_rb))
        sc = refsig.crs_sc_indices(cfg.n_rb, 0, l, cfg.cell_id)
        grid_re = grid_re.at[:, 0, s, jnp.asarray(sc)].set(pil)
    if pdcch_row is not None:
        grid_re = grid_re.at[:, 0, 0, :].add(pdcch_row)
    grid = map_to_grid(fp, grid_re)
    return ofdm_modulate(fp, grid), scrambled


def crs_channel_estimate(cfg: LtePdschConfig, re_grid: jnp.ndarray):
    """CRS LS + frequency interpolation -> ((B, R, n_sc) h, (B,) nvar).

    LS at the port-0 CRS REs of all 4 CRS symbols, block-fading average
    per comb offset, merged 3-spaced comb interpolated to every SC with
    one host-precomputed linear-interp matrix (an MXU matmul — the
    filt16a/filt8a LUT interpolation of lte_dl_channel_estimation.c)."""
    fp = cfg.fp
    by_comb = {}
    for s in cfg._crs_syms():
        sl, l = divmod(s, fp.symbols_per_slot)
        ns = 2 * cfg.subframe + sl
        pil = jnp.asarray(refsig.crs_sequence_np(ns, l, cfg.cell_id, cfg.n_rb))
        sc = refsig.crs_sc_indices(cfg.n_rb, 0, l, cfg.cell_id)
        ls = re_grid[:, :, s, :][..., jnp.asarray(sc)] * jnp.conj(pil)
        by_comb.setdefault(int(sc[0]), []).append(ls)
    offs = sorted(by_comb)
    ls_avg = [sum(by_comb[o]) / len(by_comb[o]) for o in offs]
    # merge combs into sorted pilot positions
    pil_sc = np.concatenate([o + 6 * np.arange(2 * cfg.n_rb) for o in offs])
    order = np.argsort(pil_sc, kind="stable")
    h_pil = jnp.concatenate(ls_avg, axis=-1)[..., jnp.asarray(order)]
    W = _interp_matrix(fp.n_sc, tuple(pil_sc[order].tolist()))
    h = jnp.einsum("brp,sp->brs", h_pil, jnp.asarray(W), precision=jax.lax.Precision.HIGHEST)
    # noise variance from adjacent pilot differences on one comb
    d = ls_avg[0][..., 1:] - ls_avg[0][..., :-1]
    nvar = jnp.mean(jnp.abs(d) ** 2, axis=(-2, -1))
    return h, nvar


@functools.lru_cache(maxsize=32)
def _interp_matrix(n_sc: int, pil_sc: tuple) -> np.ndarray:
    """(n_sc, n_pil) linear interpolation/extrapolation weights."""
    pil = np.asarray(pil_sc, np.int64)
    W = np.zeros((n_sc, len(pil)), np.float32)
    for k in range(n_sc):
        j = np.searchsorted(pil, k)
        if j == 0:
            W[k, 0] = 1.0
        elif j >= len(pil):
            W[k, -1] = 1.0
        else:
            t = (k - pil[j - 1]) / (pil[j] - pil[j - 1])
            W[k, j - 1] = 1.0 - t
            W[k, j] = t
    return W


def pdsch_rx(cfg: LtePdschConfig, rx_samples: jnp.ndarray, rv: int = 0,
             n_iters: int = 6, acc_streams: list | None = None):
    """(B, n_rx, samples) subframe -> decoded TB dict (+llrs, +streams).

    acc_streams: prior-round dlsch stream LLRs; this round's de-rate-matched
    LLRs are added in (HARQ chase/IR combining, dlsim.c analog)."""
    fp = cfg.fp
    grid = ofdm_demodulate(fp, rx_samples)
    re_grid = extract_from_grid(fp, grid)       # (B, R, 14, n_sc)
    h, nvar = crs_channel_estimate(cfg, re_grid)
    # MRC over RX antennas, then gather data REs in mapping order
    x_full = jnp.sum(jnp.conj(h)[:, :, None, :] * re_grid, axis=1)
    mag_full = jnp.sum(jnp.abs(h) ** 2, axis=1)[:, None, :] * jnp.ones(
        (1, fp.symbols_per_subframe, 1), jnp.float32)
    sym_ids, sc_ids = cfg.data_re_map
    x = x_full[:, jnp.asarray(sym_ids), jnp.asarray(sc_ids)]
    mag = mag_full[:, jnp.asarray(sym_ids), jnp.asarray(sc_ids)]
    lls = llr_mod.llrs(x[:, None], mag[:, None], cfg.qm)[:, 0]
    c = jnp.asarray(gold_sequence_np(cfg.scrambling_cinit(), cfg.G).astype(np.float32))
    lls = lls * (1.0 - 2.0 * c)
    streams = dlsch_deratematch(cfg, lls, rv)
    if acc_streams is not None:
        streams = [a + s for a, s in zip(acc_streams, streams)]
    out = dlsch_decode_streams(cfg, streams, n_iters=n_iters)
    out["llrs"] = lls
    out["streams"] = streams
    return out
