"""PUSCH end-to-end chain: UE TX (P32) -> gNB RX (P21/P22/P24/P25).

JAX re-design of the reference chain
  TX: nr_ue_ulsch_procedures (nr_ulsch_ue.c:100) -> nr_ulsch_encoding
      (nr_ulsch_coding.c:44) -> scramble -> modulate -> DMRS -> RE map -> IFFT
  RX: nr_rx_pusch_tp (nr_ulsch_demodulation.c:1447): channel estimation
      (nr_ul_channel_estimation.c:67) -> MRC/MMSE -> LLR
      (nr_ulsch_llr_computation.c) -> unscramble -> rate recover
      -> LDPC decode (nr_ulsch_decoding.c:320) -> CRC.

Everything is jitted with static shapes from PuschConfig; the Monte-Carlo
trial dimension is a leading batch axis (the reference's thread-pool jobs
C2/C4 become tensor dims).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..config import FrameParams, make_frame_params
from ..transport import compute_tbs, mcs_to_qm_rate
from ..coding import ldpc, rate_matching, segmentation
from ..coding.crc import crc_attach, crc_ok
from ..phy import channel_estimation as ce
from ..phy import equalization as eq
from ..phy import llr as llr_mod
from ..phy import modulation as mod
from ..phy import refsig
from ..phy.ofdm import extract_from_grid, map_to_grid, ofdm_demodulate, ofdm_modulate
from ..phy.scrambling import pusch_cinit, scramble, scramble_llrs


@dataclasses.dataclass(frozen=True)
class PuschConfig:
    mu: int = 1
    n_prb: int = 106
    mcs: int = 9
    mcs_table: int = 1
    n_layers: int = 1
    n_rx: int = 1
    start_symbol: int = 0
    n_symbols: int = 14
    dmrs_symbols: tuple = (2,)       # type A, pos 2, single-symbol DMRS
    rnti: int = 0x1234
    n_id: int = 0
    slot: int = 0
    transform_precoding: bool = False
    group_seq_hopping: str = "neither"  # DFT-s-OFDM DMRS u/v hopping
                                        # ('neither'|'enable'|'disable')
    prb_start: int = 0               # allocation offset within the BWP
    n_bwp_prb: int | None = None     # carrier/BWP width (defaults to n_prb)
    decoder_backend: str = "xla"     # 'xla' | 'triton' (coding/backend.py)
    llr_quant_bits: int = 0          # 0 = float; 8 = int8 reference parity
    chest_window: int = 8            # pilot smoothing window (filt16a analog)
    chest_mode: str = "window"       # 'window' | 'delay' (delay-domain denoise)
    ptrs: bool = False               # phase-tracking RS (TS 38.211 §6.4.1.2)
    ptrs_k: int = 2                  # K_PTRS: one SC every K PRBs
    ptrs_l: int = 1                  # L_PTRS time density (1/2/4)
    ptrs_re_offset: int = 0
    dmrs_max_len: int = 1            # 2 = double-symbol DMRS (ports 0..7);
                                     # dmrs_symbols then lists consecutive pairs
    dmrs_port0: int = 0              # first DMRS port (2nd codeword offset)
    cdm_groups_no_data: int = 2      # DMRS CDM groups without data (38.212
                                     # 6.2.2): 2 = DMRS symbols carry no
                                     # data; 1 = data on the odd comb of
                                     # each DMRS symbol (type-1 group 1)
    scrambling_q: int = 0            # codeword index q (38.211 6.3.1.1/7.3.1.1)
    tbs_lbrm: int | None = None      # LBRM reference TBS (38.212 5.4.2.1):
                                     # limits the circular buffer to
                                     # Ncb = min(N, floor(TBS_LBRM/(C*2/3)))
    receiver: str = "linear"         # 'linear' (MRC/MMSE/ZF) | 'ml':
                                     # 2-layer joint max-log ML detection
                                     # (rho-aware, phy/ml_detector.py —
                                     # nr_ulsch_qpsk_qpsk analog)
    rm_res: tuple = ()               # rate-match pattern: ((symbol, sc),
                                     # ...) REs excluded from data, sc
                                     # relative to the allocation start —
                                     # e.g. CSI-RS REs overlapping a PDSCH
                                     # (38.214 §5.1.4.2 rateMatchPattern /
                                     # the pdsch PDU patterns in
                                     # nfapi_nr_interface_scf.h)

    @property
    def bwp_prbs(self) -> int:
        return self.n_bwp_prb if self.n_bwp_prb is not None else self.n_prb

    @property
    def sc0(self) -> int:
        """First subcarrier of the allocation within the BWP grid."""
        return 12 * self.prb_start

    @property
    def fp(self) -> FrameParams:
        return make_frame_params(self.mu, self.bwp_prbs)

    @property
    def qm_rate(self):
        return mcs_to_qm_rate(self.mcs, self.mcs_table)

    @property
    def data_symbols(self) -> tuple:
        return tuple(
            s for s in range(self.start_symbol, self.start_symbol + self.n_symbols)
            if s not in self.dmrs_symbols
        )

    @property
    def ptrs_symbol_flags(self) -> tuple:
        """Per-data-symbol flag: carries PTRS.

        TS 38.211 Table 6.4.1.2.2.1-1: PTRS every L_PTRS symbols, with the
        counter RESTARTING at each DMRS symbol (the DMRS provides the phase
        reference at its own position, so the next PTRS is L_PTRS after it).
        """
        if not self.ptrs:
            return tuple(False for _ in self.data_symbols)
        flags = []
        l_ref = self.start_symbol
        for s in range(self.start_symbol, self.start_symbol + self.n_symbols):
            if s in self.dmrs_symbols:
                l_ref = s
                continue
            flags.append((s - l_ref) % self.ptrs_l == 0)
        return tuple(flags)

    def ptrs_rel_sc(self) -> np.ndarray:
        """PTRS subcarriers relative to the allocation start."""
        return refsig.ptrs_sc_indices(self.n_prb, self.ptrs_k, self.ptrs_re_offset)

    @property
    def uses_re_map(self) -> bool:
        """True when data REs are a non-rectangular gather (PTRS holes,
        data on the free comb of DMRS symbols, or a rate-match pattern)."""
        return self.ptrs or self.cdm_groups_no_data == 1 or bool(self.rm_res)

    def data_re_map(self):
        """(symbol_ids, sc_ids) of data REs in mapping order (increasing
        symbol then subcarrier), excluding PTRS REs — PUSCH data is
        rate-matched around PTRS (TS 38.211 §6.4.1.2.2) — and, with
        cdm_groups_no_data == 1, including the odd (CDM group 1) comb of
        each DMRS symbol (38.211 §6.4.1.1.3 type 1)."""
        M = 12 * self.n_prb
        ptrs_sc = set(self.ptrs_rel_sc().tolist()) if self.ptrs else set()
        flag_by_sym = dict(zip(self.data_symbols, self.ptrs_symbol_flags))
        rm = set((int(s), int(m)) for s, m in self.rm_res)
        sym_ids, sc_ids = [], []
        for s in range(self.start_symbol, self.start_symbol + self.n_symbols):
            if s in self.dmrs_symbols:
                if self.cdm_groups_no_data == 1:
                    for m in range(1, M, 2):
                        if (s, m) in rm:
                            continue
                        sym_ids.append(s)
                        sc_ids.append(m)
                continue
            for m in range(M):
                if flag_by_sym.get(s) and m in ptrs_sc:
                    continue
                if (s, m) in rm:
                    continue
                sym_ids.append(s)
                sc_ids.append(m)
        return np.array(sym_ids, np.int64), np.array(sc_ids, np.int64)

    @property
    def n_data_re(self) -> int:
        """Data REs total (incl. DMRS-symbol free-comb REs when only one
        CDM group is reserved, excl. rate-match-pattern REs)."""
        if self.rm_res:
            return len(self.data_re_map()[0])
        n = len(self.data_symbols) * 12 * self.n_prb
        if self.ptrs:
            n -= sum(self.ptrs_symbol_flags) * len(self.ptrs_rel_sc())
        if self.cdm_groups_no_data == 1:
            n += len(self.dmrs_symbols) * 6 * self.n_prb
        return n

    @property
    def tbs(self) -> int:
        qm, r = self.qm_rate
        dmrs_per_prb = (12 if self.cdm_groups_no_data == 2 else 6)
        return compute_tbs(qm, r * 1024, self.n_prb, self.n_symbols,
                           dmrs_per_prb * len(self.dmrs_symbols), 0,
                           self.n_layers)

    @property
    def G(self) -> int:
        return self.n_data_re * self.qm_rate[0] * self.n_layers

    def seg_params(self):
        A = self.tbs
        crc_name = "24A" if A > 3824 else "16"
        L = 24 if A > 3824 else 16
        qm, r = self.qm_rate
        bg = segmentation.base_graph_select(A, r)
        return segmentation.segment_params(A + L, bg), crc_name

    def ncb(self) -> int | None:
        """Limited circular-buffer size (LBRM, TS 38.212 §5.4.2.1) or None.

        N_ref = floor(TBS_LBRM / (C * R_LBRM)), R_LBRM = 2/3, rounded down
        to a multiple of Z so k0 stays Z-aligned (reference
        nr_rate_matching.c computes the same N_cb)."""
        if self.tbs_lbrm is None:
            return None
        p, _ = self.seg_params()
        n_ref = (3 * self.tbs_lbrm) // (2 * p.C)
        n_full = (66 if p.bg == 1 else 50) * p.Z
        return min(n_full, (n_ref // p.Z) * p.Z)

    def dmrs_pilot(self, symbol: int) -> jnp.ndarray:
        """(6*n_prb,) DMRS pilot sequence for a DMRS symbol.

        CP-OFDM: Gold-seeded QPSK (TS 38.211 §6.4.1.1.1.1).  Transform
        precoding: low-PAPR sequence r_{u,v} (§6.4.1.1.1.2) with group /
        sequence hopping from group_seq_hopping — the reference's
        nr_dmrs_rx.c / ul_ref_seq_nr.c split."""
        return jnp.asarray(self.dmrs_pilot_np(symbol))

    def dmrs_pilot_np(self, symbol: int) -> np.ndarray:
        """Host-constant pilot sequence (cinit is config-static, so the
        Gold generation runs at trace time, not as device ops)."""
        if not self.transform_precoding:
            cinit_d = refsig.dmrs_cinit(self.slot, symbol, self.n_id)
            return refsig.dmrs_sequence_np(cinit_d, 6 * self.n_prb)
        from ..phy.hopping import group_sequence_uv
        u, v = group_sequence_uv(self.n_id, self.group_seq_hopping,
                                 self.slot, hop=0, m_zc=6 * self.n_prb)
        return refsig.low_papr_sequence(u, v, 6 * self.n_prb)

    def cb_e_sizes(self, g_total: int | None = None) -> list[int]:
        """Per-code-block rate-matched lengths E_j (TS 38.212 §5.4.2.1).

        g_total overrides G when UCI is rate-matched onto the PUSCH
        (G_data = G - G_csi1 - G_csi2 [- G_ack], 38.212 §6.2.7).
        """
        p, _ = self.seg_params()
        qm = self.qm_rate[0]
        C, Nl = p.C, self.n_layers
        gp = (self.G if g_total is None else g_total) // (Nl * qm)
        gamma = gp % C
        return [Nl * qm * (gp // C) if j <= C - 1 - gamma else Nl * qm * (-(-gp // C))
                for j in range(C)]


# --------------------------------------------------------------------------
# TX
# --------------------------------------------------------------------------

def pusch_tx_grid(cfg: PuschConfig, tb_bits: jnp.ndarray, rv: int = 0,
                  uci_cfg=None, ack_bits=None, csi1_bits=None,
                  csi2_bits=None):
    """(batch, TBS) payload bits -> ((B, L, symbols, n_sc_bwp) RE grid,
    scrambled codeword bits).  Grid-level entry so the gNB slot pipeline
    can sum multiple channels before one OFDM pass.

    With uci_cfg, HARQ-ACK/CSI are bit-multiplexed into the codeword at
    distributed RE positions before scrambling (TS 38.212 §6.2.7,
    models/uci_on_pusch.py).
    """
    p, crc_name = cfg.seg_params()
    qm, _ = cfg.qm_rate
    B = tb_bits.shape[0]

    g_data = cfg.G if uci_cfg is None else uci_cfg.g_sizes(cfg)[3]
    tb_crc = crc_attach(tb_bits.astype(jnp.int8), crc_name)
    cbs = segmentation.segment_tb(tb_crc, p)            # (B, C, K)
    g = ldpc.build_graph(p.bg, p.Z)
    es = cfg.cb_e_sizes(g_data)
    n_cols = rate_matching.tx_cols_needed(g, rv, tuple(es), p.F,
                                          ncb=cfg.ncb())
    cw = ldpc.encode(g, cbs.reshape(B * p.C, p.K),
                     n_cols=n_cols).reshape(B, p.C, -1)
    codeword = rate_matching.fused_rate_match_tx(
        g, cw, rv, tuple(es), qm, p.F, ncb=cfg.ncb())   # (B, G_data)
    if uci_cfg is not None:
        from .uci_on_pusch import mux_uci_bits
        codeword = mux_uci_bits(cfg, uci_cfg, codeword, ack_bits=ack_bits,
                                csi1_bits=csi1_bits, csi2_bits=csi2_bits)
    cinit = pusch_cinit(cfg.rnti, cfg.scrambling_q, cfg.n_id)
    scrambled = scramble(codeword, cinit)
    syms = mod.modulate(scrambled, qm)                  # (B, G/qm)
    if cfg.transform_precoding:
        assert cfg.n_layers == 1, "transform precoding is single-layer (38.211)"
        from ..phy.transform_precoding import dft_spread
        syms = dft_spread(syms, 12 * cfg.n_prb)
    layers = mod.layer_map(syms, cfg.n_layers)          # (B, L, M)

    # RE grid: (B, L, symbols, n_sc_bwp); allocation offset by cfg.sc0
    fp = cfg.fp
    n_sc = fp.n_sc
    m_per_sym = 12 * cfg.n_prb
    a0 = cfg.sc0
    if cfg.uses_re_map:
        assert not cfg.transform_precoding, "PTRS defined for CP-OFDM PUSCH"
        assert uci_cfg is None, "UCI+RE-map multiplexing not combined yet"
        grid_re = jnp.zeros((B, cfg.n_layers, fp.symbols_per_slot, n_sc),
                            jnp.complex64)
        sym_ids, sc_ids = cfg.data_re_map()
        grid_re = grid_re.at[:, :, jnp.asarray(sym_ids),
                             jnp.asarray(sc_ids + a0)].set(layers)
        # PTRS pilots on layer 0 (single PTRS port), DMRS-seeded per symbol
        if cfg.ptrs:
            psc = jnp.asarray(cfg.ptrs_rel_sc() + a0)
            for i, s in enumerate(cfg.data_symbols):
                if cfg.ptrs_symbol_flags[i]:
                    cinit_p = refsig.dmrs_cinit(cfg.slot, s, cfg.n_id)
                    pilp = refsig.dmrs_sequence_np(cinit_p,
                                                   len(cfg.ptrs_rel_sc()))
                    grid_re = grid_re.at[:, 0, s, psc].set(pilp)
        # DMRS rows scattered per symbol/layer (sparse comb within the
        # data-carrying symbol; stays on the gather/scatter path)
        for si, s in enumerate(cfg.dmrs_symbols):
            pil = cfg.dmrs_pilot(s)
            for lay in range(cfg.n_layers):
                port = cfg.dmrs_port0 + lay
                if cfg.dmrs_max_len == 2:
                    wf, wt, delta = refsig.dmrs_type1_port_weights_double(port)
                    tw = complex(wt[si % 2])
                else:
                    wf, delta = refsig.dmrs_type1_port_weights(port)
                    tw = 1.0
                sc = refsig.dmrs_type1_sc_indices(cfg.n_prb, delta) + a0
                w = jnp.asarray(np.tile(wf, 3 * cfg.n_prb), dtype=jnp.complex64)
                grid_re = grid_re.at[:, lay, s, jnp.asarray(sc)].set(pil * w * tw)
        return grid_re, scrambled

    # Rectangular allocation fast path: the slot grid is stitched from
    # contiguous symbol runs with ONE concat + ONE pad — no scatters.  The
    # reference writes the grid RE-by-RE per symbol (nr_dlsch.c:56 map
    # loops); whether a scatter would be as fast on the GPU is not
    # measured (ROADMAP.md).  DMRS rows (pilots x OCC weights) are
    # config-static host constants — zero device ops to build.
    data = layers.reshape(B, cfg.n_layers, len(cfg.data_symbols), m_per_sym)
    nd = len(cfg.dmrs_symbols)
    dm = np.zeros((cfg.n_layers, nd, m_per_sym), np.complex64)
    for si, s in enumerate(cfg.dmrs_symbols):
        pil = cfg.dmrs_pilot_np(s)
        for lay in range(cfg.n_layers):
            port = cfg.dmrs_port0 + lay
            if cfg.dmrs_max_len == 2:
                wf, wt, delta = refsig.dmrs_type1_port_weights_double(port)
                tw = complex(wt[si % 2])
            else:
                wf, delta = refsig.dmrs_type1_port_weights(port)
                tw = 1.0
            sc = refsig.dmrs_type1_sc_indices(cfg.n_prb, delta)
            w = np.tile(wf, 3 * cfg.n_prb)
            dm[lay, si, sc] = pil * w * tw
    dmrs_rows = jnp.broadcast_to(jnp.asarray(dm)[None],
                                 (B, cfg.n_layers, nd, m_per_sym))
    data_set, dmrs_set = set(cfg.data_symbols), set(cfg.dmrs_symbols)
    pieces, s, di, mi = [], 0, 0, 0
    sps = fp.symbols_per_slot
    while s < sps:
        r = s + 1
        kind = ("data" if s in data_set
                else "dmrs" if s in dmrs_set else "zero")
        while r < sps and (("data" if r in data_set else
                            "dmrs" if r in dmrs_set else "zero") == kind):
            r += 1
        n = r - s
        if kind == "data":
            pieces.append(data[:, :, di: di + n])
            di += n
        elif kind == "dmrs":
            pieces.append(dmrs_rows[:, :, mi: mi + n])
            mi += n
        else:
            pieces.append(jnp.zeros((B, cfg.n_layers, n, m_per_sym),
                                    jnp.complex64))
        s = r
    alloc = pieces[0] if len(pieces) == 1 else jnp.concatenate(pieces, axis=2)
    grid_re = jnp.pad(alloc, ((0, 0), (0, 0), (0, 0),
                              (a0, n_sc - a0 - m_per_sym)))
    return grid_re, scrambled


def pusch_tx(cfg: PuschConfig, tb_bits: jnp.ndarray, rv: int = 0,
             uci_cfg=None, ack_bits=None, csi1_bits=None, csi2_bits=None):
    """(batch, TBS) payload bits -> (batch, n_tx_ant(=n_layers), samples).

    With uci_cfg, HARQ-ACK/CSI part1/part2 are multiplexed onto the
    PUSCH (models/uci_on_pusch.py).
    """
    grid_re, scrambled = pusch_tx_grid(cfg, tb_bits, rv, uci_cfg=uci_cfg,
                                       ack_bits=ack_bits, csi1_bits=csi1_bits,
                                       csi2_bits=csi2_bits)
    fp = cfg.fp
    grid = map_to_grid(fp, grid_re)
    tx = ofdm_modulate(fp, grid, cfg.slot)              # (B, L, samples)
    return tx, scrambled


# --------------------------------------------------------------------------
# RX
# --------------------------------------------------------------------------

def pusch_rx(cfg: PuschConfig, rx_samples: jnp.ndarray, rv: int = 0,
             n_iters: int = 20, harq_buffers=None, uci_cfg=None):
    """(batch, n_rx, samples) -> decoded TB + status.

    Returns dict with tb_bits (B, TBS), tb_ok (B,), cb_ok (B, C),
    llrs (B, G) and harq buffers for combining.
    """
    fp = cfg.fp
    grid = ofdm_demodulate(fp, rx_samples, cfg.slot)    # (B, R, sym, fft)
    re_grid = extract_from_grid(fp, grid)               # (B, R, sym, n_sc)
    return pusch_rx_grid(cfg, re_grid, rv=rv, n_iters=n_iters,
                         harq_buffers=harq_buffers, uci_cfg=uci_cfg)


def pusch_channel_estimate(cfg: PuschConfig, re_grid: jnp.ndarray,
                           n_ports: int | None = None):
    """LS channel estimation at the DMRS REs -> ((B, R, P, M) h, (B,) nvar).

    LS per DMRS symbol, averaged over symbols (block fading), CDM-
    separated per port (freq OCC; time OCC too when dmrs_max_len == 2),
    then frequency smoothing (the filt16a interpolation-LUT analog) and
    comb-2 interpolation.  n_ports overrides the estimated port count
    (e.g. joint estimation across two codewords' layers)."""
    m_per_sym = 12 * cfg.n_prb
    a0 = cfg.sc0
    P = cfg.n_layers if n_ports is None else n_ports
    double = cfg.dmrs_max_len == 2
    ports = list(range(cfg.dmrs_port0, cfg.dmrs_port0 + P))
    # symbol groups: pairs for double-symbol DMRS, singletons otherwise
    if double:
        assert len(cfg.dmrs_symbols) % 2 == 0, "double DMRS needs symbol pairs"
        groups = [tuple(cfg.dmrs_symbols[i: i + 2])
                  for i in range(0, len(cfg.dmrs_symbols), 2)]
    else:
        groups = [(s,) for s in cfg.dmrs_symbols]

    # The RE gather + LS multiply depend only on the CDM group delta (and
    # for double DMRS the port's time OCC), NOT on the port — compute them
    # once per (delta, symbol) and separate ALL of a delta's ports with one
    # broadcast sign combine over a port axis.  Pilots are host constants
    # (dmrs_pilot_np) and the smoothing is a cumsum moving average, so the
    # whole estimator is ~15 batched ops instead of per-port chains.
    h_by_port: dict[int, jnp.ndarray] = {}
    nvar_terms = []        # each (B, R, n_ports_of_term)
    for delta in sorted({refsig.dmrs_type1_port_weights(p % 4)[1] for p in ports}):
        g_ports = [p for p in ports
                   if refsig.dmrs_type1_port_weights(p % 4)[1] == delta]
        sc = refsig.dmrs_type1_sc_indices(cfg.n_prb, delta) + a0
        sc_t = jnp.asarray(sc)
        # per symbol-group LS at the group's comb (shared by its ports),
        # read with an index gather
        ls_syms = []
        for grp in groups:
            ls_t = []
            for s in grp:
                pil = jnp.asarray(cfg.dmrs_pilot_np(s))
                yp = re_grid[:, :, s, :][..., sc_t]          # (B, R, n_p)
                ls_t.append(ce.ls_estimate(yp, pil))
            ls_syms.append(ls_t)
        if not double and (P > 1 or len(g_ports) > 1):
            # vectorized CDM separation: ports differ only by the freq-OCC
            # sign on odd pilots -> one broadcast over a port axis
            wf1 = jnp.asarray(np.array(
                [refsig.dmrs_type1_port_weights(p % 4)[0][1]
                 for p in g_ports], np.float32))
            ls = sum(ls_t[0] for ls_t in ls_syms) / len(ls_syms)
            even = ls[..., 0::2]
            odd = ls[..., 1::2]
            pairs = 0.5 * (even[..., None, :]
                           + wf1[:, None] * odd[..., None, :])  # (B,R,Pg,m)
            dd = pairs[..., 1:] - pairs[..., :-1]
            # pairs average len(ls_syms) DMRS symbols -> scale back to the
            # per-symbol noise variance the old per-group estimate measured
            nvar_terms.append(
                jnp.mean(jnp.abs(dd) ** 2, axis=-1) * len(ls_syms))
            hp = jnp.repeat(pairs, 2, axis=-1)
            if cfg.chest_mode == "delay":
                hp = ce.delay_domain_denoise(hp)
            elif cfg.chest_window > 1:
                hp = ce.freq_average(hp, window=cfg.chest_window)
            hs = ce.comb2_interpolate(hp, m_per_sym, delta)   # (B,R,Pg,M)
            for i, p in enumerate(g_ports):
                h_by_port[p] = hs[..., i, :]
            continue
        for p in g_ports:
            if double:
                wf, wt, _ = refsig.dmrs_type1_port_weights_double(p)
            else:
                wf, _ = refsig.dmrs_type1_port_weights(p)
                wt = np.array([1.0], np.float32)
            hp_syms = []
            for ls_t in ls_syms:
                ls = sum(l * float(wt[li]) for li, l in enumerate(ls_t)) / len(ls_t)
                if P > 1 or double:
                    # CDM separation: (even + wf[1]*odd)/2 per pilot pair;
                    # noise estimate from the separated values (raw adjacent
                    # differences would measure the other port): each pair
                    # value averages 2 pilots -> E|pair_k - pair_{k+1}|^2 = s2
                    pair = 0.5 * (ls[..., 0::2] + float(wf[1]) * ls[..., 1::2])
                    d = pair[..., 1:] - pair[..., :-1]
                    nvar_terms.append(jnp.mean(jnp.abs(d) ** 2, axis=-1)[..., None])
                    hp_syms.append(pair)
                else:
                    nvar_terms.append(ce.noise_variance(None, ls, None)[..., None])
                    hp_syms.append(ls)
            hp = sum(hp_syms) / len(hp_syms)
            if P > 1 or double:
                hp = jnp.repeat(hp, 2, axis=-1)
            if cfg.chest_mode == "delay":
                hp = ce.delay_domain_denoise(hp)
            elif cfg.chest_window > 1:
                hp = ce.freq_average(hp, window=cfg.chest_window)
            h_by_port[p] = ce.comb2_interpolate(hp, m_per_sym, delta)
    h_est = jnp.stack([h_by_port[p] for p in ports], axis=2)
    nvar = jnp.concatenate(nvar_terms, axis=-1).mean(axis=(-2, -1))  # (B,)
    return h_est, nvar


def pusch_equalize(cfg: PuschConfig, re_grid: jnp.ndarray, h_est, nvar):
    """Equalize the data REs with the estimated channel.

    Rectangular allocations -> (x (B, P, S, M), mag) per symbol block;
    RE-map allocations (PTRS holes / DMRS free-comb data) -> (x (B, P, N),
    mag) gathered per data RE (block fading: h depends on SC only)."""
    B = re_grid.shape[0]
    m_per_sym = 12 * cfg.n_prb
    a0 = cfg.sc0
    if cfg.uses_re_map:
        sym_ids, sc_ids = cfg.data_re_map()
        y = re_grid[:, :, jnp.asarray(sym_ids), jnp.asarray(sc_ids + a0)]
        h_re = h_est[..., jnp.asarray(sc_ids)]          # (B, R, P, N)
        if h_est.shape[2] == 1:
            x, mag = eq.mrc_compensate(h_re[:, :, 0, :], y)
            x, mag = x[:, None], mag[:, None]
        elif h_est.shape[2] == 2:
            x, mag = eq.mmse_equalize_2layer(h_re, y, nvar[:, None])
        else:
            x, mag = eq.zf_equalize(h_re, y, nvar[:, None, None, None])
        return x, mag
    data_syms = list(cfg.data_symbols)
    y = re_grid[:, :, jnp.asarray(data_syms), a0: a0 + m_per_sym]
    h = h_est
    n_ports = h_est.shape[2]
    if n_ports == 1:
        x, mag = _mrc_over_syms(h[:, :, 0, :], y)
        if cfg.transform_precoding:
            from ..phy.transform_precoding import idft_despread
            S = x.shape[1]
            xf = x.reshape(B, S * m_per_sym)
            mf = mag.reshape(B, S * m_per_sym)
            xd, md = idft_despread(xf, mf, m_per_sym)
            x = xd.reshape(B, S, m_per_sym)
            mag = md.reshape(B, S, m_per_sym)
        x = x[:, None]                                   # (B, 1, S, n_sc)
        mag = mag[:, None]
    else:
        x, mag = _mmse_over_syms(h, y, nvar)
    return x, mag


def pusch_frontend(cfg: PuschConfig, re_grid: jnp.ndarray) -> jnp.ndarray:
    """RE grid (batch, n_rx, symbols, n_sc_bwp) -> descrambled codeword
    LLRs (B, G): channel estimation, MRC/MMSE equalization, PTRS phase
    tracking, LLR computation, descrambling.  The 'inner_rx' stage of the
    reference (nr_ulsch_demodulation.c:1262), left to XLA to fuse."""
    h_est, nvar = pusch_channel_estimate(cfg, re_grid)
    if cfg.receiver == "ml":
        # 2-layer joint max-log ML detection over all symbol pairs
        # (nr_ulsch_qpsk_qpsk rho path, nr_ulsch_llr_computation.c:375)
        assert cfg.n_layers == 2 and not cfg.uses_re_map \
            and not cfg.transform_precoding, "ml receiver: 2-layer PUSCH"
        from ..phy.ml_detector import ml_llrs_2layer
        qm, _ = cfg.qm_rate
        B = re_grid.shape[0]
        m_per_sym = 12 * cfg.n_prb
        a0 = cfg.sc0
        y = re_grid[:, :, jnp.asarray(list(cfg.data_symbols)),
                    a0: a0 + m_per_sym]
        llr = ml_llrs_2layer(h_est, y, qm, nvar)    # (B, 2, S, M, qm)
        llr_cw = llr.transpose(0, 2, 3, 1, 4).reshape(B, -1)
        cinit = pusch_cinit(cfg.rnti, cfg.scrambling_q, cfg.n_id)
        llr_cw = scramble_llrs(llr_cw, cinit)
        if cfg.llr_quant_bits:
            llr_cw = llr_mod.quantize(llr_cw, bits=cfg.llr_quant_bits)
        return llr_cw
    x, mag = pusch_equalize(cfg, re_grid, h_est, nvar)
    return pusch_llrs(cfg, re_grid, x, mag, h_est)


def pusch_llrs(cfg: PuschConfig, re_grid: jnp.ndarray, x, mag,
               h_est=None) -> jnp.ndarray:
    """Compensated symbols (B, L, S, M) for THIS codeword's layers ->
    descrambled codeword LLRs (B, G) (PTRS tracking + LLR + descramble)."""
    qm, _ = cfg.qm_rate
    B = re_grid.shape[0]
    a0 = cfg.sc0
    # back to codeword order: LLRs -> layer demap.  x arrives either as
    # (B, L, S, M) symbol blocks or (B, L, N) gathered data REs (re-map).
    if cfg.ptrs:
        # common-phase-error tracking from PTRS REs
        # (nr_pusch_ptrs_processing:498 analog): per-symbol phasor from
        # MRC-combined PTRS correlation, held between PTRS symbols
        psc_rel = cfg.ptrs_rel_sc()
        psc = jnp.asarray(psc_rel + a0)
        hp = h_est[:, :, 0, :][..., jnp.asarray(psc_rel)]   # (B,R,P)
        phase_by_sym = {}
        cur = None
        for i, s in enumerate(cfg.data_symbols):
            if cfg.ptrs_symbol_flags[i]:
                cinit_p = refsig.dmrs_cinit(cfg.slot, s, cfg.n_id)
                pilp = refsig.dmrs_sequence_np(cinit_p, len(psc_rel))
                yps = re_grid[:, :, s, :][..., psc]         # (B,R,P)
                z = jnp.sum(yps * jnp.conj(hp * pilp[None, None, :]),
                            axis=(1, 2))
                cur = jnp.conj(z / jnp.maximum(jnp.abs(z), 1e-12))
            phase_by_sym[s] = cur
        # hold forward between PTRS symbols, backfill any leading gaps
        # (DMRS or pre-first-PTRS symbols take the nearest phasor — the
        # CPE is common across the slot)
        all_syms = list(range(cfg.start_symbol,
                              cfg.start_symbol + cfg.n_symbols))
        held = None
        for s in all_syms:
            if phase_by_sym.get(s) is not None:
                held = phase_by_sym[s]
            else:
                phase_by_sym[s] = held
        for s in reversed(all_syms):
            if phase_by_sym[s] is None:
                phase_by_sym[s] = held
            else:
                held = phase_by_sym[s]
        if x.ndim == 4:
            phase = jnp.stack([phase_by_sym[s] for s in cfg.data_symbols],
                              axis=1)                       # (B, S)
            x = x * phase[:, None, :, None]
        else:
            sym_ids, _ = cfg.data_re_map()
            ptab = jnp.stack([phase_by_sym[s] for s in all_syms], axis=1)
            pos = {s: i for i, s in enumerate(all_syms)}
            re_pos = np.array([pos[s] for s in sym_ids], np.int64)
            x = x * jnp.take(ptab, jnp.asarray(re_pos), axis=1)[:, None, :]
    x_f = x.reshape(B, cfg.n_layers, -1)
    mag_f = mag.reshape(B, cfg.n_layers, -1)
    llrs = llr_mod.llrs(x_f, mag_f, qm)                 # (B, L, S*M*qm)
    # modulate/layer_map sent symbol i to layer i%L, so interleave per-symbol
    # qm-bit groups across layers to restore codeword order
    llr_sym = llrs.reshape(B, cfg.n_layers, -1, qm)
    llr_cw = llr_sym.swapaxes(1, 2).reshape(B, -1)
    cinit = pusch_cinit(cfg.rnti, cfg.scrambling_q, cfg.n_id)
    llr_cw = scramble_llrs(llr_cw, cinit)
    if cfg.llr_quant_bits:
        llr_cw = llr_mod.quantize(llr_cw, bits=cfg.llr_quant_bits)
    return llr_cw


def pusch_rx_grid(cfg: PuschConfig, re_grid: jnp.ndarray, rv: int = 0,
                  n_iters: int = 20, harq_buffers=None, uci_cfg=None):
    """RX from a (batch, n_rx, symbols, n_sc_bwp) resource-element grid."""
    llr_cw = pusch_frontend(cfg, re_grid)
    return pusch_decode_codeword(cfg, llr_cw, rv=rv, n_iters=n_iters,
                                 harq_buffers=harq_buffers, uci_cfg=uci_cfg)


def pusch_decode_codeword(cfg: PuschConfig, llr_cw, rv: int = 0,
                          n_iters: int = 20, harq_buffers=None, uci_cfg=None):
    """Descrambled codeword LLRs (B, G) -> decoded TB dict (UCI demux +
    rate recovery + batched LDPC decode + CRC)."""
    p, crc_name = cfg.seg_params()
    qm, _ = cfg.qm_rate
    B = llr_cw.shape[0]

    ack_bits_out = None
    uci_out = None
    g_data = cfg.G
    if uci_cfg is not None:
        from .uci_on_pusch import decode_uci, demux_uci_llrs
        streams = demux_uci_llrs(cfg, uci_cfg, llr_cw)
        uci_out = decode_uci(cfg, uci_cfg, streams)
        ack_bits_out = uci_out.get("ack")
        llr_cw = streams["data"]
        g_data = uci_cfg.g_sizes(cfg)[3]

    # --- fused deinterleave + rate recovery (ONE scatter over the whole
    # TB) then ONE batched decode over the (B*C) dim — the reference's
    # per-CB thread jobs (C2) collapse into tensor dims, and compile time
    # stays flat in C
    g = ldpc.build_graph(p.bg, p.Z)
    es = cfg.cb_e_sizes(g_data)
    stacked = rate_matching.fused_rate_match_rx(
        g, llr_cw, rv, tuple(es), qm, p.F, harq_buffer=harq_buffers,
        ncb=cfg.ncb())
    new_harq = stacked                                  # (B, C, cols*Z)
    from ..coding.backend import decoder as ldpc_decoder
    bits_all, ok_all = ldpc_decoder(cfg.decoder_backend)(
        g, stacked.reshape(B * p.C, -1), n_iters=n_iters)
    cbs = bits_all.reshape(B, p.C, -1)                  # (B, C, K)
    cb_ok = ok_all.reshape(B, p.C)
    tb_with_crc = segmentation.desegment_tb(cbs, p)
    tb_ok = crc_ok(tb_with_crc, crc_name)
    from ..coding.crc import CRC_POLYS
    Lc = CRC_POLYS[crc_name][0]
    return {
        "tb_bits": tb_with_crc[..., :-Lc],
        "tb_ok": tb_ok,
        "cb_ok": cb_ok,
        "llrs": llr_cw,
        "harq_buffers": new_harq,
        "ack_bits": ack_bits_out,
        "uci": uci_out,
    }


def _mrc_over_syms(h, y):
    """h: (B,R,M), y: (B,R,S,M) -> broadcast MRC over symbols."""
    x = jnp.sum(jnp.conj(h)[:, :, None, :] * y, axis=1)
    mag = jnp.sum(jnp.abs(h) ** 2, axis=1)[:, None, :] * jnp.ones_like(x.real)
    return x, mag


def _mmse_over_syms(h, y, nvar):
    """h: (B,R,L,M), y: (B,R,S,M), nvar (B,) -> (B,L,S,M) compensated."""
    B, R, L, M = h.shape
    S = y.shape[2]
    # block fading: same h for every data symbol of the slot
    hflat = jnp.broadcast_to(h[:, :, None], (B, R, S, L, M)).transpose(0, 2, 1, 3, 4).reshape(B * S, R, L, M)
    yflat = y.transpose(0, 2, 1, 3).reshape(B * S, R, M)
    nv = jnp.repeat(nvar, S)[:, None]
    if L == 2:
        x, eff = eq.mmse_equalize_2layer(hflat, yflat, nv)
    else:
        x, eff = eq.zf_equalize(hflat, yflat, nv[:, 0, None, None, None])
    x = x.reshape(B, S, L, M).transpose(0, 2, 1, 3)
    eff = eff.reshape(B, S, L, M).transpose(0, 2, 1, 3)
    return x, eff
