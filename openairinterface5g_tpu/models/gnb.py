"""gNB per-slot pipeline: concurrent DL TX + UL RX with FAPI-shaped PDUs.

JAX analog of the reference slot machinery:
  - DL: phy_procedures_gNB_TX (openair1/SCHED_NR/phy_procedures_nr_gNB.c:157)
    driven by the DL_TTI.request contents (nfapi_nr_dl_tti_request_t) —
    here a typed SlotDlConfig of PDU dataclasses.
  - UL: phy_procedures_gNB_uespec_RX (:708) driven by UL_TTI.request —
    SlotUlConfig; results come back as indication dicts mirroring
    rx_data.indication / crc.indication / uci.indication / rach.indication
    (openair2/NR_PHY_INTERFACE/NR_IF_Module.c:432 NR_UL_indication).

All PDUs of a slot are composed on ONE resource grid, then a single
OFDM pass runs per direction — the reference's per-channel thread jobs
become grid writes that XLA fuses.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax.numpy as jnp
import numpy as np

from ..config import make_frame_params
from ..phy.ofdm import extract_from_grid, map_to_grid, ofdm_demodulate, ofdm_modulate
from .csirs import CsirsConfig
from .pbch import PbchConfig, ssb_generate
from .pdcch import DciConfig
from .pdsch import PdschConfig
from .pucch import Pucch0Config, Pucch2Config, pucch0_rx, pucch2_rx
from .pusch import PuschConfig, pusch_rx_grid, pusch_tx_grid


@dataclasses.dataclass(frozen=True)
class SsbPdu:
    cfg: PbchConfig
    prb_offset: int = 0      # lowest PRB of the 20-PRB SSB block
    start_symbol: int = 2    # first symbol in this slot (38.213 §4.1 case;
                             # see pbch.ssb_in_slot for burst placement)


@dataclasses.dataclass(frozen=True)
class PdcchPdu:
    """nfapi_nr_dl_tti_pdcch_pdu analog: one DCI in a CORESET placed at
    prb_start within the BWP (reference nr_generate_dci_top in-slot,
    phy_procedures_nr_gNB.c:214)."""
    cfg: "DciConfig"
    prb_start: int = 0


@dataclasses.dataclass(frozen=True)
class CsirsPdu:
    """nfapi_nr_dl_tti_csi_rs_pdu analog (nr_csi_rs.c in-slot TX)."""
    cfg: "CsirsConfig"
    prb_start: int = 0


@dataclasses.dataclass(frozen=True)
class SlotDlConfig:
    """DL_TTI.request analog: what to transmit this slot."""
    mu: int
    n_bwp_prb: int
    pdsch: tuple = ()        # tuple[PdschConfig] with disjoint PRB ranges
    ssb: SsbPdu | None = None
    pdcch: tuple = ()        # tuple[PdcchPdu]; payloads via dci_payloads
    csirs: tuple = ()        # tuple[CsirsPdu]
    slot: int = 0


@dataclasses.dataclass(frozen=True)
class SlotUlConfig:
    """UL_TTI.request analog: what to receive this slot."""
    mu: int
    n_bwp_prb: int
    pusch: tuple = ()        # tuple[PuschConfig]
    pucch0: tuple = ()       # tuple[(Pucch0Config, prb)]
    pucch2: tuple = ()       # tuple[(Pucch2Config, prb_start)]
    prach: tuple = ()        # tuple[PrachConfig] (occasion fed separately,
                             # rx_nr_prach_ru runs at the RU numerology)
    slot: int = 0


def gnb_dl_slot(dl: SlotDlConfig, tb_payloads: Sequence[jnp.ndarray],
                mib_payload: jnp.ndarray | None = None,
                dci_payloads: Sequence[jnp.ndarray] = (),
                rvs: Sequence[int] = ()):
    """Compose + transmit one DL slot.

    tb_payloads[i]: (B, TBS_i) bits for pdsch[i]; mib_payload: (B, 32);
    dci_payloads[i]: (B, A_i) bits for pdcch[i]; rvs[i]: redundancy
    version for pdsch[i] (HARQ retransmissions; default 0).
    Returns (samples (B, n_ant, n_samp), per-pdu scrambled bits).
    """
    fp = make_frame_params(dl.mu, dl.n_bwp_prb)
    assert dl.pdsch or dl.ssb is not None or dl.pdcch or dl.csirs
    if dl.pdsch:
        B = tb_payloads[0].shape[0]
    elif dl.pdcch:
        B = dci_payloads[0].shape[0]
    else:
        m0 = (mib_payload[0] if isinstance(mib_payload, (tuple, list))
              else mib_payload)
        B = m0.shape[0]
    n_ant = max([p.n_layers for p in dl.pdsch] or [1])
    grid_re = jnp.zeros((B, n_ant, fp.symbols_per_slot, fp.n_sc), jnp.complex64)
    debug_bits = []
    for j, (cfg, tb) in enumerate(zip(dl.pdsch, tb_payloads)):
        g, scr = pusch_tx_grid(cfg, tb, rv=(rvs[j] if j < len(rvs) else 0))
        grid_re = grid_re.at[:, : cfg.n_layers].add(g)
        debug_bits.append(scr)
    if dl.ssb is not None:
        ssbs = dl.ssb if isinstance(dl.ssb, (tuple, list)) else (dl.ssb,)
        mibs = (mib_payload if isinstance(mib_payload, (tuple, list))
                else [mib_payload] * len(ssbs))
        assert len(mibs) == len(ssbs), (
            f"mib_payload list length {len(mibs)} != number of SSB PDUs "
            f"{len(ssbs)}")
        for pdu, mib in zip(ssbs, mibs):
            tile = ssb_generate(pdu.cfg, mib)            # (B, 4, 240)
            sc0 = 12 * pdu.prb_offset
            s0 = pdu.start_symbol
            grid_re = grid_re.at[:, 0, s0: s0 + 4, sc0: sc0 + 240].add(tile)
    for pdu, payload in zip(dl.pdcch, dci_payloads):
        from .pdcch import pdcch_tx_grid
        row = pdcch_tx_grid(pdu.cfg, payload, dl.slot)   # (B, 12*cs_prb)
        sc0 = 12 * pdu.prb_start
        s0 = pdu.cfg.start_symbol
        grid_re = grid_re.at[:, 0, s0, sc0: sc0 + row.shape[-1]].add(row)
    for pdu in dl.csirs:
        from .csirs import csirs_tx_grid
        width = 12 * pdu.cfg.n_prb
        row = csirs_tx_grid(pdu.cfg, B, width)  # (B, 12*n_prb) or (B,P,..)
        sc0 = 12 * pdu.prb_start
        if row.ndim == 2:
            grid_re = grid_re.at[:, 0, pdu.cfg.symbol,
                                 sc0: sc0 + width].add(row)
        else:
            P = row.shape[1]
            grid_re = grid_re.at[:, :P, pdu.cfg.symbol,
                                 sc0: sc0 + width].add(row)
    grid = map_to_grid(fp, grid_re)
    return ofdm_modulate(fp, grid, dl.slot), debug_bits


def _extract_pucch_tile(re_grid, cfg, prb: int) -> jnp.ndarray:
    """(B, R, n_symbols, 12) PUCCH REs, following intra-slot frequency
    hopping (first floor(N/2) symbols at `prb`, rest at second_hop_prb —
    TS 38.211 §6.3.2.4.1)."""
    s0 = cfg.start_symbol
    if not getattr(cfg, "intra_slot_hopping", False):
        sc = 12 * prb
        return re_grid[:, :, s0: s0 + cfg.n_symbols, sc: sc + 12]
    n_first = cfg.n_symbols // 2
    sc1, sc2 = 12 * prb, 12 * cfg.second_hop_prb
    return jnp.concatenate([
        re_grid[:, :, s0: s0 + n_first, sc1: sc1 + 12],
        re_grid[:, :, s0 + n_first: s0 + cfg.n_symbols, sc2: sc2 + 12],
    ], axis=2)


def place_pucch_tile(grid_re, tile, cfg, prb: int):
    """Inverse of _extract_pucch_tile for UE-side slot composition:
    adds (B, n_symbols, 12) onto (B, L, symbols, n_sc) layer 0."""
    s0 = cfg.start_symbol
    if not getattr(cfg, "intra_slot_hopping", False):
        sc = 12 * prb
        return grid_re.at[:, 0, s0: s0 + cfg.n_symbols, sc: sc + 12].add(tile)
    n_first = cfg.n_symbols // 2
    sc1, sc2 = 12 * prb, 12 * cfg.second_hop_prb
    grid_re = grid_re.at[:, 0, s0: s0 + n_first, sc1: sc1 + 12].add(
        tile[:, :n_first])
    return grid_re.at[:, 0, s0 + n_first: s0 + cfg.n_symbols,
                      sc2: sc2 + 12].add(tile[:, n_first:])


def gnb_ul_slot(ul: SlotUlConfig, rx_samples: jnp.ndarray,
                n_iters: int = 12, harq=None, prach_freq=None):
    """Receive one UL slot -> indication dicts.

    rx_samples: (B, n_rx, n_samp).  Returns dict with keys:
      crc_indication: list per PUSCH pdu of (tb_ok (B,), cb_ok (B, C))
      rx_data: list per PUSCH pdu of tb_bits (B, TBS)
      uci0 / uci2: per PUCCH pdu results
      harq: new HARQ LLR buffers per pdu
    """
    fp = make_frame_params(ul.mu, ul.n_bwp_prb)
    grid = ofdm_demodulate(fp, rx_samples, ul.slot)
    re_grid = extract_from_grid(fp, grid)

    crc_ind, rx_data, new_harq = [], [], []
    for j, cfg in enumerate(ul.pusch):
        out = pusch_rx_grid(cfg, re_grid, n_iters=n_iters,
                            harq_buffers=None if harq is None else harq[j])
        crc_ind.append({"tb_ok": out["tb_ok"], "cb_ok": out["cb_ok"]})
        rx_data.append(out["tb_bits"])
        new_harq.append(out["harq_buffers"])

    uci0 = []
    for cfg0, prb in ul.pucch0:
        rx0 = _extract_pucch_tile(re_grid, cfg0, prb)
        uci, metric = pucch0_rx(cfg0, rx0)
        uci0.append({"uci": uci, "metric": metric})

    uci2 = []
    for cfg2, prb in ul.pucch2:
        sc = 12 * prb
        rx2 = re_grid[:, :, cfg2.start_symbol: cfg2.start_symbol + cfg2.n_symbols,
                      sc: sc + 12 * cfg2.n_prb]
        uci, ok = pucch2_rx(cfg2, rx2)
        uci2.append({"uci": uci, "ok": ok})

    rach = []
    if prach_freq is not None:
        from .prach import prach_rx
        for pcfg in ul.prach:
            rach.append(prach_rx(pcfg, prach_freq))

    return {
        "crc_indication": crc_ind,
        "rx_data": rx_data,
        "uci0": uci0,
        "uci2": uci2,
        "rach_indication": rach,
        "harq": new_harq,
    }
