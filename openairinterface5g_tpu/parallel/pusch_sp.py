"""Subcarrier-block-sharded PUSCH RX (the C7 fronthaul-split analog).

The reference splits RU from L1 across hosts over IF4p5 fronthaul
(frequency-domain IQ per antenna, SURVEY.md C7).  Here the
resource grid's subcarrier dim is sharded over the mesh's `sp` axis —
each device owns a PRB block, runs channel estimation / equalization /
LLR locally, exchanges a one-pilot halo with its neighbours (a
ppermute — the overlap-save boundary; the CP makes symbol boundaries
clean so only the frequency dim needs halo), then all-gathers LLR
blocks and decodes its share of the code blocks.

Supports 1-layer MRC and 2-layer MMSE (CDM-group-0 port separation is
local to a device because pilot pairs never straddle a PRB-block
boundary; the per-RE equalizer is local; noise variance is a pmean over
the mesh axis — a second collective besides the halo/all-gather).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..coding import ldpc, rate_matching
from ..coding.crc import crc_ok
from ..coding.segmentation import desegment_tb
from ..models.pusch import PuschConfig
from ..phy import refsig
from ..phy.channel_estimation import ls_estimate
from ..phy.llr import llrs as llr_compute
from ..phy.scrambling import pusch_cinit, scramble_llrs


def pusch_rx_subcarrier_sharded(mesh: Mesh, cfg: PuschConfig,
                                re_grid: jnp.ndarray, n_iters: int = 10,
                                axis: str = "sp"):
    """(B, n_rx, symbols, n_sc) grid (replicated) -> decoded TB.

    Requires cfg.n_layers in (1, 2) and n_prb divisible by the axis size.
    Subcarriers are sharded inside the shard_map; the input may be fully
    replicated (the realistic deployment would produce each block on the
    device that owns the corresponding fronthaul stream).
    """
    assert cfg.n_layers in (1, 2), "sp path: MRC (1L) or MMSE (2L)"
    n_dev = mesh.shape[axis]
    m_per_sym = 12 * cfg.n_prb
    assert cfg.n_prb % n_dev == 0
    blk = m_per_sym // n_dev          # subcarriers per device
    pblk = 6 * cfg.n_prb // n_dev     # pilots per device
    B = re_grid.shape[0]
    s_dmrs = cfg.dmrs_symbols[0]
    data_syms = list(cfg.data_symbols)
    qm, _ = cfg.qm_rate
    p, crc_name = cfg.seg_params()
    g = ldpc.build_graph(p.bg, p.Z)

    cinit_d = refsig.dmrs_cinit(cfg.slot, s_dmrs, cfg.n_id)
    pil_full = refsig.dmrs_sequence(cinit_d, 6 * cfg.n_prb)

    L = cfg.n_layers

    def block_fn(grid_blk, pil_blk):
        """Per-device: (B, R, sym, blk) subcarrier block ->
        (B, S, blk*L*qm) LLRs in codeword-local order."""
        idx = jax.lax.axis_index(axis)
        yp = grid_blk[:, :, s_dmrs, ::2]           # comb-2 pilots (delta 0)
        ls = ls_estimate(yp, pil_blk[0])
        y = grid_blk[:, :, jnp.asarray(data_syms), :]
        if L == 1:
            hp = ls
            # halo exchange: neighbour's edge pilot for boundary interp
            right_edge = jax.lax.ppermute(hp[..., :1], axis,
                                          [(i, (i - 1) % n_dev) for i in range(n_dev)])
            # interpolate comb-2 within the block, using the halo at the seam
            right = jnp.concatenate([hp[..., 1:], right_edge], axis=-1)
            mid = 0.5 * (hp + right)
            # last device's final midpoint has no right neighbour: hold
            is_last = idx == n_dev - 1
            mid = jnp.where(is_last, mid.at[..., -1].set(hp[..., -1]), mid)
            h = jnp.stack([hp, mid], axis=-1).reshape(*hp.shape[:-1], 2 * hp.shape[-1])
            # MRC per data symbol
            x = jnp.sum(jnp.conj(h)[:, :, None, :] * y, axis=1)
            mag = jnp.broadcast_to(jnp.sum(jnp.abs(h) ** 2, axis=1)[:, None, :], x.shape)
            return llr_compute(x, mag.real, qm)     # (B, S, blk*qm)
        # 2-layer: CDM group 0 freq-OCC separation on local pilot pairs
        # (ports 0/1: wf = [+,+]/[+,-]; pairs are block-local)
        even, odd = ls[..., 0::2], ls[..., 1::2]
        hc = jnp.stack([0.5 * (even + odd), 0.5 * (even - odd)], axis=2)
        # noise variance from pair-difference residuals, pmean over the
        # mesh axis for a globally consistent MMSE regularizer
        dd = hc[..., 1:] - hc[..., :-1]
        nvar = jax.lax.pmean(jnp.mean(jnp.abs(dd) ** 2, axis=(1, 2, 3)),
                             axis)                  # (B,)
        # interpolate pair centers -> per-SC with right-neighbour halo
        nxt = jax.lax.ppermute(hc[..., :1], axis,
                               [(i, (i - 1) % n_dev) for i in range(n_dev)])
        right = jnp.concatenate([hc[..., 1:], nxt], axis=-1)
        is_last = idx == n_dev - 1
        right = jnp.where(is_last,
                          right.at[..., -1].set(hc[..., -1]), right)
        mid = 0.5 * (hc + right)
        h4 = jnp.stack([hc, hc, mid, mid], axis=-1)  # nearest/lerp mix
        h = h4.reshape(*hc.shape[:-1], 4 * hc.shape[-1])  # (B, R, 2, blk)
        from ..models.pusch import _mmse_over_syms
        x, mag = _mmse_over_syms(h, y, nvar)         # (B, 2, S, blk)
        lv = llr_compute(x, mag, qm)                 # (B, 2, S*blk*qm)
        # codeword-local order per (symbol, sc): layer-major qm groups
        lv = lv.reshape(B, 2, len(data_syms), -1, qm)
        return lv.transpose(0, 2, 3, 1, 4).reshape(B, len(data_syms), -1)

    es = cfg.cb_e_sizes()
    offs = np.concatenate([[0], np.cumsum(es)])
    n_cb_per_dev = -(-p.C // n_dev)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, None, None, axis), P(None, axis)),
        out_specs=(P(None, axis), P(None, axis)),
        check_vma=False)
    def _run(grid_blk, pil_blk):
        idx = jax.lax.axis_index(axis)
        llr_blk = block_fn(grid_blk, pil_blk)       # (B, S, blk*qm)
        # gather full-band LLRs (LLR exchange, SURVEY §5)
        llr_all = jax.lax.all_gather(llr_blk, axis, axis=3, tiled=False)
        # (B, S, n_dev, blk*qm) -> frequency order (B, S, m*qm) -> codeword
        llr_full = jnp.moveaxis(llr_all, 3, 2).reshape(B, len(data_syms), -1)
        llr_cw = llr_full.reshape(B, -1)
        llr_cw = scramble_llrs(llr_cw, pusch_cinit(cfg.rnti, 0, cfg.n_id))
        # decode this device's share of the code blocks
        fulls = []
        for j in range(p.C):
            f = llr_cw[:, int(offs[j]): int(offs[j + 1])]
            e = rate_matching.deinterleave_rx(f, qm)
            fulls.append(rate_matching.rate_match_rx(g, e, 0, p.F))
        stacked = jnp.stack(fulls, axis=1)          # (B, C, N)
        # pad C to n_dev * n_cb_per_dev and slice this device's chunk
        Cp = n_dev * n_cb_per_dev
        if Cp != p.C:
            pad = jnp.zeros((B, Cp - p.C, stacked.shape[-1]), stacked.dtype)
            stacked = jnp.concatenate([stacked, pad], axis=1)
        mine = jax.lax.dynamic_slice_in_dim(stacked, idx * n_cb_per_dev,
                                            n_cb_per_dev, axis=1)
        bits, ok, _ = ldpc.decode(g, mine.reshape(B * n_cb_per_dev, -1),
                                  n_iters=n_iters, early_stop=False)
        bits = bits.reshape(B, n_cb_per_dev, -1)
        ok = ok.reshape(B, n_cb_per_dev)
        return bits, ok

    pil_shard = jnp.broadcast_to(pil_full[None], (1, 6 * cfg.n_prb))
    bits_sh, ok_sh = jax.jit(_run)(re_grid, pil_shard)
    # (B, n_dev*n_cb_per_dev, K) device-major == CB order; drop padding
    bits = bits_sh[:, : p.C]
    ok = ok_sh[:, : p.C]
    tb = desegment_tb(bits, p)
    return {"tb_bits": tb[..., :-(24 if crc_name == '24A' else 16)],
            "tb_ok": crc_ok(tb, crc_name), "cb_ok": ok}
