"""RU <-> L1 functional split over IF4p5-analog fronthaul (two processes).

The reference gNB can split the RU (radio + per-symbol OFDM FEP) from
the rest of L1 across hosts, exchanging frequency-domain IQ over
IF4p5 (executables/nr-ru.c:278-600, radio/ETHERNET/) — SURVEY.md C7 as
an actual PROCESS boundary, not an intra-chip shard.

Here:
  RU process ("south"): owns the radio side — UE TX chain + channel +
    noise (the ulsim air segment), then nr_fep_full's role (CP removal +
    FFT + RE extraction), int16 block-floating-point quantization, and
    one IF4p5 UDP packet per (symbol, antenna) north to L1.  For DL it
    does nr_feptx_ofdm's role: receives the L1's freq-domain slot grid,
    IFFT+CP, loops it through the channel, FEPs it back north (so the
    DL TX path crosses the split too).
  L1 process ("north"): PUSCH channel estimation -> equalize -> LLR ->
    rate recovery -> LDPC decode -> CRC, batched over received slots;
    prints the ulsim-style BLER line and "PUSCH test OK" gate.

BLER parity: the 106-PRB MCS9 AWGN point at 5 dB (nr_ulsim.misc operating
point, autotest ulsim-misc1) must pass through the int16 fronthaul
quantization — run tests/test_ru_l1_split.py or:

  python -m openairinterface5g_tpu.runtime.ru_l1_split l1 &
  python -m openairinterface5g_tpu.runtime.ru_l1_split ru
Both processes may share one GPU: main() gives each 45% of the card's
memory (XLA_PYTHON_CLIENT_MEM_FRACTION, unless already set), as a JAX
process otherwise reserves 75% and the second one fails.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..fronthaul.if4p5 import DL_FD, If4p5Link, UL_FD

N_PRB = 106
MCS = 9
SNR_DB = 5.0
N_TRIALS = 64
N_DL = 4                     # DL loopback slots (PDSCH through the split)
RU_PORT = 47201
L1_PORT = 47202


def _cfg():
    from ..models.pusch import PuschConfig
    return PuschConfig(mu=1, n_prb=N_PRB, mcs=MCS, n_layers=1, n_rx=1)


def run_ru(n_trials: int = N_TRIALS, snr_db: float = SNR_DB, log=print):
    """Radio + FEP process (south side of the split)."""
    import jax
    import jax.numpy as jnp
    from ..models.pusch import pusch_tx
    from ..phy.ofdm import (extract_from_grid, map_to_grid, ofdm_demodulate,
                            ofdm_modulate)

    cfg = _cfg()
    fp = cfg.fp
    # long timeout: the L1 batches its UL decodes before starting the DL
    # phase, so the RU may wait minutes for the first DL grid
    link = If4p5Link(RU_PORT, ("127.0.0.1", L1_PORT), timeout_s=600.0)
    rng = np.random.default_rng(7)

    @jax.jit
    def make_grid(tb, key):
        tx, _ = pusch_tx(cfg, tb)
        sig = jnp.mean(jnp.abs(tx) ** 2)
        sigma2 = sig * (fp.fft_size / fp.n_sc) * 10 ** (-snr_db / 10)
        noise = (jax.random.normal(key, tx.shape)
                 + 1j * jax.random.normal(jax.random.fold_in(key, 1),
                                          tx.shape)
                 ).astype(jnp.complex64) * jnp.sqrt(sigma2 / 2)
        rx = tx + noise
        g = extract_from_grid(fp, ofdm_demodulate(fp, rx, 0))
        return jax.lax.complex(g.real, g.imag)

    try:
        for trial in range(n_trials):
            tb = jnp.asarray(rng.integers(0, 2, (1, cfg.tbs)).astype(np.int8))
            g = np.asarray(jax.block_until_ready(
                make_grid(tb, jax.random.PRNGKey(trial))))
            link.send_grid(UL_FD, trial >> 8, trial & 0xFF, g[0])
            link.wait_ack()
            if trial % 16 == 0:
                log(f"[ru] UL slot {trial}/{n_trials} sent north")
        # DL direction: L1 sends freq-domain PDSCH grids; RU runs
        # nr_feptx_ofdm's role + air + FEP, returns them north
        @jax.jit
        def dl_roundtrip(gre, key):
            tx = ofdm_modulate(fp, map_to_grid(fp, gre), 0)
            sig = jnp.mean(jnp.abs(tx) ** 2)
            sigma2 = sig * (fp.fft_size / fp.n_sc) * 10 ** (-snr_db / 10)
            noise = (jax.random.normal(key, tx.shape)
                     + 1j * jax.random.normal(jax.random.fold_in(key, 1),
                                              tx.shape)
                     ).astype(jnp.complex64) * jnp.sqrt(sigma2 / 2)
            g = extract_from_grid(fp, ofdm_demodulate(fp, tx + noise, 0))
            return jax.lax.complex(g.real, g.imag)

        for j in range(N_DL):
            typ, frame, slot, gre = link.recv_grid(1, fp.symbols_per_slot,
                                                   fp.n_sc)
            assert typ == DL_FD
            out = np.asarray(jax.block_until_ready(dl_roundtrip(
                jnp.asarray(gre), jax.random.PRNGKey(10_000 + j))))
            link.send_grid(UL_FD, frame, slot, out)
            link.wait_ack()
        log("[ru] done")
    finally:
        link.close()


def run_l1(n_trials: int = N_TRIALS, log=print) -> bool:
    """L1 process (north side): decode + BLER gate."""
    import jax
    import jax.numpy as jnp
    from ..models.pusch import pusch_rx_grid, pusch_tx_grid
    from ..models.pdsch import PdschConfig

    cfg = _cfg()
    fp = cfg.fp
    link = If4p5Link(L1_PORT, ("127.0.0.1", RU_PORT), timeout_s=300.0)
    grids = []
    try:
        for _ in range(n_trials):
            typ, frame, slot, g = link.recv_grid(cfg.n_rx,
                                                 fp.symbols_per_slot, fp.n_sc)
            assert typ == UL_FD
            link.send_ack(frame, slot)
            grids.append(g)
        n_ok = 0
        bs = 16

        @jax.jit
        def dec(x_re, x_im):
            out = pusch_rx_grid(cfg, jax.lax.complex(x_re, x_im), n_iters=12)
            return out["tb_ok"]

        for i in range(0, n_trials, bs):
            batch = np.stack(grids[i: i + bs])
            ok = np.asarray(dec(jnp.asarray(batch.real),
                                jnp.asarray(batch.imag)))
            n_ok += int(ok.sum())
            log(f"[l1] decoded {i + len(batch)}/{n_trials}: ok so far {n_ok}")
        bler = 1 - n_ok / n_trials
        log(f"[l1] UL through IF4p5 split: BLER {bler:.6f} "
            f"({n_ok}/{n_trials})")
        ul_pass = bler == 0.0

        # DL direction: compose PDSCH freq grids, send south, decode what
        # the RU loops back over the air
        dl = PdschConfig(mu=1, n_prb=N_PRB, mcs=MCS, n_layers=1, n_rx=1)
        rng = np.random.default_rng(11)
        dl_ok = 0
        for j in range(N_DL):
            tb = jnp.asarray(rng.integers(0, 2, (1, dl.tbs)).astype(np.int8))
            gre, _ = jax.jit(lambda t: pusch_tx_grid(dl, t))(tb)
            link.send_grid(DL_FD, 0xFF, j, np.asarray(gre)[0])
            typ, frame, slot, g = link.recv_grid(1, fp.symbols_per_slot,
                                                 fp.n_sc)
            link.send_ack(frame, slot)
            out = pusch_rx_grid(dl, jnp.asarray(g[None]), n_iters=12)
            dl_ok += int(np.asarray(out["tb_ok"])[0])
        log(f"[l1] DL through IF4p5 split: {dl_ok}/{N_DL} ok")
        passed = ul_pass and dl_ok == N_DL
        log("PUSCH test OK" if passed else "PUSCH test NOK")
        return passed
    finally:
        link.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description="RU/L1 IF4p5 split")
    ap.add_argument("role", choices=["ru", "l1"])
    ap.add_argument("-n", "--n-trials", type=int, default=N_TRIALS)
    ap.add_argument("-s", "--snr", type=float, default=SNR_DB)
    args = ap.parse_args(argv)
    # two processes (both roles) share one card: see the module docstring
    os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.45")
    from ..utils.cache import enable_compile_cache
    enable_compile_cache()
    if args.role == "ru":
        run_ru(args.n_trials, args.snr)
        return 0
    return 0 if run_l1(args.n_trials) else 1


if __name__ == "__main__":
    sys.exit(main())
