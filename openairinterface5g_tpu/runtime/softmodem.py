"""nr-softmodem-style continuous slot loop (phytest / noS1 mode analog).

Mirrors the reference's gNB real-time loop (executables/nr-softmodem.c
-> ru_thread -> L1 rx/tx threads, SURVEY.md §3.1) at simulation level:
a MAC-lite scheduler drives per-slot UL processing over a stream of
slots, UEs transmit through the channel simulator, CRC indications feed
HARQ back — with the async dispatch depth standing in for the reference
thread pipeline, and per-slot timing collected like rt_L1_profiling.

Usage: python -m openairinterface5g_tpu.runtime.softmodem -n 20 -u 2
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="continuous multi-slot gNB loop")
    ap.add_argument("-n", "--n-slots", type=int, default=20)
    ap.add_argument("-u", "--n-ues", type=int, default=2)
    ap.add_argument("-m", "--mcs", type=int, default=9)
    ap.add_argument("-P", "--prb-per-ue", type=int, default=24)
    ap.add_argument("-s", "--snr-db", type=float, default=14.0)
    ap.add_argument("-I", "--n-iters", type=int, default=10)
    ap.add_argument("--backend", type=str, default="xla", choices=["xla", "triton"])
    ap.add_argument("--tdd", type=str, default=None,
                    help="TDD pattern 'dlSlots,dlSyms,ulSlots,ulSyms"
                         "[,period_ms]' (tdd-UL-DL-ConfigCommon analog); "
                         "default: FDD (all slots UL in this UL-RX loop)")
    args = ap.parse_args(argv)

    from ..utils.cache import enable_compile_cache
    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from ..models.gnb import gnb_ul_slot
    from ..models.pusch import PuschConfig, pusch_tx
    from ..runtime.executor import SlotExecutor
    from ..runtime.scheduler import PhytestScheduler
    from ..runtime.tdd import TddConfig
    from ..sim.channel import add_noise

    bwp = args.prb_per_ue * args.n_ues
    ues = [
        PuschConfig(mu=1, n_prb=args.prb_per_ue, prb_start=i * args.prb_per_ue,
                    n_bwp_prb=bwp, mcs=args.mcs, rnti=0x1000 + i,
                    decoder_backend=args.backend)
        for i in range(args.n_ues)
    ]
    sched = PhytestScheduler(ues)
    tbs = ues[0].tbs
    tdd = TddConfig.from_string(args.tdd) if args.tdd else None
    print(f"softmodem loop: {args.n_ues} UEs x {args.prb_per_ue} PRB MCS {args.mcs} "
          f"TBS {tbs} @ {args.snr_db} dB, backend={args.backend}"
          + (f", TDD pattern {tdd.pattern()}" if tdd else ", FDD"))

    @jax.jit
    def ul_slot_fn(key, tbs_bits, snr_db):
        # all UEs transmit (superimposed on the shared band) + AWGN
        txs = []
        for i, ue in enumerate(ues):
            tx, _ = pusch_tx(ue, tbs_bits[i][None])
            txs.append(tx)
        rx = sum(txs)
        sig = jnp.mean(jnp.sum(jnp.abs(rx) ** 2, axis=-2)) / args.n_ues
        sigma2 = sig * (ues[0].fp.fft_size / ues[0].fp.n_sc) * 10 ** (-snr_db / 10)
        rx = add_noise(key, rx, sigma2)
        ul, _ = sched.schedule_slot(0)
        out = gnb_ul_slot(ul, rx, n_iters=args.n_iters)
        return [c["tb_ok"][0] for c in out["crc_indication"]]

    # DL TX slot: compose every UE's PDSCH on one grid + OFDM (TDD D
    # slots; phy_procedures_gNB_TX analog — the DL allocations mirror
    # the UL ones)
    from ..models.gnb import SlotDlConfig, gnb_dl_slot
    from ..models.pdsch import PdschConfig
    dl_cfgs = tuple(
        PdschConfig(mu=1, n_prb=args.prb_per_ue, prb_start=i * args.prb_per_ue,
                    n_bwp_prb=bwp, mcs=args.mcs, rnti=0x1000 + i)
        for i in range(args.n_ues))
    dl_tbs = dl_cfgs[0].tbs

    @jax.jit
    def dl_slot_fn(tbs_bits):
        dl = SlotDlConfig(mu=1, n_bwp_prb=bwp, pdsch=dl_cfgs)
        tx, _ = gnb_dl_slot(dl, [b[None] for b in tbs_bits])
        return jnp.sum(jnp.abs(tx))        # materialize the waveform

    rng = np.random.default_rng(0)
    slot_dur = 0.001 / (1 << 1)            # mu=1: 500 us
    kinds = [(tdd.slot_type(s) if tdd else "U") for s in range(args.n_slots)]

    def dispatch(i, kind, *a):
        return ul_slot_fn(*a) if kind == "U" else \
            (dl_slot_fn(*a) if kind == "D" else jnp.float32(0.0))

    ex = SlotExecutor(dispatch, depth=2, slot_duration_s=slot_dur)
    inputs = []
    for s, kind in enumerate(kinds):
        if kind == "U":
            tb = [jnp.asarray(rng.integers(0, 2, (tbs,)).astype(np.int8))
                  for _ in range(args.n_ues)]
            inputs.append((kind, jax.random.PRNGKey(s), tb,
                           jnp.float32(args.snr_db)))
        elif kind == "D":
            tb = [jnp.asarray(rng.integers(0, 2, (dl_tbs,)).astype(np.int8))
                  for _ in range(args.n_ues)]
            inputs.append((kind, tb))
        else:
            inputs.append((kind,))

    t0 = time.time()
    results = ex.run(inputs)
    wall = time.time() - t0
    n_ok = 0
    n_ul = kinds.count("U")
    n_dl = kinds.count("D")
    dl_bits = n_dl * args.n_ues * dl_tbs
    for kind, oks in zip(kinds, results):
        if kind != "U":
            continue
        for i, ok in enumerate(oks):
            ok_b = bool(ok)
            sched.handle_crc_indication(i, ok_b)
            n_ok += ok_b
    total = n_ul * args.n_ues
    thr = n_ok * tbs / wall / 1e6
    print(ex.report())
    print(f"slots/s: {args.n_slots / wall:.1f}  "
          f"[{n_dl} DL / {kinds.count('S')} S / {n_ul} UL]  "
          f"UL TB ok: {n_ok}/{total}  UL MAC throughput: {thr:.1f} Mb/s  "
          f"DL TX: {dl_bits / wall / 1e6:.1f} Mb/s")
    for st in sched.stats():
        print(f"  rnti 0x{st['rnti']:04x}: acked {st['acked']} nacked {st['nacked']}")
    print("softmodem loop OK" if n_ok == total else "softmodem loop DEGRADED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
