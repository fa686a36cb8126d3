"""nr_dlsim equivalent: PDSCH BLER/throughput simulator.

Mirrors openair1/SIMULATION/NR_PHY/dlsim.c (gNB TX -> channel -> UE RX
-> "PDSCH test OK") with the Monte-Carlo batch as one jitted program.

Usage: python -m openairinterface5g_tpu.sim.dlsim -m 9 -R 106 -s 5 -n 100
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .ulsim import run_sweep


def main(argv=None):
    ap = argparse.ArgumentParser(description="PDSCH BLER simulator (nr_dlsim analog)")
    ap.add_argument("-m", "--mcs", type=int, default=9)
    ap.add_argument("-R", "--n-prb", type=int, default=106)
    ap.add_argument("-q", "--mcs-table", type=int, default=1)
    ap.add_argument("-s", "--snr0", type=float, default=5.0)
    ap.add_argument("-S", "--snr1", type=float, default=None)
    ap.add_argument("--snr-step", type=float, default=1.0)
    ap.add_argument("-n", "--n-trials", type=int, default=100)
    ap.add_argument("-b", "--batch", type=int, default=None)
    ap.add_argument("-u", "--mu", type=int, default=1)
    ap.add_argument("-W", "--n-layers", type=int, default=1)
    ap.add_argument("-y", "--n-rx", type=int, default=1)
    ap.add_argument("-g", "--channel", type=str, default="AWGN",
                    choices=["AWGN", "TDLA", "TDLB", "TDLC", "EPA", "EVA", "ETU"])
    ap.add_argument("-M", "--max-rounds", type=int, default=1)
    ap.add_argument("--delay-spread", type=float, default=30.0, help="TDL delay spread (ns)")
    ap.add_argument("-D", "--dmrs-add-pos", type=int, default=0, choices=[0, 1],
                    help="additional DMRS position (0: single at sym 2; 1: add sym 11)")
    ap.add_argument("--chest-window", type=int, default=8)
    ap.add_argument("-I", "--n-iters", type=int, default=20)
    ap.add_argument("-t", "--eff-tp-check", type=float, default=70.0)
    ap.add_argument("--backend", type=str, default="xla", choices=["xla", "triton"])
    ap.add_argument("--csirs", action="store_true",
                    help="schedule a CSI-RS inside the PDSCH allocation "
                         "and rate-match the PDSCH around it "
                         "(gNB_scheduler_dlsch.c:62 sched_csirs analog)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from ..utils.cache import enable_compile_cache
    enable_compile_cache()

    from ..models.pdsch import PdschConfig

    rm_kw = {}
    csirs_cfg = None
    if args.csirs:
        from ..models.csirs import CsirsConfig, csirs_rm_pattern
        csirs_cfg = CsirsConfig(n_prb=args.n_prb, symbol=6, re_offset=0)
        probe = PdschConfig(mu=args.mu, n_prb=args.n_prb, mcs=args.mcs)
        rm_kw = dict(rm_res=csirs_rm_pattern(csirs_cfg, 0, probe))
    cfg = PdschConfig(mu=args.mu, n_prb=args.n_prb, mcs=args.mcs,
                      mcs_table=args.mcs_table, n_layers=args.n_layers,
                      n_rx=args.n_rx, decoder_backend=args.backend,
                      dmrs_symbols=(2, 11) if args.dmrs_add_pos else (2,),
                      chest_window=args.chest_window, **rm_kw)
    p, _ = cfg.seg_params()
    print(f"PDSCH sim: {args.n_prb} PRB mu={args.mu} MCS {args.mcs} "
          f"(Qm={cfg.qm_rate[0]} R={cfg.qm_rate[1]:.3f}) {args.n_layers}x{args.n_rx} "
          f"TBS {cfg.tbs} C={p.C} Z={p.Z} channel={args.channel}")
    # reference default sweep window (ulsim.c:538 analog)
    snr1 = args.snr1 if args.snr1 is not None else args.snr0 + 10.0
    snrs = np.arange(args.snr0, snr1 + 1e-9, args.snr_step)
    batch = args.batch or max(1, min(64, args.n_trials))
    results, ok = run_sweep(cfg, snrs, args.n_trials, batch,
                            max_rounds=args.max_rounds, n_iters=args.n_iters,
                            channel=args.channel, eff_tp_check=args.eff_tp_check,
                            delay_spread_ns=args.delay_spread,
                            csirs_cfg=csirs_cfg)
    if args.json:
        print(json.dumps(results))
    print("PDSCH test OK" if ok else "PDSCH test NOK")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
