#!/usr/bin/env python3
"""Smoke test of the gNB uplink slot path on one NVIDIA GPU.

  python chip_smoke.py          # one card: the five phases below
  python chip_smoke.py --four   # four cards: the sharded paths only

Phases (one process, in order; any failure ends the run with a non-zero
exit code and no result line):
  1. device  — a GPU, its kind and count, the JAX version, and the card's
               name and power limit from nvidia-smi;
  2. kernel  — the Triton LDPC kernel at BG1 Z=384 with 208 code blocks
               (the bench shape) and at BG2 Z=384, against the plain
               layered reference (ldpc.layered_minsum);
  3. path    — pusch_tx -> AWGN -> pusch_rx at the bench config with the
               production decoder; every TB decodes to the bits sent, and
               the frontend LLRs match the same function run on the CPU;
  4. entry   — sim.ulsim (100 MHz 3GPP point), sim.dlsim and
               runtime.softmodem through main(argv), on their pass strings;
  5. bench   — bench.py's config once, timed (no threshold).
The last line of stdout is one JSON object with the device.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import time

import numpy as np

# Phase 2: relative error allowed on the messages and totals after two
# iterations.  Kernel and reference do the same float32 operations in the
# same order (a subtraction, a min, a scale and an add per edge), so any
# difference is rounding of those few operations.
MSG_RTOL = 1e-4
# Phase 3: max |LLR difference| over max |LLR|, GPU against CPU.  Both run
# the same XLA program on the same resource grid, but the GPU sums the
# cumulative-sum smoothing over up to 3276 subcarriers and the noise
# means in another order (parallel scans and tree reductions), each worth
# up to ~n * 2^-24 relative; every matrix product runs at HIGHEST.
LLR_RTOL = 1e-3
# Phase 2: (base graph, code blocks, SNR in dB) at Z=384; 208 BG1 blocks
# are the bench shape, 8 slots of 26
KERNEL_CASES = ((1, 208, 1.5), (2, 64, 1.0))

# the ulsim 100 MHz conformance point, 3gpp-22 of sim/autotest.py, cut to
# 32 trials
ULSIM_ARGV = ["-m", "20", "-R", "273", "-u", "1", "-y", "2", "-g", "TDLA",
              "--delay-spread", "10", "-M", "2", "-I", "7", "-s", "13.1",
              "-n", "32", "--batch", "16", "-t", "70", "-D", "1",
              "--chest-window", "16", "--backend", "triton"]


def card() -> str:
    # nvidia-smi runs in a child that never imports JAX
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"FAIL: {what}")


def device(n_cards: int):
    import jax

    t0 = phase("1 device")
    devs = jax.devices()
    check(devs[0].platform == "gpu", f"no GPU: {devs[0]}")
    check(len(devs) >= n_cards, f"{n_cards} cards needed, {len(devs)} found")
    print(f"   {devs[0].device_kind} x{len(devs)}, jax {jax.__version__}")
    print(f"   card: {card()}")
    done(t0)


def noisy_codewords(g, n, snr_db, seed):
    import jax.numpy as jnp

    from openairinterface5g_tpu.coding import ldpc

    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (n, g.K)).astype(np.int8)
    cw = np.asarray(ldpc.encode(g, jnp.asarray(info))).astype(np.float32)
    sigma = 10 ** (-snr_db / 20)
    y = (1 - 2 * cw) + sigma * rng.standard_normal(cw.shape).astype(np.float32)
    llr = 2 * y / sigma ** 2
    llr[:, : 2 * g.Z] = 0                    # punctured columns
    return info, jnp.asarray(llr)


def kernel():
    import jax
    import jax.numpy as jnp

    from openairinterface5g_tpu.coding import ldpc
    from openairinterface5g_tpu.ops import ldpc_triton

    t0 = phase("2 kernel")
    for bg, n_cb, snr in KERNEL_CASES:
        g = ldpc.build_graph(bg, 384)
        info, llr = noisy_codewords(g, n_cb, snr, seed=bg)
        for n_iters in (2, 8):
            step = jax.jit(lambda x: ldpc_triton.decode_state(g, x, n_iters))
            compiled = step.lower(llr).compile()
            print(f"   BG{bg} Z=384 {n_cb} CBs, {n_iters} iterations: "
                  f"{compiled.memory_analysis()}")
            bits, ok, app, c2v = jax.block_until_ready(compiled(llr))
            ref = jax.jit(lambda x: ldpc.layered_minsum(g, x, n_iters))(llr)
            ok, ok_ref = np.asarray(ok), np.asarray(ref.ok)
            bits_ref = np.asarray(ref.app[:, : g.kc] < 0).reshape(n_cb, -1)
            e_app = float(jnp.max(jnp.abs(app - ref.app))
                          / jnp.max(jnp.abs(ref.app)))
            e_c2v = float(jnp.max(jnp.abs(c2v - ref.c2v))
                          / jnp.maximum(jnp.max(jnp.abs(ref.c2v)), 1e-30))
            n_right = int((np.asarray(bits) == info).all(1).sum())
            print(f"     ok {int(ok.sum())}/{n_cb} (reference {int(ok_ref.sum())}),"
                  f" info bits right {n_right}/{n_cb}, rel err app {e_app:.3g}"
                  f" c2v {e_c2v:.3g}")
            check(np.array_equal(ok, ok_ref), "ok flags differ")
            check(np.array_equal(np.asarray(bits)[ok_ref], bits_ref[ok_ref]),
                  "hard bits differ on blocks the reference decodes")
            if n_iters == 2:
                check(e_app <= MSG_RTOL and e_c2v <= MSG_RTOL,
                      "messages after 2 iterations differ")
            else:
                check(ok.all() and n_right == n_cb, "blocks left undecoded")
    done(t0)


def path():
    import jax
    import jax.numpy as jnp

    import bench
    from openairinterface5g_tpu.models.pusch import (pusch_frontend, pusch_rx,
                                                     pusch_tx)
    from openairinterface5g_tpu.phy.ofdm import extract_from_grid, ofdm_demodulate
    from openairinterface5g_tpu.sim.channel import (ChannelModel, add_noise,
                                                    apply_channel)

    t0 = phase("3 path")
    cfg = bench.bench_config()
    rng = np.random.default_rng(3)
    tb = jnp.asarray(rng.integers(0, 2, (bench.B, cfg.tbs)).astype(np.int8))
    model = ChannelModel("AWGN", cfg.n_layers, cfg.n_rx, cfg.fp.sample_rate)

    @jax.jit
    def air(tb, key):
        tx, _ = pusch_tx(cfg, tb)
        rx, _ = apply_channel(model, key, tx)
        return add_noise(jax.random.fold_in(key, 1), rx, 10 ** (-20.0 / 10))

    rx = air(tb, jax.random.PRNGKey(3))
    out = jax.jit(lambda r: pusch_rx(cfg, r, n_iters=bench.N_ITERS))(rx)
    n_ok = int(out["tb_ok"].sum())
    n_cb = out["cb_ok"].size
    print(f"   {cfg.n_prb} PRB MCS{cfg.mcs} {cfg.n_layers}x{cfg.n_rx}, "
          f"{bench.B} slots, {n_cb} CBs: "
          f"tb_ok {n_ok}/{bench.B}, cb_ok {int(out['cb_ok'].sum())}/{n_cb}")
    check(n_ok == bench.B, "TBs left undecoded")
    check(np.array_equal(np.asarray(out["tb_bits"]), np.asarray(tb)),
          "decoded TB bits differ from the bits sent")

    grid = jax.jit(lambda r: extract_from_grid(
        cfg.fp, ofdm_demodulate(cfg.fp, r, cfg.slot)))(rx)
    fe = jax.jit(lambda gr: pusch_frontend(cfg, gr))
    llr_gpu = np.asarray(fe(grid))
    cpu = jax.devices("cpu")[0]
    llr_cpu = np.asarray(fe(jax.device_put(np.asarray(grid), cpu)))
    err = float(np.max(np.abs(llr_gpu - llr_cpu)) / np.max(np.abs(llr_cpu)))
    print(f"   frontend LLRs {llr_gpu.shape}, GPU vs CPU max err / max |LLR| "
          f"= {err:.3g} (limit {LLR_RTOL})")
    check(err <= LLR_RTOL, "frontend LLRs differ between GPU and CPU")
    done(t0)


def entry_points():
    from openairinterface5g_tpu.runtime import softmodem
    from openairinterface5g_tpu.sim import dlsim, ulsim

    t0 = phase("4 entry points")
    for name, mod, argv, want in (
            ("sim.ulsim", ulsim, ULSIM_ARGV, "PUSCH test OK"),
            ("sim.dlsim", dlsim, ["-m", "9", "-R", "106", "-s", "6",
                                  "-n", "100"], "PDSCH test OK"),
            ("runtime.softmodem", softmodem, ["-n", "20", "-u", "2"],
             "softmodem loop OK")):
        t1 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(argv)
        text = buf.getvalue()
        tail = text.strip().splitlines()[-3:]
        print(f"   {name} {' '.join(argv)}: rc={rc} "
              f"({time.perf_counter() - t1:.1f} s)")
        for line in tail:
            print(f"     | {line}")
        check(want in text and not rc, f"{name} did not print {want!r}")
    done(t0)


def bench_once():
    import bench

    t0 = phase("5 bench")
    value = bench.slots_per_s(bench.bench_config())
    print(f"   {bench.B} slots x {bench.N_REP} steps: {value:.2f} slots/s "
          f"on {card()} (no threshold)")
    done(t0)


def four():
    import jax

    from __graft_entry__ import multichip_phases

    t0 = phase("four cards: dp, sp, dp x cb against one card")
    many = multichip_phases(jax.devices()[:4], "triton")
    one = multichip_phases(jax.devices()[:1], "triton")
    for name in many:
        m, o = many[name], one[name]
        same = all(np.array_equal(m[k], o[k])
                   for k in ("bits", "tb_ok", "cb_ok"))
        print(f"   {name}: tb_ok {int(m['tb_ok'].sum())}/{m['tb_ok'].size} "
              f"cb_ok {int(m['cb_ok'].sum())}/{m['cb_ok'].size}"
              + (f" on {m['n_devices']} cards" if "n_devices" in m else "")
              + f"; one card tb_ok {int(o['tb_ok'].sum())} "
              f"cb_ok {int(o['cb_ok'].sum())}; equal: {same}")
        check(same, f"{name}: four cards and one card disagree")
        check(m["tb_ok"].all(), f"{name}: TBs left undecoded")
    done(t0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)

    # the frontend check of phase 3 also needs the CPU backend
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    from openairinterface5g_tpu.utils.cache import enable_compile_cache

    device(4 if args.four else 1)
    enable_compile_cache()
    if args.four:
        four()
    else:
        kernel()
        path()
        entry_points()
        bench_once()
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
