#!/usr/bin/env python3
"""Headline benchmark: NR PUSCH gNB RX slots/s per card at 100 MHz 2x2.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", "device"}.
vs_baseline is against the real-time requirement of 2000 slots/s at
30 kHz SCS (BASELINE.md north star; the reference publishes no absolute
slots/s — real-time on commodity x86 is its operating point).

The timed region is ONE jitted lax.scan over N_REP DISTINCT
device-resident batches of B slots, whose per-step TB counts fold into
one scalar fetched at the end: every step has to run, and the host
fetches once.  Every TB must decode.  Needs a GPU; fails without one.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np

B = 8          # slots per step
N_REP = 128    # timed steps, each on its own input
N_ITERS = 8    # LDPC iterations at most


def bench_config(decoder_backend: str = "triton"):
    from openairinterface5g_tpu.models.pusch import PuschConfig

    return PuschConfig(mu=1, n_prb=273, mcs=16, n_layers=2, n_rx=2,
                       decoder_backend=decoder_backend)


def card() -> str:
    """`name, power limit` of the first GPU, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_info() -> dict:
    import jax

    d = jax.devices()[0]
    name, limit = card().rsplit(",", 1)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": name.strip(),
            "power_limit": limit.strip()}


def slots_per_s(cfg, n_rep: int = N_REP) -> float:
    """Received slots decoded per second at cfg, B slots per step."""
    import jax
    import jax.numpy as jnp

    from openairinterface5g_tpu.models.pusch import pusch_rx, pusch_tx

    rng = np.random.default_rng(0)
    tb = jnp.asarray(rng.integers(0, 2, size=(B, cfg.tbs)).astype(np.int8))

    @jax.jit
    def make_rx(t, key):
        tx, _ = pusch_tx(cfg, t)
        noise = 0.05 * (jax.random.normal(key, tx.shape)
                        + 1j * jax.random.normal(jax.random.fold_in(key, 1), tx.shape))
        return tx + 0.1 * tx[:, ::-1, :] + noise.astype(jnp.complex64)

    def stack_rx(i0):
        return jnp.stack([make_rx(tb, jax.random.PRNGKey(i0 + i))
                          for i in range(n_rep)])

    @jax.jit
    def rx_all(rxs):
        def body(c, r):
            ok = pusch_rx(cfg, r, n_iters=N_ITERS)["tb_ok"]
            return c + jnp.sum(ok.astype(jnp.int32)), ()
        c, _ = jax.lax.scan(body, jnp.int32(0), rxs)
        return c

    # warm set: compile + correctness check (every TB must decode)
    warm = jax.block_until_ready(stack_rx(0))
    n_ok = int(np.asarray(rx_all(warm)))
    assert n_ok == B * n_rep, f"bench config must decode cleanly ({n_ok})"
    del warm

    timed = jax.block_until_ready(stack_rx(n_rep))
    t0 = time.perf_counter()
    n_ok = int(np.asarray(rx_all(timed)))
    dt = time.perf_counter() - t0
    assert n_ok == B * n_rep
    return B * n_rep / dt


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU, found {jax.devices()[0]}")
    from openairinterface5g_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    value = slots_per_s(bench_config())
    print(json.dumps({
        "metric": "pusch_rx_slots_per_s_100mhz_2x2",
        "value": value,
        "unit": "slots/s/card",
        "vs_baseline": value / 2000.0,
        "device": device_info(),
    }))


if __name__ == "__main__":
    main()
