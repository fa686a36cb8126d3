"""2-layer joint-LLR ML receiver (rho-aware) vs linear MMSE.

Reference: nr_ulsch_qpsk_qpsk + the rho cross-correlation path
(nr_ulsch_llr_computation.c:375, nr_ulsch_demodulation.c:1301)."""
import jax
import jax.numpy as jnp
import numpy as np

from openairinterface5g_tpu.models.pusch import (PuschConfig, pusch_rx,
                                                 pusch_tx)
from openairinterface5g_tpu.phy.ml_detector import ml_llrs_2layer
from openairinterface5g_tpu.sim.channel import (ChannelModel, add_noise,
                                                apply_channel)


def test_ml_detector_matches_exhaustive():
    """The tensorized pair-metric equals brute-force ||y - Hs||^2 LLRs."""
    rng = np.random.default_rng(0)
    B, R, M, S = 2, 2, 6, 3
    qm = 2
    h = jnp.asarray((rng.normal(size=(B, R, 2, M))
                     + 1j * rng.normal(size=(B, R, 2, M))
                     ).astype(np.complex64))
    y = jnp.asarray((rng.normal(size=(B, R, S, M))
                     + 1j * rng.normal(size=(B, R, S, M))
                     ).astype(np.complex64))
    nvar = jnp.ones((B,), jnp.float32)
    llr = np.asarray(ml_llrs_2layer(h, y, qm, nvar))

    from openairinterface5g_tpu.phy.modulation import constellation
    tab = constellation(qm)
    hn, yn = np.asarray(h), np.asarray(y)
    for b in range(B):
        for s in range(S):
            for m in range(M):
                D = np.empty((4, 4))
                for i in range(4):
                    for j in range(4):
                        x = hn[b, :, 0, m] * tab[i] + hn[b, :, 1, m] * tab[j]
                        D[i, j] = np.sum(np.abs(yn[b, :, s, m] - x) ** 2)
                for k in range(qm):
                    b0 = ((np.arange(4) >> (qm - 1 - k)) & 1).astype(bool)
                    want = (D[b0].min() - D[~b0].min())
                    got = llr[b, 0, s, m, k]
                    assert abs(got - want) < 1e-3, (b, s, m, k, got, want)


def test_ml_beats_mmse_2layer_tdl():
    """At the 2-layer TDL operating region the ML receiver recovers
    clearly more TBs than linear MMSE at the same SNR."""
    B = 16
    base = dict(mu=1, n_prb=24, mcs=9, n_layers=2, n_rx=2)
    cfg_l = PuschConfig(**base)
    cfg_m = PuschConfig(receiver="ml", **base)
    model = ChannelModel("TDLA", 2, 2, cfg_l.fp.sample_rate,
                         delay_spread_ns=100.0)
    rng = np.random.default_rng(0)
    tb = jnp.asarray(rng.integers(0, 2, (B, cfg_l.tbs)).astype(np.int8))

    @jax.jit
    def run(key):
        tx, _ = pusch_tx(cfg_l, tb)
        k1, k2 = jax.random.split(key)
        rx, _ = apply_channel(model, k1, tx)
        sig = jnp.mean(jnp.sum(jnp.abs(tx) ** 2, axis=-2)) / 2
        s2 = sig * (cfg_l.fp.fft_size / cfg_l.fp.n_sc) * 10 ** (-8.0 / 10)
        rx = add_noise(k2, rx, s2)
        ok_l = pusch_rx(cfg_l, rx, n_iters=12)["tb_ok"]
        ok_m = pusch_rx(cfg_m, rx, n_iters=12)["tb_ok"]
        return ok_l, ok_m

    nl = nm = 0
    for i in range(3):
        ol, om = run(jax.random.PRNGKey(100 * i))
        nl += int(np.asarray(ol).sum())
        nm += int(np.asarray(om).sum())
    assert nm > nl + 8, (nm, nl)
    assert nm >= int(0.9 * 3 * B), (nm, nl)
