"""PUSCH receive through the XLA frontend at the configurations the fused
frontend kernel used to cover: MRC, MMSE 2x2, two DMRS symbols, the
delta=1 comb, 256QAM without pilot smoothing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openairinterface5g_tpu.models import pusch
from openairinterface5g_tpu.sim.channel import add_noise

CFGS = [
    dict(n_prb=24, mcs=9, n_layers=1, n_rx=1),                  # QPSK MRC
    dict(n_prb=51, mcs=16, n_layers=1, n_rx=2, chest_window=8),  # 16QAM MRC-2
    dict(n_prb=24, mcs=16, n_layers=2, n_rx=2),                  # MMSE 2x2
    dict(n_prb=24, mcs=19, n_layers=2, n_rx=2,
         dmrs_symbols=(2, 11)),                                  # 64QAM 2-DMRS
    dict(n_prb=24, mcs=9, n_layers=2, n_rx=2, dmrs_port0=2),     # delta=1 comb
    dict(n_prb=16, mcs=26, n_layers=1, n_rx=2, chest_window=0),  # 256QAM no-avg
]


@pytest.mark.parametrize("kw", CFGS)
def test_xla_frontend_decodes(kw):
    cfg = pusch.PuschConfig(mu=1, **kw)
    rng = np.random.default_rng(3)
    tb = jnp.asarray(rng.integers(0, 2, (2, cfg.tbs)).astype(np.int8))
    grid_re, _ = pusch.pusch_tx_grid(cfg, tb)
    # a fixed random channel mixing the layers, then noise
    key = jax.random.PRNGKey(9)
    h = (jax.random.normal(key, (cfg.n_rx, cfg.n_layers))
         + 1j * jax.random.normal(jax.random.fold_in(key, 1),
                                  (cfg.n_rx, cfg.n_layers))) / np.sqrt(2)
    y = jnp.einsum("rl,blsm->brsm", h.astype(jnp.complex64), grid_re,
                   precision=jax.lax.Precision.HIGHEST)
    y = add_noise(jax.random.fold_in(key, 2), y, 1e-4)
    out = jax.jit(lambda g: pusch.pusch_rx_grid(cfg, g, n_iters=8))(y)
    assert out["llrs"].shape == (2, cfg.G)
    assert bool(np.asarray(out["tb_ok"]).all())
    np.testing.assert_array_equal(np.asarray(out["tb_bits"]), np.asarray(tb))
