"""Channel simulator: AWGN + tapped-delay-line fading (SIMULATION/TOOLS analog).

Models mirror the reference's channel library (openair1/SIMULATION/TOOLS/
random_channel.c:561 new_channel_desc_scm, multipath_channel.c:176,
channel_sim.c add_noise): AWGN, TDL-A/B/C (TS 38.901 Table 7.7.2), and
simple EPA/EVA/ETU-style power-delay profiles.  The FIR convolution is a
batched time-domain conv (or per-trial random taps) entirely on device;
the Monte-Carlo trial dim is a leading batch axis so a whole BLER point
is one program.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

# Normalized power-delay profiles: (delays in ns @ normal delay spread, power dB)
# TS 38.901 Table 7.7.2-1..3 (TDL-A/B/C, normalized unit delay spread —
# scaled by the DS parameter at build time).
TDL_PROFILES = {
    "TDLA": (
        np.array([0.0000, 0.3819, 0.4025, 0.5868, 0.4610, 0.5375, 0.6708,
                  0.5750, 0.7618, 1.5375, 1.8978, 2.2242, 2.1718, 2.4942,
                  2.5119, 3.0582, 4.0810, 4.4579, 4.5695, 4.7966, 5.0066,
                  5.3043, 9.6586]),
        np.array([-13.4, 0.0, -2.2, -4.0, -6.0, -8.2, -9.9, -10.5, -7.5,
                  -15.9, -6.6, -16.7, -12.4, -15.2, -10.8, -11.3, -12.7,
                  -16.2, -18.3, -18.9, -16.6, -19.9, -29.7]),
    ),
    "TDLB": (
        np.array([0.0000, 0.1072, 0.2155, 0.2095, 0.2870, 0.2986, 0.3752,
                  0.5055, 0.3681, 0.3697, 0.5700, 0.5283, 1.1021, 1.2756,
                  1.5474, 1.7842, 2.0169, 2.8294, 3.0219, 3.6187, 4.1067,
                  4.2790, 4.7834]),
        np.array([0.0, -2.2, -4.0, -3.2, -9.8, -1.2, -3.4, -5.2, -7.6,
                  -3.0, -8.9, -9.0, -4.8, -5.7, -7.5, -1.9, -7.6, -12.2,
                  -9.8, -11.4, -14.9, -9.2, -11.3]),
    ),
    "TDLC": (
        np.array([0.0000, 0.2099, 0.2219, 0.2329, 0.2176, 0.6366, 0.6448,
                  0.6560, 0.6584, 0.7935, 0.8213, 0.9336, 1.2285, 1.3083,
                  2.1704, 2.7105, 4.2589, 4.6003, 5.4902, 5.6077, 6.3065,
                  6.6374, 7.0427, 8.6523]),
        np.array([-4.4, -1.2, -3.5, -5.2, -2.5, 0.0, -2.2, -3.9, -7.4,
                  -7.1, -10.7, -11.1, -5.1, -6.8, -8.7, -13.2, -13.9,
                  -13.9, -15.8, -17.1, -16.0, -15.7, -21.6, -22.8]),
    ),
}


# LOS (Rician) models TDL-D/E: the first tap has a deterministic specular
# component (TS 38.901 Tables 7.7.2-4/5 split tap 1 into a LOS path and a
# Rayleigh subtap at the same delay).  Stored as (los_power_db, nlos_rows).
LOS_COMPONENT = {
    "TDLD": -0.2,
    "TDLE": -0.03,
}

TDL_PROFILES["TDLD"] = (
    np.array([0.0000, 0.0350, 0.6120, 1.3630, 1.4050, 1.8040, 2.5960,
              1.7750, 4.0420, 7.9370, 9.4240, 9.7080, 12.5250]),
    np.array([-13.5, -18.8, -21.0, -22.8, -17.9, -20.1, -21.9, -22.9,
              -27.8, -23.6, -24.8, -30.0, -27.7]),
)
TDL_PROFILES["TDLE"] = (
    np.array([0.0000, 0.5133, 0.5440, 0.5630, 0.5440, 0.7112, 1.9092,
              1.9293, 1.9589, 2.6426, 3.7136, 5.4524, 12.0034, 20.6419]),
    np.array([-22.03, -15.8, -18.1, -19.8, -22.9, -22.4, -18.6, -21.2,
              -22.8, -22.9, -25.9, -28.6, -29.8, -30.0]),
)


@dataclasses.dataclass(frozen=True)
class ChannelModel:
    """Static channel description (new_channel_desc_scm analog)."""

    name: str               # 'AWGN' | 'TDLA'..'TDLE' | 'EPA'|'EVA'|'ETU'
    n_tx: int
    n_rx: int
    sample_rate: float
    delay_spread_ns: float = 30.0   # DS scaling for TDL profiles
    max_doppler_hz: float = 0.0     # TS 38.104 G.3-1 HST Doppler trajectory
    center_freq_hz: float = 3.5e9   # carrier (sets v from max_doppler_hz)

    def tap_delays_samples(self) -> np.ndarray:
        if self.name == "AWGN":
            return np.zeros(1, dtype=np.int64)
        d_ns, _ = TDL_PROFILES[self.name]
        return np.round(d_ns * self.delay_spread_ns * 1e-9 * self.sample_rate).astype(np.int64)

    def tap_powers(self) -> np.ndarray:
        """NLOS (Rayleigh) tap powers, normalized so NLOS + LOS sums to 1."""
        if self.name == "AWGN":
            return np.ones(1)
        _, p_db = TDL_PROFILES[self.name]
        p = 10 ** (p_db / 10)
        return p / (p.sum() + self.los_power())

    def los_power(self) -> float:
        """Linear power of the deterministic specular component (0 if NLOS),
        in the same un-normalized scale as 10**(p_db/10) of the taps."""
        if self.name not in LOS_COMPONENT:
            return 0.0
        return float(10 ** (LOS_COMPONENT[self.name] / 10))

    def los_power_normalized(self) -> float:
        if self.name not in LOS_COMPONENT:
            return 0.0
        _, p_db = TDL_PROFILES[self.name]
        p = 10 ** (p_db / 10)
        return self.los_power() / (p.sum() + self.los_power())


def apply_channel(
    model: ChannelModel,
    key: jax.Array,
    tx: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Propagate (..., n_tx, n_samples) through one random channel realization.

    Returns (rx (..., n_rx, n_samples), h_taps (..., n_rx, n_tx, max_delay+1)).
    Block-fading: taps constant over the slot (multipath_channel.c analog).
    """
    lead = tx.shape[:-2]
    n_s = tx.shape[-1]
    delays = model.tap_delays_samples()
    powers = model.tap_powers()
    L = int(delays.max()) + 1
    if model.name == "AWGN":
        h = jnp.broadcast_to(
            jnp.eye(model.n_rx, model.n_tx, dtype=jnp.complex64)[..., None],
            (*lead, model.n_rx, model.n_tx, 1),
        )
        rx = jnp.einsum("...rt,...ts->...rs", h[..., 0], tx.astype(jnp.complex64),
                        precision=jax.lax.Precision.HIGHEST)
        return rx, h
    # Rayleigh taps at the given PDP
    kr, ki = jax.random.split(key)
    shape = (*lead, model.n_rx, model.n_tx, len(delays))
    g = (jax.random.normal(kr, shape) + 1j * jax.random.normal(ki, shape)) / np.sqrt(2)
    g = g * jnp.asarray(np.sqrt(powers), dtype=g.dtype)
    p_los = model.los_power_normalized()
    if p_los > 0.0:
        # Rician first tap: deterministic specular component with a random
        # phase per antenna pair (TS 38.901 7.7.2-4/5 LOS path)
        kphi = jax.random.fold_in(key, 2)
        phi = jax.random.uniform(kphi, (*lead, model.n_rx, model.n_tx),
                                 minval=0.0, maxval=2 * np.pi)
        los = np.sqrt(p_los) * jnp.exp(1j * phi)
        g = g.at[..., 0].add(los.astype(g.dtype))
    # scatter taps into a dense FIR of length L
    h = jnp.zeros((*lead, model.n_rx, model.n_tx, L), dtype=jnp.complex64)
    h = h.at[..., jnp.asarray(delays)].add(g.astype(jnp.complex64))
    # frequency-domain convolution over the slot (linear conv via zero-pad FFT)
    nfft = int(2 ** np.ceil(np.log2(n_s + L)))
    Htap = jnp.fft.fft(h, n=nfft, axis=-1)
    Xtap = jnp.fft.fft(tx.astype(jnp.complex64), n=nfft, axis=-1)
    Y = jnp.einsum("...rtf,...tf->...rf", Htap, Xtap, precision=jax.lax.Precision.HIGHEST)
    rx = jnp.fft.ifft(Y, axis=-1)[..., :n_s].astype(jnp.complex64)
    return rx, h


def doppler_phasor(model: ChannelModel, key: jax.Array, n_samples: int,
                   t0: float = 0.0) -> jnp.ndarray:
    """(n_samples,) time-varying Doppler phasor, TS 38.104 Table G.3-1.

    The reference's get_cexp_doppler (random_channel.c:460): a high-speed
    train passes the site at v = f_D*c/f_c; the instantaneous Doppler
    fs(t) = f_D*cos(theta(t)) follows the piecewise HST trajectory with
    Dmin=2 m, Ds=300 m, and the output phasor exp(j(2*pi*fs(t)*t + phi0))
    multiplies the faded signal (multipath_channel.c:235)."""
    d_min, d_s = 2.0, 300.0
    c = 299792458.0
    f_d = model.max_doppler_hz
    v = f_d * c / model.center_freq_hz
    t = t0 + jnp.arange(n_samples) / model.sample_rate
    x1 = d_s / 2 - v * t
    x2 = -1.5 * d_s + v * t
    cos1 = x1 / jnp.sqrt(d_min * d_min + x1 * x1)
    cos2 = x2 / jnp.sqrt(d_min * d_min + x2 * x2)
    cos3 = jnp.cos(jnp.mod(t, 2 * d_s / v))
    cos_theta = jnp.where(t <= d_s / v, cos1,
                          jnp.where(t <= 2 * d_s / v, cos2, cos3))
    phi0 = jax.random.uniform(key, (), minval=0.0, maxval=2 * np.pi)
    return jnp.exp(1j * (2 * np.pi * f_d * cos_theta * t + phi0)
                   ).astype(jnp.complex64)


def apply_cfo(rx: jnp.ndarray, sample_rate: float, cfo_hz: float,
              t0: float = 0.0, phase0: float = 0.0) -> jnp.ndarray:
    """Carrier frequency offset: rx * exp(j(2*pi*cfo*t + phase0)) over the
    last (time) axis.  The rfsimulator/do_DL_sig freq_offset analog."""
    t = t0 + jnp.arange(rx.shape[-1]) / sample_rate
    return rx * jnp.exp(1j * (2 * np.pi * cfo_hz * t + phase0)
                        ).astype(jnp.complex64)


def apply_phase_noise(rx: jnp.ndarray, sample_rate: float,
                      fd_hz: float = 300.0, t0: float = 0.0) -> jnp.ndarray:
    """Reference 'linear phase noise model' (phase_noise.c): a 300 Hz
    continuous rotation applied per sample to the received signal."""
    return apply_cfo(rx, sample_rate, fd_hz, t0)


def add_noise(key: jax.Array, rx: jnp.ndarray, sigma2: float) -> jnp.ndarray:
    """Complex AWGN with per-component variance sigma2/2 (add_noise analog)."""
    kr, ki = jax.random.split(key)
    n = (jax.random.normal(kr, rx.shape) + 1j * jax.random.normal(ki, rx.shape))
    return rx + jnp.sqrt(jnp.float32(sigma2 / 2)) * n.astype(jnp.complex64)


# 3GPP TR 36.873 / 36.101 legacy profiles (random_channel.c EPA/EVA/ETU)
LEGACY_PROFILES = {
    # delays in ns (absolute), powers in dB
    "EPA": (np.array([0, 30, 70, 90, 110, 190, 410], dtype=np.float64),
            np.array([0.0, -1.0, -2.0, -3.0, -8.0, -17.2, -20.8])),
    "EVA": (np.array([0, 30, 150, 310, 370, 710, 1090, 1730, 2510], dtype=np.float64),
            np.array([0.0, -1.5, -1.4, -3.6, -0.6, -9.1, -7.0, -12.0, -16.9])),
    "ETU": (np.array([0, 50, 120, 200, 230, 500, 1600, 2300, 5000], dtype=np.float64),
            np.array([-1.0, -1.0, -1.0, 0.0, 0.0, 0.0, -3.0, -5.0, -7.0])),
}

# absolute-delay profiles register alongside the normalized TDL ones
for _name, (_d, _p) in LEGACY_PROFILES.items():
    TDL_PROFILES[_name] = (_d / 1000.0, _p)  # store as us-scaled like TDL @1000ns DS
