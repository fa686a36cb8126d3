"""openairinterface5g_tpu — a JAX 5G NR PHY framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of OAI's
``openair1/PHY`` signal chain (reference map: SURVEY.md): OFDM
modulation/demodulation, DMRS channel estimation + MMSE equalization,
LDPC BG1/BG2 encode + min-sum decode, polar encode/SCL decode, rate
matching, and ulsim/dlsim-class BLER simulators.

Everything is expressed as batched tensor programs over
(slot, antenna, symbol, subcarrier, code-block) dims; the reference's
SIMD codegen and thread pools map to XLA fusion + Pallas kernels, its
fronthaul/nFAPI process splits map to jax.sharding over a device Mesh.
"""

__version__ = "0.1.0"
