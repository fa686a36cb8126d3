"""LDPC decoder backends (P11 analog).

The reference loads coder implementations behind the ldpc_interface_t
plugin vtable at runtime (openair1/PHY/CODING/nrLDPC_extern.h:28,
nrLDPC_load.c dlopen) — libldpc.so, _optim8seg, _cl, _cuda, _t2.  Here
the choice is between two implementations of the same signature:

  'xla'    — pure-JAX flooding min-sum (any platform; the reference
             schedule, used for BLER parity runs)
  'triton' — layered min-sum Pallas kernel on the Triton route
             (ops/ldpc_triton.py; NVIDIA GPUs only, raises elsewhere)
"""
from __future__ import annotations

from typing import Callable

from . import ldpc
from ..ops import ldpc_triton


def _decode_xla(graph, llr, n_iters=12):
    bits, ok, _ = ldpc.decode(graph, llr, n_iters=n_iters)
    return bits, ok


def _decode_triton(graph, llr, n_iters=8):
    return ldpc_triton.decode(graph, llr, n_iters=n_iters)


_BACKENDS: dict[str, Callable] = {
    "xla": _decode_xla,
    "triton": _decode_triton,
}


def decoder(name: str) -> Callable:
    """Resolve a decode fn (graph, llr, n_iters) -> (bits, ok)."""
    if name not in _BACKENDS:
        raise KeyError(f"unknown LDPC backend {name!r}; have {sorted(_BACKENDS)}")
    return _BACKENDS[name]
