"""LTE (4G) PHY layer — the legacy-stack capability of the reference
(openair1/PHY/LTE_TRANSPORT, LTE_ESTIMATION, LTE_REFSIG; ~150k LoC of C).

A re-design sharing the NR infrastructure: batched XLA FFTs,
GF(2)-matrix Gold sequences, gather/scatter rate matching, and the
lax.scan turbo / Viterbi codecs in coding/turbo.py, coding/viterbi.py.
"""
