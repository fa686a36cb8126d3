"""Layered LDPC decoding: the Triton kernel (interpret mode) against the
plain layered reference, the reference against the flooding decoder, and
the backend wrapper."""
import jax
import numpy as np
import pytest

from openairinterface5g_tpu.coding import ldpc
from openairinterface5g_tpu.coding.backend import decoder
from openairinterface5g_tpu.ops import ldpc_triton


def _noisy(bg, Z, n, snr_db, seed=0):
    """n random codewords through BPSK + AWGN -> (info bits, LLRs)."""
    g = ldpc.build_graph(bg, Z)
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (n, g.K)).astype(np.int8)
    cw = np.asarray(ldpc.encode(g, info)).astype(np.float32)
    sigma = 10 ** (-snr_db / 20)
    y = (1 - 2 * cw) + sigma * rng.standard_normal(cw.shape).astype(np.float32)
    llr = 2 * y / sigma ** 2
    llr[:, : 2 * Z] = 0                     # punctured columns
    return g, info, llr


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))
                 / max(float(np.max(np.abs(np.asarray(b)))), 1e-30))


@pytest.mark.parametrize("Z", [16, 24])     # a power of two, and not
def test_kernel_matches_layered_reference(Z):
    g, info, llr = _noisy(2, Z, 3, 1.0)
    bits, ok, app, c2v = ldpc_triton.decode_state(g, llr, 8, interpret=True)
    ref = ldpc.layered_minsum(g, llr, 8)
    ok_ref = np.asarray(ref.ok)
    np.testing.assert_array_equal(np.asarray(ok), ok_ref)
    bits_ref = np.asarray(ref.app[:, : g.kc] < 0).reshape(3, -1)
    np.testing.assert_array_equal(np.asarray(bits)[ok_ref], bits_ref[ok_ref])
    assert _rel(app, ref.app) <= 1e-4 and _rel(c2v, ref.c2v) <= 1e-4
    assert ok_ref.all() and (np.asarray(bits) == info).all()


def test_kernel_messages_after_two_iterations():
    """Before convergence the totals and messages still agree."""
    g, _, llr = _noisy(2, 24, 3, 0.0, seed=1)
    _, ok, app, c2v = ldpc_triton.decode_state(g, llr, 2, interpret=True)
    ref = ldpc.layered_minsum(g, llr, 2)
    assert not np.asarray(ref.ok).all()
    np.testing.assert_array_equal(np.asarray(ok), np.asarray(ref.ok))
    assert _rel(app, ref.app) <= 1e-4 and _rel(c2v, ref.c2v) <= 1e-4


def test_kernel_early_exit_matches_fixed_trip_count():
    """At high SNR the kernel stops early and gives the bits of a decode
    that runs all 8 iterations."""
    g, info, llr = _noisy(2, 24, 3, 4.0, seed=2)
    bits, ok = ldpc_triton.decode(g, llr, 8, interpret=True)
    ref = ldpc.layered_minsum(g, llr, 8, early_stop=False)
    assert int(ldpc.layered_minsum(g, llr, 8).iters.max()) < 8
    bits_ref = np.asarray(ref.app[:, : g.kc] < 0).reshape(3, -1)
    np.testing.assert_array_equal(np.asarray(bits), bits_ref)
    np.testing.assert_array_equal(np.asarray(ok), np.asarray(ref.ok))
    assert (np.asarray(bits) == info).all()


@pytest.mark.parametrize("n", [1, 5])
def test_kernel_any_number_of_blocks(n):
    g, info, llr = _noisy(2, 24, n, 3.0, seed=3)
    bits, ok = ldpc_triton.decode(g, llr, 8, interpret=True)
    assert bits.shape == (n, g.K) and bits.dtype == np.int8
    assert ok.shape == (n,) and np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(bits), info)


@pytest.mark.parametrize("bg", [1, 2])
def test_row_groups_cover_every_edge_once(bg):
    groups, table = ldpc_triton._row_groups(bg, 384)
    rows = ldpc.row_edges(bg, 384)
    edges = []
    for r0, r1, D, s0 in groups:
        for r in range(r0, r1):
            e0, cs, ss = rows[r]
            sl = table[:, s0 + (r - r0) * D: s0 + (r - r0 + 1) * D]
            assert list(sl[0, : len(cs)]) == list(cs)
            assert list(sl[1, : len(cs)]) == list(ss)
            assert (sl[0, len(cs):] == -1).all()
            edges += list(sl[2, : len(cs)])
    assert groups[0][0] == 0 and groups[-1][1] == len(rows)
    assert edges == list(range(len(edges)))
    assert len(edges) == int((ldpc.build_graph(bg, 384).tab >= 0).sum())


@pytest.mark.parametrize("bg,Z", [(1, 16), (2, 24)])
def test_layered_reference_agrees_with_flooding(bg, Z):
    """Both schedules decode the same blocks to the sent bits; the layered
    one needs no more iterations."""
    g, info, llr = _noisy(bg, Z, 4, 1.5, seed=4)
    b_l, ok_l, it_l = ldpc.decode_layered(g, llr, 12)
    b_f, ok_f, it_f = ldpc.decode(g, llr, 12)
    assert np.asarray(ok_l).all() and np.asarray(ok_f).all()
    np.testing.assert_array_equal(np.asarray(b_l), info)
    np.testing.assert_array_equal(np.asarray(b_f), info)
    assert int(np.max(it_l)) <= int(it_f)


def test_flooding_early_stop_ends_before_the_iteration_cap():
    g, info, llr = _noisy(2, 24, 2, 4.0, seed=5)
    bits, ok, iters = ldpc.decode(g, llr, 20)
    assert int(iters) < 20 and np.asarray(ok).all()
    _, _, iters_fixed = ldpc.decode(g, llr, 20, early_stop=False)
    assert int(iters_fixed) == 20
    np.testing.assert_array_equal(np.asarray(bits), info)


def test_backend_selection_by_name():
    g, info, llr = _noisy(2, 24, 2, 4.0, seed=6)
    bits, ok = decoder("xla")(g, llr, n_iters=8)
    np.testing.assert_array_equal(np.asarray(bits), info)
    with pytest.raises(KeyError):
        decoder("pallas")


def test_triton_backend_raises_without_a_gpu():
    g, _, llr = _noisy(2, 24, 2, 4.0)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        decoder("triton")(g, llr, n_iters=8)


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.gpu
def test_kernel_compiled_for_the_gpu(gpu):
    g, info, llr = _noisy(1, 384, 8, 1.5)
    bits, ok, app, c2v = ldpc_triton.decode_state(g, llr, 8)
    ref = ldpc.layered_minsum(g, llr, 8)
    np.testing.assert_array_equal(np.asarray(ok), np.asarray(ref.ok))
    assert _rel(app, ref.app) <= 1e-4
    np.testing.assert_array_equal(np.asarray(bits), info)
