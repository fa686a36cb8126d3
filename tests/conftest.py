import os

# Tests run on the CPU with 8 virtual devices, so the multi-device sharding
# logic is exercised without a GPU; kernels run in Pallas interpret mode
# (the tier-1 command is in ROADMAP.md).  The checks that need a GPU are in
# chip_smoke.py; the few `gpu`-marked tests run only when JAX_PLATFORMS
# names a GPU platform: JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -n 0
if "host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu")
if ON_CPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)


# Fast tier: `pytest -m quick` runs a breadth-covering subset in ~2 min
# so correctness can be re-checked between optimization steps.  Modules
# here must each finish in well under 30 s on CPU.
QUICK_MODULES = {
    "test_crc", "test_fapi", "test_l2", "test_l3", "test_l3_ext",
    "test_confmod_log_trace", "test_utils_runtime", "test_scope_vcd",
    "test_rlc_am", "test_lte_pdcch", "test_nbiot",
    "test_csi_loop", "test_parallel", "test_tdd", "test_runtime",
    "test_lte_pucch", "test_prs",
}


def pytest_configure(config):
    assert not ON_CPU or jax.devices()[0].platform == "cpu", (
        "tests must run on CPU; launch pytest with JAX_PLATFORMS=cpu"
    )
    config.addinivalue_line("markers",
                            "quick: fast breadth tier (pytest -m quick)")


def pytest_collection_modifyitems(config, items):
    import pytest
    for item in items:
        if item.module.__name__ in QUICK_MODULES:
            item.add_marker(pytest.mark.quick)
