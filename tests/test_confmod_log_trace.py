"""Config module, LOG, and T-tracer analog tests (§5 aux subsystems)."""
from __future__ import annotations

import numpy as np
import pytest

from openairinterface5g_tpu.utils.confmod import (
    ConfigModule, ParamDef, parse_config)
from openairinterface5g_tpu.utils import log as log_mod
from openairinterface5g_tpu.utils.ttrace import Tracer

SAMPLE = """
# libconfig-style sample (the gnb.conf shape)
Active_gNBs = ( "gNB-JAX" );
gNBs = {
  gNB_ID = 0xe00;
  ssb_frequency = 3619200000;
  min_rxtxtime = 6;
  servingCellConfigCommon = {
    dl_carrierBandwidth = 273;
    ul_subcarrierSpacing = 1;   // mu
  };
};
log_config = {
  global_log_level = "info";
  phy_log_level = "debug";
};
rfsimulator = {
  serveraddr = "server";
  options = ( "chanmod", "saviq" );
};
"""


def test_parse_libconfig_subset():
    t = parse_config(SAMPLE)
    assert t["Active_gNBs"] == ["gNB-JAX"]
    assert t["gNBs"]["gNB_ID"] == 0xE00
    assert t["gNBs"]["ssb_frequency"] == 3619200000
    assert t["gNBs"]["servingCellConfigCommon"]["dl_carrierBandwidth"] == 273
    assert t["rfsimulator"]["options"] == ["chanmod", "saviq"]
    assert t["log_config"]["phy_log_level"] == "debug"


def test_paramdef_resolution_and_cli_override():
    cm = ConfigModule(parse_config(SAMPLE),
                      cli_overrides=["gNBs.min_rxtxtime=2",
                                     "gNBs.new_flag=true"])
    vals = cm.get("gNBs", [
        ParamDef("gNB_ID", int, 0),
        ParamDef("min_rxtxtime", int, 5),
        ParamDef("new_flag", bool, False),
        ParamDef("absent_with_default", int, 42),
    ])
    assert vals["gNB_ID"] == 0xE00
    assert vals["min_rxtxtime"] == 2          # CLI wins over file
    assert vals["new_flag"] is True
    assert vals["absent_with_default"] == 42
    nested = cm.get("gNBs.servingCellConfigCommon",
                    [ParamDef("dl_carrierBandwidth", int, 106)])
    assert nested["dl_carrierBandwidth"] == 273
    with pytest.raises(KeyError):
        cm.get("gNBs", [ParamDef("must_exist", int, required=True)])


def test_log_levels_configured_from_config():
    t = parse_config(SAMPLE)
    log_mod.configure(t["log_config"])
    import logging
    assert log_mod.get_logger("PHY").level == logging.DEBUG
    assert log_mod.get_logger("MAC").level == logging.INFO
    assert "PHY" in log_mod.dump_levels()


def test_tracer_ring_filter_record_replay(tmp_path):
    tr = Tracer(capacity=8)
    tr.T("GNB_PHY_CRC", 1, 2, 0x46, 1)
    iq = np.arange(6, dtype=np.float32).reshape(2, 3)
    tr.T("GNB_PHY_PUSCH_IQ", 1, 2, 0x46, payload=iq)
    assert len(tr.events()) == 2
    assert len(tr.events("GNB_PHY_CRC")) == 1
    # ring bound: overflow drops oldest and counts
    for i in range(20):
        tr.T("GNB_PHY_UL_TIME", 0, i)
    assert len(tr.events()) == 8 and tr.dropped > 0
    # record/replay with payload integrity
    tr2 = Tracer()
    tr2.T("GNB_PHY_PUSCH_IQ", 3, 4, 0x99, payload=iq)
    tr2.T("GNB_MAC_SCHED", 3, 4, 0x99, 16, 273)
    p = str(tmp_path / "trace.t5g")
    tr2.save(p)
    evs = list(Tracer.load(p))
    assert [e.name for e in evs] == ["GNB_PHY_PUSCH_IQ", "GNB_MAC_SCHED"]
    np.testing.assert_array_equal(evs[0].payload, iq)
    assert evs[1].fields == (3, 4, 0x99, 16, 273)


def test_tracer_enable_only():
    tr = Tracer()
    tr.enable_only("GNB_MAC_SCHED")
    tr.T("GNB_PHY_CRC", 0, 0, 1, 1)
    tr.T("GNB_MAC_SCHED", 0, 0, 1, 9, 106)
    assert [e.name for e in tr.events()] == ["GNB_MAC_SCHED"]
