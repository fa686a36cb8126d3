"""UE MAC random access, E2AP RIC agent, XnAP handover tests."""


def test_ue_mac_random_access():
    from openairinterface5g_tpu.l2.ue_mac import UeMac
    ue = UeMac()
    req = ue.start_ra(slot=0, msg3_payload=b"RRCSetupRequest")
    assert req["preamble_index"] == ue.ra.preamble_index
    # RAR for a different preamble is ignored
    assert ue.on_rar(5, {"preamble_index": 3, "tc_rnti": 0x41}) is None
    msg3 = ue.on_rar(5, {"preamble_index": req["preamble_index"],
                         "tc_rnti": 0x41, "ul_grant": 56})
    assert msg3["rnti"] == 0x41 and msg3["payload"] == b"RRCSetupRequest"
    assert ue.on_contention_resolution(0x41, b"RRCSetupRequest...")
    assert ue.state == "CONNECTED" and ue.c_rnti == 0x41


def test_ue_mac_ra_timeout_and_bsr():
    from openairinterface5g_tpu.l2.ue_mac import UeMac
    ue = UeMac()
    ue.start_ra(slot=0)
    assert ue.ra_timeout(ue.ra.response_window_slots + 1)  # retry allowed
    assert ue.state == "IDLE"
    ue.push_ul_data(5000)
    assert ue.bsr() > 0
    filled = ue.on_ul_grant(tbs_bytes=1000)
    assert filled["data_bytes"] == 998
    assert ue.ul_buffer == 5000 - 998


def test_e2ap_kpm_loop():
    import json
    from openairinterface5g_tpu.l3.e2ap import E2Agent, RicStub
    stats = {"ues": [{"rnti": 0x46, "dl_mbps": 42.0, "mcs": 16}]}
    controls = []
    agent = E2Agent(gnb_id=7, stats_provider=lambda: stats,
                    control_sink=controls.append)
    ric = RicStub()
    agent.send = ric.handle
    ric.send = agent.handle
    agent.e2_setup()
    assert agent.setup_done and ric.functions == [2, 3]
    ric.subscribe(period_ms=100)
    agent.tick()
    agent.tick()
    assert len(ric.indications) == 2
    assert ric.indications[0]["ues"][0]["rnti"] == 0x46
    ric.control({"max_mcs": 9})
    assert controls == [{"max_mcs": 9}]


def test_xnap_handover():
    from openairinterface5g_tpu.l3.xnap import XnEndpoint
    src = XnEndpoint(gnb_id=1, cells=[101])
    tgt = XnEndpoint(gnb_id=2, cells=[202])
    src.send = tgt.handle
    tgt.send = src.handle
    src.xn_setup()
    assert src.setup_done and src.peer_cells == [202]
    src.start_handover(ue_id=9, target_cell=202, c_rnti=0x46,
                       ue_context=b"rrc-ctx", sn_dl=100, sn_ul=50)
    assert 9 in src.pending_ho and "ack" in src.pending_ho[9]
    assert src.completed == [9]
    tid = src.pending_ho[9]["ack"]["target_ue_id"]
    assert tgt.admitted[tid]["context"] == b"rrc-ctx"
    assert tgt.admitted[tid]["c_rnti"] == 0xC000 + tid


def test_nas_service_and_release_procedures():
    """Idle-mode and teardown NAS flows (24.501 §5.5.2/5.6/6.3):
    service request, session modification, session release, GUTI
    reallocation, de-registration."""
    from openairinterface5g_tpu.l3 import nas

    amf = nas.AmfStub()
    ue = nas.UeNas()
    # full registration + session first
    pending = [ue.start()]
    while pending:
        for reply in amf.handle(pending.pop(0)):
            pending.extend(ue.handle(reply))
    assert ue.state == "SESSION" and ue.ip is not None

    # network GUTI reallocation
    replies = ue.handle(nas.configuration_update_command(b"\x07" * 11))
    assert ue.guti == b"\x07" * 11
    assert nas.decode(replies[0]).msg_type == nas.MSG_CONFIG_UPDATE_COMPLETE

    # identity request/response
    replies = ue.handle(nas.identity_request())
    assert nas.decode(replies[0]).msg_type == nas.MSG_IDENTITY_RESPONSE

    # session modification
    req = ue.request_session_modification(qos=b"\x09")
    for reply in amf.handle(req):
        ue.handle(reply)
    assert ue.qos == b"\x09"

    # session release: UE requests, AMF commands, UE completes
    req = ue.request_session_release()
    for reply in amf.handle(req):
        for done in ue.handle(reply):
            amf.handle(done)
    assert ue.ip is None and ue.state == "REGISTERED"
    assert amf.state == "REGISTERED"

    # service request from idle
    for reply in amf.handle(ue.request_service()):
        ue.handle(reply)
    assert ue.state == "REGISTERED"

    # de-registration
    for reply in amf.handle(ue.request_deregistration()):
        ue.handle(reply)
    assert ue.state == "DEREGISTERED" and amf.state == "DEREGISTERED"


def test_x2ap_handover_and_endc():
    """LTE X2 handover between two eNBs + EN-DC SgNB addition, and a
    preparation-failure path (admission refused)."""
    from openairinterface5g_tpu.l3.x2ap import X2Endpoint

    wire_a, wire_b = [], []
    a = X2Endpoint(1, cells=[0x100], send=wire_a.append)
    b = X2Endpoint(2, cells=[0x200], send=wire_b.append)

    def pump():
        while wire_a or wire_b:
            for pdu in wire_a[:]:
                wire_a.remove(pdu)
                b.handle(pdu)
            for pdu in wire_b[:]:
                wire_b.remove(pdu)
                a.handle(pdu)

    a.x2_setup()
    pump()
    assert a.setup_done and a.peer_cells == [0x200]

    a.start_handover(7, target_cell=0x200, ue_context=b"rrc-ctx",
                     erabs=(5, 6))
    pump()
    assert a.completed == [7]
    tid = a.pending_ho[7]["ack"]["new_ue_x2ap_id"]
    assert b.admitted[tid]["context"] == b"rrc-ctx"
    assert b.admitted[tid]["pdcp_sn_dl"] == 100   # SN status transferred

    # admission refusal -> preparation failure back at the source
    b2 = X2Endpoint(3, cells=[0x300], send=wire_b.append,
                    admit=lambda m: False)
    a.start_handover(8, target_cell=0x300, ue_context=b"x")
    for pdu in wire_a[:]:
        wire_a.remove(pdu)
        b2.handle(pdu)
    for pdu in wire_b[:]:
        wire_b.remove(pdu)
        a.handle(pdu)
    assert a.failed == [8]

    # EN-DC: MeNB adds an NR secondary node
    a.start_sgnb_addition(9, nr_cell=0xABC)
    pump()
    assert a.sgnb[9]["scg"] == b"nr-scg-config"
