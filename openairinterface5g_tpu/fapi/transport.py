"""nFAPI P7-style UDP transport + PNF/VNF split (C8 analog).

The reference splits MAC (VNF) from PHY (PNF) into separate processes
exchanging SCF FAPI messages over UDP (nfapi/oai_integration/nfapi_pnf.c,
nfapi_vnf.c; mode selection executables/nr-softmodem.c:684-748).  Here the
same seam carries the compact binary encoding of fapi/messages.py:

  VNF (MAC side)                       PNF (L1 side)
  CONFIG.request  ------------------>  configure cell
                 <------------------   CONFIG.response
  START.request   ------------------>  begin slot loop
                 <------------------   SLOT.indication (per slot)
  DL_TTI/UL_TTI/TX_Data.request --->   run gnb_dl_slot / gnb_ul_slot
                 <------------------   RX_Data/CRC/UCI/RACH.indication

Each datagram is one framed FAPI message (pack_message); the segmentation
layer of big nFAPI (sequence numbers & fragmentation) is unnecessary at
these message sizes but a 4-byte sequence header is kept for ordering
checks, like nfapi_p7_message_header_t does.
"""
from __future__ import annotations

import socket
import struct
from typing import Optional

from . import messages

_SEQ = struct.Struct("<I")


class FapiEndpoint:
    """One side of the P7 UDP link."""

    def __init__(self, bind_addr=("127.0.0.1", 0), timeout: float = 5.0):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(bind_addr)
        self.sock.settimeout(timeout)
        self.peer: Optional[tuple] = None
        self.tx_seq = 0
        self.rx_seq = -1
        self.out_of_order = 0

    @property
    def addr(self):
        return self.sock.getsockname()

    def connect(self, peer):
        self.peer = peer

    def send(self, msg) -> None:
        buf = _SEQ.pack(self.tx_seq) + messages.pack_message(msg)
        self.tx_seq += 1
        assert self.peer is not None, "endpoint not connected"
        self.sock.sendto(buf, self.peer)

    def recv(self):
        buf, src = self.sock.recvfrom(65536)
        if self.peer is None:
            self.peer = src
        (seq,) = _SEQ.unpack_from(buf, 0)
        if seq <= self.rx_seq:
            self.out_of_order += 1
        self.rx_seq = max(self.rx_seq, seq)
        return messages.unpack_message(buf[_SEQ.size:])

    def close(self):
        self.sock.close()


class Pnf:
    """PHY-node function: owns the L1, serves FAPI requests.

    run_slots(n) processes n slots: for each slot it emits
    SLOT.indication, collects the VNF's {DL_TTI, UL_TTI, TX_Data}
    requests, runs the PHY, and sends back indications.  The PHY
    execution callback is injected so tests can run a pure-python L1.
    """

    def __init__(self, endpoint: FapiEndpoint, phy_slot_fn):
        self.ep = endpoint
        self.phy_slot_fn = phy_slot_fn
        self.config: Optional[messages.ConfigRequest] = None
        self.running = False

    def serve_control(self):
        """Handle P5 until START.request."""
        while not self.running:
            msg = self.ep.recv()
            if isinstance(msg, messages.ConfigRequest):
                self.config = msg
                self.ep.send(messages.ConfigResponse(error_code=0))
            elif isinstance(msg, messages.StartRequest):
                self.running = True
            elif isinstance(msg, messages.StopRequest):
                return

    def run_slots(self, n_slots: int):
        for s in range(n_slots):
            sfn, slot = divmod(s, 20)
            self.ep.send(messages.SlotIndication(sfn=sfn, slot=slot))
            dl = ul = txd = None
            # collect this slot's requests (VNF sends all three, possibly empty)
            while dl is None or ul is None or txd is None:
                msg = self.ep.recv()
                if isinstance(msg, messages.DlTtiRequest):
                    dl = msg
                elif isinstance(msg, messages.UlTtiRequest):
                    ul = msg
                elif isinstance(msg, messages.TxDataRequest):
                    txd = msg
                elif isinstance(msg, messages.StopRequest):
                    return
            for ind in self.phy_slot_fn(self.config, dl, ul, txd):
                self.ep.send(ind)


class Vnf:
    """VNF side driver: configures the PNF and runs a MAC callback per slot.

    mac_slot_fn(sfn, slot) -> (DlTtiRequest, UlTtiRequest, TxDataRequest)
    on_indication(msg) consumes UL indications.
    """

    def __init__(self, endpoint: FapiEndpoint, mac_slot_fn, on_indication=None):
        self.ep = endpoint
        self.mac_slot_fn = mac_slot_fn
        self.on_indication = on_indication or (lambda m: None)

    def configure(self, cfg: messages.ConfigRequest):
        self.ep.send(cfg)
        resp = self.ep.recv()
        assert isinstance(resp, messages.ConfigResponse) and resp.error_code == 0
        self.ep.send(messages.StartRequest())

    def run_slots(self, n_slots: int, drain_s: float = 2.0):
        done = 0
        while done < n_slots:
            msg = self.ep.recv()
            if isinstance(msg, messages.SlotIndication):
                dl, ul, txd = self.mac_slot_fn(msg.sfn, msg.slot)
                self.ep.send(dl)
                self.ep.send(ul)
                self.ep.send(txd)
                done += 1
            else:
                self.on_indication(msg)
        # drain remaining indications for the final slot (the PNF may still
        # be processing it when the last SLOT.indication's requests land)
        old = self.ep.sock.gettimeout()
        self.ep.sock.settimeout(drain_s)
        try:
            while True:
                self.on_indication(self.ep.recv())
        except socket.timeout:
            pass
        finally:
            self.ep.sock.settimeout(old)

    def stop(self):
        self.ep.send(messages.StopRequest())
