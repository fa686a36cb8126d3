"""ITTI-style inter-task message bus (common/utils/ocp_itti analog).

The reference composes the gNB from ITTI tasks — named threads with typed
message queues (`itti_create_task` / `itti_send_msg_to_task`,
intertask_interface.h:441-489).  Here the analog is a small thread+queue
bus used by the host-side runtime (PNF/VNF loops, softmodem composition,
telnet control): the device data path itself needs no message passing — one
jitted program replaces the per-stage thread handoffs — so this exists
for the *control* plane only, matching how the reference uses ITTI (RRC/
NGAP/GTP tasks, not the PHY hot path).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Optional


@dataclasses.dataclass
class Message:
    msg_id: str
    origin: str
    payload: Any = None


class Task:
    def __init__(self, name: str, handler: Callable[["Itti", Message], None],
                 bus: "Itti"):
        self.name = name
        self.handler = handler
        self.bus = bus
        self.queue: "queue.Queue[Optional[Message]]" = queue.Queue()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"itti-{name}")
        self.processed = 0

    def _run(self):
        while True:
            msg = self.queue.get()
            if msg is None:
                return
            try:
                self.handler(self.bus, msg)
            finally:
                self.processed += 1


class Itti:
    """The bus: create_task / send / broadcast / terminate."""

    def __init__(self):
        self.tasks: dict[str, Task] = {}
        self._lock = threading.Lock()

    def create_task(self, name: str,
                    handler: Callable[["Itti", Message], None]) -> Task:
        with self._lock:
            if name in self.tasks:
                raise ValueError(f"task {name!r} exists")
            t = Task(name, handler, self)
            self.tasks[name] = t
            t.thread.start()
            return t

    def send(self, to: str, msg_id: str, payload: Any = None,
             origin: str = "main"):
        self.tasks[to].queue.put(Message(msg_id, origin, payload))

    def broadcast(self, msg_id: str, payload: Any = None,
                  origin: str = "main"):
        for t in self.tasks.values():
            t.queue.put(Message(msg_id, origin, payload))

    def wait_idle(self, timeout: float = 5.0):
        """Block until all queues drain (test helper)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(t.queue.empty() for t in self.tasks.values()):
                return True
            time.sleep(0.001)
        return False

    def terminate(self):
        for t in self.tasks.values():
            t.queue.put(None)
        for t in self.tasks.values():
            t.thread.join(timeout=5)
        self.tasks.clear()
