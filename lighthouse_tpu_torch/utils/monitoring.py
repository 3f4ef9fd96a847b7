"""Remote monitoring push + host health snapshots.

Twin of common/monitoring_api (periodic node-health POST to a remote
endpoint, src/lib.rs:1-14) and common/system_health (host metrics).
"""

from __future__ import annotations

import json
import os
import time
import urllib.request
from dataclasses import asdict, dataclass


@dataclass
class SystemHealth:
    cpu_count: int
    load_1m: float
    mem_total_kb: int
    mem_available_kb: int
    disk_free_kb: int

    @classmethod
    def observe(cls, path: str = "/") -> "SystemHealth":
        load = os.getloadavg()[0]
        mem_total = mem_avail = 0
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        mem_total = int(line.split()[1])
                    elif line.startswith("MemAvailable:"):
                        mem_avail = int(line.split()[1])
        except OSError:
            pass
        st = os.statvfs(path)
        return cls(
            cpu_count=os.cpu_count() or 1,
            load_1m=load,
            mem_total_kb=mem_total,
            mem_available_kb=mem_avail,
            disk_free_kb=st.f_bavail * st.f_frsize // 1024,
        )


@dataclass
class ProcessHealth:
    pid: int
    uptime_sec: float
    chain_head_slot: int
    sync_state: str


class MonitoringService:
    """Periodic beacon-node health push (the beaconcha.in-style client
    monitoring protocol).  Transport injectable for tests."""

    def __init__(self, endpoint: str, chain=None, post=None):
        self.endpoint = endpoint
        self.chain = chain
        self._post = post or self._http_post
        self._start = time.time()
        self.sent: int = 0

    def _http_post(self, payload: dict) -> None:
        req = urllib.request.Request(
            self.endpoint,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        urllib.request.urlopen(req, timeout=10).read()

    def snapshot(self) -> dict:
        body = {
            "version": 1,
            "timestamp": int(time.time() * 1000),
            "process": "beaconnode",
            "system": asdict(SystemHealth.observe()),
        }
        if self.chain is not None:
            head = self.chain.head_state()
            body["beacon"] = {
                "head_slot": int(head.slot),
                "head_root": "0x" + self.chain.head_root.hex(),
                "finalized_epoch": int(
                    self.chain.fork_choice.finalized_checkpoint[0]
                ),
                "validators": len(head.validators),
            }
        return body

    def tick(self) -> dict:
        payload = self.snapshot()
        self._post(payload)
        self.sent += 1
        return payload
