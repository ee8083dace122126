"""OBD ("on-board diagnostics") bundle: per-node hardware/health facts
(reference cmd/obdinfo.go getLocalDrivesOBD + peer OBD verbs,
cmd/peer-rest-common.go:29-37; counterpart of minio_tpu/utils/obd.py,
whole): CPU and memory facts from /proc, plus a real latency probe per
local drive (timed write+fsync+read of a small file) — the numbers an
operator reads first when a cluster feels slow.
"""

from __future__ import annotations

import os
import shutil
import socket
import time


def _meminfo() -> dict:
    out: dict[str, int] = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                parts = line.split()
                if parts[0] in ("MemTotal:", "MemAvailable:"):
                    out[parts[0][:-1]] = int(parts[1]) * 1024
    except OSError:
        pass
    return {"total": out.get("MemTotal", 0),
            "available": out.get("MemAvailable", 0)}


def probe_drive(path: str, size: int = 64 << 10) -> dict:
    """Timed write+fsync then read of `size` bytes under `path`
    (reference getLocalDrivesOBD performance probe)."""
    info: dict = {"path": path}
    try:
        usage = shutil.disk_usage(path)
        info["total_bytes"] = usage.total
        info["free_bytes"] = usage.free
        probe = os.path.join(path, ".minio.sys", "tmp",
                             f".obd-probe-{os.getpid()}")
        os.makedirs(os.path.dirname(probe), exist_ok=True)
        payload = os.urandom(size)
        t0 = time.perf_counter()
        with open(probe, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        info["write_latency_us"] = round(
            (time.perf_counter() - t0) * 1e6)
        t0 = time.perf_counter()
        with open(probe, "rb") as f:
            got = f.read()
        info["read_latency_us"] = round(
            (time.perf_counter() - t0) * 1e6)
        info["ok"] = got == payload
        os.remove(probe)
    except OSError as e:
        info["error"] = str(e)
        info["ok"] = False
    return info


def drive_fault_counters(disks) -> list[dict]:
    """Per-drive fault counters from the live StorageAPI objects (ROADMAP
    follow-up: surface NaughtyDisk/transport faults in OBD): unwrap each
    drive's wrapper chain (DiskIDCheck → NaughtyDisk → XLStorage /
    RemoteStorage) and collect whatever counters it carries —

      * NaughtyDisk fault-injection stats (errors, latency, bitrot,
        truncated, offline_hits) — what chaos actually injected;
      * RemoteStorage transport counters (calls, net_errors, retries,
        offline_trips) — what the internode plane actually suffered.

    Drives with neither report only their identity; a None slot reports
    offline. Duck-typed so gateways/FS layers return [].

    Each entry also carries the gray-failure plane's view: the tracked
    per-verb latency summary and the quarantine health state, next to
    the fault counters — the "is it slow" answer beside "is it
    failing"."""
    from . import healthtrack
    tracked = {e["key"]: e for e in healthtrack.TRACKER.snapshot("drive")}
    out: list[dict] = []
    for i, d in enumerate(disks):
        entry: dict = {"index": i,
                       "drive": str(d) if d is not None else None,
                       "online": d is not None}
        if d is not None:
            h = tracked.get(healthtrack.disk_key(d))
            if h is not None:
                entry["health"] = {"state": h["state"],
                                   "state_age_s": h["state_age_s"],
                                   "latency": h["verbs"]}
        cur, hops = d, 0
        while cur is not None and hops < 8:
            hops += 1
            stats = getattr(cur, "stats", None)
            if stats is not None and hasattr(stats, "offline_hits"):
                entry["faults"] = {
                    "errors": stats.errors, "latency": stats.latency,
                    "bitrot": stats.bitrot,
                    "truncated": stats.truncated,
                    "offline_hits": stats.offline_hits,
                    "total_ops": getattr(cur, "total_ops", 0),
                }
            rc = getattr(cur, "rc", None)
            if rc is not None and hasattr(rc, "net_counters"):
                entry["transport"] = rc.net_counters()
            cur = getattr(cur, "inner", None)
        out.append(entry)
    return out


def _process_info() -> dict:
    """This server process's own footprint (reference OBD bundles
    process detail alongside host cpu/mem)."""
    out: dict = {"pid": os.getpid()}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["rss_bytes"] = int(line.split()[1]) * 1024
                elif line.startswith("Threads:"):
                    out["threads"] = int(line.split()[1])
    except (OSError, ValueError, IndexError):
        pass
    try:
        out["open_fds"] = len(os.listdir("/proc/self/fd"))
    except OSError:
        pass
    return out


def local_obd(drive_paths: list[str] | None = None,
              storage_drives=None) -> dict:
    """This node's OBD facts; the peer plane fans this out cluster-wide.
    `storage_drives` (live StorageAPI objects, any wrapper depth) adds
    per-drive fault counters alongside the latency probes."""
    try:
        load1, load5, load15 = os.getloadavg()
    except OSError:
        load1 = load5 = load15 = 0.0
    out = {
        "hostname": socket.gethostname(),
        "time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "cpu": {"count": os.cpu_count() or 0,
                "load1": round(load1, 3), "load5": round(load5, 3),
                "load15": round(load15, 3)},
        "mem": _meminfo(),
        "process": _process_info(),
        "drives": [probe_drive(p) for p in (drive_paths or [])],
    }
    if storage_drives is not None:
        out["drive_faults"] = drive_fault_counters(storage_drives)
    # the gray-failure snapshot: per-peer latency summaries (the
    # per-drive ones ride each drive_faults entry above)
    from . import healthtrack
    out["peer_health"] = healthtrack.TRACKER.snapshot("peer")
    return out
