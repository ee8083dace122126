"""Lock RPC — NetLocker over the internode transport.

The reference's cmd/lock-rest-server.go / cmd/lock-rest-client.go:
verbs /lock /rlock /unlock /runlock /force-unlock /expired mounted at
/minio/lock/v1, plus a maintenance sweep of stale grants.

A copy of minio_tpu/distributed/lock_rpc.py, with its verbs and wire
format; nothing is left out.
"""

from __future__ import annotations

import json
import threading

from .local_locker import LOCK_VALIDITY, LocalLocker
from .transport import NetworkError, RestClient, RPCError, RPCHandler

LOCK_RPC_PREFIX = "/minio/lock/v1"
MAINTENANCE_INTERVAL = 30.0


class LockRPCServer:
    """Serves a LocalLocker's verbs; mount into any server that accepts
    (prefix, route_fn) routers (e.g. s3.server.S3Server)."""

    def __init__(self, locker: LocalLocker, access_key: str,
                 secret_key: str, start_sweeper: bool = True):
        self.locker = locker
        self.handler = RPCHandler(LOCK_RPC_PREFIX, access_key, secret_key)
        for verb in ("lock", "rlock", "unlock", "runlock", "force-unlock",
                     "refresh"):
            self.handler.register(verb, self._make(verb))
        self.handler.register("dump", lambda a, b: self.locker.dump())
        self._stop = threading.Event()
        if start_sweeper:
            threading.Thread(target=self._sweep_loop, daemon=True).start()

    def _make(self, verb: str):
        fn = {
            "lock": self.locker.lock,
            "rlock": self.locker.rlock,
            "unlock": self.locker.unlock,
            "runlock": self.locker.runlock,
            "force-unlock": lambda uid, res, **kw:
                self.locker.force_unlock(res),
            "refresh": lambda uid, res, **kw:
                self.locker.refresh(uid, res),
        }[verb]

        def handle(args: dict, body: bytes):
            req = json.loads(body.decode())
            if verb in ("lock", "rlock"):
                ok = fn(req["uid"], req["resources"],
                        owner=req.get("owner", ""),
                        source=req.get("source", ""))
            else:
                ok = fn(req["uid"], req["resources"])
            return {"granted": bool(ok)}
        return handle

    def _sweep_loop(self) -> None:
        while not self._stop.wait(MAINTENANCE_INTERVAL):
            self.locker.expire_old_locks(LOCK_VALIDITY)

    def close(self) -> None:
        self._stop.set()

    def route(self, ctx):
        return self.handler.route(ctx)


class LockRPCClient:
    """NetLocker speaking the lock verbs to a remote node."""

    def __init__(self, host: str, port: int, access_key: str,
                 secret_key: str, timeout: float = 5.0):
        self.rc = RestClient(host, port, LOCK_RPC_PREFIX, access_key,
                             secret_key, timeout=timeout)

    def _call(self, verb: str, uid: str, resources: list[str],
              owner: str = "", source: str = "") -> bool:
        payload = {"uid": uid, "resources": resources, "owner": owner,
                   "source": source}
        try:
            out = self.rc.call_json(verb, payload=payload)
        except (NetworkError, RPCError):
            return False
        return bool(out and out.get("granted"))

    def lock(self, uid, resources, owner="", source=""):
        return self._call("lock", uid, resources, owner, source)

    def rlock(self, uid, resources, owner="", source=""):
        return self._call("rlock", uid, resources, owner, source)

    def unlock(self, uid, resources):
        return self._call("unlock", uid, resources)

    def runlock(self, uid, resources):
        return self._call("runlock", uid, resources)

    def force_unlock(self, resources):
        return self._call("force-unlock", "", resources)

    def refresh(self, uid, resources):
        return self._call("refresh", uid, resources)

    def dump(self) -> dict:
        try:
            return self.rc.call_json("dump") or {}
        except (NetworkError, RPCError):
            return {}

    @property
    def online(self) -> bool:
        return self.rc.online

    def close(self) -> None:
        self.rc.close()
