"""Bucket event notification: config rules + target dispatch.

The reference's pkg/event: per-bucket NotificationConfiguration XML maps
event-name patterns + prefix/suffix filters to targets (ARNs); every
object operation publishes an S3-format event record to the matching
targets, asynchronously with retry. Durability matches the reference's
queuestore (pkg/event/target/queuestore.go): when the notifier has a
queue directory, every matched event is persisted BEFORE dispatch and
deleted only after the target accepts it — pending events survive a
process restart (at-least-once).

Targets (all real wire protocols, offline-tested against in-process
fakes): webhook (HTTP POST), redis (RESP2), mqtt (3.1.1), nats (text
protocol), nsq (V2 TCP), amqp (0-9-1), postgres (v3 protocol with
SCRAM-SHA-256 auth), mysql (handshake v10, native-password +
caching_sha2 auth), elasticsearch (document API), kafka (binary
broker protocol: ApiVersions/Metadata handshake + Produce v2 carrying
a MessageSet v1 of magic-1 messages with CRC32 framing — KafkaTarget
below, no client lib needed), memory (tests / ListenNotification
feed).

A copy of minio_tpu/features/events.py. Departure: ``close`` also ends
every ListenBucketNotification stream on the hub (the stream ends on a
``None`` item): the port's edge stop waits for the worker that serves a
stream, and a listener would otherwise hold a node's shutdown until its
idle window lapsed.
"""

from __future__ import annotations

import base64
import dataclasses
import fnmatch
import hashlib
import hmac
import json
import os
import queue
import socket
import struct
import threading
import time
import urllib.error
import urllib.request
import uuid as _uuid
import xml.etree.ElementTree as ET
import zlib
from typing import Callable, Optional

_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"


def _findall(el, tag):
    return list(el.findall(tag)) + list(el.findall(_NS + tag))


def _text(el, tag, default=""):
    r = el.find(tag)
    if r is None:
        r = el.find(_NS + tag)
    return (r.text or "").strip() if r is not None else default


@dataclasses.dataclass
class QueueRule:
    arn: str
    events: list[str]                  # e.g. ["s3:ObjectCreated:*"]
    prefix: str = ""
    suffix: str = ""

    def matches(self, event_name: str, key: str) -> bool:
        if not any(fnmatch.fnmatchcase(event_name, pat)
                   for pat in self.events):
            return False
        if self.prefix and not key.startswith(self.prefix):
            return False
        if self.suffix and not key.endswith(self.suffix):
            return False
        return True


class NotificationConfig:
    def __init__(self, rules: list[QueueRule]):
        self.rules = rules

    @classmethod
    def from_xml(cls, raw: str | bytes) -> "NotificationConfig":
        root = ET.fromstring(raw)
        rules = []
        for qel in (_findall(root, "QueueConfiguration")
                    + _findall(root, "TopicConfiguration")
                    + _findall(root, "CloudFunctionConfiguration")):
            arn = (_text(qel, "Queue") or _text(qel, "Topic")
                   or _text(qel, "CloudFunction"))
            events = [(e.text or "").strip()
                      for e in _findall(qel, "Event")]
            prefix = suffix = ""
            for fel in _findall(qel, "Filter"):
                for kel in _findall(fel, "S3Key"):
                    for frel in _findall(kel, "FilterRule"):
                        name = _text(frel, "Name").lower()
                        value = _text(frel, "Value")
                        if name == "prefix":
                            prefix = value
                        elif name == "suffix":
                            suffix = value
            rules.append(QueueRule(arn=arn, events=events, prefix=prefix,
                                   suffix=suffix))
        return cls(rules)


# ---------------------------------------------------------------------------
# durable queue store (pkg/event/target/queuestore.go semantics)
# ---------------------------------------------------------------------------

class QueueStore:
    """One directory of JSON event files per target. put() is atomic
    (tmp + rename); entries are deleted only after successful delivery,
    so whatever is on disk at startup is exactly the undelivered
    backlog."""

    def __init__(self, directory: str, limit: int = 10000,
                 fsync: Optional[bool] = None):
        self.dir = directory
        self.limit = limit
        if fsync is None:
            from ..utils import knobs
            fsync = knobs.get_bool("MINIO_TPU_QUEUE_FSYNC")
        self.fsync = fsync
        os.makedirs(directory, exist_ok=True)
        self._mu = threading.Lock()
        # Crash mid-put leaves '.tmp-*' files that keys() skips — sweep
        # them so they can't accumulate invisibly forever. Only stale
        # ones: a fresh store may be constructed over a directory an
        # older store object is actively put()ing into (admin config
        # re-apply), and an unconditional sweep would delete the
        # in-flight tmp file between json.dump and os.replace.
        now = time.time()
        try:
            for name in os.listdir(directory):
                if not name.startswith(".tmp-"):
                    continue
                p = os.path.join(directory, name)
                try:
                    if now - os.path.getmtime(p) > 60.0:
                        os.remove(p)
                except OSError:
                    pass
        except OSError:
            pass
        # O(1) limit enforcement: count once at startup, maintain on
        # put/delete (a per-put listdir is O(n^2) as backlog grows)
        self._count = len(self.keys())

    def put(self, record: dict) -> Optional[str]:
        """Persist; returns the entry key, or None when the store is at
        its limit (caller falls back to at-most-once)."""
        with self._mu:
            if self._count >= self.limit:
                return None
            key = f"{time.time_ns():020d}-{_uuid.uuid4().hex[:8]}"
            tmp = os.path.join(self.dir, f".tmp-{key}")
            with open(tmp, "w") as f:
                json.dump(record, f)
                if self.fsync:
                    # opt-in (MINIO_TPU_QUEUE_FSYNC=on): survives power
                    # loss, but an fsync per event on the request
                    # thread serializes the PUT hot path; process-crash
                    # durability already holds via atomic rename +
                    # redrive.
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.dir, key))
            if self.fsync:
                # the rename itself is only durable once the directory
                # metadata is flushed
                dfd = os.open(self.dir, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            self._count += 1
            return key

    def get(self, key: str) -> Optional[dict]:
        try:
            with open(os.path.join(self.dir, key)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def delete(self, key: str) -> None:
        with self._mu:
            try:
                os.remove(os.path.join(self.dir, key))
                self._count -= 1
            except OSError:
                pass

    def keys(self) -> list[str]:
        """Undelivered entry keys, oldest first (names sort by put
        time)."""
        try:
            return sorted(k for k in os.listdir(self.dir)
                          if not k.startswith("."))
        except OSError:
            return []


# ---------------------------------------------------------------------------
# targets
# ---------------------------------------------------------------------------

class WebhookTarget:
    """POST the event JSON to an endpoint (pkg/event/target/webhook)."""

    def __init__(self, arn: str, endpoint: str, timeout: float = 5.0):
        self.arn = arn
        self.endpoint = endpoint
        self.timeout = timeout

    def send(self, record: dict) -> None:
        body = json.dumps(record).encode()
        req = urllib.request.Request(
            self.endpoint, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            resp.read()


class RedisTarget:
    """Event delivery over the actual Redis RESP2 wire protocol
    (pkg/event/target/redis.go): format="namespace" keeps a hash of
    object-key -> latest event (HSET / HDEL on delete events);
    format="access" appends every event to a list (RPUSH)."""

    def __init__(self, arn: str, addr: str, key: str,
                 format: str = "namespace", password: str = "",
                 timeout: float = 5.0,
                 connect: Optional[Callable[[], socket.socket]] = None):
        self.arn, self.addr, self.key = arn, addr, key
        self.format = format
        self.password = password
        self.timeout = timeout
        self._connect = connect or self._default_connect

    def _default_connect(self) -> socket.socket:
        from ..utils import host_port
        return socket.create_connection(
            host_port(self.addr, 6379), timeout=self.timeout)

    @staticmethod
    def _resp(*args: bytes) -> bytes:
        out = b"*%d\r\n" % len(args)
        for a in args:
            out += b"$%d\r\n%s\r\n" % (len(a), a)
        return out

    @staticmethod
    def _read_reply(f) -> bytes:
        line = f.readline()
        if not line:
            raise OSError("redis connection closed")
        if line[:1] == b"-":
            raise OSError(f"redis error: {line[1:].strip().decode()}")
        if line[:1] == b"$":                    # bulk string
            n = int(line[1:])
            return f.read(n + 2)[:-2] if n >= 0 else b""
        return line.strip()                     # +OK / :n

    def send(self, record: dict) -> None:
        rec = record["Records"][0]
        obj_key = rec["s3"]["object"]["key"]
        body = json.dumps(record).encode()
        with self._connect() as s:
            f = s.makefile("rb")
            if self.password:
                s.sendall(self._resp(b"AUTH", self.password.encode()))
                self._read_reply(f)
            if self.format == "access":
                cmd = self._resp(b"RPUSH", self.key.encode(), body)
            elif rec["eventName"].startswith("s3:ObjectRemoved"):
                cmd = self._resp(b"HDEL", self.key.encode(),
                                 obj_key.encode())
            else:
                cmd = self._resp(b"HSET", self.key.encode(),
                                 obj_key.encode(), body)
            s.sendall(cmd)
            self._read_reply(f)


class MQTTTarget:
    """Event delivery over real MQTT 3.1.1 (pkg/event/target/mqtt.go):
    CONNECT, await CONNACK, PUBLISH QoS 0, DISCONNECT."""

    def __init__(self, arn: str, addr: str, topic: str,
                 client_id: str = "", timeout: float = 5.0,
                 connect: Optional[Callable[[], socket.socket]] = None):
        self.arn, self.addr, self.topic = arn, addr, topic
        self.client_id = client_id or f"minio-tpu-{_uuid.uuid4().hex[:8]}"
        self.timeout = timeout
        self._connect = connect or self._default_connect

    def _default_connect(self) -> socket.socket:
        from ..utils import host_port
        return socket.create_connection(
            host_port(self.addr, 1883), timeout=self.timeout)

    @staticmethod
    def _varlen(n: int) -> bytes:
        out = b""
        while True:
            b7, n = n & 0x7F, n >> 7
            out += bytes([b7 | (0x80 if n else 0)])
            if not n:
                return out

    @staticmethod
    def _mstr(s: bytes) -> bytes:
        return len(s).to_bytes(2, "big") + s

    def send(self, record: dict) -> None:
        body = json.dumps(record).encode()
        var = (self._mstr(b"MQTT") + b"\x04"   # protocol level 3.1.1
               + b"\x02"                       # clean session
               + (60).to_bytes(2, "big")       # keepalive
               + self._mstr(self.client_id.encode()))
        connect = b"\x10" + self._varlen(len(var)) + var
        pub_var = self._mstr(self.topic.encode()) + body
        publish = b"\x30" + self._varlen(len(pub_var)) + pub_var
        with self._connect() as s:
            s.sendall(connect)
            ack = b""
            while len(ack) < 4:                # CONNACK may fragment
                chunk = s.recv(4 - len(ack))
                if not chunk:
                    raise OSError("MQTT connection closed before CONNACK")
                ack += chunk
            if ack[0] != 0x20 or ack[3] != 0:
                raise OSError(f"MQTT CONNACK refused: {ack.hex()}")
            s.sendall(publish)
            s.sendall(b"\xe0\x00")             # DISCONNECT


class NATSTarget:
    """Event delivery over the real NATS text protocol
    (pkg/event/target/nats.go): INFO -> CONNECT(verbose) -> +OK ->
    PUB subject len / payload -> +OK."""

    def __init__(self, arn: str, addr: str, subject: str,
                 timeout: float = 5.0,
                 connect: Optional[Callable[[], socket.socket]] = None):
        # the subject is interpolated into the PUB frame: whitespace or
        # control characters would corrupt (or inject) protocol
        # commands, so reject them at configuration time
        if not subject or any(c.isspace() or ord(c) < 0x21
                              for c in subject):
            raise ValueError(
                f"invalid NATS subject {subject!r}: must be non-empty "
                "without whitespace/control characters")
        self.arn, self.addr, self.subject = arn, addr, subject
        self.timeout = timeout
        self._connect = connect or self._default_connect

    def _default_connect(self) -> socket.socket:
        from ..utils import host_port
        return socket.create_connection(
            host_port(self.addr, 4222), timeout=self.timeout)

    @staticmethod
    def _expect_ok(f) -> None:
        line = f.readline()
        if line.strip().startswith(b"-ERR"):
            raise OSError(f"NATS error: {line.strip().decode()}")
        if not line.strip().startswith(b"+OK"):
            raise OSError(f"unexpected NATS reply: {line[:80]!r}")

    def send(self, record: dict) -> None:
        body = json.dumps(record).encode()
        with self._connect() as s:
            f = s.makefile("rb")
            info = f.readline()
            if not info.startswith(b"INFO"):
                raise OSError(f"not a NATS server: {info[:80]!r}")
            s.sendall(b'CONNECT {"verbose":true,"pedantic":false,'
                      b'"name":"minio-tpu"}\r\n')
            self._expect_ok(f)
            s.sendall(b"PUB %s %d\r\n%s\r\n" % (
                self.subject.encode(), len(body), body))
            self._expect_ok(f)


class AMQPTarget:
    """Event delivery over real AMQP 0-9-1 (pkg/event/target/amqp.go):
    protocol header, Connection.Start/Tune/Open handshake with PLAIN
    auth, Channel.Open, then Basic.Publish with a content header +
    body frame to the configured exchange/routing key."""

    FRAME_METHOD, FRAME_HEADER, FRAME_BODY = 1, 2, 3
    FRAME_END = 0xCE

    def __init__(self, arn: str, addr: str, exchange: str = "",
                 routing_key: str = "minioevents",
                 user: str = "guest", password: str = "guest",
                 vhost: str = "/", timeout: float = 5.0,
                 connect: Optional[Callable[[], socket.socket]] = None):
        # shortstr fields are capped at 255 bytes on the wire; reject
        # at configuration time so _register skips the target instead
        # of every send() failing forever
        for name, v in (("exchange", exchange),
                        ("routing_key", routing_key), ("user", user),
                        ("vhost", vhost)):
            if len(v.encode()) > 255 or any(ord(c) < 0x20 for c in v):
                raise ValueError(
                    f"invalid AMQP {name} {v!r}: max 255 bytes, no "
                    "control characters")
        self.arn, self.addr = arn, addr
        self.exchange, self.routing_key = exchange, routing_key
        self.user, self.password, self.vhost = user, password, vhost
        self.timeout = timeout
        self._connect = connect or self._default_connect

    def _default_connect(self) -> socket.socket:
        from ..utils import host_port
        return socket.create_connection(
            host_port(self.addr, 5672), timeout=self.timeout)

    # -- wire encoding -----------------------------------------------------

    @staticmethod
    def _shortstr(s: str) -> bytes:
        b = s.encode()
        return bytes([len(b)]) + b

    @staticmethod
    def _longstr(b: bytes) -> bytes:
        return len(b).to_bytes(4, "big") + b

    def _frame(self, ftype: int, channel: int, payload: bytes) -> bytes:
        return (bytes([ftype]) + channel.to_bytes(2, "big")
                + len(payload).to_bytes(4, "big") + payload
                + bytes([self.FRAME_END]))

    def _method(self, channel: int, cls: int, meth: int,
                args: bytes) -> bytes:
        return self._frame(self.FRAME_METHOD, channel,
                           cls.to_bytes(2, "big")
                           + meth.to_bytes(2, "big") + args)

    @classmethod
    def _read_frame(cls, f) -> tuple[int, int, bytes]:
        head = f.read(7)
        if len(head) < 7:
            raise OSError("AMQP connection closed")
        ftype = head[0]
        channel = int.from_bytes(head[1:3], "big")
        size = int.from_bytes(head[3:7], "big")
        payload = f.read(size)
        if f.read(1) != bytes([cls.FRAME_END]):
            raise OSError("AMQP framing error")
        return ftype, channel, payload

    def _expect_method(self, f, cls_id: int, meth_id: int) -> bytes:
        ftype, _ch, payload = self._read_frame(f)
        if ftype != self.FRAME_METHOD or len(payload) < 4:
            raise OSError("AMQP: expected method frame")
        got_cls = int.from_bytes(payload[:2], "big")
        got_meth = int.from_bytes(payload[2:4], "big")
        if (got_cls, got_meth) != (cls_id, meth_id):
            raise OSError(f"AMQP: expected {cls_id}.{meth_id}, "
                          f"got {got_cls}.{got_meth}")
        return payload[4:]

    def send(self, record: dict) -> None:
        body = json.dumps(record).encode()
        with self._connect() as s:
            f = s.makefile("rb")
            s.sendall(b"AMQP\x00\x00\x09\x01")
            self._expect_method(f, 10, 10)          # Connection.Start
            plain = self._longstr(
                b"\x00" + self.user.encode() + b"\x00"
                + self.password.encode())
            s.sendall(self._method(
                0, 10, 11,                          # Start-Ok
                (0).to_bytes(4, "big")              # empty client table
                + self._shortstr("PLAIN") + plain
                + self._shortstr("en_US")))
            tune = self._expect_method(f, 10, 30)   # Tune
            offered = int.from_bytes(tune[2:6], "big") \
                if len(tune) >= 6 else 0
            # the client's frame-max must not exceed the server's offer
            # (0 = no server limit)
            frame_max = min(offered or 131072, 131072)
            s.sendall(self._method(
                0, 10, 31,                          # Tune-Ok
                (0).to_bytes(2, "big")
                + frame_max.to_bytes(4, "big")
                + (0).to_bytes(2, "big")))
            s.sendall(self._method(
                0, 10, 40,                          # Open (vhost)
                self._shortstr(self.vhost)
                + self._shortstr("") + b"\x00"))
            self._expect_method(f, 10, 41)          # Open-Ok
            s.sendall(self._method(1, 20, 10,       # Channel.Open
                                   self._shortstr("")))
            self._expect_method(f, 20, 11)          # Channel.Open-Ok
            s.sendall(self._method(
                1, 60, 40,                          # Basic.Publish
                (0).to_bytes(2, "big")
                + self._shortstr(self.exchange)
                + self._shortstr(self.routing_key) + b"\x00"))
            header = ((60).to_bytes(2, "big")       # content header
                      + (0).to_bytes(2, "big")
                      + len(body).to_bytes(8, "big")
                      + (0x8000).to_bytes(2, "big")  # content-type set
                      + self._shortstr("application/json"))
            s.sendall(self._frame(self.FRAME_HEADER, 1, header))
            # split the body at frame-max (8 bytes of frame overhead)
            chunk = max(frame_max - 8, 1)
            for at in range(0, len(body), chunk):
                s.sendall(self._frame(self.FRAME_BODY, 1,
                                      body[at:at + chunk]))
            s.sendall(self._method(0, 10, 50,       # Connection.Close
                                   (200).to_bytes(2, "big")
                                   + self._shortstr("bye")
                                   + (0).to_bytes(4, "big")))
            # the broker reports async publish failures (unroutable
            # exchange etc.) as Channel.Close/Connection.Close before
            # our Close-Ok — fire-and-forget here would ack-and-delete
            # a lost event from the durable queue
            ftype, _ch, payload = self._read_frame(f)
            if ftype == self.FRAME_METHOD and len(payload) >= 4:
                cls_id = int.from_bytes(payload[:2], "big")
                meth_id = int.from_bytes(payload[2:4], "big")
                if (cls_id, meth_id) == (10, 51):   # Close-Ok: clean
                    return
                if meth_id == 40 or (cls_id, meth_id) == (10, 50):
                    code = int.from_bytes(payload[4:6], "big") \
                        if len(payload) >= 6 else 0
                    raise OSError(
                        f"AMQP publish refused ({cls_id}.{meth_id} "
                        f"reply-code {code})")
            raise OSError("AMQP: unexpected reply to Connection.Close")


class NSQTarget:
    """Event delivery over the real NSQ TCP protocol
    (pkg/event/target/nsq.go): '  V2' magic, PUB <topic> with a 4-byte
    big-endian size prefix, OK frame response."""

    def __init__(self, arn: str, addr: str, topic: str,
                 timeout: float = 5.0,
                 connect: Optional[Callable[[], socket.socket]] = None):
        # the topic is interpolated into the PUB command line: NSQ
        # names are [.a-zA-Z0-9_-], 1..64 chars — reject anything else
        # at configuration time (same reasoning as NATSTarget)
        import re as _re
        if not _re.fullmatch(r"[.a-zA-Z0-9_-]{1,64}(#ephemeral)?",
                             topic):
            raise ValueError(
                f"invalid NSQ topic {topic!r}: must match "
                "[.a-zA-Z0-9_-]{{1,64}} with optional #ephemeral")
        self.arn, self.addr, self.topic = arn, addr, topic
        self.timeout = timeout
        self._connect = connect or self._default_connect

    def _default_connect(self) -> socket.socket:
        from ..utils import host_port
        return socket.create_connection(
            host_port(self.addr, 4150), timeout=self.timeout)

    def send(self, record: dict) -> None:
        body = json.dumps(record).encode()
        with self._connect() as s:
            s.sendall(b"  V2")
            s.sendall(b"PUB %s\n" % self.topic.encode()
                      + len(body).to_bytes(4, "big") + body)
            # response frame: [size u32][frame_type i32][data]
            head = b""
            while len(head) < 8:
                chunk = s.recv(8 - len(head))
                if not chunk:
                    raise OSError("NSQ connection closed")
                head += chunk
            size = int.from_bytes(head[:4], "big")
            frame_type = int.from_bytes(head[4:8], "big", signed=True)
            data = b""
            while len(data) < size - 4:
                chunk = s.recv(size - 4 - len(data))
                if not chunk:
                    break
                data += chunk
            if frame_type == 1 or not data.startswith(b"OK"):
                raise OSError(f"NSQ error: {data[:80]!r}")


class PostgresTarget:
    """Event delivery over the PostgreSQL v3 wire protocol
    (pkg/event/target/postgresql.go): startup + cleartext/MD5/
    SCRAM-SHA-256 password auth (the modern server default; mutual
    proof verification per RFC 7677), then simple-query INSERTs.
    format="namespace" upserts one row per object key (and deletes on
    removal events); format="access" appends. Reference table
    contract: namespace = (key TEXT PRIMARY KEY, value TEXT/JSONB),
    access = (event_time TIMESTAMP, event_data TEXT/JSONB).
    """

    def __init__(self, arn: str, addr: str, database: str, table: str,
                 user: str = "postgres", password: str = "",
                 format: str = "namespace", timeout: float = 5.0,
                 connect: Optional[Callable[[], socket.socket]] = None):
        import re as _re
        if not _re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]{0,62}", table):
            raise ValueError(
                f"invalid Postgres table name {table!r}")
        self.arn, self.addr = arn, addr
        self.database, self.table = database, table
        self.user, self.password = user, password
        self.format = format
        self.timeout = timeout
        self._connect = connect or self._default_connect

    def _default_connect(self) -> socket.socket:
        from ..utils import host_port
        return socket.create_connection(
            host_port(self.addr, 5432), timeout=self.timeout)

    # -- wire plumbing -----------------------------------------------------

    @staticmethod
    def _msg(tag: bytes, payload: bytes) -> bytes:
        return tag + (len(payload) + 4).to_bytes(4, "big") + payload

    @staticmethod
    def _read_msg(f) -> tuple[bytes, bytes]:
        tag = f.read(1)
        if not tag:
            raise OSError("postgres connection closed")
        size = int.from_bytes(f.read(4), "big")
        return tag, f.read(size - 4)

    def _auth(self, s, f) -> None:
        # standard_conforming_strings rides the StartupMessage options
        # (quote-doubled literals are only injection-safe with it on;
        # pinning here costs no extra round trip)
        params = (b"user\x00" + self.user.encode() + b"\x00"
                  b"database\x00" + self.database.encode() + b"\x00"
                  b"options\x00-c standard_conforming_strings=on\x00"
                  b"\x00")
        s.sendall((len(params) + 8).to_bytes(4, "big")
                  + (196608).to_bytes(4, "big") + params)  # proto 3.0
        while True:
            tag, payload = self._read_msg(f)
            if tag == b"E":
                raise OSError(f"postgres error: {payload[:120]!r}")
            if tag != b"R":
                continue
            code = int.from_bytes(payload[:4], "big")
            if code == 0:                       # AuthenticationOk
                break
            if code == 3:                       # cleartext password
                s.sendall(self._msg(
                    b"p", self.password.encode() + b"\x00"))
            elif code == 5:                     # md5 password
                salt = payload[4:8]
                inner = hashlib.md5(
                    self.password.encode()
                    + self.user.encode()).hexdigest()
                digest = hashlib.md5(
                    inner.encode() + salt).hexdigest()
                s.sendall(self._msg(
                    b"p", b"md5" + digest.encode() + b"\x00"))
            elif code == 10:                    # SASL (RFC 5802/7677)
                # modern servers default to scram-sha-256 — speak it
                mechs = [m.decode() for m in
                         payload[4:].split(b"\x00") if m]
                if "SCRAM-SHA-256" not in mechs:
                    raise OSError(
                        "postgres offers no SCRAM-SHA-256 "
                        f"mechanism (got {mechs})")
                import secrets as _secrets
                nonce = base64.b64encode(
                    _secrets.token_bytes(18)).decode()
                # user is empty in gs2: the startup message names it
                first_bare = f"n=,r={nonce}"
                init = b"n,," + first_bare.encode()
                body = (b"SCRAM-SHA-256\x00"
                        + len(init).to_bytes(4, "big") + init)
                s.sendall(self._msg(b"p", body))
                scram_state = (nonce, first_bare)
            elif code == 11:                    # SASLContinue
                nonce, first_bare = scram_state
                server_first = payload[4:].decode()
                fields = dict(kv.split("=", 1) for kv in
                              server_first.split(","))
                srv_nonce, salt_b64 = fields["r"], fields["s"]
                iters = int(fields["i"])
                if not srv_nonce.startswith(nonce):
                    raise OSError("postgres scram: server nonce "
                                  "does not extend ours")
                salted = hashlib.pbkdf2_hmac(
                    "sha256", self.password.encode(),
                    base64.b64decode(salt_b64), iters)
                ckey = hmac.new(salted, b"Client Key",
                                hashlib.sha256).digest()
                stored = hashlib.sha256(ckey).digest()
                final_bare = f"c=biws,r={srv_nonce}"
                auth_msg = ",".join(
                    (first_bare, server_first, final_bare)).encode()
                csig = hmac.new(stored, auth_msg,
                                hashlib.sha256).digest()
                proof = bytes(a ^ b for a, b in zip(ckey, csig))
                skey = hmac.new(salted, b"Server Key",
                                hashlib.sha256).digest()
                scram_verify = hmac.new(skey, auth_msg,
                                        hashlib.sha256).digest()
                s.sendall(self._msg(
                    b"p", (final_bare + ",p="
                           + base64.b64encode(proof).decode()
                           ).encode()))
            elif code == 12:                    # SASLFinal
                fields = dict(kv.split("=", 1) for kv in
                              payload[4:].decode().split(","))
                if base64.b64decode(fields.get("v", "")) != \
                        scram_verify:
                    raise OSError("postgres scram: bad server "
                                  "signature (not the real server?)")
            else:
                raise OSError(
                    f"unsupported postgres auth method {code}")
        # drain ParameterStatus/BackendKeyData until ReadyForQuery
        while True:
            tag, payload = self._read_msg(f)
            if tag == b"Z":
                return
            if tag == b"E":
                raise OSError(f"postgres error: {payload[:120]!r}")

    def _query(self, s, f, sql: str) -> None:
        s.sendall(self._msg(b"Q", sql.encode() + b"\x00"))
        err = None
        while True:
            tag, payload = self._read_msg(f)
            if tag == b"E":
                err = payload[:200]
            if tag == b"Z":
                break
        if err is not None:
            raise OSError(f"postgres query failed: {err!r}")

    @staticmethod
    def _lit(s: str) -> str:
        """SQL string literal with quotes doubled (simple-query
        protocol has no parameter binding)."""
        return "'" + s.replace("'", "''") + "'"

    def send(self, record: dict) -> None:
        rec = record["Records"][0]
        obj_key = (rec["s3"]["bucket"]["name"] + "/"
                   + rec["s3"]["object"]["key"])
        payload = json.dumps(record)
        if self.format == "access":
            # reference access schema: (event_time, event_data)
            sql = (f"INSERT INTO {self.table} (event_time, event_data)"
                   f" VALUES (now(), {self._lit(payload)})")
        elif rec["eventName"].startswith("s3:ObjectRemoved"):
            sql = (f"DELETE FROM {self.table} WHERE key = "
                   f"{self._lit(obj_key)}")
        else:
            sql = (f"INSERT INTO {self.table} (key, value) VALUES "
                   f"({self._lit(obj_key)}, {self._lit(payload)}) "
                   f"ON CONFLICT (key) DO UPDATE SET value = "
                   f"EXCLUDED.value")
        with self._connect() as s:
            f = s.makefile("rb")
            self._auth(s, f)
            self._query(s, f, sql)
            s.sendall(self._msg(b"X", b""))     # Terminate


class MySQLTarget:
    """Event delivery over the MySQL client/server protocol
    (pkg/event/target/mysql.go): handshake v10 with
    mysql_native_password or caching_sha2_password (the 8.0+ default;
    fast-auth path — the full-auth RSA exchange needs TLS and fails
    with a clear action), honoring server AuthSwitchRequest, then
    COM_QUERY statements. Same table contract and formats as the
    Postgres target."""

    CLIENT_LONG_PASSWORD = 0x1
    CLIENT_CONNECT_WITH_DB = 0x8
    CLIENT_PROTOCOL_41 = 0x200
    CLIENT_SECURE_CONNECTION = 0x8000
    CLIENT_PLUGIN_AUTH = 0x80000

    def __init__(self, arn: str, addr: str, database: str, table: str,
                 user: str = "root", password: str = "",
                 format: str = "namespace", timeout: float = 5.0,
                 connect: Optional[Callable[[], socket.socket]] = None):
        import re as _re
        if not _re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]{0,63}", table):
            raise ValueError(f"invalid MySQL table name {table!r}")
        if database and not _re.fullmatch(
                r"[A-Za-z0-9_$-]{1,64}", database):
            raise ValueError(f"invalid MySQL database name {database!r}")
        self.arn, self.addr = arn, addr
        self.database, self.table = database, table
        self.user, self.password = user, password
        self.format = format
        self.timeout = timeout
        self._connect = connect or self._default_connect

    def _default_connect(self) -> socket.socket:
        from ..utils import host_port
        return socket.create_connection(
            host_port(self.addr, 3306), timeout=self.timeout)

    # -- packet plumbing ---------------------------------------------------

    @staticmethod
    def _read_packet(f) -> tuple[int, bytes]:
        head = f.read(4)
        if len(head) < 4:
            raise OSError("mysql connection closed")
        size = int.from_bytes(head[:3], "little")
        return head[3], f.read(size)

    @staticmethod
    def _packet(seq: int, payload: bytes) -> bytes:
        return (len(payload).to_bytes(3, "little") + bytes([seq])
                + payload)

    def _scramble(self, salt: bytes) -> bytes:
        """mysql_native_password token."""
        if not self.password:
            return b""
        h1 = hashlib.sha1(self.password.encode()).digest()
        h2 = hashlib.sha1(h1).digest()
        h3 = hashlib.sha1(salt + h2).digest()
        return bytes(a ^ b for a, b in zip(h1, h3))

    def _scramble_sha2(self, nonce: bytes) -> bytes:
        """caching_sha2_password token: XOR(SHA256(pw),
        SHA256(SHA256(SHA256(pw)) || nonce)) — the modern server
        default (8.0+)."""
        if not self.password:
            return b""
        h1 = hashlib.sha256(self.password.encode()).digest()
        h2 = hashlib.sha256(hashlib.sha256(h1).digest() + nonce).digest()
        return bytes(a ^ b for a, b in zip(h1, h2))

    @staticmethod
    def _check_ok(payload: bytes, what: str) -> None:
        if payload[:1] == b"\xff":
            code = int.from_bytes(payload[1:3], "little")
            raise OSError(f"mysql {what} failed ({code}): "
                          f"{payload[9:120]!r}")

    def send(self, record: dict) -> None:
        rec = record["Records"][0]
        obj_key = (rec["s3"]["bucket"]["name"] + "/"
                   + rec["s3"]["object"]["key"])
        payload = json.dumps(record)

        def lit(s: str) -> str:
            # quote-doubling only: the connection pins
            # NO_BACKSLASH_ESCAPES, making backslashes literal in every
            # deployment (mirrors the Postgres target's
            # standard_conforming_strings pin)
            return "'" + s.replace("'", "''") + "'"

        if self.format == "access":
            # reference access schema: (event_time, event_data)
            sql = (f"INSERT INTO {self.table} (event_time, event_data)"
                   f" VALUES (NOW(), {lit(payload)})")
        elif rec["eventName"].startswith("s3:ObjectRemoved"):
            sql = (f"DELETE FROM {self.table} WHERE `key` = "
                   f"{lit(obj_key)}")
        else:
            sql = (f"REPLACE INTO {self.table} (`key`, value) VALUES "
                   f"({lit(obj_key)}, {lit(payload)})")

        with self._connect() as s:
            f = s.makefile("rb")
            _seq, greet = self._read_packet(f)
            self._check_ok(greet, "handshake")
            if greet[:1] != b"\x0a":
                raise OSError("unsupported mysql protocol version")
            at = greet.index(b"\x00", 1) + 1    # server version string
            at += 4                             # thread id
            salt = greet[at:at + 8]
            at += 8 + 1                         # salt part 1 + filler
            at += 2 + 1 + 2 + 2 + 1 + 10        # caps, charset, status…
            salt += greet[at:at + 12]           # salt part 2 (of 13-1)
            at += 12 + 1                        # salt part 2 + NUL
            end = greet.find(b"\x00", at)
            plugin = greet[at:end if end >= 0 else None].decode(
                "ascii", "replace") or "mysql_native_password"
            caps = (self.CLIENT_LONG_PASSWORD | self.CLIENT_PROTOCOL_41
                    | self.CLIENT_SECURE_CONNECTION
                    | self.CLIENT_PLUGIN_AUTH)
            if self.database:
                caps |= self.CLIENT_CONNECT_WITH_DB
            if plugin == "caching_sha2_password":
                token = self._scramble_sha2(salt)
            else:
                plugin = "mysql_native_password"
                token = self._scramble(salt)
            resp = (caps.to_bytes(4, "little")
                    + (1 << 24).to_bytes(4, "little")   # max packet
                    + bytes([33]) + bytes(23)           # utf8 + filler
                    + self.user.encode() + b"\x00"
                    + bytes([len(token)]) + token)
            if self.database:
                # selected in the handshake (CLIENT_CONNECT_WITH_DB):
                # no per-event USE round trip, no identifier splicing
                resp += self.database.encode() + b"\x00"
            resp += plugin.encode() + b"\x00"
            s.sendall(self._packet(1, resp))
            seq, auth = self._read_packet(f)
            self._check_ok(auth, "auth")
            if auth[:1] == b"\xfe":
                # AuthSwitchRequest: plugin name NUL, then new nonce
                end = auth.index(b"\x00", 1)
                new_plugin = auth[1:end].decode("ascii", "replace")
                new_salt = auth[end + 1:].rstrip(b"\x00")
                if new_plugin == "mysql_native_password":
                    token = self._scramble(new_salt)
                elif new_plugin == "caching_sha2_password":
                    token = self._scramble_sha2(new_salt)
                else:
                    raise OSError(
                        f"mysql requested unsupported auth plugin "
                        f"{new_plugin!r}")
                s.sendall(self._packet(seq + 1, token))
                seq, auth = self._read_packet(f)
                self._check_ok(auth, "auth switch")
                plugin = new_plugin
            if plugin == "caching_sha2_password" and \
                    auth[:1] == b"\x01":
                # AuthMoreData: 0x03 = fast-auth success (an OK packet
                # follows); 0x04 = full auth, which needs TLS or the
                # server RSA key exchange — fail with a clear action
                if auth[1:2] == b"\x03":
                    _seq, auth = self._read_packet(f)
                    self._check_ok(auth, "auth")
                elif auth[1:2] == b"\x04":
                    raise OSError(
                        "mysql caching_sha2_password full "
                        "authentication requires TLS (no cached "
                        "entry for this user); connect once with "
                        "another client to prime the cache, or "
                        "create the notify user WITH "
                        "mysql_native_password")
                else:
                    raise OSError("mysql: unexpected AuthMoreData "
                                  f"{auth[1:2]!r}")
            for stmt in ("SET SESSION sql_mode = "
                         "'NO_BACKSLASH_ESCAPES'", sql):
                s.sendall(self._packet(0, b"\x03" + stmt.encode()))
                _seq, reply = self._read_packet(f)
                self._check_ok(reply, "query")
            s.sendall(self._packet(0, b"\x01"))     # COM_QUIT


class ElasticsearchTarget:
    """Event delivery to an Elasticsearch index over its HTTP document
    API (pkg/event/target/elasticsearch.go): format="namespace" keeps
    one doc per object key (PUT /index/_doc/<id>, DELETE on removal);
    format="access" appends (POST /index/_doc)."""

    def __init__(self, arn: str, url: str, index: str,
                 format: str = "namespace", timeout: float = 5.0):
        self.arn = arn
        self.url = url.rstrip("/")
        self.index = index
        self.format = format
        self.timeout = timeout

    def _doc_id(self, record: dict) -> str:
        rec = record["Records"][0]
        bucket = rec["s3"]["bucket"]["name"]
        key = rec["s3"]["object"]["key"]
        import urllib.parse as _up
        return _up.quote(f"{bucket}/{key}", safe="")

    def send(self, record: dict) -> None:
        rec = record["Records"][0]
        body = json.dumps(record).encode()
        if self.format == "access":
            req = urllib.request.Request(
                f"{self.url}/{self.index}/_doc", data=body,
                method="POST",
                headers={"Content-Type": "application/json"})
        elif rec["eventName"].startswith("s3:ObjectRemoved"):
            req = urllib.request.Request(
                f"{self.url}/{self.index}/_doc/{self._doc_id(record)}",
                method="DELETE")
        else:
            req = urllib.request.Request(
                f"{self.url}/{self.index}/_doc/{self._doc_id(record)}",
                data=body, method="PUT",
                headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout) as resp:
                resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404 and req.get_method() == "DELETE":
                return                 # deleting a never-indexed doc
            raise


# -- Kafka wire protocol (pkg/event/target/kafka.go semantics) --------------
#
# The reference drives Kafka through sarama; this speaks the protocol
# itself: ApiVersions v0 handshake, Metadata v1 for leader discovery,
# Produce v2 with a MessageSet v1 (magic-1 messages: CRC32, timestamp,
# key = object key, value = event JSON). Partition choice mirrors
# sarama's default hash partitioner: FNV-1a(key) mod numPartitions.

_K_PRODUCE, _K_METADATA, _K_APIVERSIONS = 0, 3, 18


def _k_str(s: Optional[str]) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    raw = s.encode()
    return struct.pack(">h", len(raw)) + raw


def _k_bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


class _KReader:
    """Big-endian cursor over one Kafka response payload."""

    def __init__(self, raw: bytes):
        self.raw, self.at = raw, 0

    def take(self, n: int) -> bytes:
        if self.at + n > len(self.raw):
            raise OSError("kafka: truncated response")
        out = self.raw[self.at:self.at + n]
        self.at += n
        return out

    def i8(self) -> int:
        return struct.unpack(">b", self.take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self.take(8))[0]

    def string(self) -> str:
        n = self.i16()
        return "" if n < 0 else self.take(n).decode()


def _fnv1a32(data: bytes) -> int:
    h = 0x811C9DC5
    for b in data:
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


def _sarama_partition(key: bytes, n: int) -> int:
    """sarama's default hash partitioner, bit-for-bit: p = int32(fnv1a)
    % n with Go's truncate-toward-zero modulo, negated if negative
    (even the int32-min overflow case matches)."""
    h = _fnv1a32(key)
    if h >= 1 << 31:
        h -= 1 << 32                    # int32 view
    p = h - int(h / n) * n              # Go %: truncated, sign of h
    return -p if p < 0 else p


class _KafkaConn:
    """One broker connection: framed request/response with correlation
    id checking."""

    def __init__(self, host: str, port: int, client_id: str,
                 timeout: float):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self.client_id = client_id
        self._corr = 0

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def call(self, api_key: int, api_version: int, body: bytes
             ) -> _KReader:
        self._corr += 1
        header = struct.pack(">hhi", api_key, api_version, self._corr) \
            + _k_str(self.client_id)
        msg = header + body
        self.sock.sendall(struct.pack(">i", len(msg)) + msg)
        raw = self._read_exact(4)
        (size,) = struct.unpack(">i", raw)
        payload = self._read_exact(size)
        r = _KReader(payload)
        corr = r.i32()
        if corr != self._corr:
            raise OSError(f"kafka: correlation id {corr} != {self._corr}")
        return r

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise OSError("kafka: connection closed")
            buf += chunk
        return buf


class KafkaTarget:
    """Kafka target speaking the real produce protocol
    (pkg/event/target/kafka.go): key = object key, value = event JSON,
    routed to `topic` on the partition leader. A custom `producer`
    remains injectable for embedding."""

    def __init__(self, arn: str, brokers: list[str], topic: str,
                 producer: Optional[Callable] = None,
                 client_id: str = "minio-tpu", timeout: float = 10.0):
        self.arn, self.brokers, self.topic = arn, brokers, topic
        self.client_id, self.timeout = client_id, timeout
        self._producer = producer    # wire client built lazily on first
        # send: connecting in __init__ would run inside ConfigSys.apply
        # on node startup and crash the boot when the broker is down —
        # deferring lets the queuestore retry machinery absorb it
        self._meta: Optional[tuple[dict, dict]] = None
        self._conns: dict[int, _KafkaConn] = {}   # node id -> conn
        self._mu = threading.Lock()

    # -- wire producer -----------------------------------------------------

    def _connect_any(self) -> _KafkaConn:
        last: Optional[Exception] = None
        for b in self.brokers:
            host, _, port = b.partition(":")
            try:
                conn = _KafkaConn(host, int(port or 9092),
                                  self.client_id, self.timeout)
                self._handshake(conn)
                return conn
            except (OSError, ValueError) as e:
                last = e
        raise OSError(f"kafka: no broker reachable: {last}")

    @staticmethod
    def _handshake(conn: _KafkaConn) -> None:
        """ApiVersions v0: confirm the broker speaks Produce v2 and
        Metadata v1 before using them."""
        r = conn.call(_K_APIVERSIONS, 0, b"")
        err = r.i16()
        if err:
            raise OSError(f"kafka: ApiVersions error {err}")
        supported = {}
        for _ in range(r.i32()):
            key, lo, hi = r.i16(), r.i16(), r.i16()
            supported[key] = (lo, hi)
        for key, need in ((_K_PRODUCE, 2), (_K_METADATA, 1)):
            lo, hi = supported.get(key, (0, -1))
            if not lo <= need <= hi:
                raise OSError(
                    f"kafka: broker lacks api {key} v{need}")

    def _metadata(self, conn: _KafkaConn
                  ) -> tuple[dict[int, tuple[str, int]],
                             dict[int, int]]:
        """Metadata v1 for the topic: returns ({node: (host, port)},
        {partition: leader_node})."""
        body = struct.pack(">i", 1) + _k_str(self.topic)
        r = conn.call(_K_METADATA, 1, body)
        brokers = {}
        for _ in range(r.i32()):
            node = r.i32()
            host = r.string()
            port = r.i32()
            r.string()                       # rack (nullable)
            brokers[node] = (host, port)
        r.i32()                              # controller id
        leaders: dict[int, int] = {}
        for _ in range(r.i32()):             # topics
            terr = r.i16()
            name = r.string()
            r.i8()                           # is_internal
            nparts = r.i32()
            for _ in range(nparts):
                perr = r.i16()
                pid = r.i32()
                leader = r.i32()
                for _ in range(r.i32()):
                    r.i32()                  # replicas
                for _ in range(r.i32()):
                    r.i32()                  # isr
                if name == self.topic and perr == 0:
                    leaders[pid] = leader
            if name == self.topic and terr:
                raise OSError(f"kafka: topic {name} error {terr}")
        if not leaders:
            raise OSError(f"kafka: topic {self.topic} has no partitions")
        return brokers, leaders

    @staticmethod
    def _message_set(key: bytes, value: bytes) -> bytes:
        """MessageSet v1: one magic-1 message, CRC over everything
        after the crc field."""
        ts_ms = int(time.time() * 1000)
        content = struct.pack(">bbq", 1, 0, ts_ms) \
            + _k_bytes(key) + _k_bytes(value)
        msg = struct.pack(">I", zlib.crc32(content)) + content
        return struct.pack(">qi", 0, len(msg)) + msg

    def _reset(self) -> None:
        for c in self._conns.values():
            c.close()
        self._conns.clear()
        self._meta = None

    def _leader_conn(self, node: int, host: str, port: int
                     ) -> _KafkaConn:
        conn = self._conns.get(node)
        if conn is None:
            conn = _KafkaConn(host, port, self.client_id, self.timeout)
            self._conns[node] = conn
        return conn

    def _wire_produce(self, topic: str, key: bytes, value: bytes
                      ) -> None:
        """Metadata and leader connections are cached across events —
        one produce is one request on a standing connection, not two
        fresh TCP connects + handshake + metadata per event. Any
        OSError drops the cache and retries once (leader moved, broker
        restarted); the second failure surfaces to the queuestore."""
        with self._mu:
            for attempt in (0, 1):
                try:
                    if self._meta is None:
                        conn = self._connect_any()
                        try:
                            self._meta = self._metadata(conn)
                        finally:
                            conn.close()
                    brokers, leaders = self._meta
                    pids = sorted(leaders)
                    pid = pids[_sarama_partition(key, len(pids))]
                    host, port = brokers[leaders[pid]]
                    conn = self._leader_conn(leaders[pid], host, port)
                    mset = self._message_set(key, value)
                    body = (struct.pack(">hi", 1,
                                        int(self.timeout * 1000))
                            + struct.pack(">i", 1) + _k_str(topic)
                            + struct.pack(">i", 1)
                            + struct.pack(">i", pid)
                            + struct.pack(">i", len(mset)) + mset)
                    r = conn.call(_K_PRODUCE, 2, body)
                    for _ in range(r.i32()):         # topics
                        r.string()
                        for _ in range(r.i32()):     # partition responses
                            r.i32()                  # partition
                            err = r.i16()
                            r.i64()                  # base offset
                            r.i64()                  # log append time
                            if err:
                                raise OSError(
                                    f"kafka: produce error {err}")
                    return
                except OSError:
                    self._reset()
                    if attempt:
                        raise

    def send(self, record: dict) -> None:
        if self._producer is None:
            self._producer = self._wire_produce
        rec = record["Records"][0]
        key = rec["s3"]["object"]["key"].encode()
        self._producer(self.topic, key, json.dumps(record).encode())


class MemoryTarget:
    """Captures records in-process (tests / ListenNotification feed)."""

    def __init__(self, arn: str):
        self.arn = arn
        self.records: list[dict] = []
        self._cond = threading.Condition()

    def send(self, record: dict) -> None:
        with self._cond:
            self.records.append(record)
            self._cond.notify_all()

    def wait_for(self, n: int, timeout: float = 5.0) -> bool:
        deadline = time.monotonic() + timeout
        with self._cond:
            while len(self.records) < n:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    return False
            return True


# ---------------------------------------------------------------------------
# notifier
# ---------------------------------------------------------------------------

def event_record(event_name: str, bucket: str, key: str, size: int = 0,
                 etag: str = "", region: str = "us-east-1") -> dict:
    """S3 event message structure (pkg/event/event.go)."""
    now = time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime())
    return {"Records": [{
        "eventVersion": "2.0", "eventSource": "minio:s3",
        "awsRegion": region, "eventTime": now, "eventName": event_name,
        "userIdentity": {"principalId": "minio"},
        "s3": {"s3SchemaVersion": "1.0",
               "bucket": {"name": bucket,
                          "arn": f"arn:aws:s3:::{bucket}"},
               "object": {"key": key, "size": size, "eTag": etag}},
    }]}


class EventNotifier:
    """Per-bucket rule matching + async fan-out with retries."""

    def __init__(self, bucket_meta_sys, region: str = "us-east-1",
                 retries: int = 3, queue_size: int = 10000,
                 queue_dir: Optional[str] = None,
                 redrive_interval: float = 60.0):
        self.bucket_meta = bucket_meta_sys
        self.region = region
        self.retries = retries
        self.targets: dict[str, object] = {}     # arn -> target
        # durable at-least-once backlog, one store per target (reference
        # queuestore.go); None = legacy in-memory at-most-once
        self.queue_dir = queue_dir
        self.redrive_interval = redrive_interval
        self._stores: dict[str, QueueStore] = {}
        self._inflight: set[tuple[str, str]] = set()   # (arn, key)
        # live-listen hub: every event (rule-matched or not) publishes
        # here for ListenBucketNotification subscribers (pkg/pubsub use
        # in cmd/listen-notification-handlers.go)
        from ..utils.pubsub import PubSub
        self.hub = PubSub()
        self._mu = threading.Lock()
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        if queue_dir is not None:
            self._redrive_thread = threading.Thread(
                target=self._redrive_loop, daemon=True)
            self._redrive_thread.start()

    def register_target(self, target) -> None:
        self.targets[target.arn] = target
        if self.queue_dir is not None:
            safe = "".join(c if c.isalnum() or c in "-_." else "_"
                           for c in target.arn)
            store = QueueStore(os.path.join(self.queue_dir, safe))
            self._stores[target.arn] = store
            self.redrive(target.arn)     # replay pre-restart backlog

    def unregister_target(self, arn: str) -> None:
        """Remove a target AND its queue store binding — a disabled
        target must stop accumulating (and redriving) backlog. Entries
        already on disk stay there until the target is re-enabled."""
        self.targets.pop(arn, None)
        self._stores.pop(arn, None)

    def close(self) -> None:
        self._stop.set()
        self.hub.publish(None)          # ends every listener's stream

    def send(self, event_name: str, bucket: str, key: str,
             size: int = 0, etag: str = "") -> None:
        if self.hub.subscriber_count:
            self.hub.publish(
                (bucket, event_record(event_name, bucket, key, size,
                                      etag, self.region)))
        bm = self.bucket_meta.get(bucket)
        if not bm.notification_xml:
            return
        try:
            cfg = NotificationConfig.from_xml(bm.notification_xml)
        except ET.ParseError:
            return
        for rule in cfg.rules:
            if not rule.matches(event_name, key):
                continue
            target = self.targets.get(rule.arn)
            if target is None:
                continue
            record = event_record(event_name, bucket, key, size, etag,
                                  self.region)
            store = self._stores.get(rule.arn)
            store_key = store.put(record) if store is not None else None
            # store full -> at-most-once fallback (store_key None)
            self._enqueue(rule.arn, record, store_key, 0)

    def _enqueue(self, arn: str, record: dict, store_key: Optional[str],
                 attempt: int) -> bool:
        if store_key is not None:
            with self._mu:
                if (arn, store_key) in self._inflight:
                    return False
                self._inflight.add((arn, store_key))
        try:
            self._q.put_nowait((arn, record, store_key, attempt))
            return True
        except queue.Full:
            # durable entries stay in the store; the redrive loop
            # re-queues them once there is room (at-least-once)
            if store_key is not None:
                with self._mu:
                    self._inflight.discard((arn, store_key))
            return False

    def redrive(self, arn: Optional[str] = None) -> int:
        """Queue every persisted-but-unqueued entry (startup replay and
        the periodic loop). Returns how many were queued."""
        n = 0
        for a, store in list(self._stores.items()):
            if arn is not None and a != arn:
                continue
            if a not in self.targets:
                continue               # disabled target: backlog waits
            for key in store.keys():
                with self._mu:
                    if (a, key) in self._inflight:
                        continue
                record = store.get(key)
                if record is None:
                    store.delete(key)       # corrupt entry
                    continue
                if self._enqueue(a, record, key, 0):
                    n += 1
        return n

    def _redrive_loop(self) -> None:
        while not self._stop.wait(self.redrive_interval):
            self.redrive()

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                arn, record, store_key, attempt = self._q.get(
                    timeout=0.25)
            except queue.Empty:
                continue
            target = self.targets.get(arn)
            try:
                if target is None:
                    raise OSError(f"no target registered for {arn}")
                target.send(record)
                if store_key is not None:
                    # The target may have been unregistered while the
                    # send was in flight (admin config re-apply); only
                    # delete from a still-mounted store — a KeyError
                    # here would land in the retry path and re-send the
                    # already-delivered event.
                    store = self._stores.get(arn)
                    if store is not None:
                        store.delete(store_key)
                    with self._mu:
                        self._inflight.discard((arn, store_key))
            except Exception:  # noqa: BLE001 — retry with backoff
                if attempt + 1 < self.retries:
                    time.sleep(0.2 * (attempt + 1))
                    try:
                        self._q.put_nowait(
                            (arn, record, store_key, attempt + 1))
                    except queue.Full:
                        if store_key is not None:
                            with self._mu:
                                self._inflight.discard((arn, store_key))
                elif store_key is not None:
                    # retries exhausted: the durable entry REMAINS in
                    # the store; the redrive loop (or next restart)
                    # tries again — at-least-once, never silent drop
                    with self._mu:
                        self._inflight.discard((arn, store_key))
            finally:
                self._q.task_done()

    def drain(self, timeout: float = 5.0) -> None:
        done = threading.Event()

        def waiter():
            self._q.join()
            done.set()

        threading.Thread(target=waiter, daemon=True).start()
        done.wait(timeout)
