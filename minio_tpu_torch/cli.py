"""CLI — `python -m minio_tpu_torch server ...` process bootstrap, and
the admin verbs that drive a running node.

Counterpart of the `server`, `fsck`, `decommission`, `tier`, `qos` and
`notify` subcommands of minio_tpu/cli.py (the reference's main.go +
cmd/server-main.go): parse args, boot the node, print the startup banner,
block on SIGTERM/SIGINT. The admin verbs sign with the root credential
(MINIO_ROOT_USER / MINIO_ROOT_PASSWORD) through madmin.AdminClient:

    python -m minio_tpu_torch fsck --url 127.0.0.1:9000 [--repair]
    python -m minio_tpu_torch decommission --url ... --pool 0 | --status
    python -m minio_tpu_torch tier add|ls|rm|stats --url ...
    python -m minio_tpu_torch qos get|set|rm --url ... [--scope tenant|tier
        --name NAME --share W --rps R --rx-bps B --tx-bps B]
    python -m minio_tpu_torch notify status|add|rm --url ... [--type
        webhook|queue|log --name N --endpoint URL --path FILE --arn ARN]

    python -m minio_tpu_torch server /data/d{1...16} --address :9000

Distributed (run once per node, same node list everywhere; the node
listens on its own --node address, and --address is not read):

    python -m minio_tpu_torch server \
        --node 10.0.0.1:9000=/data/d{1...4} \
        --node 10.0.0.2:9000=/data/d{1...4} ... --this 0

``--device`` (default ``cuda``) picks where the erasure, hash and cipher
steps run: the default needs a card and exits non-zero without one;
``--device cpu`` runs the plain PyTorch versions on the host.

One drive path boots the plain-file FS backend (``cluster.start_fs``;
with ``--pool`` it exits 2, as the reference does). Each ``--pool``
appends one pool of drives to an erasure node online
(``ClusterNode.add_pool``), which also re-adopts a pool's persisted
draining state and resumes its drain. MINIO_TPU_FSCK_BOOT=on audits and
repairs the pools the boot opens (object/fsck.py); the ``--pool`` pools
join after that audit, as in the reference, so a fault in one of them
waits for an on-demand ``run_fsck``.

Refused with exit code 2 and a message, not half served: ``--node``
without a ``--this`` that indexes the list, and ``--pool`` with
``--node`` (distributed clusters are one pool). MINIO_COMPRESS=on
compresses eligible objects inline (by
extension and content type, as the reference does), with S2 framing or,
under MINIO_COMPRESS_ALGORITHM=zstd, zstd; a zstd PUT fails where the
`zstandard` package does not import, and never stores the object
uncompressed.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time

from .s3.credentials import Credentials, global_credentials


def _parse(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="minio_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("server", help="start an object-store node")
    s.add_argument("drives", nargs="*",
                   help="local drive paths (ellipses {1...N} supported)")
    s.add_argument("--address", default=":9000",
                   help="listen address host:port (default :9000)")
    s.add_argument("--node", action="append", default=[],
                   help="host:port=/drive{1...N} — one per cluster node")
    s.add_argument("--this", type=int, default=-1,
                   help="index of this node in the --node list")
    s.add_argument("--parity", type=int, default=None,
                   help="parity shards per set (default N/2)")
    s.add_argument("--set-drive-count", type=int, default=0,
                   help="drives per erasure set (default: auto 4..16)")
    s.add_argument("--region", default=os.environ.get(
        "MINIO_REGION", "us-east-1"))
    s.add_argument("--cert", default="", help="TLS certificate file")
    s.add_argument("--key", default="", help="TLS private key file")
    s.add_argument("--pool", action="append", default=[],
                   help="extra drive pool (ellipses supported), appended "
                   "online after boot; repeatable")
    s.add_argument("--device", default="cuda",
                   help="where the erasure, hash and cipher steps run: "
                   "cuda (default) or cpu")

    d = sub.add_parser("decommission",
                       help="drain a pool's objects into the active "
                       "pools (admin rebalance surface)")
    d.add_argument("--url", default="127.0.0.1:9000",
                   help="server admin endpoint host:port")
    d.add_argument("--pool", type=int, default=None,
                   help="pool index to decommission")
    d.add_argument("--status", action="store_true",
                   help="print rebalance/topology status and exit")
    d.add_argument("--cancel", action="store_true",
                   help="cancel the running drain (pool returns to "
                   "active)")
    d.add_argument("--region", default=os.environ.get(
        "MINIO_REGION", "us-east-1"))

    t = sub.add_parser("tier", help="manage remote tiers for ILM "
                       "transitions (mc admin tier surface)")
    t.add_argument("action", choices=("add", "ls", "rm", "stats"))
    t.add_argument("--url", default="127.0.0.1:9000",
                   help="server admin endpoint host:port")
    t.add_argument("--name", default="",
                   help="tier name (add/rm)")
    t.add_argument("--type", default="fs", dest="tier_type",
                   choices=("fs", "s3", "azure", "gcs", "hdfs"),
                   help="tier backend type (add)")
    t.add_argument("--param", action="append", default=[],
                   help="backend param key=value (repeatable): fs needs "
                   "path=...; s3 needs host=, bucket= (+port/access_key/"
                   "secret_key/prefix/region)")
    t.add_argument("--force", action="store_true",
                   help="add: update an existing tier in place; "
                   "rm: remove even when lifecycle rules reference it")
    t.add_argument("--region", default=os.environ.get(
        "MINIO_REGION", "us-east-1"))

    q = sub.add_parser("qos", help="manage per-tenant/per-tier QoS "
                       "budgets (admission shares, request/byte rates)")
    q.add_argument("action", choices=("get", "set", "rm"))
    q.add_argument("--url", default="127.0.0.1:9000",
                   help="server admin endpoint host:port")
    q.add_argument("--scope", default="tenant",
                   choices=("tenant", "tier"),
                   help="budget scope (set/rm)")
    q.add_argument("--name", default="",
                   help="tenant account or tier name (set/rm)")
    q.add_argument("--share", type=float, default=0.0,
                   help="admission-share weight (0 = default)")
    q.add_argument("--rps", type=float, default=0.0,
                   help="request-rate budget, req/s (0 = unlimited)")
    q.add_argument("--rx-bps", type=float, default=0.0,
                   help="request-body byte budget, bytes/s "
                   "(0 = unlimited)")
    q.add_argument("--tx-bps", type=float, default=0.0,
                   help="response/push byte budget, bytes/s "
                   "(0 = unlimited)")
    q.add_argument("--region", default=os.environ.get(
        "MINIO_REGION", "us-east-1"))

    n = sub.add_parser("notify", help="manage bucket event "
                       "notification targets (webhook/queue/log)")
    n.add_argument("action", choices=("status", "add", "rm"))
    n.add_argument("--url", default="127.0.0.1:9000",
                   help="server admin endpoint host:port")
    n.add_argument("--type", default="webhook",
                   choices=("webhook", "queue", "log"),
                   help="target type (add)")
    n.add_argument("--name", default="",
                   help="ARN id segment (add; random when empty)")
    n.add_argument("--arn", default="",
                   help="target ARN (rm, or add --force to update)")
    n.add_argument("--endpoint", default="",
                   help="webhook POST URL (add --type webhook)")
    n.add_argument("--auth-token", default="",
                   help="webhook bearer token (add --type webhook)")
    n.add_argument("--timeout", type=float, default=0.0,
                   help="webhook send timeout, seconds (0 = default)")
    n.add_argument("--path", default="",
                   help="event log file (add --type log)")
    n.add_argument("--force", action="store_true",
                   help="add: update an existing target in place "
                   "(needs --arn)")
    n.add_argument("--region", default=os.environ.get(
        "MINIO_REGION", "us-east-1"))

    f = sub.add_parser("fsck", help="run the crash-consistency "
                       "auditor against a running node")
    f.add_argument("--url", default="127.0.0.1:9000",
                   help="server admin endpoint host:port")
    f.add_argument("--repair", action="store_true",
                   help="repair repairable findings (POST mode)")
    f.add_argument("--bucket", default="",
                   help="narrow the audit to one bucket")
    f.add_argument("--tmp-age", type=float, default=None,
                   help="staged tmp older than this (seconds) counts "
                   "as a crash leftover; 0 = reap all (quiesced only)")
    f.add_argument("--region", default=os.environ.get(
        "MINIO_REGION", "us-east-1"))

    return p.parse_args(argv)


def _creds() -> Credentials:
    ak = os.environ.get("MINIO_ACCESS_KEY") or \
        os.environ.get("MINIO_ROOT_USER")
    sk = os.environ.get("MINIO_SECRET_KEY") or \
        os.environ.get("MINIO_ROOT_PASSWORD")
    if ak and sk:
        return Credentials(access_key=ak, secret_key=sk)
    return global_credentials()


_STOP: list = []         # a SIGTERM/SIGINT seen since _trap_signals


def _trap_signals() -> dict:
    """Catch SIGTERM/SIGINT from here on; returns the handlers it
    replaced. The handler only appends to a list (no lock a signal
    could land inside)."""
    return {s: signal.signal(s, lambda *a: _STOP.append(1))
            for s in (signal.SIGTERM, signal.SIGINT)}


def _serve_until_signal(cleanup) -> int:
    """Block until SIGTERM/SIGINT, then run cleanup. The main thread
    looks at the signal list every 0.2 s: a signal the kernel delivers
    to another thread (the server runs many) only sets a flag that the
    main thread reads when it next runs, so an untimed wait might never
    run the handler."""
    _trap_signals()
    try:
        while not _STOP:
            time.sleep(0.2)
    finally:
        cleanup()
    return 0


def _refuse(msg: str) -> int:
    print(msg, file=sys.stderr)
    return 2


def _run_decommission(args, creds: Credentials) -> int:
    """`minio_tpu decommission` — drive the admin rebalance surface
    (start / --status / --cancel) against a running node."""
    import json as _json
    from .madmin import AdminClient, AdminClientError
    from .utils import host_port
    h, p = host_port(args.url, 9000)
    cli = AdminClient(h, p, creds.access_key, creds.secret_key,
                      region=args.region)
    try:
        if args.status:
            out = cli.rebalance_status()
        elif args.cancel:
            out = cli.cancel_rebalance()
        elif args.pool is None:
            print("decommission needs --pool N (or --status/--cancel)",
                  file=sys.stderr)
            return 2
        else:
            out = cli.start_rebalance(args.pool)
    except AdminClientError as e:
        print(f"decommission failed: {e}", file=sys.stderr)
        return 1
    print(_json.dumps(out, indent=2, sort_keys=True))
    return 0


def _run_tier(args, creds: Credentials) -> int:
    """`minio_tpu tier add|ls|rm|stats` — drive the admin tier registry
    against a running node."""
    import json as _json
    from .madmin import AdminClient, AdminClientError
    from .utils import host_port
    h, p = host_port(args.url, 9000)
    cli = AdminClient(h, p, creds.access_key, creds.secret_key,
                      region=args.region)
    try:
        if args.action == "ls":
            out = cli.list_tiers()
        elif args.action == "stats":
            out = cli.tier_stats()
        elif args.action == "rm":
            if not args.name:
                print("tier rm needs --name", file=sys.stderr)
                return 2
            out = cli.remove_tier(args.name, force=args.force)
        else:
            if not args.name:
                print("tier add needs --name", file=sys.stderr)
                return 2
            params = {}
            for kv in args.param:
                k, sep, v = kv.partition("=")
                if not sep:
                    print(f"bad --param {kv!r}: need key=value",
                          file=sys.stderr)
                    return 2
                params[k] = v
            out = cli.add_tier(args.name, args.tier_type,
                               update=args.force, **params)
    except AdminClientError as e:
        print(f"tier {args.action} failed: {e}", file=sys.stderr)
        return 1
    print(_json.dumps(out, indent=2, sort_keys=True))
    return 0


def _run_qos(args, creds: Credentials) -> int:
    """`minio_tpu qos get|set|rm` — drive the admin QoS budget
    registry against a running node."""
    import json as _json
    from .madmin import AdminClient, AdminClientError
    from .utils import host_port
    h, p = host_port(args.url, 9000)
    cli = AdminClient(h, p, creds.access_key, creds.secret_key,
                      region=args.region)
    try:
        if args.action == "get":
            out = cli.qos_get()
        elif args.action == "rm":
            if not args.name:
                print("qos rm needs --name", file=sys.stderr)
                return 2
            out = cli.qos_remove(args.name, scope=args.scope)
        else:
            if not args.name:
                print("qos set needs --name", file=sys.stderr)
                return 2
            out = cli.qos_set(args.name, scope=args.scope,
                              share=args.share, rps=args.rps,
                              rx_bps=args.rx_bps, tx_bps=args.tx_bps)
    except AdminClientError as e:
        print(f"qos {args.action} failed: {e}", file=sys.stderr)
        return 1
    print(_json.dumps(out, indent=2, sort_keys=True))
    return 0


def _run_notify(args, creds: Credentials) -> int:
    """`minio_tpu notify status|add|rm` — drive the admin
    notification-target registry against a running node."""
    import json as _json
    from .madmin import AdminClient, AdminClientError
    from .utils import host_port
    h, p = host_port(args.url, 9000)
    cli = AdminClient(h, p, creds.access_key, creds.secret_key,
                      region=args.region)
    try:
        if args.action == "status":
            out = cli.notify_status()
        elif args.action == "rm":
            if not args.arn:
                print("notify rm needs --arn", file=sys.stderr)
                return 2
            cli.remove_notify_target(args.arn)
            out = {"removed": args.arn}
        else:
            params = {}
            if args.endpoint:
                params["endpoint"] = args.endpoint
            if args.auth_token:
                params["auth_token"] = args.auth_token
            if args.timeout:
                params["timeout"] = args.timeout
            if args.path:
                params["path"] = args.path
            arn = cli.add_notify_target(
                type=args.type, name=args.name, arn=args.arn,
                update=args.force, **params)
            out = {"arn": arn}
    except AdminClientError as e:
        print(f"notify {args.action} failed: {e}", file=sys.stderr)
        return 1
    print(_json.dumps(out, indent=2, sort_keys=True))
    return 0


def _run_fsck(args, creds: Credentials) -> int:
    """`minio_tpu fsck` — drive the admin consistency auditor. Exit 0
    when the tree is clean (or everything repairable was repaired),
    1 when unrepaired findings remain."""
    import json as _json
    from .madmin import AdminClient, AdminClientError
    from .utils import host_port
    h, p = host_port(args.url, 9000)
    cli = AdminClient(h, p, creds.access_key, creds.secret_key,
                      region=args.region)
    try:
        out = cli.fsck(repair=args.repair, bucket=args.bucket,
                       tmp_age_s=args.tmp_age)
    except AdminClientError as e:
        print(f"fsck failed: {e}", file=sys.stderr)
        return 1
    print(_json.dumps(out, indent=2, sort_keys=True))
    return 0 if out.get("unrepaired", 0) == 0 else 1


def main(argv: list[str] | None = None) -> int:
    args = _parse(argv if argv is not None else sys.argv[1:])
    creds = _creds()
    if args.cmd == "fsck":
        return _run_fsck(args, creds)
    if args.cmd == "decommission":
        return _run_decommission(args, creds)
    if args.cmd == "tier":
        return _run_tier(args, creds)
    if args.cmd == "qos":
        return _run_qos(args, creds)
    if args.cmd == "notify":
        return _run_notify(args, creds)
    if args.node:
        return _serve_node(args, creds)
    if not args.drives:
        return _refuse("no drives given")
    host, sep, port = args.address.rpartition(":")
    if not sep:
        host, port = args.address, ""
    try:
        port_n = int(port) if port else 9000
    except ValueError:
        return _refuse(f"bad --address {args.address!r}: port must be a "
                       "number (host:port)")
    from .utils import ellipses
    expanded = ellipses.expand_args(args.drives)
    if len(expanded) == 1:
        # one path: FS backend, no erasure (reference newObjectLayer)
        if args.pool:
            return _refuse("--pool needs an erasure backend; the FS "
                           "backend has no pool topology")
        from .cluster import start_fs
        try:
            node = start_fs(expanded[0], host or "0.0.0.0", port_n,
                            creds, region=args.region, device=args.device)
        except (RuntimeError, ValueError) as e:
            return _refuse(f"boot refused: {e}")
        print(f"MinIO-TPU FS node up at {node.url} "
              f"(access key {creds.access_key})", flush=True)
        return _serve_until_signal(node.shutdown)
    from .cluster import start_single
    try:
        node = start_single(
            args.drives, host or "0.0.0.0", port_n, creds,
            parity=args.parity, set_drive_count=args.set_drive_count,
            region=args.region, certfile=args.cert or None,
            keyfile=args.key or None, device=args.device)
    except (RuntimeError, ValueError) as e:
        return _refuse(f"boot refused: {e}")
    try:
        for pool_arg in args.pool:
            node.add_pool([pool_arg])
    except (RuntimeError, ValueError) as e:
        node.shutdown()
        return _refuse(f"--pool refused: {e}")
    return _banner_and_serve(node, creds)


def _serve_node(args: argparse.Namespace, creds: Credentials) -> int:
    """One node of a distributed cluster (reference cli.py:484-490)."""
    if args.this < 0 or args.this >= len(args.node):
        return _refuse("--this must index the --node list")
    if args.pool:
        return _refuse("--pool expansion is single-node only; distributed "
                       "pools join via their own --node lists")
    from .cluster import parse_node_arg, start_node
    # a node's listener answers before its boot ends (its peers need its
    # RPC): a stop signal that lands in between waits for the boot
    # instead of killing the process mid-boot
    saved = _trap_signals()
    try:
        nodes = [parse_node_arg(n) for n in args.node]
        node = start_node(
            nodes, args.this, creds, parity=args.parity,
            set_drive_count=args.set_drive_count, region=args.region,
            certfile=args.cert or None, keyfile=args.key or None,
            device=args.device)
    except (RuntimeError, ValueError) as e:
        for sig_, handler in saved.items():
            signal.signal(sig_, handler)
        return _refuse(f"boot refused: {e}")
    return _banner_and_serve(node, creds)


def _banner_and_serve(node, creds: Credentials) -> int:
    info = node.object_layer.storage_info()
    print(f"MinIO-TPU node {node.spec.addr} up: "
          f"{node.set_count} set(s) x {node.set_drive_count} drives, "
          f"EC:{node.parity}; {info['online_disks']} online / "
          f"{info['offline_disks']} offline drives", flush=True)
    print(f"S3 endpoint: {node.url}  (access key {creds.access_key})",
          flush=True)
    return _serve_until_signal(node.shutdown)


if __name__ == "__main__":
    sys.exit(main())
