"""CLI — `python -m minio_tpu_torch server ...` process bootstrap.

Counterpart of the `server` subcommand of minio_tpu/cli.py (the
reference's main.go + cmd/server-main.go): parse args, boot the node,
print the startup banner, block on SIGTERM/SIGINT.

    python -m minio_tpu_torch server /data/d{1...16} --address :9000

``--device`` (default ``cuda``) picks where the erasure, hash and cipher
steps run: the default needs a card and exits non-zero without one;
``--device cpu`` runs the plain PyTorch versions on the host.

Refused with exit code 2 and a message, not half served: distributed
nodes (``--node``), pool expansion (``--pool``) and the single-path FS
backend. MINIO_COMPRESS=on compresses eligible objects inline (by
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
                   help="host:port=/drive{1...N} — one per cluster node "
                   "(not served by this port yet)")
    s.add_argument("--parity", type=int, default=None,
                   help="parity shards per set (default N/2)")
    s.add_argument("--set-drive-count", type=int, default=0,
                   help="drives per erasure set (default: auto 4..16)")
    s.add_argument("--region", default=os.environ.get(
        "MINIO_REGION", "us-east-1"))
    s.add_argument("--cert", default="", help="TLS certificate file")
    s.add_argument("--key", default="", help="TLS private key file")
    s.add_argument("--pool", action="append", default=[],
                   help="extra drive pool (not served by this port yet)")
    s.add_argument("--device", default="cuda",
                   help="where the erasure, hash and cipher steps run: "
                   "cuda (default) or cpu")
    return p.parse_args(argv)


def _creds() -> Credentials:
    ak = os.environ.get("MINIO_ACCESS_KEY") or \
        os.environ.get("MINIO_ROOT_USER")
    sk = os.environ.get("MINIO_SECRET_KEY") or \
        os.environ.get("MINIO_ROOT_PASSWORD")
    if ak and sk:
        return Credentials(access_key=ak, secret_key=sk)
    return global_credentials()


def _serve_until_signal(cleanup) -> int:
    """Block until SIGTERM/SIGINT, then run cleanup. The handler only
    appends to a list (no lock a signal could land inside), and the main
    thread looks at it every 0.2 s: a signal the kernel delivers to
    another thread (the server runs many) only sets a flag that the main
    thread reads when it next runs, so an untimed wait might never run
    the handler."""
    stop: list = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    try:
        while not stop:
            time.sleep(0.2)
    finally:
        cleanup()
    return 0


def _refuse(msg: str) -> int:
    print(msg, file=sys.stderr)
    return 2


def main(argv: list[str] | None = None) -> int:
    args = _parse(argv if argv is not None else sys.argv[1:])
    creds = _creds()
    if args.node:
        return _refuse("--node: distributed nodes are not served by this "
                       "port yet (ROADMAP Queue A item 8)")
    if args.pool:
        return _refuse("--pool: online pool expansion is not served by "
                       "this port yet (ROADMAP Queue A item 8)")
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
    if len(ellipses.expand_args(args.drives)) == 1:
        return _refuse("one drive path: the FS backend is not served by "
                       "this port yet (ROADMAP Queue A item 8); give an "
                       "erasure set of drives")
    from .cluster import start_single
    try:
        node = start_single(
            args.drives, host or "0.0.0.0", port_n, creds,
            parity=args.parity, set_drive_count=args.set_drive_count,
            region=args.region, certfile=args.cert or None,
            keyfile=args.key or None, device=args.device)
    except (RuntimeError, ValueError) as e:
        return _refuse(f"boot refused: {e}")
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
