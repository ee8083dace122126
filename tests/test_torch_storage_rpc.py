"""The port's storage RPC (minio_tpu_torch/distributed/storage_rpc.py) and
remote shard-write path (object/bitrot_io.py) held against minio_tpu's.

  * tests/test_storage_rpc.py's and tests/test_storage_stream.py's verb
    cases, each run on three wires: the port's RemoteStorage against the
    port's StorageRPCServer, against the reference's server, and the
    reference's RemoteStorage against the port's server;
  * wire parity: one verb sequence (volumes, files, metadata, bulk
    deletes, streamed create and read, renames, walks, errors) run on the
    port's own wire and on both cross-package wires gives the same
    results and the same files on the served drives;
  * the engine over remote drives: the port's erasure set with every
    drive an RPC client of either package writes the same shard files as
    over local drives (one appendfile per drive and flush, no streamed
    create), reads them back, reconstructs around a wiped drive and heals;
  * the streaming bitrot writer over a remote drive: one appendfile per
    8 MiB flush, and a copy of the views it is given before it returns.
"""

from __future__ import annotations

import hashlib
import io
import os
import types

import numpy as np
import pytest

import minio_tpu.distributed.storage_rpc as ref_srpc
import minio_tpu.distributed.transport as ref_transport
import minio_tpu.storage.errors as ref_errors
import minio_tpu.storage.format as ref_format
import minio_tpu.storage.xl_storage as ref_xl
import minio_tpu_torch.bitrot as port_bitrot
import minio_tpu_torch.distributed.storage_rpc as port_srpc
import minio_tpu_torch.distributed.transport as port_transport
import minio_tpu_torch.object.bitrot_io as port_bio
import minio_tpu_torch.storage.errors as port_errors
import minio_tpu_torch.storage.format as port_format
import minio_tpu_torch.storage.xl_storage as port_xl
from minio_tpu_torch.storage.datatypes import ChecksumInfo, new_file_info

AK, SK = "nodekey", "nodesecret12345"
N = 6

PKGS = {
    "ref": types.SimpleNamespace(srpc=ref_srpc, tr=ref_transport,
                                 errors=ref_errors, fmt=ref_format,
                                 xl=ref_xl),
    "port": types.SimpleNamespace(srpc=port_srpc, tr=port_transport,
                                  errors=port_errors, fmt=port_format,
                                  xl=port_xl),
}
WIRES = [("port", "port"), ("port", "ref"), ("ref", "port")]


def serve(root, server: str, n: int = N):
    """n formatted drives of `server`'s package behind its storage RPC
    server on a standalone RPC host. Returns (drives, host, srv)."""
    p = PKGS[server]
    fmts = p.fmt.new_format_erasure_v3(1, n)
    drives = {}
    for i in range(n):
        d = p.xl.XLStorage(str(root / f"d{i}"))
        d.write_format(fmts[0][i])
        drives[f"/d{i}"] = d
    srv = p.srpc.StorageRPCServer(drives, AK, SK)
    host = p.tr.RPCServer().start()
    host.mount(srv.handler)
    return drives, host, srv


def remotes_of(client: str, host, n: int = N, **kw):
    return [PKGS[client].srpc.RemoteStorage("127.0.0.1", host.port,
                                            f"/d{i}", AK, SK, **kw)
            for i in range(n)]


@pytest.fixture(params=WIRES, ids=[f"{c}-to-{s}" for c, s in WIRES])
def wire(request, tmp_path):
    client, server = request.param
    drives, host, srv = serve(tmp_path, server)
    remotes = remotes_of(client, host)
    yield types.SimpleNamespace(client=client, server=server,
                                drives=drives, host=host, srv=srv,
                                remotes=remotes,
                                serr=PKGS[client].errors)
    for r in remotes:
        r.close()
    host.stop()


def _fi(pkg_datatypes_new_file_info=new_file_info, cls=ChecksumInfo):
    fi = pkg_datatypes_new_file_info("v/obj", 4, 2)
    fi.volume, fi.name = "v", "obj"
    fi.size = 42
    fi.mod_time = 1234567890.5
    fi.data_dir = "11111111-2222-3333-4444-555555555555"
    fi.metadata = {"etag": "deadbeef", "content-type": "x/y"}
    fi.add_object_part(1, "deadbeef", 42, 42)
    fi.erasure.checksums = [cls(1, "highwayhash256S", b"")]
    return fi


def _client_fi(client: str):
    if client == "port":
        return _fi()
    from minio_tpu.storage.datatypes import ChecksumInfo as RC
    from minio_tpu.storage.datatypes import new_file_info as rnfi
    return _fi(rnfi, RC)


# ---------------------------------------------------------------------------
# tests/test_storage_rpc.py and tests/test_storage_stream.py, on each wire
# ---------------------------------------------------------------------------

def test_vol_verbs(wire):
    r, serr = wire.remotes[0], wire.serr
    r.make_vol("vol1")
    assert "vol1" in [v.name for v in r.list_vols()]
    assert r.stat_vol("vol1").name == "vol1"
    with pytest.raises(serr.VolumeExists):
        r.make_vol("vol1")
    r.make_vol_bulk("vol2", "vol3")
    assert {"vol2", "vol3"} <= {v.name for v in r.list_vols()}
    r.delete_vol("vol1")
    with pytest.raises(serr.VolumeNotFound):
        r.stat_vol("vol1")


def test_file_verbs(wire):
    r, serr = wire.remotes[1], wire.serr
    r.make_vol("v")
    r.write_all("v", "f.bin", b"hello remote")
    assert r.read_all("v", "f.bin") == b"hello remote"
    assert r.read_file("v", "f.bin", 6, 6) == b"remote"
    r.append_file("v", "f.bin", b"!more")
    assert r.read_all("v", "f.bin") == b"hello remote!more"
    r.create_file("v", "dir/stream.bin", 4, io.BytesIO(b"abcd"))
    assert r.read_all("v", "dir/stream.bin") == b"abcd"
    r.rename_file("v", "dir/stream.bin", "v", "dir/renamed.bin")
    assert r.read_all("v", "dir/renamed.bin") == b"abcd"
    assert "dir/" in r.list_dir("v", "")
    r.delete_file("v", "f.bin")
    with pytest.raises(serr.FileNotFound):
        r.read_all("v", "f.bin")


def test_metadata_verbs(wire):
    r, serr = wire.remotes[2], wire.serr
    r.make_vol("v")
    fi = _client_fi(wire.client)
    r.write_metadata("v", "obj", fi)
    got = r.read_version("v", "obj")
    assert got.size == 42
    assert got.metadata["etag"] == "deadbeef"
    assert got.erasure.data_blocks == 4
    assert [v.name for v in r.read_versions("v", "obj")] == ["obj"]
    assert "obj" in [w.name for w in r.walk("v")]
    r.delete_version("v", "obj", got)
    with pytest.raises((serr.FileNotFound, serr.FileVersionNotFound)):
        r.read_version("v", "obj")


def test_fi_codec_roundtrip_across_packages():
    """A FileInfo encoded by either package decodes in the other with
    every field equal."""
    fi = new_file_info("b/o", 12, 4)
    fi.volume, fi.name, fi.size = "b", "o", 999
    fi.metadata = {"etag": "abc", "x": "y"}
    fi.add_object_part(1, "abc", 999, 999)
    fi.erasure.checksums = [ChecksumInfo(1, "sha256", b"\x01\x02")]
    d = port_srpc.fi_to_dict(fi)
    assert ref_srpc.fi_to_dict(ref_srpc.fi_from_dict(d)) == d
    back = port_srpc.fi_from_dict(ref_srpc.fi_to_dict(
        ref_srpc.fi_from_dict(d)))
    assert port_srpc.fi_to_dict(back) == d
    assert back.erasure.checksums[0].hash == b"\x01\x02"
    assert back.parts[0].size == 999


def test_network_error_is_disk_not_found(wire):
    dead = PKGS[wire.client].srpc.RemoteStorage("127.0.0.1", 1, "/d0", AK,
                                                SK, timeout=0.5)
    with pytest.raises(wire.serr.DiskNotFound):
        dead.read_all("v", "x")
    assert not dead.is_online()
    dead.close()


def test_auth_failure(wire):
    bad = PKGS[wire.client].srpc.RemoteStorage(
        "127.0.0.1", wire.host.port, "/d0", AK, "wrongsecret1234")
    with pytest.raises(wire.serr.UnexpectedError):
        bad.list_vols()
    assert bad.is_online()
    bad.close()


def test_unknown_drive_is_disk_not_found(wire):
    ghost = PKGS[wire.client].srpc.RemoteStorage(
        "127.0.0.1", wire.host.port, "/nope", AK, SK)
    with pytest.raises(wire.serr.DiskNotFound):
        ghost.disk_info()
    ghost.close()


class ChunkTracker(io.RawIOBase):
    """Reader that records how the client consumes it."""

    def __init__(self, total: int):
        self.total = total
        self.served = 0
        self.max_read = 0
        self.calls = 0

    def read(self, n: int = -1) -> bytes:
        self.calls += 1
        if n is None or n < 0:
            n = self.total - self.served
        self.max_read = max(self.max_read, n)
        n = min(n, self.total - self.served)
        if n <= 0:
            return b""
        start = self.served
        self.served += n
        return _expected(n, start)


def _expected(n: int, start: int = 0) -> bytes:
    return (np.arange(start, start + n, dtype=np.int64) * 31 + 7).astype(
        np.uint8).tobytes()


def test_create_file_streams_in_bounded_chunks(wire):
    drive, remote = wire.drives["/d0"], wire.remotes[0]
    remote.make_vol("v")
    total = 4 << 20
    tracker = ChunkTracker(total)
    remote.create_file("v", "big/shard.bin", total, tracker)
    assert tracker.max_read <= 1 << 20, tracker.max_read
    assert tracker.calls >= total // (1 << 20)
    assert drive.read_file("v", "big/shard.bin", 0, total) == \
        _expected(total)


def test_read_file_stream_is_chunked_and_correct(wire):
    drive, remote = wire.drives["/d0"], wire.remotes[0]
    remote.make_vol("v")
    payload = _expected(2 << 20)
    drive.create_file("v", "r/shard.bin", len(payload),
                      io.BytesIO(payload))
    stream = remote.read_file_stream("v", "r/shard.bin", 0, len(payload))
    first = stream.read(1000)
    assert first == payload[:1000]
    rest = b""
    while True:
        chunk = stream.read(1 << 20)
        if not chunk:
            break
        rest += chunk
    stream.close()
    assert first + rest == payload
    stream = remote.read_file_stream("v", "r/shard.bin", 4096, 1 << 20)
    got = b""
    while True:
        chunk = stream.read(1 << 18)
        if not chunk:
            break
        got += chunk
    stream.close()
    assert got == payload[4096:4096 + (1 << 20)]


def test_read_file_stream_falls_back_without_verb(wire):
    """A peer without the streaming verb answers the reference's 404
    unknown-verb, and the client falls back to the buffered readfile."""
    remote = wire.remotes[0]
    remote.make_vol("v")
    payload = _expected(1 << 16)
    remote.create_file("v", "fb.bin", len(payload), io.BytesIO(payload))
    del wire.srv.handler._verbs["readfilestream"]
    stream = remote.read_file_stream("v", "fb.bin", 0, len(payload))
    assert stream.read(-1) == payload


def test_short_body_surfaces_as_error(wire):
    wire.remotes[0].make_vol("v")
    remote = PKGS[wire.client].srpc.RemoteStorage(
        "127.0.0.1", wire.host.port, "/d0", AK, SK, timeout=2.0)

    class Short(io.RawIOBase):
        def read(self, n=-1):
            return b""                    # claims 1 MiB, sends none

    with pytest.raises(wire.serr.StorageError):
        remote.create_file("v", "short.bin", 1 << 20, Short())


def test_missing_file_stream_error_maps(wire):
    remote = wire.remotes[0]
    remote.make_vol("v")
    with pytest.raises(wire.serr.StorageError):
        s = remote.read_file_stream("v", "ghost.bin", 0, 100)
        s.read(100)


# ---------------------------------------------------------------------------
# wire parity: one sequence, the same results and files on every wire
# ---------------------------------------------------------------------------

def _outcome(fn):
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 — the error class is the result
        return ("error", type(e).__name__)
    if isinstance(out, types.GeneratorType):
        out = list(out)
    return ("ok", _plain(out))


def _plain(x):
    """A comparable form of a verb's result across the two packages'
    dataclasses (FileInfo, VolInfo, DiskInfo)."""
    import dataclasses
    if dataclasses.is_dataclass(x):
        d = {f.name: _plain(getattr(x, f.name))
             for f in dataclasses.fields(x)}
        for k in ("created", "total", "free", "used", "mod_time"):
            d.pop(k, None)
        return d
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, Exception):
        return type(x).__name__
    return x


def _sequence(client: str, r, snapshot):
    fi = _client_fi(client)
    fi2 = _client_fi(client)
    fi2.name, fi2.data_dir = "obj2", "66666666-2222-3333-4444-555555555555"
    big = _expected(3 << 20, 5)

    def stream_read():
        s = r.read_file_stream("v", "big.bin", 100, 1 << 20)
        out = b""
        while True:
            c = s.read(65536)
            if not c:
                break
            out += c
        s.close()
        return hashlib.sha256(out).hexdigest()

    steps = [
        lambda: r.make_vol("v"),
        lambda: r.make_vol("v"),
        lambda: r.make_vol_bulk("w", "x"),
        lambda: sorted(v.name for v in r.list_vols()),
        lambda: r.stat_vol("nope"),
        lambda: len(r.get_disk_id()),
        lambda: r.disk_info().endpoint != "",
        lambda: r.write_all("v", "a/b.txt", b"xyz"),
        lambda: r.read_all("v", "a/b.txt"),
        lambda: r.read_all("v", "a/missing"),
        lambda: r.append_file("v", "a/app.bin", b"one"),
        lambda: r.append_file("v", "a/app.bin", memoryview(b"two")),
        lambda: r.read_file("v", "a/app.bin", 1, 4),
        lambda: r.create_file("v", "big.bin", len(big), io.BytesIO(big)),
        stream_read,
        lambda: r.rename_file("v", "a/b.txt", "w", "moved.txt"),
        lambda: r.list_dir("w", ""),
        lambda: r.list_dir("v", "", 1),
        lambda: r.write_metadata("v", "obj", fi),
        lambda: r.write_metadata("v", "obj2", fi2),
        lambda: r.read_version("v", "obj"),
        lambda: r.read_versions("v", "obj2"),
        lambda: r.check_file("v", "obj"),
        lambda: r.check_parts("v", "obj", fi),
        lambda: [w.name for w in r.walk("v")],
        snapshot,
        lambda: r.delete_versions("v", [fi, fi2, fi]),
        lambda: r.delete_file("v", "a", recursive=True),
        lambda: r.delete_vol("x"),
        lambda: r.delete_vol("w"),
        lambda: r.delete_vol("w", force=True),
    ]
    return [_outcome(s) for s in steps]


def _tree(root) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            rel = os.path.relpath(p, root)
            if rel.endswith("format.json") or "/tmp/" in rel:
                continue
            with open(p, "rb") as fh:
                out[rel] = fh.read()
    return out


def test_wire_parity_across_packages(tmp_path):
    results, trees, finals = {}, {}, {}
    for client, server in WIRES:
        root = tmp_path / f"{client}-{server}"
        drives, host, _srv = serve(root, server, n=1)
        r = remotes_of(client, host, n=1)[0]

        def snapshot(key=(client, server), root=root):
            trees[key] = _tree(root)

        try:
            results[(client, server)] = _sequence(client, r, snapshot)
        finally:
            r.close()
            host.stop()
        finals[(client, server)] = _tree(root)
    want = results[("port", "port")]
    assert any(o[0] == "error" for o in want)
    for key in WIRES[1:]:
        for i, (a, b) in enumerate(zip(want, results[key])):
            assert a == b, f"{key} step {i}: {a} != {b}"
    assert len(trees[("port", "port")]) > 4
    for key in WIRES[1:]:
        assert trees[key] == trees[("port", "port")], key
        assert finals[key] == finals[("port", "port")], key


# ---------------------------------------------------------------------------
# the engine over remote drives
# ---------------------------------------------------------------------------

def _part_files(drives: dict) -> dict:
    """(drive, object/part.N) -> bytes; the data-dir uuid, which differs
    per write, left out of the key."""
    out = {}
    for name, d in drives.items():
        for rel, data in _tree(d.root).items():
            parts = rel.split(os.sep)
            if parts[-1].startswith("part."):
                out[(name, os.sep.join(parts[:-2] + [parts[-1]]))] = data
    return out


@pytest.mark.parametrize("server", ["port", "ref"])
def test_engine_over_remote_drives(tmp_path, server):
    """The port's erasure set with every drive an RPC client writes the
    shard files it writes over local drives, one appendfile per drive,
    and reads, reconstructs and heals through the wire."""
    import shutil

    from minio_tpu_torch.object import ErasureSetObjects
    drives, host, _srv = serve(tmp_path / "remote", server)
    remotes = remotes_of("port", host)
    local_drives, local_host, _lsrv = serve(tmp_path / "local", "port")
    local_host.stop()
    local = ErasureSetObjects(list(local_drives.values()), 4, 2,
                              block_size=1 << 16, device="cpu")
    eng = ErasureSetObjects(list(remotes), 4, 2, block_size=1 << 16,
                            device="cpu")
    try:
        data = b"remote drive payload " * 9973
        before = port_transport.verb_stats()
        for e in (local, eng):
            e.make_bucket("rb")
            assert e.put_object("rb", "obj", data).etag == \
                hashlib.md5(data).hexdigest()
        after = port_transport.verb_stats()
        assert after["appendfile"]["calls"] - \
            before.get("appendfile", {}).get("calls", 0) == N
        assert after.get("createfile", {}).get("calls", 0) == \
            before.get("createfile", {}).get("calls", 0)
        want = _part_files(local_drives)
        assert _part_files(drives) == want and want
        assert b"".join(eng.get_object("rb", "obj")[1]) == data
        shutil.rmtree(os.path.join(drives["/d0"].root, "rb"),
                      ignore_errors=True)
        assert b"".join(eng.get_object("rb", "obj")[1]) == data
        eng.heal_object("rb", "obj")
        assert _part_files(drives) == want
        objs, _, _ = eng.list_objects("rb")
        assert [o.name for o in objs] == ["obj"]
        eng.delete_object("rb", "obj")
        eng.delete_bucket("rb")
    finally:
        for r in remotes:
            r.close()
        host.stop()


# ---------------------------------------------------------------------------
# the streaming bitrot writer
# ---------------------------------------------------------------------------

def test_remote_writer_flushes_per_threshold_and_copies(tmp_path):
    """A remote drive takes buffered frames: one appendfile per 8 MiB
    flush (and the rest at close), never one per frame, with the same
    bytes a local drive's appender writes; the writer copies the views it
    is handed, so a recycled staging slot cannot change the file."""
    algo = port_bitrot.BitrotAlgorithm.HIGHWAYHASH256S
    shard = 1 << 20
    blocks = [_expected(shard, i) for i in range(11)]
    drives, host, _srv = serve(tmp_path / "srv", "port", n=1)
    remote = remotes_of("port", host, n=1)[0]
    local = port_xl.XLStorage(str(tmp_path / "local"))
    try:
        files = []
        for disk in (local, remote):
            disk.make_vol("v")
            w = port_bio.new_bitrot_writer(disk, "v", "p/part.1", -1, algo,
                                           shard)
            before = port_transport.verb_stats().get(
                "appendfile", {}).get("calls", 0)
            slot = bytearray(shard)
            for b in blocks:
                slot[:] = b
                view = memoryview(slot)
                w.write_with_digest(view, port_bitrot.hash_shard(b, algo))
                slot[:] = b"\0" * shard          # the slot is recycled
            w.close()
            calls = port_transport.verb_stats().get(
                "appendfile", {}).get("calls", 0) - before
            files.append(disk.read_all("v", "p/part.1"))
        # 11 frames of 1 MiB + 32 B: flushes at 8 frames, the rest at close
        assert calls == 2
        assert files[0] == files[1]
        assert files[1][32:32 + shard] == blocks[0]
    finally:
        remote.close()
        host.stop()
