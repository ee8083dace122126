"""The port's single-node boot (minio_tpu_torch/cluster.py) and its CLI
(`python -m minio_tpu_torch server`, minio_tpu_torch/cli.py) on the host.

The CLI runs as a subprocess with `--device cpu`: it must answer a signed
ListBuckets, a PUT and a GET, and exit 0 on SIGTERM, with MINIO_COMPRESS
on too (the object stored compressed). One drive path serves the plain-
file FS backend; `--pool` appends a pool of drives to an erasure node
(and with one drive path exits 2). `--node` and the default device on a
host without a card are refused with exit code 2 and a message. The boot's background plane (disk monitor, tracker,
heal scanner, crawler) is wired and closes on shutdown. Every test is
bounded: subprocesses by their own timeouts, the rest by an alarm.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from minio_tpu_torch import cli, cluster
from tests.test_s3 import CREDS, S3TestClient

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_SECONDS = 120


@pytest.fixture(autouse=True)
def _deadline():
    def expire(*_):
        raise TimeoutError(f"test ran past {TEST_SECONDS} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_SECONDS)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = dict(os.environ, MINIO_ACCESS_KEY=CREDS.access_key,
               MINIO_SECRET_KEY=CREDS.secret_key, **extra)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _wait_for(client, proc, seconds: float = 60.0) -> None:
    """Until the server answers a signed ListBuckets (or the process
    exits, or the bound passes)."""
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"server exited {proc.returncode}: "
                                 f"{proc.stderr.read()}")
        try:
            if client.request("GET", "/")[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError("server did not answer in time")


def test_cli_serves_and_stops_on_sigterm(tmp_path):
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch", "server",
         str(tmp_path / "e{1...8}"), "--address", f"127.0.0.1:{port}",
         "--device", "cpu"],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        c = S3TestClient("127.0.0.1", port)
        _wait_for(c, proc)
        assert c.request("PUT", "/clibucket")[0] == 200
        data = np.random.default_rng(3).bytes(3 << 20)
        assert c.request("PUT", "/clibucket/o", body=data)[0] == 200
        assert c.request("GET", "/clibucket/o")[2] == data
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "1 set(s) x 8 drives, EC:4" in out
    assert f"S3 endpoint: http://127.0.0.1:{port}" in out


@pytest.mark.parametrize("algo", ["s2", "zstd"])
def test_cli_serves_compressed_objects(tmp_path, algo):
    """MINIO_COMPRESS=on: the CLI boots (the port refused to before
    compression was ported) under either algorithm, stores a CSV
    compressed and serves it back whole and ranged."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch", "server",
         str(tmp_path / "e{1...8}"), "--address", f"127.0.0.1:{port}",
         "--device", "cpu"],
        cwd=ROOT, env=_env(MINIO_COMPRESS="on",
                           MINIO_COMPRESS_ALGORITHM=algo),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        c = S3TestClient("127.0.0.1", port)
        _wait_for(c, proc)
        assert c.request("PUT", "/clizip")[0] == 200
        data = b"".join(b"%d,%d,row\n" % (i, i * 7) for i in range(200_000))
        assert c.request("PUT", "/clizip/t.csv", body=data)[0] == 200
        assert c.request("GET", "/clizip/t.csv")[2] == data
        st, _, got = c.request("GET", "/clizip/t.csv",
                               headers={"range": "bytes=100000-100999"})
        assert st == 206 and got == data[100000:101000]
        listing = c.request("GET", "/clizip", query={"list-type": "2"})[2]
        stored = int(listing.split(b"<Size>")[1].split(b"<")[0])
        assert stored < len(data) // 2
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err


@pytest.mark.parametrize("args,env,needle", [
    (["--node", "127.0.0.1:9000=/d{1...4}"], {}, "--node"),
    (["--pool", "{root}/p{1...4}"], {}, "--pool"),
])
def test_cli_refuses_what_it_does_not_serve(tmp_path, args, env, needle):
    """`--node` stays refused (exit 2, pointing at the roadmap item that
    holds it); `--pool` now appends a pool online, and the node serves
    across both pools."""
    args = [a.replace("{root}", str(tmp_path)) for a in args]
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch", "server",
         str(tmp_path / "e{1...4}"), "--address", f"127.0.0.1:{port}",
         "--device", "cpu", *args],
        cwd=ROOT, env=_env(**env), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    if needle == "--node":
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 2
        assert needle in err and "Queue A item 4" in err
        return
    try:
        c = S3TestClient("127.0.0.1", port)
        _wait_for(c, proc)
        assert c.request("PUT", "/pools")[0] == 200
        data = np.random.default_rng(8).bytes(1 << 20)
        for i in range(4):
            assert c.request("PUT", f"/pools/o{i}", body=data)[0] == 200
        assert all(c.request("GET", f"/pools/o{i}")[2] == data
                   for i in range(4))
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "8 online / 0 offline drives" in out
    # the placement epoch doc reached the added pool's drives
    assert os.path.isdir(str(tmp_path / "p1" / ".minio.sys" / "topology"))


def test_cli_refuses_one_path_and_no_card(tmp_path, capsys):
    """One drive path serves the FS backend (exit 2 only with --pool,
    with the reference's message); the default device without a card is
    refused."""
    assert cli.main(["server", str(tmp_path / "fs"), "--device", "cpu",
                     "--pool", str(tmp_path / "p{1...4}")]) == 2
    assert "--pool needs an erasure backend" in capsys.readouterr().err
    if torch.cuda.is_available():
        return
    assert cli.main(["server", str(tmp_path / "e{1...4}"),
                     "--address", "127.0.0.1:0"]) == 2
    assert "CUDA" in capsys.readouterr().err
    assert cli.main(["server", str(tmp_path / "fs"),
                     "--address", "127.0.0.1:0"]) == 2
    assert "CUDA" in capsys.readouterr().err


def test_cli_serves_one_path_as_fs(tmp_path):
    """One drive path boots the FS backend: objects are plain files
    under the path, and SIGTERM exits 0."""
    port = _free_port()
    root = tmp_path / "fsroot"
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch", "server", str(root),
         "--address", f"127.0.0.1:{port}", "--device", "cpu"],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        c = S3TestClient("127.0.0.1", port)
        _wait_for(c, proc)
        assert c.request("PUT", "/fsb")[0] == 200
        data = np.random.default_rng(6).bytes(300_000)
        st, h, _ = c.request("PUT", "/fsb/dir/o", body=data)
        assert st == 200
        assert h["etag"] == '"' + __import__("hashlib").md5(
            data).hexdigest() + '"'
        assert c.request("GET", "/fsb/dir/o")[2] == data
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "FS node up" in out
    assert (root / "fsb" / "dir" / "o").read_bytes() == data


def test_start_single_without_a_device_needs_a_card(tmp_path, monkeypatch):
    """The default device is the card: without one the boot raises and
    leaves no listener behind; it never falls back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster.start_single([str(tmp_path / "e{1...4}")], creds=CREDS)


def test_start_single_on_the_host(tmp_path, monkeypatch):
    """The boot's wiring: one former shared by the sets, the admission
    gate and the staging rings sized from one budget, the object layer
    late-bound into the handlers."""
    from minio_tpu_torch.parallel import pipeline
    # the boot re-sizes the process's staging rings: restored afterwards
    monkeypatch.setattr(pipeline, "POOL_BUFFERS", pipeline.POOL_BUFFERS)
    node = cluster.start_single([str(tmp_path / "e{1...16}")],
                                creds=CREDS, block_size=1 << 20,
                                device="cpu")
    try:
        assert (node.set_count, node.set_drive_count, node.parity) == \
            (1, 16, 8)
        assert all(s.scheduler is node.scheduler for s in node.sets.sets)
        assert node.s3.api.obj is node.object_layer
        assert node.s3.api.admission.layer is node.object_layer
        budget = node.s3.api.admission.capacity
        assert pipeline.POOL_BUFFERS == max(4, 2 * budget) or \
            "MINIO_TPU_PIPELINE_POOL" in os.environ
        c = S3TestClient("127.0.0.1", node.s3.port)
        assert c.request("PUT", "/single")[0] == 200
        data = np.random.default_rng(4).bytes(2_500_000)
        assert c.request("PUT", "/single/o", body=data)[0] == 200
        assert c.request("GET", "/single/o")[2] == data
        # the background plane: the monitor over the sets, the tracker
        # marked by the handlers, the scanner and the crawler on this node
        assert node.disk_monitor.sets is node.sets
        assert node.s3.api.update_tracker is node.update_tracker
        assert node.update_tracker.changed_since(1, "single", "o")
        assert node.s3.api.usage is node.crawler
        assert node.heal_scanner.scan_once() == 1
        assert node.crawler.scan_once()["buckets"]["single"] == \
            {"objects": 1, "size": len(data)}
        monitor = node.disk_monitor
    finally:
        node.shutdown()
    assert node.s3 is None and node.scheduler is None
    assert node.disk_monitor is None and monitor._stop.is_set()
    assert os.path.exists(os.path.join(str(tmp_path), "e1", ".minio.sys",
                                       "tracker", "update-tracker.bin"))
