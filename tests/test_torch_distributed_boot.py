"""The port's distributed boot (minio_tpu_torch/cluster.py, cli.py)
held against minio_tpu's, beside test_torch_distributed.py's twin
clusters.

  * bootstrap refusing a node whose credentials differ from its peers';
  * no card: the default device refuses the boot before anything listens;
  * the CLI: ``--node``/``--this`` parsed as the reference parses them,
    its refusals, and a 4-node 12+4 cluster booted as 4 ``--node``
    subprocesses (``--device cpu``) answering a PUT through node 0 and a
    GET through node 3 and exiting 0 on SIGTERM;
  * the distributed modules import neither jax nor minio_tpu.
"""

from __future__ import annotations

import hashlib
import os
import signal
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import minio_tpu.cluster as ref_cluster
import minio_tpu_torch.cluster as port_cluster
from minio_tpu_torch import cli
from minio_tpu_torch.s3.credentials import Credentials
from tests.test_s3 import CREDS, S3TestClient
from tests.test_torch_distributed import (BS, DRIVES, NODES, ROOT,
                                          free_ports, wait_for)


# ---------------------------------------------------------------------------
# the boot's refusals
# ---------------------------------------------------------------------------

def test_bootstrap_verify_rejects_mismatched_creds(tmp_path):
    ports = free_ports(2)
    specs = [port_cluster.NodeSpec("127.0.0.1", ports[i],
                                   [str(tmp_path / f"{w}d{j}")
                                    for j in range(4)])
             for i, w in enumerate("ab")]

    def good():
        try:
            port_cluster.ClusterNode(specs, 0, CREDS, parity=2,
                                     set_drive_count=8, block_size=BS,
                                     bootstrap_timeout=4.0,
                                     format_timeout=4.0,
                                     device="cpu").shutdown()
        except Exception:  # noqa: BLE001 — its partner never comes up
            pass

    th = threading.Thread(target=good, daemon=True)
    th.start()
    bad = Credentials(access_key=CREDS.access_key, secret_key="WRONG-SECRET")
    with pytest.raises(RuntimeError):
        port_cluster.ClusterNode(specs, 1, bad, parity=2,
                                 set_drive_count=8, block_size=BS,
                                 bootstrap_timeout=3.0, format_timeout=5.0,
                                 device="cpu")
    th.join(timeout=30)


def test_no_card_refuses_the_boot(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device boots")
    port = free_ports(1)[0]
    spec = port_cluster.NodeSpec("127.0.0.1", port, [str(tmp_path / "d")])
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cluster.ClusterNode([spec, spec], 0, CREDS)
    with socket.socket() as s:          # nothing was left listening
        s.bind(("127.0.0.1", port))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arg", ["127.0.0.1:9000=/d{1...4}",
                                 "h.example:9001=/a,/b{1...2}",
                                 ":9002=/x/d{01...03}"])
def test_node_arg_parses_as_the_reference(arg):
    got = port_cluster.parse_node_arg(arg)
    want = ref_cluster.parse_node_arg(arg)
    assert (got.host, got.port, got.drives, got.addr) == \
        (want.host, want.port, want.drives, want.addr)


def test_node_arg_needs_drives():
    for mod in (port_cluster, ref_cluster):
        with pytest.raises(ValueError):
            mod.parse_node_arg("127.0.0.1:9000")


@pytest.mark.parametrize("extra,needle", [
    ([], "--this must index the --node list"),
    (["--this", "2"], "--this must index the --node list"),
    (["--this", "0", "--pool", "/p{1...4}"], "--pool expansion"),
])
def test_cli_node_refusals(extra, needle, capsys):
    args = ["server", "--node", "127.0.0.1:1=/a{1...4}",
            "--node", "127.0.0.1:2=/b{1...4}", "--device", "cpu", *extra]
    assert cli.main(args) == 2
    assert needle in capsys.readouterr().err


def test_cli_node_without_a_card_is_refused(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device boots")
    p = free_ports(2)
    assert cli.main(["server", "--node", f"127.0.0.1:{p[0]}={tmp_path}/a",
                     "--node", f"127.0.0.1:{p[1]}={tmp_path}/b",
                     "--this", "0"]) == 2
    assert "CUDA" in capsys.readouterr().err


def test_cli_boots_a_four_node_cluster(tmp_path):
    """The 4-node cluster as four `--node ... --this i` processes: a PUT
    through node 0 reads back through node 3, and each exits 0 on
    SIGTERM."""
    ports = free_ports(NODES)
    node_args = []
    for i, p in enumerate(ports):
        node_args += ["--node",
                      f"127.0.0.1:{p}={tmp_path}/n{i}d{{1...{DRIVES}}}"]
    env = dict(os.environ, MINIO_ACCESS_KEY=CREDS.access_key,
               MINIO_SECRET_KEY=CREDS.secret_key,
               PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch", "server", *node_args,
         "--this", str(i), "--parity", "4", "--device", "cpu"],
        cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(NODES)]
    try:
        clients = [S3TestClient("127.0.0.1", p) for p in ports]

        def up():
            for pr in procs:
                assert pr.poll() is None, pr.communicate()[1][-2000:]
            try:
                return all(c.request("GET", "/")[0] == 200
                           for c in clients)
            except OSError:
                return False

        wait_for(up, 120, "the four nodes answering")
        data = np.random.default_rng(4).bytes(700_000)
        assert clients[0].request("PUT", "/cli")[0] == 200
        st, h, _ = clients[0].request("PUT", "/cli/o", body=data)
        assert st == 200 and \
            h["etag"] == f'"{hashlib.md5(data).hexdigest()}"'
        st, _, got = clients[3].request("GET", "/cli/o")
        assert st == 200 and got == data
        outs = []
        for pr in procs:
            pr.send_signal(signal.SIGTERM)
        for pr in procs:
            out, err = pr.communicate(timeout=60)
            outs.append(out)
            assert pr.returncode == 0, err[-2000:]
        assert all("1 set(s) x 16 drives, EC:4" in o for o in outs), outs
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()


def test_distributed_modules_import_neither_jax_nor_the_reference():
    """Importing the port's distributed node pulls in no module of jax or
    of minio_tpu (checked in a fresh interpreter)."""
    mods = ["minio_tpu_torch.cluster", "minio_tpu_torch.cli",
            "minio_tpu_torch.distributed.transport",
            "minio_tpu_torch.distributed.membership",
            "minio_tpu_torch.distributed.storage_rpc",
            "minio_tpu_torch.distributed.local_locker",
            "minio_tpu_torch.distributed.lock_rpc",
            "minio_tpu_torch.distributed.dsync",
            "minio_tpu_torch.distributed.peer_rpc",
            "minio_tpu_torch.utils.dyntimeout",
            "minio_tpu_torch.utils.healthtrack"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'minio_tpu')]\n"
            "assert not bad, bad\nprint('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
