"""The port's streaming bitrot writer (minio_tpu_torch/object/bitrot_io.py)
held against minio_tpu's on an empty block.

The reference's ``StreamingBitrotWriter.write(b"")`` returns without a
frame (minio_tpu/object/bitrot_io.py:73-74); the port wrote a 32-byte
digest frame for it. ``b""`` then ``b"abc"`` through each package's
writer under HighwayHash-256S must give the same shard file byte for byte
(35 B: one digest frame and its 3 bytes), over a local drive and over a
remote drive behind the port's storage RPC.
"""

from __future__ import annotations

import pytest

import minio_tpu.bitrot as ref_bitrot
import minio_tpu.object.bitrot_io as ref_bio
import minio_tpu.storage.xl_storage as ref_xl
import minio_tpu_torch.bitrot as port_bitrot
import minio_tpu_torch.object.bitrot_io as port_bio
import minio_tpu_torch.storage.xl_storage as port_xl


def _shard_file(disk, bio, bitrot):
    algo = bitrot.BitrotAlgorithm.HIGHWAYHASH256S
    disk.make_vol("v")
    w = bio.new_bitrot_writer(disk, "v", "s/part.1", -1, algo, 1 << 16)
    w.write(b"")
    w.write(b"abc")
    w.close()
    return disk.read_all("v", "s/part.1")


@pytest.mark.parametrize("where", ["local", "remote"])
def test_empty_block_writes_no_frame(tmp_path, where):
    """b"" then b"abc" through each package's streaming writer: the port's
    shard file equals the reference's byte for byte (35 B: one 32-byte
    digest frame and its 3 bytes)."""
    want = _shard_file(ref_xl.XLStorage(str(tmp_path / "ref")),
                       ref_bio, ref_bitrot)
    assert len(want) == 32 + 3
    if where == "local":
        disk = port_xl.XLStorage(str(tmp_path / "port"))
        got = _shard_file(disk, port_bio, port_bitrot)
    else:
        from tests.test_torch_storage_rpc import remotes_of, serve
        _drives, host, _srv = serve(tmp_path / "srv", "port", n=1)
        disk = remotes_of("port", host, n=1)[0]
        try:
            got = _shard_file(disk, port_bio, port_bitrot)
        finally:
            disk.close()
            host.stop()
    assert got == want
