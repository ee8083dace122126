"""One set's namespace on the port (minio_tpu_torch/object/engine.py:
bucket verbs, listings, bulk delete, delete markers, metadata updates,
the if_none_newer gate) held against minio_tpu's on twin drive sets fed
the same calls, with version ids and mod times pinned so versioned
listings compare entry for entry; and the port's modules import neither
JAX nor minio_tpu."""

import ast
import os
import pathlib
import re
import uuid

import numpy as np
import pytest

import minio_tpu.object.engine as ref_engine
from minio_tpu.object.engine import PutOptions as RefPutOptions
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu_torch.object import api_errors, engine
from minio_tpu_torch.object.engine import PutOptions
from minio_tpu_torch.object.sets import ErasureSets
from tests.test_torch_s3 import pin_deadlines

N, M, BS = 6, 2, 1 << 14
NAMES = ["a", "a/b", "a/b/c", "a/c", "ab", "b/x", "b/y/z", "c", "d/e/f/g",
         "d/e/h", "zz"]


class _Pinned:
    UUID = uuid.UUID

    def __init__(self):
        self.n = 0
        self.t = 1.7e9

    def uuid4(self):
        self.n += 1
        return uuid.UUID(int=self.n)

    def now(self):
        self.t += 1.0
        return self.t


@pytest.fixture
def twins(tmp_path, monkeypatch):
    """(reference layer, port layer) over twin drive sets, uuids and
    mod times pinned in both engines."""
    rp, pp = _Pinned(), _Pinned()
    monkeypatch.setattr(ref_engine, "_uuid", rp)
    monkeypatch.setattr(ref_engine, "now", rp.now)
    monkeypatch.setattr(engine, "_uuid", pp)
    monkeypatch.setattr(engine, "now", pp.now)
    pin_deadlines(monkeypatch)
    ref = RefSets.from_drives([str(tmp_path / f"r{i}") for i in range(N)],
                              1, N, M, block_size=BS, enable_mrf=False)
    port = ErasureSets.from_drives(
        [str(tmp_path / f"p{i}") for i in range(N)], 1, N, M,
        block_size=BS, enable_mrf=False, device="cpu")
    yield ref, port
    ref.close()
    port.close()


def _both(twins, fn):
    """fn(layer) on both layers: (reference result or exception name,
    port result or exception name)."""
    out = []
    for layer in twins:
        try:
            out.append(fn(layer))
        except Exception as e:  # noqa: BLE001 — compared by name
            out.append(type(e).__name__)
    return out


def _opts(layer, **kw):
    """PutOptions of the layer's own package."""
    return (RefPutOptions if isinstance(layer, RefSets) else PutOptions)(
        **kw)


def _objs(page):
    objs, pfx, trunc = page
    return ([(o.name, o.size, o.etag) for o in objs], pfx, trunc)


def _vers(page):
    vers, pfx, nkm, nvm, trunc = page
    return ([(o.name, o.version_id, o.delete_marker, o.size, o.mod_time)
             for o in vers], pfx, nkm, nvm, trunc)


def test_bucket_verbs_equal_reference(twins):
    for fn in (lambda z: z.make_bucket("b1"),
               lambda z: z.make_bucket("b2"),
               lambda z: z.make_bucket("b1"),
               lambda z: z.make_bucket(".minio.sys"),
               lambda z: z.bucket_exists("b1"),
               lambda z: z.bucket_exists("nope"),
               lambda z: z.get_bucket_info("b2").name,
               lambda z: z.get_bucket_info("nope"),
               lambda z: [v.name for v in z.list_buckets()],
               lambda z: z.put_object("b1", "o", b"x").size,
               lambda z: z.delete_bucket("b1"),
               lambda z: z.delete_bucket("b2"),
               lambda z: z.delete_bucket("b1", force=True),
               lambda z: [v.name for v in z.list_buckets()]):
        a, b = _both(twins, fn)
        assert a == b


@pytest.mark.parametrize("prefix,delimiter", [("", ""), ("", "/"),
                                              ("a", "/"), ("a/", "/"),
                                              ("d/e/", ""), ("b/", "/")])
def test_listing_pages_equal_reference(twins, prefix, delimiter):
    rng = np.random.default_rng(3)
    for layer in twins:
        layer.make_bucket("b")
    for name in NAMES:
        data = rng.bytes(50 + len(name))
        for layer in twins:
            layer.put_object("b", name, data)
    for max_keys in (1, 2, 3, 1000):
        marker, pages = "", 0
        while True:
            a, b = _both(twins, lambda z: _objs(z.list_objects(
                "b", prefix, marker, delimiter, max_keys)))
            assert a == b
            objs, pfx, trunc = a
            pages += 1
            if not trunc or pages > 20:
                break
            marker = max([o[0] for o in objs] + pfx)
        assert not trunc


def test_version_listing_pages_equal_reference(twins):
    for layer in twins:
        layer.make_bucket("b")
    for i, name in enumerate(NAMES[:6]):
        for v in range(1 + i % 3):
            for layer in twins:
                layer.put_object("b", name, bytes([v]) * (v + 1),
                                 opts=_opts(layer, versioned=True))
    for layer in twins:
        layer.delete_object("b", "a/b", versioned=True)  # a marker
    for delimiter in ("", "/"):
        for max_keys in (1, 2, 5, 1000):
            km, vm, pages = "", "", 0
            while True:
                a, b = _both(twins, lambda z: _vers(z.list_object_versions(
                    "b", "", km, max_keys, vm, delimiter)))
                assert a == b
                _v, _p, km, vm, trunc = a
                pages += 1
                if not trunc or pages > 40:
                    break
            assert not trunc
    a, b = _both(twins, lambda z: [
        (o.version_id, o.delete_marker) for o in z.object_versions("b",
                                                                   "a/b")])
    assert a == b and a[0][1] is True


def test_delete_markers_bulk_delete_and_metadata_equal_reference(twins):
    for layer in twins:
        layer.make_bucket("b")
        for name in NAMES:
            layer.put_object("b", name, name.encode())
    steps = [
        lambda z: z.has_object_versions("b", "c"),
        lambda z: z.update_object_metadata(
            "b", "c", {"x-amz-meta-k": "v"}).user_defined,
        lambda z: z.get_object_info("b", "c").etag,
        lambda z: z.delete_objects("b", ["a", "zz", "nope"]),
        lambda z: z.put_delete_marker(
            "b", "c", "00000000-0000-0000-0000-0000000000aa",
            1.9e9).delete_marker,
        lambda z: z.latest_file_info("b", "c").deleted,
        lambda z: z.get_object_info("b", "c"),
        lambda z: z.has_object_versions("b", "c"),
        lambda z: z.has_object_versions("b", "a"),
        lambda z: _objs(z.list_objects("b")),
    ]
    for fn in steps:
        a, b = _both(twins, fn)
        if isinstance(a, list) and a and not isinstance(a[0], tuple):
            a = [None if e is None else type(e).__name__ for e in a]
            b = [None if e is None else type(e).__name__ for e in b]
        assert a == b


def test_if_none_newer_and_parity_equal_reference(twins):
    for layer in twins:
        layer.make_bucket("b")
        layer.put_object("b", "o", b"first")
    # an older replayed write loses; a newer one wins
    for mod_time, want in ((1.0, "PreConditionFailed"), (3e9, 6)):
        a, b = _both(twins, lambda z: z.put_object(
            "b", "o", b"second", opts=_opts(
                z, mod_time=mod_time, if_none_newer=True)).size)
        assert a == b == want
    a, b = _both(twins, lambda z: z.put_object(
        "b", "p", b"x" * 3000, opts=_opts(z, parity=3)).parity_blocks)
    assert a == b == 3
    with pytest.raises(api_errors.PreConditionFailed):
        twins[1].put_object("b", "o", b"third", opts=PutOptions(
            mod_time=2.0, if_none_newer=True))


def test_port_imports_neither_jax_nor_the_reference():
    root = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((root / "minio_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 40
    names = {p.relative_to(root).as_posix() for p in files}
    for mod in ("scan/engine.py", "scan/kernels.py", "scan/pager.py",
                "scan/plan.py", "s3select/sql.py", "s3select/select.py",
                "ops/scan_cuda.py", "ops/scan_plain.py",
                "ops/scan_program.py", "features/snappy.py",
                "object/update_tracker.py", "object/background.py",
                "object/metacache.py", "object/cache.py",
                "features/lifecycle.py", "tier/__init__.py",
                "tier/client.py", "tier/config.py", "tier/transition.py",
                "object/faithful.py", "utils/pressure.py",
                "utils/bandwidth.py", "object/rebalance.py",
                "object/fsck.py", "object/fs.py", "utils/regfence.py",
                "utils/lockcheck.py", "distributed/naughtynet.py",
                "s3/qos.py", "s3/postpolicy.py", "features/objectlock.py",
                "features/events.py", "notify/__init__.py",
                "notify/rules.py", "notify/targets.py", "notify/chaos.py",
                "notify/plane.py", "replicate/__init__.py",
                "replicate/targets.py", "replicate/client.py",
                "replicate/plane.py", "replicate/resync.py",
                "features/replication.py"):
        assert f"minio_tpu_torch/{mod}" in names, mod
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "minio_tpu"), \
                    f"{os.path.relpath(path, root)} imports {mod}"


# the card path's roles, which the reference's dispatch has no name for
_DEVICE_ROLES = {"codec.steps", "codec.slots", "bpool.copies",
                 "kernels.build", "kernels.count"}
_ROLE = re.compile(r"lockcheck\.(?:mutex|rlock|condition)\(\s*\"([^\"]+)\"")


def _roles(package: str) -> dict:
    root = pathlib.Path(__file__).resolve().parent.parent / package
    out: dict = {}
    for path in sorted(root.rglob("*.py")):
        if path.name == "lockcheck.py":
            continue
        for role in _ROLE.findall(path.read_text()):
            out.setdefault(role, []).append(path.relative_to(root).as_posix())
    return out


def test_every_reference_lock_role_is_named_in_the_port():
    """Each role the reference names through lockcheck is named in the
    port (mesh.dispatch waits for the multi-card mesh), and so are the
    card path's own roles; no port role is named twice."""
    ref, port = _roles("minio_tpu"), _roles("minio_tpu_torch")
    ref_sites = sum(len(v) for v in ref.values())
    assert ref_sites == 10 and "mesh.dispatch" in ref, ref
    assert set(ref) - {"mesh.dispatch"} <= set(port), \
        sorted(set(ref) - set(port))
    assert _DEVICE_ROLES <= set(port)
    assert set(port) == set(ref) - {"mesh.dispatch"} | _DEVICE_ROLES
    assert all(len(v) == 1 for v in port.values()), port
    for role in ("sched.buckets", "bpool.created", "metacache.cond",
                 "mrf.queue", "telemetry.registry"):
        assert port[role] == ref[role], role
