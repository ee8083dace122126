"""FS backend — single-drive, non-erasure ObjectLayer.

Counterpart of minio_tpu/object/fs.py, the reference's fs-v1
(cmd/fs-v1.go + fs-v1-helpers/metadata/multipart): objects live as PLAIN
FILES under <root>/<bucket>/<object> (the tree is usable by any tool),
with per-object metadata in .minio.sys/buckets/<bucket>/<object>/fs.json
and multipart staging under .minio.sys/multipart. Selected for
single-drive deployments (newObjectLayer, cmd/server-main.go:524-532;
``python -m minio_tpu_torch server <one path>``). No versioning, no
erasure, no heal, and no device work: the ObjectLayer surface stays the
same, so every handler works unchanged. The on-disk bytes (files,
fs.json, upload.json, part files) are the reference's, so either package
reads a tree the other wrote.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import uuid as _uuid
from typing import Iterator, Optional

from ..storage.datatypes import ObjectInfo, ObjectPartInfo, VolInfo, single_version_page
from . import api_errors
from .engine import GetOptions, PutOptions
from .hash_reader import HashReader
from .nslock import NSLockMap

META_DIR = ".minio.sys"
BUCKET_META = os.path.join(META_DIR, "buckets")
MULTIPART_DIR = os.path.join(META_DIR, "multipart")
CHUNK = 1 << 20


class FSObjects:
    """ObjectLayer over one directory tree. ``device`` is only where the
    handlers' ChaCha20 SSE GETs decipher (None: the card); the backend
    itself runs nothing on it, and has no batch former."""

    scheduler = None

    def __init__(self, root: str, device=None):
        self.root = os.path.abspath(root)
        self.device = device
        os.makedirs(os.path.join(self.root, BUCKET_META), exist_ok=True)
        os.makedirs(os.path.join(self.root, MULTIPART_DIR), exist_ok=True)
        self.ns = NSLockMap()
        self._mu = threading.Lock()

    # -- paths -------------------------------------------------------------

    def _bucket_dir(self, bucket: str) -> str:
        # META_DIR is a legal internal bucket (config/IAM/bucket-metadata
        # ride the ObjectLayer exactly like the erasure backend)
        if bucket != META_DIR and (
                not bucket or bucket.startswith(".") or "/" in bucket):
            raise api_errors.BucketNameInvalid(bucket)
        return os.path.join(self.root, bucket)

    def _obj_path(self, bucket: str, key: str) -> str:
        p = os.path.normpath(os.path.join(self._bucket_dir(bucket), key))
        if not p.startswith(self._bucket_dir(bucket) + os.sep):
            raise api_errors.ObjectNameInvalid(key)
        return p

    def _meta_path(self, bucket: str, key: str) -> str:
        return os.path.join(self.root, BUCKET_META, bucket, key,
                            "fs.json")

    def _load_meta(self, bucket: str, key: str) -> dict:
        try:
            with open(self._meta_path(bucket, key)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _save_meta(self, bucket: str, key: str, meta: dict) -> None:
        p = self._meta_path(bucket, key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, p)

    def _drop_meta(self, bucket: str, key: str) -> None:
        try:
            os.remove(self._meta_path(bucket, key))
        except OSError:
            pass
        # prune empty metadata dirs
        d = os.path.dirname(self._meta_path(bucket, key))
        while d != os.path.join(self.root, BUCKET_META):
            try:
                os.rmdir(d)
            except OSError:
                break
            d = os.path.dirname(d)

    # -- buckets -----------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        d = self._bucket_dir(bucket)
        if os.path.isdir(d):
            raise api_errors.BucketExists(bucket)
        os.makedirs(d)
        os.makedirs(os.path.join(self.root, BUCKET_META, bucket),
                    exist_ok=True)

    def bucket_exists(self, bucket: str) -> bool:
        return os.path.isdir(self._bucket_dir(bucket))

    def get_bucket_info(self, bucket: str) -> VolInfo:
        d = self._bucket_dir(bucket)
        if not os.path.isdir(d):
            raise api_errors.BucketNotFound(bucket)
        return VolInfo(bucket, os.stat(d).st_mtime)

    def list_buckets(self) -> list[VolInfo]:
        out = []
        for e in sorted(os.listdir(self.root)):
            if e.startswith("."):
                continue
            full = os.path.join(self.root, e)
            if os.path.isdir(full):
                out.append(VolInfo(e, os.stat(full).st_mtime))
        return out

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        d = self._bucket_dir(bucket)
        if not os.path.isdir(d):
            raise api_errors.BucketNotFound(bucket)
        if not force and any(
                files for _, _, files in os.walk(d)):
            raise api_errors.BucketNotEmpty(bucket)
        shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(os.path.join(self.root, BUCKET_META, bucket),
                      ignore_errors=True)

    def heal_bucket(self, bucket: str) -> None:
        self.get_bucket_info(bucket)

    # -- objects -----------------------------------------------------------

    def put_object(self, bucket: str, key: str, reader, size: int = -1,
                   opts: Optional[PutOptions] = None) -> ObjectInfo:
        opts = opts or PutOptions()
        self.get_bucket_info(bucket)
        if isinstance(reader, (bytes, bytearray)):
            import io as _io
            size = len(reader)
            reader = HashReader(_io.BytesIO(reader), size)
        elif not isinstance(reader, HashReader):
            reader = HashReader(reader, size)
        path = self._obj_path(bucket, key)
        with self.ns.new_lock(f"{bucket}/{key}").write_locked():
            tmp = os.path.join(self.root, META_DIR,
                               f"tmp-{_uuid.uuid4()}")
            total = 0
            try:
                with open(tmp, "wb") as f:
                    while True:
                        chunk = reader.read(CHUNK)
                        if not chunk:
                            break
                        f.write(chunk)
                        total += len(chunk)
                reader.verify()
            except Exception:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise
            finally:
                reader.close()
            etag = opts.metadata.pop("etag", "") or \
                reader.md5_current_hex()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            os.replace(tmp, path)
            meta = {"etag": etag, "metadata": dict(opts.metadata),
                    "size": total, "mod_time": time.time()}
            self._save_meta(bucket, key, meta)
        return self._info(bucket, key, meta)

    def _info(self, bucket: str, key: str, meta: dict) -> ObjectInfo:
        md = dict(meta.get("metadata", {}))
        parts = [ObjectPartInfo(number=p["number"], etag=p.get("etag", ""),
                                size=p.get("size", 0),
                                actual_size=p.get("actual_size",
                                                  p.get("size", 0)))
                 for p in meta.get("parts", [])]
        return ObjectInfo(
            bucket=bucket, name=key, mod_time=meta.get("mod_time", 0.0),
            size=meta.get("size", 0),
            actual_size=int(md.get("X-Minio-Internal-actual-size",
                                   meta.get("size", 0))),
            etag=meta.get("etag", ""),
            content_type=md.get("content-type", ""),
            content_encoding=md.get("content-encoding", ""),
            parts=parts,
            user_defined={k: v for k, v in md.items()
                          if k not in ("content-type",
                                       "content-encoding")})

    def get_object_info(self, bucket: str, key: str,
                        opts: Optional[GetOptions] = None) -> ObjectInfo:
        self.get_bucket_info(bucket)
        path = self._obj_path(bucket, key)
        if not os.path.isfile(path):
            raise api_errors.ObjectNotFound(bucket, key)
        meta = self._load_meta(bucket, key)
        if "size" not in meta:
            st = os.stat(path)
            meta = {"etag": "", "metadata": {}, "size": st.st_size,
                    "mod_time": st.st_mtime}
        return self._info(bucket, key, meta)

    def get_object(self, bucket: str, key: str, offset: int = 0,
                   length: int = -1,
                   opts: Optional[GetOptions] = None
                   ) -> tuple[ObjectInfo, Iterator[bytes]]:
        info = self.get_object_info(bucket, key, opts)
        if length < 0:
            length = info.size - offset
        if offset < 0 or offset + length > info.size:
            if not (info.size == 0 and offset == 0 and length <= 0):
                raise api_errors.InvalidRange(offset, length, info.size)
        path = self._obj_path(bucket, key)

        def gen() -> Iterator[bytes]:
            remaining = length
            with open(path, "rb") as f:
                f.seek(offset)
                while remaining > 0:
                    chunk = f.read(min(CHUNK, remaining))
                    if not chunk:
                        return
                    remaining -= len(chunk)
                    yield chunk

        return info, gen()

    def delete_object(self, bucket: str, key: str, version_id: str = "",
                      versioned: bool = False) -> ObjectInfo:
        self.get_bucket_info(bucket)
        path = self._obj_path(bucket, key)
        with self.ns.new_lock(f"{bucket}/{key}").write_locked():
            if not os.path.isfile(path):
                raise api_errors.ObjectNotFound(bucket, key)
            os.remove(path)
            self._drop_meta(bucket, key)
            # prune empty parent dirs up to the bucket root
            d = os.path.dirname(path)
            while d != self._bucket_dir(bucket):
                try:
                    os.rmdir(d)
                except OSError:
                    break
                d = os.path.dirname(d)
        return ObjectInfo(bucket=bucket, name=key)

    def delete_objects(self, bucket: str, objects: list[str]
                       ) -> list[Optional[Exception]]:
        out: list[Optional[Exception]] = []
        for o in objects:
            try:
                self.delete_object(bucket, o)
                out.append(None)
            except Exception as e:  # noqa: BLE001 — per-key result
                out.append(e)
        return out

    def update_object_metadata(self, bucket: str, key: str,
                               metadata: dict, version_id: str = ""
                               ) -> ObjectInfo:
        with self.ns.new_lock(f"{bucket}/{key}").write_locked():
            info = self.get_object_info(bucket, key)
            meta = self._load_meta(bucket, key)
            new_md = dict(metadata)
            new_md.pop("etag", None)
            meta["metadata"] = new_md
            self._save_meta(bucket, key, meta)
        return self.get_object_info(bucket, key)

    def has_object_versions(self, bucket: str, key: str) -> bool:
        try:
            self.get_object_info(bucket, key)
            return True
        except api_errors.ObjectApiError:
            return False

    def heal_object(self, bucket: str, key: str, version_id: str = "",
                    deep_scan: bool = False, dry_run: bool = False):
        self.get_object_info(bucket, key)   # existence check only
        from .healing import HealResultItem
        return HealResultItem(bucket=bucket, object=key, disks_total=1)

    # -- listing -----------------------------------------------------------

    def _walk_names(self, bucket: str, prefix: str,
                    marker: str) -> Iterator[str]:
        bdir = self._bucket_dir(bucket)

        def rec(rel: str) -> Iterator[str]:
            full = os.path.join(bdir, rel) if rel else bdir
            try:
                entries = sorted(os.listdir(full))
            except OSError:
                return
            for e in entries:
                sub = f"{rel}/{e}" if rel else e
                fp = os.path.join(full, e)
                if os.path.isdir(fp):
                    yield from rec(sub)
                elif (not marker or sub > marker):
                    yield sub

        for name in rec(""):
            if name.startswith(prefix):
                yield name
            elif name > prefix:
                return

    def list_objects(self, bucket: str, prefix: str = "",
                     marker: str = "", delimiter: str = "",
                     max_keys: int = 1000
                     ) -> tuple[list[ObjectInfo], list[str], bool]:
        self.get_bucket_info(bucket)
        objects: list[ObjectInfo] = []
        prefixes: list[str] = []
        seen: set[str] = set()
        truncated = False
        for name in self._walk_names(bucket, prefix, marker):
            if marker and name <= marker:
                continue
            if delimiter:
                rest = name[len(prefix):]
                di = rest.find(delimiter)
                if di >= 0:
                    p = prefix + rest[:di + len(delimiter)]
                    if (not marker or p > marker) and p not in seen:
                        seen.add(p)
                        prefixes.append(p)
                        if len(objects) + len(prefixes) > max_keys:
                            truncated = True
                            prefixes.pop()
                            break
                    continue
            try:
                objects.append(self.get_object_info(bucket, name))
            except api_errors.ObjectApiError:
                continue
            if len(objects) + len(prefixes) > max_keys:
                truncated = True
                objects.pop()
                break
        return objects, prefixes, truncated

    def list_object_versions(self, bucket: str, prefix: str = "",
                             marker: str = "", max_keys: int = 1000,
                             version_marker: str = "",
                             delimiter: str = ""
                             ) -> tuple[list[ObjectInfo], list[str],
                                        str, str, bool]:
        """FS backend is unversioned: one "version" per key, paged on
        the key marker alone (the erasure layer's 5-tuple contract);
        the delimiter rolls up through the regular listing."""
        objs, pfx, trunc = self.list_objects(bucket, prefix, marker,
                                             delimiter, max_keys)
        return single_version_page(objs, trunc, pfx)

    # -- multipart ---------------------------------------------------------

    def _upload_dir(self, upload_id: str) -> str:
        return os.path.join(self.root, MULTIPART_DIR, upload_id)

    def new_multipart_upload(self, bucket: str, key: str,
                             opts: Optional[PutOptions] = None) -> str:
        self.get_bucket_info(bucket)
        upload_id = str(_uuid.uuid4())
        d = self._upload_dir(upload_id)
        os.makedirs(d)
        with open(os.path.join(d, "upload.json"), "w") as f:
            json.dump({"bucket": bucket, "key": key,
                       "metadata": dict((opts or PutOptions()).metadata),
                       "started": time.time()}, f)
        return upload_id

    def _upload_info(self, bucket: str, key: str,
                     upload_id: str) -> dict:
        try:
            with open(os.path.join(self._upload_dir(upload_id),
                                   "upload.json")) as f:
                info = json.load(f)
        except (OSError, ValueError):
            raise api_errors.InvalidUploadID(upload_id) from None
        if info.get("bucket") != bucket or info.get("key") != key:
            raise api_errors.InvalidUploadID(upload_id)
        return info

    def get_multipart_info(self, bucket: str, key: str,
                           upload_id: str) -> dict:
        return dict(self._upload_info(bucket, key, upload_id).get(
            "metadata", {}))

    def put_object_part(self, bucket: str, key: str, upload_id: str,
                        part_number: int, reader, size: int = -1):
        self._upload_info(bucket, key, upload_id)
        if isinstance(reader, (bytes, bytearray)):
            import io as _io
            size = len(reader)
            reader = HashReader(_io.BytesIO(reader), size)
        elif not isinstance(reader, HashReader):
            reader = HashReader(reader, size)
        p = os.path.join(self._upload_dir(upload_id),
                         f"part.{part_number}")
        total = 0
        with open(p, "wb") as f:
            while True:
                chunk = reader.read(CHUNK)
                if not chunk:
                    break
                f.write(chunk)
                total += len(chunk)
        reader.verify()
        etag = reader.md5_current_hex()
        reader.close()
        with open(p + ".json", "w") as f:
            json.dump({"etag": etag, "size": total,
                       "actual_size": reader.actual_size
                       if reader.actual_size >= 0 else total}, f)
        return ObjectPartInfo(number=part_number, etag=etag, size=total,
                              actual_size=reader.actual_size
                              if reader.actual_size >= 0 else total)

    def list_object_parts(self, bucket: str, key: str, upload_id: str,
                          part_marker: int = 0, max_parts: int = 1000
                          ) -> list[ObjectPartInfo]:
        self._upload_info(bucket, key, upload_id)
        d = self._upload_dir(upload_id)
        out = []
        for e in sorted(os.listdir(d)):
            if e.startswith("part.") and e.endswith(".json"):
                n = int(e.split(".")[1])
                if n <= part_marker:
                    continue
                with open(os.path.join(d, e)) as f:
                    pi = json.load(f)
                out.append(ObjectPartInfo(number=n, etag=pi["etag"],
                                          size=pi["size"],
                                          actual_size=pi["actual_size"]))
        out.sort(key=lambda p: p.number)
        return out[:max_parts]

    def list_multipart_uploads(self, bucket: str, key: str = ""
                               ) -> list[dict]:
        base = os.path.join(self.root, MULTIPART_DIR)
        out = []
        for uid in sorted(os.listdir(base)):
            try:
                with open(os.path.join(base, uid, "upload.json")) as f:
                    info = json.load(f)
            except (OSError, ValueError):
                continue
            if info.get("bucket") != bucket:
                continue
            if key and info.get("key") != key:
                continue
            out.append({"object": info["key"], "upload_id": uid,
                        "initiated": info.get("started", 0.0)})
        return out

    def abort_multipart_upload(self, bucket: str, key: str,
                               upload_id: str) -> None:
        self._upload_info(bucket, key, upload_id)
        shutil.rmtree(self._upload_dir(upload_id), ignore_errors=True)

    def complete_multipart_upload(self, bucket: str, key: str,
                                  upload_id: str, parts) -> ObjectInfo:
        info = self._upload_info(bucket, key, upload_id)
        d = self._upload_dir(upload_id)
        md5s = []
        total = 0
        stored = {p.number: p for p in self.list_object_parts(
            bucket, key, upload_id)}
        for i, cp in enumerate(parts):
            sp = stored.get(cp.part_number)
            if sp is None or sp.etag != cp.etag.strip('"'):
                raise api_errors.InvalidPart(cp.part_number)
            if i < len(parts) - 1 and sp.size < 5 * (1 << 20):
                raise api_errors.PartTooSmall(cp.part_number)
            md5s.append(bytes.fromhex(sp.etag))
            total += sp.size
        path = self._obj_path(bucket, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = os.path.join(self.root, META_DIR, f"tmp-{_uuid.uuid4()}")
        with open(tmp, "wb") as out:
            for cp in parts:
                with open(os.path.join(d, f"part.{cp.part_number}"),
                          "rb") as f:
                    shutil.copyfileobj(f, out, CHUNK)
        os.replace(tmp, path)
        etag = (hashlib.md5(b"".join(md5s)).hexdigest()
                + f"-{len(parts)}")
        meta = {"etag": etag, "metadata": info.get("metadata", {}),
                "size": total, "mod_time": time.time(),
                "parts": [{"number": cp.part_number,
                           "etag": stored[cp.part_number].etag,
                           "size": stored[cp.part_number].size,
                           "actual_size":
                               stored[cp.part_number].actual_size}
                          for cp in parts]}
        self._save_meta(bucket, key, meta)
        shutil.rmtree(d, ignore_errors=True)
        return self._info(bucket, key, meta)

    # -- info --------------------------------------------------------------

    def storage_info(self) -> dict:
        st = os.statvfs(self.root)
        total = st.f_blocks * st.f_frsize
        free = st.f_bavail * st.f_frsize
        return {"total": total, "free": free, "used": total - free,
                "online_disks": 1, "offline_disks": 0, "sets": 0,
                "drives_per_set": 1, "backend": "FS"}

    def close(self) -> None:
        pass
