"""Distributed runtime: internode RPC transport, quorum locks (dsync),
remote storage, peer control plane.

Counterpart of minio_tpu/distributed/ (the reference's cmd/rest/,
pkg/dsync/, cmd/lock-rest-*.go, cmd/storage-rest-*.go,
cmd/peer-rest-*.go): nodes speak a thin authenticated HTTP-POST RPC;
each node's erasure, hash and cipher steps stay on its own card; the
transport carries the seeded fault-injection plane (naughtynet). Left
out: the etcd client."""
