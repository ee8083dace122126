"""The S3 front: signatures, handlers, XML dialect, admission, server.

Counterpart of minio_tpu/s3/ (the reference's cmd/http, cmd/routers.go,
cmd/auth-handler.go, cmd/signature-v*.go, cmd/object-handlers.go and
cmd/bucket-handlers.go) over the port's object layer.
"""
