"""S3 Select: SQL over CSV/JSON objects with event-stream responses
(reference pkg/s3select — SQL parser/evaluator, format readers, message
framing). A copy of minio_tpu/s3select/: host code, no device work."""

from .select import SelectRequest, run_select  # noqa: F401
