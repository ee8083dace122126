"""The S3 front. Ported so far: the error registry (s3errors.py)."""
