"""Host-side features of the data path: SSE (crypto.py) and its KMS seam
(kms.py)."""
