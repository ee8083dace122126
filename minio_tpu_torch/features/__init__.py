"""Host-side features of the data path: SSE and compression (crypto.py),
the KMS seam (kms.py), S2 framing (snappy.py) and bucket lifecycle rules
with the crawler's actions (lifecycle.py)."""
