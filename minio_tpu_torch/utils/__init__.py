def backoff_delay(base: float, cap: float, attempt: int) -> float:
    """Capped exponential backoff with half-jitter: attempt 0 -> ~base,
    doubling per attempt up to `cap`, scaled by a uniform factor in
    [0.5, 1.0) so synchronized retriers de-correlate (a copy of
    minio_tpu/utils/__init__.py:13; the MRF queue's retry delay)."""
    import random
    return min(cap, base * (2 ** attempt)) * (0.5 + random.random() / 2)


def host_port(addr: str, default_port: int) -> tuple[str, int]:
    """Split "host[:port]": a bare hostname gets the default port (a
    copy of minio_tpu/utils/__init__.py:1; the LDAP provider's dial)."""
    host, sep, port = addr.rpartition(":")
    if not sep:
        return addr, default_port
    try:
        return host, int(port)
    except ValueError:
        return addr, default_port
