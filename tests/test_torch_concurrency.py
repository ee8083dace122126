"""The reference's concurrency races (tests/test_concurrency.py) on the
port, with the port's lock-order watchdog on.

Every case of tests/test_concurrency.py rebound to the port
(tests/test_torch_iam.rebound), its erasure sets on device="cpu": same-key
PUTs where one writer's payload wins whole, a PUT/GET/DELETE mix with no
torn read, a heal racing readers, concurrent multipart sessions, and a
thread pool across the live S3 server's surface. The payloads are the
oracle: every GET is held to the bytes its writer sent. Each test ends
with no ``cycle`` violation in the watchdog's graph.
"""

from __future__ import annotations

import inspect

import pytest

import tests.test_concurrency as ref_cases
from minio_tpu_torch.object.sets import ErasureSets
from tests.test_torch_chaos import _CpuSets
from tests.test_torch_iam import _one_torch_thread, rebound  # noqa: F401
from tests.test_torch_lockcheck import port_watchdog  # noqa: F401

pytestmark = pytest.mark.chaos


@pytest.fixture()
def sets(tmp_path):
    """tests/test_concurrency.py's fixture on the port: one 4+2 set."""
    s = ErasureSets.from_drives(
        [str(tmp_path / f"d{i}") for i in range(6)], 1, 6, 2,
        block_size=1 << 16, device="cpu")
    yield s
    s.close()


_CASES = sorted(name for name, fn in vars(ref_cases).items()
                if name.startswith("test_") and inspect.isfunction(fn))


def test_every_reference_case_is_rebound():
    assert len(_CASES) == 5, _CASES


@pytest.mark.parametrize("name", _CASES)
def test_reference_concurrency_cases(tmp_path, request, name):
    fn = rebound(getattr(ref_cases, name), ErasureSets=_CpuSets)
    params = inspect.signature(fn).parameters
    given = {"tmp_path": tmp_path}
    if "sets" in params:
        given["sets"] = request.getfixturevalue("sets")
    fn(**{p: given[p] for p in params})
