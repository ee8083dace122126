"""IAM: identity, access policies, STS (reference cmd/iam.go +
pkg/iam/policy + cmd/sts-handlers.go); counterpart of minio_tpu/iam/."""

from .policy import Policy, PolicyArgs, Statement  # noqa: F401
from .sys import IAMSys  # noqa: F401
