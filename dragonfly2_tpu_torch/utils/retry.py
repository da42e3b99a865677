"""Port of dragonfly2_tpu/utils/retry.py, whole.

Exponential-backoff retry loop.

Capability parity with pkg/retry/retry.go `Run(ctx, initBackoff,
maxBackoff, maxAttempts, f)`: f returns (result, cancel, err); cancel=True
aborts the loop immediately (non-retryable), otherwise failures back off
exponentially up to maxBackoff for maxAttempts tries.

Two hardenings over the plain loop:

- **Full jitter** (the AWS-architecture backoff result): each sleep is
  uniform in [0, min(cap, init * 2^attempt)] rather than the deterministic
  ladder, so a fleet of daemons retrying the same restarted scheduler
  spreads its redials instead of stampeding in lockstep.
- **A `retryable` predicate**: errors that can never succeed on retry —
  a malformed request (`InvalidArgument`), a bad credential
  (`Unauthenticated`) — abort immediately instead of burning every
  attempt against a deterministic failure. The default predicate encodes
  exactly that for DFErrors and retries everything else; `Cancel` keeps
  its original contract as the explicit in-band abort.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, TypeVar

from dragonfly2_tpu_torch.utils import dferrors

T = TypeVar("T")


class Cancel(Exception):
    """Raise inside the retried callable to abort without further attempts."""

    def __init__(self, cause: Exception | None = None):
        super().__init__(str(cause) if cause else "cancelled")
        self.cause = cause


# DFError codes for which a retry is wasted by construction: the same
# request will fail the same way until the CALLER changes something.
_NON_RETRYABLE_CODES = frozenset({
    dferrors.Code.INVALID_ARGUMENT,
    dferrors.Code.UNAUTHENTICATED,
    dferrors.Code.PERMISSION_DENIED,
})


def default_retryable(error: Exception) -> bool:
    """Retry unless the error is a DFError whose code marks it as a
    caller bug/credential problem rather than a transient fault."""
    if isinstance(error, dferrors.DFError):
        return error.code not in _NON_RETRYABLE_CODES
    return True


def run(
    fn: Callable[[], T],
    init_backoff: float = 0.2,
    max_backoff: float = 5.0,
    max_attempts: int = 3,
    sleep: Callable[[float], Any] = time.sleep,
    retryable: Callable[[Exception], bool] | None = default_retryable,
    rng: random.Random | None = None,
) -> T:
    """Call fn until it succeeds, sleeping a full-jittered exponential
    backoff between failures. Raises the last error after max_attempts,
    the Cancel cause immediately, or the first error `retryable` rejects.
    `retryable=None` retries every Exception (the pre-predicate behavior);
    `rng` pins the jitter for deterministic tests."""
    uniform = (rng or random).uniform
    cap = init_backoff
    last: Exception | None = None
    for attempt in range(max_attempts):
        try:
            return fn()
        except Cancel as c:
            raise (c.cause or c)
        except Exception as e:  # noqa: BLE001 - the predicate decides
            if retryable is not None and not retryable(e):
                raise
            last = e
            if attempt + 1 < max_attempts:
                sleep(uniform(0.0, min(cap, max_backoff)))
                cap *= 2
    assert last is not None
    raise last
