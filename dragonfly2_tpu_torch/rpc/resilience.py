"""Port of dragonfly2_tpu/rpc/resilience.py, whole: the deadline scopes,
the per-target ``CircuitBreaker``, ``BreakerBoard`` and the process's
``open_breaker_census``.

Failure-domain resilience primitives for the RPC edge.

Two capabilities the reference gets from gRPC + pkg/retry and this codebase
previously lacked end to end:

- **Deadline budgets** (grpc-timeout semantics): a caller opens a
  ``deadline(budget_s)`` scope; every frame encoded inside it carries the
  *remaining* budget in the wire envelope (rpc/wire.py ``"dl"``), the
  receiving server re-anchors the budget on receipt and keeps decrementing
  while it holds the request — so a hop chain shares ONE budget instead of
  stacking per-hop timeouts. Clients enforce the budget per call
  (``DeadlineExceeded`` DFError before dialing work that cannot finish);
  servers shed work whose budget already expired instead of scheduling it.
  The budget rides as a RELATIVE duration, not an absolute timestamp:
  hosts do not share a clock, and monotonic clocks never cross processes.

- **Per-target circuit breakers** (closed → open → half-open): every dial
  site shares one implementation keyed by ``host:port``. A blackholed
  target costs `failure_threshold` dial timeouts, then the breaker opens
  and callers fail in microseconds until ``open_ttl`` elapses; the first
  caller after that runs as the half-open probe (dial + the existing
  HealthCheck request where the transport supports it) and its outcome
  closes or re-opens the breaker. This generalizes SyncSchedulerClient's
  old ad-hoc ``dial_failure_ttl`` cache to every client in the tree.

Breaker state and deadline outcomes export through
``telemetry.series.resilience_series`` (``dragonfly_<service>_rpc_breaker_*``
and ``dragonfly_<service>_rpc_deadline_*`` families).
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import threading
import time
import weakref

from dragonfly2_tpu_torch.utils import dferrors

# ---------------------------------------------------------------- deadlines

# Absolute time.monotonic() deadline for the current logical call chain.
# Context-local, so concurrent asyncio tasks / threads (asyncio.to_thread
# copies the context) each see their own budget.
_DEADLINE: contextvars.ContextVar[float | None] = contextvars.ContextVar(
    "rpc_deadline", default=None
)


def current_deadline() -> float | None:
    """Absolute monotonic deadline of the ambient scope, or None."""
    return _DEADLINE.get()


def remaining() -> float | None:
    """Seconds of budget left in the ambient scope (may be <= 0), or None
    when no deadline scope is active."""
    dl = _DEADLINE.get()
    return None if dl is None else dl - time.monotonic()


def expired() -> bool:
    r = remaining()
    return r is not None and r <= 0


def check(what: str = "call") -> None:
    """Raise DeadlineExceeded if the ambient budget is already spent —
    the pre-flight guard clients run before dialing/sending."""
    r = remaining()
    if r is not None and r <= 0:
        raise dferrors.DeadlineExceeded(
            f"{what}: deadline budget exhausted ({r:.3f}s remaining)"
        )


def bound_timeout(timeout: float | None) -> float | None:
    """The effective per-call timeout: the caller's own cap bounded by the
    ambient budget. None stays None only when neither side bounds it."""
    r = remaining()
    if r is None:
        return timeout
    r = max(r, 0.0)
    return r if timeout is None else min(timeout, r)


@contextlib.contextmanager
def deadline(budget_s: float):
    """Open (or tighten) a deadline scope: the effective deadline is the
    MINIMUM of any enclosing scope and now+budget_s — a callee can only
    shrink the budget it was handed, never extend it."""
    yield from _enter(time.monotonic() + budget_s)


@contextlib.contextmanager
def deadline_at(deadline_monotonic: float):
    """Like deadline(), anchored at an absolute monotonic instant (the
    server side re-anchors a received relative budget here)."""
    yield from _enter(deadline_monotonic)


def _enter(candidate: float):
    current = _DEADLINE.get()
    effective = candidate if current is None else min(current, candidate)
    token = _DEADLINE.set(effective)
    try:
        yield effective
    finally:
        _DEADLINE.reset(token)


# ---------------------------------------------------------------- breakers

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# gauge encoding (dashboards alert on == 2)
_STATE_VALUE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


class BreakerOpen(dferrors.Unavailable, ConnectionError):
    """Raised by acquire() when the breaker short-circuits the call. A
    subclass of Unavailable (the retryable DFError code) AND of
    ConnectionError, so every existing except-clause that treats a dead
    target as a transport failure — the manager's job edge catches
    ConnectionError, the daemon's retry loop catches Unavailable — keeps
    working without enumerating a new type."""


class CircuitBreaker:
    """One target's closed/open/half-open dial breaker. Thread-safe (one
    plain lock, never held across IO) so the asyncio pool, the manager's
    REST worker threads, and the announcer cadence can share instances.

    - CLOSED: calls flow; `failure_threshold` consecutive failures open it.
    - OPEN: acquire() raises BreakerOpen until `open_ttl` elapses.
    - HALF_OPEN: exactly one caller wins acquire() as the probe (the rest
      keep fast-failing); its record_success()/record_failure() closes or
      re-opens the breaker.
    """

    def __init__(self, target: str, failure_threshold: int = 2,
                 open_ttl: float = 5.0, on_transition=None):
        self.target = target
        self.failure_threshold = max(int(failure_threshold), 1)
        self.open_ttl = open_ttl
        self._on_transition = on_transition  # (target, new_state) -> None
        self._mu = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        with self._mu:
            return self._effective_state()

    def _effective_state(self) -> str:
        # lazily ripen OPEN -> HALF_OPEN once the ttl elapsed
        if self._state == OPEN and time.monotonic() - self._opened_at >= self.open_ttl:
            self._set_state(HALF_OPEN)
        return self._state

    def _set_state(self, state: str) -> None:
        if state == self._state:
            return
        self._state = state
        if state != HALF_OPEN:
            self._probing = False
        if self._on_transition is not None:
            self._on_transition(self.target, state)

    def allows(self) -> bool:
        """Non-raising peek (the hashring failover asks 'should I even try
        this node' without consuming the half-open probe slot)."""
        with self._mu:
            state = self._effective_state()
            return state == CLOSED or (state == HALF_OPEN and not self._probing)

    def acquire(self) -> str:
        """Claim the right to dial. Returns the state the call runs under
        (CLOSED, or HALF_OPEN for the single probe); raises BreakerOpen
        when the target is short-circuited. Callers MUST follow up with
        record_success()/record_failure()."""
        with self._mu:
            state = self._effective_state()
            if state == CLOSED:
                return CLOSED
            if state == HALF_OPEN and not self._probing:
                self._probing = True
                return HALF_OPEN
            ttl_left = self.open_ttl - (time.monotonic() - self._opened_at)
            raise BreakerOpen(
                f"{self.target}: circuit open "
                f"({self._failures} consecutive failures; "
                f"probe in {max(ttl_left, 0.0):.1f}s)"
            )

    def record_success(self) -> None:
        with self._mu:
            self._failures = 0
            self._probing = False
            self._set_state(CLOSED)

    def record_failure(self) -> None:
        with self._mu:
            self._failures += 1
            if self._state == HALF_OPEN or self._failures >= self.failure_threshold:
                self._opened_at = time.monotonic()
                self._set_state(OPEN)

    def release(self) -> None:
        """Abandon an acquire() without a verdict (the caller was
        CANCELLED mid-dial, not refused by the target): frees the
        half-open probe slot so the next caller can probe — a cancelled
        dial says nothing about the target's health and must neither
        open the breaker nor wedge the probe."""
        with self._mu:
            self._probing = False


class BreakerBoard:
    """Per-service registry of per-target breakers, wired to the
    ``dragonfly_<service>_rpc_breaker_*`` telemetry families. One board per
    client object (pool / sync client), so tests and multi-cluster tools
    don't share failure state through a process-global."""

    def __init__(self, service: str, failure_threshold: int = 2,
                 open_ttl: float = 5.0, registry=None):
        from dragonfly2_tpu_torch.telemetry import default_registry
        from dragonfly2_tpu_torch.telemetry.series import resilience_series

        self.service = service
        self.failure_threshold = failure_threshold
        self.open_ttl = open_ttl
        self.metrics = resilience_series(registry or default_registry(), service)
        self._mu = threading.Lock()
        self._breakers: dict[str, CircuitBreaker] = {}
        _register_board(self)

    def open_count(self) -> int:
        """Breakers currently NOT closed (open or half-open probing) —
        the per-board contribution to the process-wide census the soak
        timeline samples (telemetry/timeline.py)."""
        with self._mu:
            breakers = list(self._breakers.values())
        return sum(1 for b in breakers if b.state != "closed")

    def get(self, target: str) -> CircuitBreaker:
        with self._mu:
            breaker = self._breakers.get(target)
            if breaker is None:
                breaker = self._breakers[target] = CircuitBreaker(
                    target,
                    failure_threshold=self.failure_threshold,
                    open_ttl=self.open_ttl,
                    on_transition=self._observe_transition,
                )
                self.metrics.breaker_state.labels(target).set(0.0)
            return breaker

    def _observe_transition(self, target: str, state: str) -> None:
        self.metrics.breaker_state.labels(target).set(_STATE_VALUE[state])
        self.metrics.breaker_transitions.labels(target, state).inc()

    def acquire(self, target: str) -> str:
        """get(target).acquire() + the fast-fail counter on BreakerOpen."""
        try:
            return self.get(target).acquire()
        except BreakerOpen:
            self.metrics.breaker_fast_fail.labels(target).inc()
            raise

    def allows(self, target: str) -> bool:
        return self.get(target).allows()

    def targets(self) -> list[str]:
        with self._mu:
            return list(self._breakers)

    def record_outcome(self, target: str, error: BaseException | None) -> None:
        """Single classification point for a dial/probe outcome, shared by
        every call site so the three dial paths cannot drift: None ->
        success; a transport failure (OSError incl. ConnectionError, or a
        timeout) -> failure; anything else (cancellation, a codec bug) is
        NOT evidence against the target -> release the probe slot without
        opening the breaker."""
        breaker = self.get(target)
        if error is None:
            breaker.record_success()
        elif isinstance(error, (OSError, TimeoutError, asyncio.TimeoutError)):
            breaker.record_failure()
        else:
            breaker.release()

    def drop(self, target: str) -> None:
        """Forget a decommissioned target (dynconfig removed it from the
        active set): its gauge resets to closed so dashboards don't alert
        forever on a scheduler that no longer exists."""
        with self._mu:
            if self._breakers.pop(target, None) is not None:
                self.metrics.breaker_state.labels(target).set(0.0)


# Weak census of live boards (boards stay per-client-object — no failure
# state is shared through this; it only answers "how many breakers are
# open anywhere in this process right now" for the soak timeline and the
# /debug/flight surface).
_BOARDS: "weakref.WeakSet[BreakerBoard]" = weakref.WeakSet()
_boards_mu = threading.Lock()


def _register_board(board: "BreakerBoard") -> None:
    with _boards_mu:
        _BOARDS.add(board)


def open_breaker_census() -> int:
    """Process-wide count of non-closed circuit breakers across every
    live BreakerBoard."""
    with _boards_mu:
        boards = list(_BOARDS)
    return sum(b.open_count() for b in boards)
