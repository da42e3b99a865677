"""Coded errors crossing service boundaries.

Capability parity with internal/dferrors (gRPC-status-shaped errors the
reference threads through streams) plus the common codes the services
raise. Host-side control-plane code raises these; the message layer
(cluster/messages.py ScheduleFailure) carries code+message across the
in-proc or socket boundary.
"""

from __future__ import annotations

import enum


class Code(enum.Enum):
    OK = "OK"
    CANCELLED = "Cancelled"
    INVALID_ARGUMENT = "InvalidArgument"
    NOT_FOUND = "NotFound"
    ALREADY_EXISTS = "AlreadyExists"
    PERMISSION_DENIED = "PermissionDenied"
    RESOURCE_EXHAUSTED = "ResourceExhausted"
    FAILED_PRECONDITION = "FailedPrecondition"
    UNAVAILABLE = "Unavailable"
    UNAUTHENTICATED = "Unauthenticated"
    INTERNAL = "Internal"
    DEADLINE_EXCEEDED = "DeadlineExceeded"
    DATA_LOSS = "DataLoss"


class DFError(Exception):
    code: Code = Code.INTERNAL

    def __init__(self, message: str = "", code: Code | None = None):
        if code is not None:
            self.code = code
        super().__init__(message or self.code.value)
        self.message = message

    def to_wire(self) -> dict:
        return {"code": self.code.value, "message": self.message}

    @staticmethod
    def from_wire(d: dict) -> "DFError":
        try:
            code = Code(d.get("code", Code.INTERNAL.value))
        except ValueError:  # unknown code from a newer/corrupt peer
            code = Code.INTERNAL
        cls = _BY_CODE.get(code, DFError)
        return cls(d.get("message", ""), code=code)


class InvalidArgument(DFError):
    code = Code.INVALID_ARGUMENT


class NotFound(DFError):
    code = Code.NOT_FOUND


class AlreadyExists(DFError):
    code = Code.ALREADY_EXISTS


class PermissionDenied(DFError):
    code = Code.PERMISSION_DENIED


class ResourceExhausted(DFError):
    code = Code.RESOURCE_EXHAUSTED


class FailedPrecondition(DFError):
    code = Code.FAILED_PRECONDITION


class Unavailable(DFError):
    code = Code.UNAVAILABLE


class Unauthenticated(DFError):
    code = Code.UNAUTHENTICATED


class DeadlineExceeded(DFError):
    code = Code.DEADLINE_EXCEEDED


class DataLoss(DFError):
    """Bytes crossing a trust boundary failed an integrity check."""

    code = Code.DATA_LOSS


class PieceCorrupted(DataLoss):
    """A fetched piece's digest does not match its attested digest — the
    parent served corrupt bytes (or they were corrupted in flight). The
    bytes are never committed; the failure report carries
    reason="corruption" so the scheduler can quarantine the parent."""


class TaskIntegrityError(DataLoss):
    """A task's stored state is internally inconsistent at completion
    time: piece holes in the finished bitset, summed piece lengths that
    disagree with the content length, or a whole-task digest mismatch."""


_BY_CODE = {cls.code: cls for cls in DFError.__subclasses__()}
