"""Peer/Task state machines and host types as integer enums.

Capability parity with the reference's looplab/fsm-driven entities:
peer states/events (scheduler/resource/peer.go:53-109), task states
(scheduler/resource/task.go:58-84), host types (pkg/types/types.go:84-93).

A copy of dragonfly2_tpu/state/fsm.py. States are small ints so they
live in the struct-of-arrays cluster state and can be compared inside
device programs; the transition table is validated host-side at mutation
time, exactly where the reference calls ``FSM.Event``.
"""

from __future__ import annotations

import enum


class HostType(enum.IntEnum):
    NORMAL = 0
    SUPER = 1       # seed peer
    STRONG = 2
    WEAK = 3

    @classmethod
    def from_name(cls, name: str) -> "HostType":
        return _HOST_TYPE_NAMES.get(name.lower(), cls.NORMAL)


_HOST_TYPE_NAMES = {
    "normal": HostType.NORMAL,
    "super": HostType.SUPER,
    "strong": HostType.STRONG,
    "weak": HostType.WEAK,
}


class PeerState(enum.IntEnum):
    PENDING = 0
    RECEIVED_EMPTY = 1
    RECEIVED_TINY = 2
    RECEIVED_SMALL = 3
    RECEIVED_NORMAL = 4
    RUNNING = 5
    BACK_TO_SOURCE = 6
    SUCCEEDED = 7
    FAILED = 8
    LEAVE = 9

    @classmethod
    def from_name(cls, name: str) -> "PeerState":
        return _PEER_STATE_NAMES.get(name, cls.PENDING)

    @property
    def display(self) -> str:
        return _PEER_STATE_DISPLAY[self]


_PEER_STATE_DISPLAY = {
    PeerState.PENDING: "Pending",
    PeerState.RECEIVED_EMPTY: "ReceivedEmpty",
    PeerState.RECEIVED_TINY: "ReceivedTiny",
    PeerState.RECEIVED_SMALL: "ReceivedSmall",
    PeerState.RECEIVED_NORMAL: "ReceivedNormal",
    PeerState.RUNNING: "Running",
    PeerState.BACK_TO_SOURCE: "BackToSource",
    PeerState.SUCCEEDED: "Succeeded",
    PeerState.FAILED: "Failed",
    PeerState.LEAVE: "Leave",
}
_PEER_STATE_NAMES = {v: k for k, v in _PEER_STATE_DISPLAY.items()}


class PeerEvent(enum.IntEnum):
    REGISTER_EMPTY = 0
    REGISTER_TINY = 1
    REGISTER_SMALL = 2
    REGISTER_NORMAL = 3
    DOWNLOAD = 4
    DOWNLOAD_BACK_TO_SOURCE = 5
    DOWNLOAD_SUCCEEDED = 6
    DOWNLOAD_FAILED = 7
    LEAVE = 8


# event -> (allowed source states, destination state); peer.go:137-221 wiring.
PEER_TRANSITIONS: dict[PeerEvent, tuple[frozenset[PeerState], PeerState]] = {
    PeerEvent.REGISTER_EMPTY: (frozenset({PeerState.PENDING}), PeerState.RECEIVED_EMPTY),
    PeerEvent.REGISTER_TINY: (frozenset({PeerState.PENDING}), PeerState.RECEIVED_TINY),
    PeerEvent.REGISTER_SMALL: (frozenset({PeerState.PENDING}), PeerState.RECEIVED_SMALL),
    PeerEvent.REGISTER_NORMAL: (frozenset({PeerState.PENDING}), PeerState.RECEIVED_NORMAL),
    PeerEvent.DOWNLOAD: (
        frozenset({
            PeerState.RECEIVED_EMPTY,
            PeerState.RECEIVED_TINY,
            PeerState.RECEIVED_SMALL,
            PeerState.RECEIVED_NORMAL,
        }),
        PeerState.RUNNING,
    ),
    PeerEvent.DOWNLOAD_BACK_TO_SOURCE: (
        frozenset({
            PeerState.RECEIVED_EMPTY,
            PeerState.RECEIVED_TINY,
            PeerState.RECEIVED_SMALL,
            PeerState.RECEIVED_NORMAL,
            PeerState.RUNNING,
        }),
        PeerState.BACK_TO_SOURCE,
    ),
    PeerEvent.DOWNLOAD_SUCCEEDED: (
        frozenset({PeerState.RUNNING, PeerState.BACK_TO_SOURCE}),
        PeerState.SUCCEEDED,
    ),
    PeerEvent.DOWNLOAD_FAILED: (
        frozenset({
            PeerState.RUNNING,
            PeerState.BACK_TO_SOURCE,
            PeerState.SUCCEEDED,
        }),
        PeerState.FAILED,
    ),
    PeerEvent.LEAVE: (
        frozenset(s for s in PeerState if s != PeerState.LEAVE),
        PeerState.LEAVE,
    ),
}


class TaskState(enum.IntEnum):
    PENDING = 0
    RUNNING = 1
    SUCCEEDED = 2
    FAILED = 3
    LEAVE = 4

    @classmethod
    def from_name(cls, name: str) -> "TaskState":
        return _TASK_STATE_NAMES.get(name, cls.PENDING)

    @property
    def display(self) -> str:
        return _TASK_STATE_DISPLAY[self]


_TASK_STATE_DISPLAY = {
    TaskState.PENDING: "Pending",
    TaskState.RUNNING: "Running",
    TaskState.SUCCEEDED: "Succeeded",
    TaskState.FAILED: "Failed",
    TaskState.LEAVE: "Leave",
}
_TASK_STATE_NAMES = {v: k for k, v in _TASK_STATE_DISPLAY.items()}


class TaskEvent(enum.IntEnum):
    DOWNLOAD = 0
    DOWNLOAD_SUCCEEDED = 1
    DOWNLOAD_FAILED = 2
    LEAVE = 3


TASK_TRANSITIONS: dict[TaskEvent, tuple[frozenset[TaskState], TaskState]] = {
    TaskEvent.DOWNLOAD: (
        frozenset({TaskState.PENDING, TaskState.SUCCEEDED, TaskState.FAILED, TaskState.LEAVE}),
        TaskState.RUNNING,
    ),
    TaskEvent.DOWNLOAD_SUCCEEDED: (
        frozenset({TaskState.RUNNING, TaskState.FAILED}),
        TaskState.SUCCEEDED,
    ),
    TaskEvent.DOWNLOAD_FAILED: (frozenset({TaskState.RUNNING}), TaskState.FAILED),
    TaskEvent.LEAVE: (frozenset(s for s in TaskState if s != TaskState.LEAVE), TaskState.LEAVE),
}


class InvalidTransition(Exception):
    pass


def peer_transition(current: PeerState, event: PeerEvent) -> PeerState:
    sources, dest = PEER_TRANSITIONS[event]
    if current not in sources:
        raise InvalidTransition(f"peer event {event.name} invalid from state {current.name}")
    return dest


def task_transition(current: TaskState, event: TaskEvent) -> TaskState:
    sources, dest = TASK_TRANSITIONS[event]
    if current not in sources:
        raise InvalidTransition(f"task event {event.name} invalid from state {current.name}")
    return dest


# States for which IsBadNode short-circuits to True (evaluator.go:93-99):
# Failed, Leave, Pending, and all Received* states.
BAD_NODE_STATES = frozenset({
    PeerState.FAILED,
    PeerState.LEAVE,
    PeerState.PENDING,
    PeerState.RECEIVED_EMPTY,
    PeerState.RECEIVED_TINY,
    PeerState.RECEIVED_SMALL,
    PeerState.RECEIVED_NORMAL,
})
