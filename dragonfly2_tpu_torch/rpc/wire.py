"""Wire codec for the cluster control-plane edge.

Capability parity with pkg/rpc's typed message layer (the d7y.io/api
protobufs, SURVEY.md L1/L3): every control-plane message is a dataclass
(cluster/messages.py) encoded as a length-prefixed msgpack frame
`{"t": <type-name>, "d": <fields>}`. Nested dataclasses, enums, and lists
round-trip via type hints — no codegen step. gRPC is not used because the
image ships no protoc python plugin; the framing preserves what matters
from the reference's transport: long-lived bidirectional typed streams
(AnnouncePeer, SyncProbes, Trainer.Train).

Port of dragonfly2_tpu/rpc/wire.py. The type registry is this module's
own, keyed by message name like the reference's, so a frame encoded by
either package decodes in the other.
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import struct
import types
import typing

import msgpack

from dragonfly2_tpu_torch.rpc import resilience as _resilience
from dragonfly2_tpu_torch.telemetry import tracing as _tracing

_REGISTRY: dict[str, type] = {}

_LEN = struct.Struct(">I")
MAX_FRAME = 256 << 20  # trainer dataset chunks are 128 MiB (announcer.go:40)


class WireDecodeError(TypeError):
    """A frame's payload cannot instantiate its message type — a
    required (no-default) field is absent. Distinct from a codec bug:
    the skew replayer (tools/dflint/wirefuzz.py) treats this as "the
    frame is from an incompatible schema generation", anything else as
    a defect. Subclasses TypeError so pre-existing callers that caught
    the bare ``cls(**kwargs)`` TypeError keep working."""

    def __init__(self, message_type: str, missing: list[str]):
        self.message_type = message_type
        self.missing = list(missing)
        super().__init__(
            f"cannot decode {message_type}: required field(s) "
            f"{', '.join(missing)} absent from the frame — the sender "
            f"speaks an incompatible schema generation"
        )


def register_messages(*classes: type) -> None:
    """Register top-level frame types by ``__name__``. Re-registering
    the SAME class is an idempotent no-op (servers and clients both
    import-register their message modules); a DIFFERENT class under an
    already-taken name raises — silent overwrite would alias two
    message types in the name-keyed registry and misroute every frame
    of the loser."""
    for cls in classes:
        existing = _REGISTRY.get(cls.__name__)
        if existing is not None and existing is not cls:
            raise TypeError(
                f"wire message name collision: {cls.__name__!r} is "
                f"already registered by {existing.__module__}; refusing "
                f"to alias {cls.__module__}.{cls.__qualname__} onto it"
            )
        _REGISTRY[cls.__name__] = cls


def register_module(module: types.ModuleType) -> None:
    for name in dir(module):
        obj = getattr(module, name)
        if dataclasses.is_dataclass(obj) and isinstance(obj, type):
            register_messages(obj)


def _to_plain(value: typing.Any) -> typing.Any:
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {
            f.name: _to_plain(getattr(value, f.name)) for f in dataclasses.fields(value)
        }
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, (list, tuple)):
        return [_to_plain(v) for v in value]
    if isinstance(value, dict):
        return {k: _to_plain(v) for k, v in value.items()}
    return value


def _from_plain(hint: typing.Any, value: typing.Any) -> typing.Any:
    origin = typing.get_origin(hint)
    if origin in (list, tuple):
        (inner,) = typing.get_args(hint)[:1] or (typing.Any,)
        seq = [_from_plain(inner, v) for v in value]
        return seq if origin is list else tuple(seq)
    if origin is typing.Union or origin is getattr(types, "UnionType", ()):
        # Optional[X] / X | None (PEP 604 unions report types.UnionType)
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if value is None or not args:
            return value
        return _from_plain(args[0], value)
    if isinstance(hint, type):
        if dataclasses.is_dataclass(hint) and isinstance(value, dict):
            return _instantiate(hint, value)
        if issubclass(hint, enum.Enum):
            return hint(value)
    return value


def _instantiate(cls: type, fields: dict) -> typing.Any:
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in fields:
            kwargs[f.name] = _from_plain(hints.get(f.name, typing.Any), fields[f.name])
    missing = [
        f.name for f in dataclasses.fields(cls)
        if f.name not in kwargs
        and f.default is dataclasses.MISSING
        and f.default_factory is dataclasses.MISSING
    ]
    if missing:
        # typed, not the bare TypeError out of cls(**kwargs): the skew
        # replayer needs "incompatible frame" distinguishable from a
        # codec bug, and operators need the message type in the error
        raise WireDecodeError(cls.__name__, missing)
    return cls(**kwargs)


def encode(message: typing.Any, trace_context: dict | None = None,
           deadline_s: float | None = None) -> bytes:
    """Frame one message. Trace context ({"trace_id", "span_id"}) rides
    the envelope — the explicit argument wins, else the ambient span's
    context (telemetry/tracing.current_context) is injected so a span
    opened on one side of the wire continues on the other. No active
    span, no extra bytes.

    The deadline budget rides the same way (rpc/resilience.py): an
    explicit `deadline_s` wins, else the ambient deadline scope's
    REMAINING budget is stamped into `"dl"` as relative seconds — the
    receiver re-anchors it on its own monotonic clock, so the time this
    hop already spent is what decrements the budget across hops. No
    active scope, no extra bytes."""
    name = type(message).__name__
    if name not in _REGISTRY:
        raise TypeError(f"message type {name} not registered")
    env: dict = {"t": name, "d": _to_plain(message)}
    tc = trace_context if trace_context is not None else _tracing.current_context()
    if tc and tc.get("trace_id"):
        env["tc"] = {
            "trace_id": str(tc["trace_id"]),
            "span_id": str(tc.get("span_id") or ""),
        }
    dl = deadline_s if deadline_s is not None else _resilience.remaining()
    if dl is not None:
        env["dl"] = max(float(dl), 0.0)
    payload = msgpack.packb(env, use_bin_type=True)
    if len(payload) > MAX_FRAME:
        raise ValueError(f"frame too large: {len(payload)}")
    return _LEN.pack(len(payload)) + payload


def decode(payload: bytes) -> typing.Any:
    obj = msgpack.unpackb(payload, raw=False)
    cls = _REGISTRY.get(obj.get("t"))
    if cls is None:
        raise TypeError(f"unknown message type {obj.get('t')!r}")
    message = _instantiate(cls, obj.get("d", {}))
    tc = obj.get("tc")
    if tc:
        try:
            # non-field attribute: dataclass __eq__/asdict ignore it, so
            # the codec's roundtrip contract (test_wire_property) holds
            object.__setattr__(message, "trace_context", dict(tc))
        except AttributeError:
            pass  # slotted message types simply drop the context
    dl = obj.get("dl")
    if dl is not None:
        try:
            # remaining budget in seconds at SEND time; receivers re-anchor
            # it on their own clock (rpc/server.py shed + deadline scope)
            object.__setattr__(message, "deadline_s", float(dl))
        except AttributeError:
            pass
    return message


async def read_frame(reader: asyncio.StreamReader) -> object | None:
    """Read one framed message from an asyncio StreamReader; None on EOF."""
    try:
        header = await reader.readexactly(_LEN.size)
        (length,) = _LEN.unpack(header)
        if length > MAX_FRAME:
            raise ValueError(f"frame length {length} exceeds cap")
        payload = await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    return decode(payload)


def write_frame(writer: asyncio.StreamWriter, message: typing.Any,
                trace_context: dict | None = None) -> None:
    writer.write(encode(message, trace_context=trace_context))
