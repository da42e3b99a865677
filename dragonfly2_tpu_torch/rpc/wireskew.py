"""The megascale soak's mixed-version wire: the port's own copy of the
reference's ``degrade_payload`` and ``SkewProxy``
(tools/dflint/wirefuzz.py), over the port's ``rpc/wire.py``.

``run_megascale(wire_skew=schema)`` wraps the scheduler in a
:class:`SkewProxy`: every message-shaped control-plane exchange
(registrations, report handlers, the tick's scheduling responses, the
fleet's handoff frames) round-trips through encode → degrade to the N-1
snapshot → decode before it is acted on, so a rolling-upgrade soak
replays its whole compressed day over cross-version frames and must
lose zero downloads. The snapshot is the golden wire schema
``tools/dfwire_schema.json`` (:func:`load_golden`), read, never written.
"""

from __future__ import annotations

import importlib
import json
import pathlib

import msgpack

from dragonfly2_tpu_torch.rpc import wire

GOLDEN_SCHEMA = pathlib.Path(__file__).resolve().parents[2] / "tools" / "dfwire_schema.json"

# the modules whose imports register the whole message surface, as the
# reference's tools/dflint/wireschema.REGISTERING_MODULES
REGISTERING_MODULES: tuple[str, ...] = (
    "dragonfly2_tpu_torch.rpc.mux",
    "dragonfly2_tpu_torch.rpc.inference",
    "dragonfly2_tpu_torch.rpc.server",
    "dragonfly2_tpu_torch.manager.rpc",
)


def load_golden(path=GOLDEN_SCHEMA) -> dict:
    """The golden wire-schema snapshot (messages, enums, codes)."""
    return json.loads(pathlib.Path(path).read_text())


def ensure_registered() -> None:
    """Import every registering module so ``wire._REGISTRY`` holds the
    full message surface — the soak drives the scheduler in-proc and
    never imports the RPC servers on its own, which would leave the
    skew codec silently passing everything through."""
    for name in REGISTERING_MODULES:
        importlib.import_module(name)


def _schema_fields(schema: dict, name: str) -> dict | None:
    message = schema.get("messages", {}).get(name)
    return None if message is None else message["fields"]


def degrade_payload(payload: dict, schema: dict, name: str) -> dict:
    """The N-1 view of a live payload: fields the snapshot does not know
    are dropped (that is all an old decoder does with them); nested
    message fields degrade recursively along the snapshot's own types."""
    fields = _schema_fields(schema, name)
    if fields is None:
        return payload
    out = {}
    for key, value in payload.items():
        spec = fields.get(key)
        if spec is None:
            continue  # unknown to N-1: dropped
        ftype = spec["type"]
        if ftype.startswith("optional["):
            ftype = ftype[len("optional["):-1]
        if ftype.startswith("message:") and isinstance(value, dict):
            value = degrade_payload(value, schema, ftype.split(":", 1)[1])
        elif ftype.startswith(("list[message:", "tuple[message:")) \
                and isinstance(value, list):
            inner = ftype.split("message:", 1)[1][:-1]
            value = [
                degrade_payload(v, schema, inner) if isinstance(v, dict)
                else v
                for v in value
            ]
        out[key] = value
    return out


class SkewProxy:
    """Service wrapper for the megascale soak's mixed-version mode:
    every message-shaped exchange round-trips the real codec and the
    N-1 degrade before it is acted on — requests on the way in, the
    tick's scheduling responses on the way out. Attribute access
    delegates, so the engine drives it exactly like the bare service;
    the columnar bulk APIs (``pieces_finished_batch`` etc.) pass
    through untouched — they are in-process arrays, not frames."""

    #: request-bearing entry points whose (single) argument is a message
    _REQUEST_METHODS = (
        "handle", "register_peer", "piece_finished", "piece_failed",
        "peer_finished", "peer_failed", "back_to_source_started",
        "back_to_source_finished", "back_to_source_failed",
    )

    #: the proxy's own state; every other attribute read AND write
    #: delegates to the wrapped service (the simulator swap-assigns
    #: ``svc.seed_triggers`` — a write landing on the proxy would fork
    #: the trigger queue)
    _INTERNAL = ("_svc", "_schema", "frames_by_type", "mismatches")

    def __init__(self, service, schema: dict):
        ensure_registered()
        object.__setattr__(self, "_svc", service)
        object.__setattr__(self, "_schema", schema)
        object.__setattr__(self, "frames_by_type", {})
        object.__setattr__(self, "mismatches", [])

    def __setattr__(self, name, value):
        if name in SkewProxy._INTERNAL:
            object.__setattr__(self, name, value)
        else:
            setattr(self._svc, name, value)

    # -- codec round-trip -------------------------------------------------

    def _skew(self, message):
        name = type(message).__name__
        if name not in wire._REGISTRY:
            return message  # not a wire type (None, packets, arrays)
        self.frames_by_type[name] = self.frames_by_type.get(name, 0) + 1
        try:
            env = msgpack.unpackb(wire.encode(message)[4:], raw=False)
            env["d"] = degrade_payload(env.get("d", {}), self._schema, name)
            return wire.decode(msgpack.packb(env, use_bin_type=True))
        except Exception as e:  # noqa: BLE001 - a skew failure is the finding
            self.mismatches.append(f"{name}: {type(e).__name__}: {e}")
            return message

    # -- message-shaped entry points --------------------------------------

    def __getattr__(self, item):
        if item in SkewProxy._REQUEST_METHODS:
            method = getattr(self._svc, item)

            def call(request, _method=method):
                return self._skew(_method(self._skew(request)))

            return call
        return getattr(self._svc, item)

    def register_peers_batch(self, reqs) -> list:
        responses = self._svc.register_peers_batch(
            [self._skew(r) for r in reqs]
        )
        return [self._skew(r) for r in responses]

    def tick(self) -> list:
        return [self._skew(r) for r in self._svc.tick()]

    def report(self) -> dict:
        return {
            "frames": dict(sorted(self.frames_by_type.items())),
            "frames_total": sum(self.frames_by_type.values()),
            "mismatches": list(self.mismatches),
        }
