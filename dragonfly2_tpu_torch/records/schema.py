"""Port of dragonfly2_tpu/records/schema.py, whole: the record dataclasses
and their CSV flatten/unflatten codec.

Trace record schemas — the training dataset's shape.

Capability parity with /root/reference/scheduler/storage/types.go:
``Download`` (:189-225, peer + task + host features, up to 20 ``Parent``s
each with up to 10 ``Piece`` costs) and ``NetworkTopology`` (:285-297,
``SrcHost`` + up to 5 ``DestHost``s with EWMA ``Probes.AverageRTT``), with
host stat sub-structs from scheduler/resource/host.go:210-330.

Records are plain dataclasses with ``flatten()``/``unflatten()`` to a flat
``dict[str, str|int|float]`` whose keys are dotted paths with fixed-width
list expansion (``parents.3.pieces.7.cost``) — i.e. a *columnar* layout:
every record of a type has the same columns, so a CSV file of them maps
1:1 onto the padded dense arrays the device programs consume
(records/features.py). Ragged reality (fewer parents/pieces) is encoded by
zero-filled columns + count fields, which become masks on device.
"""

from __future__ import annotations

import dataclasses
import functools
import typing
from typing import get_args, get_origin, get_type_hints


@dataclasses.dataclass
class CPUStat:
    logical_count: int = 0
    physical_count: int = 0
    percent: float = 0.0
    process_percent: float = 0.0


@dataclasses.dataclass
class MemoryStat:
    total: int = 0
    available: int = 0
    used: int = 0
    used_percent: float = 0.0
    process_used: int = 0
    free: int = 0


@dataclasses.dataclass
class NetworkStat:
    tcp_connection_count: int = 0
    upload_tcp_connection_count: int = 0
    location: str = ""
    idc: str = ""


@dataclasses.dataclass
class DiskStat:
    total: int = 0
    free: int = 0
    used: int = 0
    used_percent: float = 0.0
    inodes_total: int = 0
    inodes_used: int = 0
    inodes_free: int = 0
    inodes_used_percent: float = 0.0


@dataclasses.dataclass
class BuildInfo:
    git_version: str = ""
    git_commit: str = ""
    go_version: str = ""
    platform: str = ""


@dataclasses.dataclass
class TaskRecord:
    id: str = ""
    url: str = ""
    type: str = ""
    content_length: int = 0
    total_piece_count: int = 0
    back_to_source_limit: int = 0
    back_to_source_peer_count: int = 0
    state: str = ""
    created_at: int = 0
    updated_at: int = 0


@dataclasses.dataclass
class HostRecord:
    id: str = ""
    type: str = ""
    hostname: str = ""
    ip: str = ""
    port: int = 0
    download_port: int = 0
    os: str = ""
    platform: str = ""
    platform_family: str = ""
    platform_version: str = ""
    kernel_version: str = ""
    concurrent_upload_limit: int = 0
    concurrent_upload_count: int = 0
    upload_count: int = 0
    upload_failed_count: int = 0
    cpu: CPUStat = dataclasses.field(default_factory=CPUStat)
    memory: MemoryStat = dataclasses.field(default_factory=MemoryStat)
    network: NetworkStat = dataclasses.field(default_factory=NetworkStat)
    disk: DiskStat = dataclasses.field(default_factory=DiskStat)
    build: BuildInfo = dataclasses.field(default_factory=BuildInfo)
    scheduler_cluster_id: int = 0
    created_at: int = 0
    updated_at: int = 0


@dataclasses.dataclass
class PieceRecord:
    length: int = 0
    cost: int = 0  # nanoseconds
    created_at: int = 0


@dataclasses.dataclass
class ParentRecord:
    id: str = ""
    tag: str = ""
    application: str = ""
    state: str = ""
    cost: int = 0
    upload_piece_count: int = 0
    finished_piece_count: int = 0
    host: HostRecord = dataclasses.field(default_factory=HostRecord)
    pieces: list[PieceRecord] = dataclasses.field(default_factory=list)  # maxlen 10
    created_at: int = 0
    updated_at: int = 0


@dataclasses.dataclass
class ErrorRecord:
    code: str = ""
    message: str = ""


@dataclasses.dataclass
class DownloadRecord:
    id: str = ""
    tag: str = ""
    application: str = ""
    state: str = ""
    error: ErrorRecord = dataclasses.field(default_factory=ErrorRecord)
    cost: int = 0
    finished_piece_count: int = 0
    task: TaskRecord = dataclasses.field(default_factory=TaskRecord)
    host: HostRecord = dataclasses.field(default_factory=HostRecord)
    parents: list[ParentRecord] = dataclasses.field(default_factory=list)  # maxlen 20
    created_at: int = 0
    updated_at: int = 0


@dataclasses.dataclass
class ProbesRecord:
    average_rtt: int = 0  # nanoseconds, EWMA
    created_at: int = 0
    updated_at: int = 0


@dataclasses.dataclass
class SrcHostRecord:
    id: str = ""
    type: str = ""
    hostname: str = ""
    ip: str = ""
    port: int = 0
    network: NetworkStat = dataclasses.field(default_factory=NetworkStat)


@dataclasses.dataclass
class DestHostRecord:
    id: str = ""
    type: str = ""
    hostname: str = ""
    ip: str = ""
    port: int = 0
    network: NetworkStat = dataclasses.field(default_factory=NetworkStat)
    probes: ProbesRecord = dataclasses.field(default_factory=ProbesRecord)


@dataclasses.dataclass
class NetworkTopologyRecord:
    id: str = ""
    host: SrcHostRecord = dataclasses.field(default_factory=SrcHostRecord)
    dest_hosts: list[DestHostRecord] = dataclasses.field(default_factory=list)  # maxlen 5
    created_at: int = 0


# Fixed list widths per (record type, field): types.go csv[] tags.
LIST_WIDTHS: dict[tuple[type, str], int] = {
    (ParentRecord, "pieces"): 10,
    (DownloadRecord, "parents"): 20,
    (NetworkTopologyRecord, "dest_hosts"): 5,
}


def _list_width(cls: type, field: str) -> int:
    try:
        return LIST_WIDTHS[(cls, field)]
    except KeyError:
        raise TypeError(f"no fixed width declared for list field {cls.__name__}.{field}")


@functools.lru_cache(maxsize=None)
def _class_hints(cls: type) -> dict:
    return get_type_hints(cls)


def _element_type(cls: type, field_name: str) -> type:
    tp = _class_hints(cls)[field_name]
    if get_origin(tp) in (list, typing.List):
        return get_args(tp)[0]
    raise TypeError(f"{cls.__name__}.{field_name} is not a list field")


def flatten(record) -> dict:
    """Flatten a record into an ordered flat dict of scalar columns."""
    out: dict = {}
    _flatten_into(record, "", out)
    return out


def _flatten_into(obj, prefix: str, out: dict) -> None:
    cls = type(obj)
    for f in dataclasses.fields(cls):
        key = f"{prefix}{f.name}"
        value = getattr(obj, f.name)
        if dataclasses.is_dataclass(value):
            _flatten_into(value, key + ".", out)
        elif isinstance(value, list):
            width = _list_width(cls, f.name)
            elem_cls = _element_type(cls, f.name)
            if len(value) > width:
                raise ValueError(f"{cls.__name__}.{f.name} has {len(value)} items, max {width}")
            out[key + ".count"] = len(value)
            for i in range(width):
                elem = value[i] if i < len(value) else elem_cls()
                _flatten_into(elem, f"{key}.{i}.", out)
        else:
            out[key] = value


def header(cls_or_obj) -> list[str]:
    obj = cls_or_obj() if isinstance(cls_or_obj, type) else cls_or_obj
    return list(flatten(obj).keys())


def unflatten(cls: type, row: dict):
    """Rebuild a record from a flat column dict (inverse of flatten)."""
    obj = cls()
    _unflatten_into(obj, "", row)
    return obj


def _unflatten_into(obj, prefix: str, row: dict) -> None:
    cls = type(obj)
    hints = get_type_hints(cls)
    for f in dataclasses.fields(cls):
        key = f"{prefix}{f.name}"
        current = getattr(obj, f.name)
        if dataclasses.is_dataclass(current):
            _unflatten_into(current, key + ".", row)
        elif isinstance(current, list):
            width = _list_width(cls, f.name)
            elem_cls = _element_type(cls, f.name)
            count = int(row.get(key + ".count", 0))
            items = []
            for i in range(min(count, width)):
                elem = elem_cls()
                _unflatten_into(elem, f"{key}.{i}.", row)
                items.append(elem)
            setattr(obj, f.name, items)
        else:
            tp = hints[f.name]
            raw = row.get(key, "")
            if tp is int:
                setattr(obj, f.name, int(float(raw)) if raw != "" else 0)
            elif tp is float:
                setattr(obj, f.name, float(raw) if raw != "" else 0.0)
            else:
                setattr(obj, f.name, str(raw))


# --------------------------------------------------------------------------
# Compiled positional codecs — the CSV hot path.
#
# A DownloadRecord spans 1,745 columns (20 parents x 10 pieces x nested host
# stats), so per-row reflection (get_type_hints + fields walks) and DictReader
# dicts dominate trace loading at the 1M-piece scale. These compile, once per
# record class, closures that read/write a positional value list aligned with
# `header(cls)` — the exact order `flatten` emits, i.e. the on-disk layout.


def _to_int(raw: str) -> int:
    if not raw:
        return 0
    try:
        return int(raw)
    except ValueError:
        return int(float(raw))


def _compile_reader(cls: type, prefix: str, index: dict[str, int]):
    template = cls()
    hints = _class_hints(cls)
    steps = []
    for f in dataclasses.fields(cls):
        key = f"{prefix}{f.name}"
        current = getattr(template, f.name)
        if dataclasses.is_dataclass(current):
            steps.append((f.name, _compile_reader(type(current), key + ".", index)))
        elif isinstance(current, list):
            width = _list_width(cls, f.name)
            elem_cls = _element_type(cls, f.name)
            subs = tuple(
                _compile_reader(elem_cls, f"{key}.{i}.", index) for i in range(width)
            )
            ci = index[key + ".count"]

            def read_list(vals, subs=subs, ci=ci, width=width):
                n = min(_to_int(vals[ci]), width)
                return [subs[i](vals) for i in range(n)]

            steps.append((f.name, read_list))
        else:
            i = index[key]
            tp = hints[f.name]
            if tp is int:
                steps.append((f.name, lambda vals, i=i: _to_int(vals[i])))
            elif tp is float:
                steps.append(
                    (f.name, lambda vals, i=i: float(vals[i]) if vals[i] else 0.0)
                )
            else:
                steps.append((f.name, lambda vals, i=i: vals[i]))
    steps = tuple(steps)

    def build(vals, cls=cls, steps=steps):
        obj = cls.__new__(cls)  # every field is assigned below
        for name, fn in steps:
            setattr(obj, name, fn(vals))
        return obj

    return build


@functools.lru_cache(maxsize=None)
def _compiled_reader(cls: type):
    index = {k: i for i, k in enumerate(header(cls))}
    reader = _compile_reader(cls, "", index)
    return reader, len(index)


def from_row(cls: type, values: list[str]):
    """Rebuild a record from a positional CSV row in `header(cls)` order."""
    reader, n = _compiled_reader(cls)
    if len(values) != n:
        raise ValueError(f"{cls.__name__} row has {len(values)} columns, want {n}")
    return reader(values)


def _compile_writer(cls: type):
    # Position-only: the writer emits values in field-walk order (the same
    # order `header` derives), so no column keys are needed anywhere.
    template = cls()
    steps = []
    for f in dataclasses.fields(cls):
        current = getattr(template, f.name)
        if dataclasses.is_dataclass(current):
            sub = _compile_writer(type(current))
            steps.append(lambda obj, out, n=f.name, sub=sub: sub(getattr(obj, n), out))
        elif isinstance(current, list):
            width = _list_width(cls, f.name)
            elem_cls = _element_type(cls, f.name)
            sub = _compile_writer(elem_cls)
            pad = tuple(flatten(elem_cls()).values())

            def write_list(
                obj, out, n=f.name, sub=sub, width=width, pad=pad,
                cls_name=cls.__name__,
            ):
                items = getattr(obj, n)
                if len(items) > width:
                    raise ValueError(
                        f"{cls_name}.{n} has {len(items)} items, max {width}"
                    )
                out.append(len(items))
                for elem in items:
                    sub(elem, out)
                for _ in range(width - len(items)):
                    out.extend(pad)

            steps.append(write_list)
        else:
            steps.append(lambda obj, out, n=f.name: out.append(getattr(obj, n)))
    steps = tuple(steps)

    def write(obj, out, steps=steps):
        for fn in steps:
            fn(obj, out)

    return write


@functools.lru_cache(maxsize=None)
def _compiled_writer(cls: type):
    return _compile_writer(cls)


def to_row(record) -> list:
    """Record -> positional scalar list in `header(type(record))` order
    (the inverse of `from_row`; same values `flatten` would emit)."""
    out: list = []
    _compiled_writer(type(record))(record, out)
    return out


# --------------------------------------------------------------------------
# Compiled CSV line writer — the trace-recording hot path.
#
# `to_row` + csv.writer costs ~0.35 ms per DownloadRecord: 1,745 values walk
# through per-field closures into a list, then through the csv module again.
# But most of those columns are PAD (empty parent/piece slots whose flattened
# defaults never change), and the live fields are overwhelmingly numbers that
# never need quoting. `to_line` therefore compiles, once per record class, a
# direct record -> CSV-text emitter: live scalars render through one f-string
# segment per contiguous run, empty list slots append a PRE-JOINED pad string,
# and only str-typed fields pass through the quote check. Output is
# byte-identical to csv.writer(lineterminator="\n") over `to_row` (pinned by
# tests/test_records.py) — QUOTE_MINIMAL quotes a field iff it contains the
# delimiter, the quotechar, or a lineterminator character.


def _csv_field(value) -> str:
    s = str(value)
    if '"' in s or "," in s or "\n" in s:
        return '"' + s.replace('"', '""') + '"'
    return s


# Nested sub-records of these classes serialize through an identity-keyed
# segment memo: the scheduler reuses ONE HostRecord instance per announced
# host across every download record it emits (scheduler._host_record), so
# the 44-column host segment — the bulk of a record's live fields, repeated
# once per parent — reduces to a dict hit after the first write. Entries
# hold a strong ref and re-verify `is` on lookup, so a recycled id() can
# never alias. Contract: records are frozen once handed to storage (true
# everywhere in this repo); mutating a memoized sub-record AFTER it has
# been serialized once would re-emit the stale segment.
_SEGMENT_MEMO_CLASSES = ("HostRecord",)


def _compile_line_writer(cls: type):
    ctx: dict = {"_q": _csv_field}
    lines: list[str] = []
    exprs: list[str] = []
    counters = {"v": 0, "l": 0, "m": 0}

    def flush() -> None:
        if not exprs:
            return
        body = ",".join("{" + e + "}" for e in exprs)
        lines.append(f'    parts.append(f"{body}")')
        exprs.clear()

    def emit(cls: type, var: str) -> None:
        template = cls()
        hints = _class_hints(cls)
        for f in dataclasses.fields(cls):
            current = getattr(template, f.name)
            if dataclasses.is_dataclass(current):
                if type(current).__name__ in _SEGMENT_MEMO_CLASSES:
                    counters["m"] += 1
                    k = counters["m"]
                    ctx[f"_msub{k}"] = _compiled_line_writer(type(current))
                    ctx[f"_memo{k}"] = {}
                    flush()
                    lines.append(f"    _o = {var}.{f.name}")
                    lines.append(f"    _ent = _memo{k}.get(id(_o))")
                    lines.append("    if _ent is not None and _ent[0] is _o:")
                    lines.append("        parts.append(_ent[1])")
                    lines.append("    else:")
                    lines.append("        _p2 = []")
                    lines.append(f"        _msub{k}(_o, _p2)")
                    lines.append("        _seg = ','.join(_p2)")
                    lines.append(f"        if len(_memo{k}) > 8192:")
                    lines.append(f"            _memo{k}.clear()")
                    lines.append(f"        _memo{k}[id(_o)] = (_o, _seg)")
                    lines.append("        parts.append(_seg)")
                    continue
                counters["v"] += 1
                sub = f"_v{counters['v']}"
                lines.append(f"    {sub} = {var}.{f.name}")
                emit(type(current), sub)
            elif isinstance(current, list):
                width = _list_width(cls, f.name)
                elem_cls = _element_type(cls, f.name)
                counters["l"] += 1
                k = counters["l"]
                ctx[f"_sub{k}"] = _compiled_line_writer(elem_cls)
                one = ",".join(
                    _csv_field(v) if isinstance(v, str) else str(v)
                    for v in flatten(elem_cls()).values()
                )
                ctx[f"_pads{k}"] = tuple(
                    ",".join([one] * j) for j in range(width + 1)
                )
                flush()
                lines.append(f"    _it = {var}.{f.name}")
                lines.append("    _n = len(_it)")
                lines.append(f"    if _n > {width}:")
                lines.append(
                    f"        raise ValueError("
                    f"f\"{cls.__name__}.{f.name} has {{_n}} items,"
                    f" max {width}\")"
                )
                lines.append('    parts.append(f"{_n}")')
                lines.append("    for _e in _it:")
                lines.append(f"        _sub{k}(_e, parts)")
                lines.append(f"    if _n < {width}:")
                lines.append(f"        parts.append(_pads{k}[{width} - _n])")
            else:
                if hints[f.name] is str:
                    exprs.append(f"_q({var}.{f.name})")
                else:
                    exprs.append(f"{var}.{f.name}")

    emit(cls, "obj")
    flush()
    src = "def _write(obj, parts):\n" + "\n".join(lines or ["    pass"])
    exec(src, ctx)  # noqa: S102 - compiled from the dataclass schema only
    return ctx["_write"]


@functools.lru_cache(maxsize=None)
def _compiled_line_writer(cls: type):
    return _compile_line_writer(cls)


def to_line(record) -> str:
    """Record -> its finished CSV text line (terminated with \\n), exactly
    what ``csv.writer(..., lineterminator="\\n").writerow(to_row(record))``
    would produce, without materialising the positional row."""
    parts: list[str] = []
    _compiled_line_writer(type(record))(record, parts)
    return ",".join(parts) + "\n"
