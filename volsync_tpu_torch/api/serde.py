"""Dataclass <-> plain-dict serde with k8s-style camelCase keys.

Gives every API object a YAML-able representation (the reference's CRDs are
YAML; our CLI relationship files and the cluster object store reuse this).
Rules follow k8s JSON conventions: snake_case fields serialize as camelCase,
``None`` fields are omitted, datetimes render as RFC-3339 strings.

Ports ``volsync_tpu/api/serde.py`` whole: both packages write the
same dict for equal objects.
"""

from __future__ import annotations

import dataclasses
import enum
import typing
from datetime import datetime, timedelta, timezone


def _camel(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(p.capitalize() for p in parts[1:])


def _snake(name: str) -> str:
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)


def fmt_time(dt: datetime) -> str:
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.astimezone(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%fZ")


def parse_time(s: str) -> datetime:
    s = s.rstrip("Z")
    for fmt in ("%Y-%m-%dT%H:%M:%S.%f", "%Y-%m-%dT%H:%M:%S"):
        try:
            return datetime.strptime(s, fmt).replace(tzinfo=timezone.utc)
        except ValueError:
            continue
    raise ValueError(f"unparseable timestamp: {s!r}")


def to_dict(obj):
    """Serialize a dataclass tree to plain dicts/lists/scalars."""
    if isinstance(obj, enum.Enum):  # before str: str-enums must not leak through
        return obj.value
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    if isinstance(obj, datetime):
        return fmt_time(obj)
    if isinstance(obj, timedelta):
        return obj.total_seconds()
    if isinstance(obj, bytes):
        import base64

        return base64.b64encode(obj).decode("ascii")
    if isinstance(obj, (list, tuple)):
        return [to_dict(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is None:
                continue
            out[_camel(f.name)] = to_dict(v)
        return out
    raise TypeError(f"cannot serialize {type(obj)!r}")


def _strip_optional(tp):
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def from_dict(cls, data):
    """Reconstruct a dataclass tree from `to_dict` output.

    Unknown keys are ignored (forward compatibility, like k8s), missing
    optional fields default.
    """
    if data is None:
        return None
    cls = _strip_optional(cls)
    origin = typing.get_origin(cls)
    if origin in (list, tuple):
        (elem,) = typing.get_args(cls) or (typing.Any,)
        return [from_dict(elem, x) for x in data]
    if origin is dict:
        args = typing.get_args(cls)
        elem = args[1] if len(args) == 2 else typing.Any
        return {k: from_dict(elem, v) for k, v in data.items()}
    if isinstance(cls, type) and issubclass(cls, enum.Enum):
        return cls(data)
    if cls is datetime:
        return parse_time(data) if isinstance(data, str) else data
    if cls is timedelta:
        return timedelta(seconds=data) if isinstance(data, (int, float)) else data
    if cls is bytes:
        import base64

        return base64.b64decode(data) if isinstance(data, str) else data
    if dataclasses.is_dataclass(cls):
        hints = typing.get_type_hints(cls)
        kwargs = {}
        by_camel = {_camel(f.name): f.name for f in dataclasses.fields(cls)}
        for key, val in data.items():
            fname = by_camel.get(key) or (_snake(key) if _snake(key) in hints else None)
            if fname is None or fname not in hints:
                continue
            kwargs[fname] = from_dict(hints[fname], val)
        return cls(**kwargs)
    return data
