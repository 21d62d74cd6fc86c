"""Shared dataclass↔dict round-trip helpers (validation reports,
goldens, search artifacts)."""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, Type, TypeVar

T = TypeVar("T")


def _field_types(cls: type) -> Dict[str, Any]:
    """Resolved (non-string) field annotations — dataclass modules use
    ``from __future__ import annotations``, so raw annotations are
    strings until resolved against the defining module's globals."""
    try:
        return typing.get_type_hints(cls)
    except Exception:           # unresolvable forward refs: no nesting
        return {}


def dataclass_from_dict(cls: Type[T], d: dict) -> T:
    """Construct ``cls`` from a dict, ignoring unknown keys — the one
    place that defines how report dicts rehydrate, so schema-migration
    behavior changes in exactly one spot.

    Dict values for fields whose annotated type is itself a dataclass
    are rehydrated recursively (``ClusterSpec.chip`` → ``ChipSpec``),
    matching what ``dataclasses.asdict`` lowers on the way out."""
    fields = {f.name for f in dataclasses.fields(cls)}
    hints = _field_types(cls)
    out: Dict[str, Any] = {}
    for k, v in d.items():
        if k not in fields:
            continue
        t = hints.get(k)
        if dataclasses.is_dataclass(t) and isinstance(v, dict):
            v = dataclass_from_dict(t, v)
        out[k] = v
    return cls(**out)
