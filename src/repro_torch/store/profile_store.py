"""Disk-backed, content-addressed profile + build store.

The paper's core economy is unique-event dedup — profile each event
ONCE, reuse it everywhere (Observation 1) — but until this module the
reuse layer lived per-process: every nightly rerun, search and executor
worker re-derived the same event means and engine builds. The
``ProfileStore`` persists both caches to disk, shared across processes,
the same shared op/profile-database architecture Proteus and DistIR
build around:

* **event times** — keyed on structural :class:`~repro_torch.core.events.Event`
  identity (the frozen-dataclass fields minus the display-only name),
  serialized as canonical JSON and addressed by its SHA-256. Values are
  Python floats; JSON ``repr`` round-trips them EXACTLY, so a
  store-served sweep is bit-identical to a cold in-process run.
* **engine builds** — :class:`~repro_torch.core.engine.EngineBuild` pickles
  keyed on the existing BuildCache tuple
  ``(cfg, schedule-stripped strategy, microbatch, seq)``, addressed by
  the SHA-256 of the tuple's canonical JSON.

A store directory may be shared with the reference package. Event
shards are plain JSON and interchange freely (same provider class name
+ same cluster dict = same namespace). Build pickles do not: a pickle
names the classes of the package that wrote it, and unpickling a
foreign one would import that package. This package therefore keeps
its builds in a directory of its own (``builds_torch/``), reads pickles
only through an unpickler that resolves nothing outside this package,
NumPy and the builtins, and counts a foreign build found at a key it
looks up (``foreign_rejected``) without ever opening it.

Both namespaces are scoped per (provider class, cluster spec): an
``AnalyticalProvider`` on ``a40-cluster`` never serves times measured
by a ``MeasuredProvider`` or profiled for ``v5e-pod``.

Invalidation follows the in-process rule: every entry records the
provider's ``cache_version`` at write time and is served only when it
matches the reading provider's current version — a ``clear_cache()``
(version bump) makes all older persisted entries stale, exactly as it
invalidates in-process engines. Corrupted files (truncated JSON, bad
pickles, key mismatches) are rejected and counted, never served.

Writes are atomic (``os.replace`` of a same-directory temp file) and
idempotent (content-addressed names), so concurrent executor workers
and nightly reruns share one store safely: two writers producing the
same content race onto the same bytes, different content lands in
different files, and readers merge shards by set-union.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import pickle
import tempfile
from typing import Dict, Optional, Tuple

from repro_torch.core.engine import EngineBuild
from repro_torch.core.events import Event
from repro_torch.core.modelgraph import GEMM
from repro_torch.core.profiler import Provider

#: bump on any incompatible change to the on-disk layout; mismatched
#: entries are rejected (treated as absent), never mis-parsed.
FORMAT_VERSION = 1

_HASH_LEN = 24      # hex chars of sha256 kept in filenames


# --------------------------------------------------------------------------
# stable serialization (events, keys)
# --------------------------------------------------------------------------

def event_to_dict(e: Event) -> Dict:
    return {"kind": e.kind, "name": e.name,
            "gemms": [[g.m, g.n, g.k] for g in e.gemms],
            "coll_op": e.coll_op, "nbytes": e.nbytes,
            "n_dev": e.n_dev, "scope": e.scope}


def event_from_dict(d: Dict) -> Event:
    return Event(kind=d["kind"], name=d.get("name", ""),
                 gemms=tuple(GEMM(int(m), int(n), int(k))
                             for m, n, k in d["gemms"]),
                 coll_op=d["coll_op"], nbytes=d["nbytes"],
                 n_dev=int(d["n_dev"]), scope=d["scope"])


#: directory of this package's build pickles inside a namespace; the
#: reference package's live in ``builds/`` and are never opened here
_BUILDS_DIR = "builds_torch"
_FOREIGN_BUILDS_DIR = "builds"

_PICKLE_ROOTS = ("repro_torch", "numpy", "builtins", "collections")


class _OwnUnpickler(pickle.Unpickler):
    """Unpickler that resolves globals only from this package, NumPy
    and the standard containers — a pickle naming any other module
    (another package's ``EngineBuild``, or anything hostile) fails to
    load instead of importing it."""

    def find_class(self, module: str, name: str):
        if module.split(".")[0] not in _PICKLE_ROOTS:
            raise pickle.UnpicklingError(
                f"pickle names {module}.{name}, which is outside "
                f"{_PICKLE_ROOTS}")
        return super().find_class(module, name)


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return _OwnUnpickler(io.BytesIO(f.read())).load()


def _sha(payload: str) -> str:
    return hashlib.sha256(payload.encode()).hexdigest()[:_HASH_LEN]


def _canon(obj) -> str:
    """Canonical JSON — the hashing input for every content address.
    Python float repr is shortest-round-trip, so equal floats hash
    equally and distinct floats never collide by formatting."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def event_key(e: Event) -> str:
    """Stable serialized key of an event's STRUCTURAL identity — the
    frozen-dataclass hash made process-independent (``name`` is
    display-only and excluded, matching ``Event.__eq__``)."""
    d = event_to_dict(e)
    d.pop("name")
    return _sha(_canon(d))


def build_key_json(key: Tuple) -> str:
    """Canonical JSON of a BuildCache build key
    ``(cfg, stripped strategy, microbatch, seq[, scenario])`` —
    dataclasses are lowered with ``asdict`` so the address is content,
    not object identity. The scenario entry is OMITTED for the train
    scenario (and legacy 4-tuples), so every pre-scenario store address
    keeps serving warm training builds unchanged."""
    if len(key) == 4:
        cfg, strat, microbatch, seq = key
        scenario = None
    else:
        cfg, strat, microbatch, seq, scenario = key
    d = {"cfg": dataclasses.asdict(cfg),
         "strategy": dataclasses.asdict(strat),
         "microbatch": int(microbatch), "seq": int(seq)}
    if scenario is not None and not scenario.is_train:
        d["scenario"] = scenario.to_dict()
    return _canon(d)


def provider_namespace(provider: Provider) -> str:
    """Store namespace per (provider class, cluster spec): times from
    different providers/clusters are different numbers and must never
    cross-serve."""
    ident = {"provider": type(provider).__qualname__,
             "cluster": provider.cluster.to_dict()}
    extra = provider.namespace_extra()
    if extra:
        # omitted when empty, so deterministic providers keep the
        # reference package's namespaces and share its event shards
        ident["extra"] = extra
    return _sha(_canon(ident))


# --------------------------------------------------------------------------
# stats
# --------------------------------------------------------------------------

@dataclasses.dataclass
class StoreStats:
    """Per-store accounting (reported by ``bench_validate --store``)."""
    events_loaded: int = 0        # merged into a provider from disk
    events_saved: int = 0         # written in fresh shards
    event_shards_read: int = 0
    builds_loaded: int = 0        # EngineBuilds served from disk
    builds_saved: int = 0
    builds_missed: int = 0        # disk lookups that found nothing
    stale_rejected: int = 0       # cache_version mismatch (events+builds)
    corrupt_rejected: int = 0     # unreadable/mismatched entries
    foreign_rejected: int = 0     # another package's builds, never opened

    def to_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


# --------------------------------------------------------------------------
# the store
# --------------------------------------------------------------------------

class ProfileStore:
    """One directory of persisted profiles + builds.

    Layout (all filenames content-addressed, all writes atomic)::

        <path>/meta.json
        <path>/<namespace>/events/<shard-sha>.json
        <path>/<namespace>/builds_torch/<key-sha>.pkl

    Open is cheap (one mkdir + meta stat); event shards are read on
    :meth:`load_events`, builds lazily per key.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self.stats = StoreStats()
        os.makedirs(self.path, exist_ok=True)
        meta = os.path.join(self.path, "meta.json")
        if not os.path.exists(meta):
            self._atomic_write(
                meta, _canon({"format": FORMAT_VERSION,
                              "store": "repro_torch.store"}).encode())

    # ---- low-level ----

    def _atomic_write(self, path: str, data: bytes) -> None:
        """Same-directory temp file + ``os.replace``: readers never see
        a partial file, and concurrent identical writers converge on
        identical bytes."""
        d = os.path.dirname(path)
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _events_dir(self, provider: Provider) -> str:
        return os.path.join(self.path, provider_namespace(provider),
                            "events")

    def _builds_dir(self, provider: Provider) -> str:
        return os.path.join(self.path, provider_namespace(provider),
                            _BUILDS_DIR)

    def _foreign_build(self, provider: Provider, fn: str) -> str:
        return os.path.join(self.path, provider_namespace(provider),
                            _FOREIGN_BUILDS_DIR, fn)

    # ---- event times ----

    def save_events(self, provider: Provider,
                    events: Optional[Dict[Event, float]] = None) -> int:
        """Persist ``events`` (default: the provider's full cache
        snapshot) as one content-addressed shard. Idempotent: an
        already-persisted identical shard is skipped. Returns the
        number of events written (0 on skip/empty)."""
        if events is None:
            events = provider.cache_snapshot()
        if not events:
            return 0
        rows = sorted(
            ({**event_to_dict(e), "t": t} for e, t in events.items()),
            key=lambda r: _canon(r))
        doc = {"format": FORMAT_VERSION,
               "cache_version": provider.cache_version,
               "events": rows}
        payload = _canon(doc)
        path = os.path.join(self._events_dir(provider),
                            _sha(payload) + ".json")
        if os.path.exists(path):
            return 0
        self._atomic_write(path, payload.encode())
        self.stats.events_saved += len(rows)
        return len(rows)

    def load_events(self, provider: Provider) -> int:
        """Merge every valid persisted event shard into ``provider``'s
        cache (union, incumbent wins — see ``Provider.merge_cache``).
        Shards with a stale ``cache_version`` or any corruption are
        rejected, not served. Stats (hit/miss accounting) are NOT
        touched: disk loads are neither evaluations nor hits. Returns
        how many events were new to the provider."""
        d = self._events_dir(provider)
        if not os.path.isdir(d):
            return 0
        fresh = 0
        for fn in sorted(os.listdir(d)):
            if not fn.endswith(".json"):
                continue
            try:
                with open(os.path.join(d, fn), "rb") as f:
                    doc = json.loads(f.read().decode())
                if doc["format"] != FORMAT_VERSION:
                    self.stats.corrupt_rejected += 1
                    continue
                if doc["cache_version"] != provider.cache_version:
                    self.stats.stale_rejected += 1
                    continue
                entries = {event_from_dict(r): float(r["t"])
                           for r in doc["events"]}
            except Exception:
                self.stats.corrupt_rejected += 1
                continue
            self.stats.event_shards_read += 1
            n = provider.merge_cache(entries)
            fresh += n
            self.stats.events_loaded += n
        return fresh

    # ---- engine builds ----

    def save_build(self, provider: Provider, key: Tuple,
                   build: EngineBuild) -> bool:
        """Persist one :class:`EngineBuild` under its content address.
        Skips (returns False) if a LIVE entry already exists — builds
        are deterministic per (key, cache_version), so that incumbent
        is identical. A stale-version or corrupt incumbent (unusable by
        any current reader) is overwritten, not kept."""
        kj = build_key_json(key)
        path = os.path.join(self._builds_dir(provider),
                            _sha(kj) + ".pkl")
        if os.path.exists(path):
            try:
                old = _load_pickle(path)
                if (old["format"] == FORMAT_VERSION
                        and old["cache_version"]
                        == provider.cache_version):
                    return False
            except Exception:
                pass
        doc = {"format": FORMAT_VERSION,
               "cache_version": provider.cache_version,
               "key": kj, "build": build}
        self._atomic_write(path, pickle.dumps(doc, protocol=4))
        self.stats.builds_saved += 1
        return True

    def load_build(self, provider: Provider,
                   key: Tuple) -> Optional[EngineBuild]:
        """Fetch the persisted build for ``key``, or None. Validates
        format, ``cache_version`` and the full key JSON (guarding
        against truncation-by-hash and corrupt pickles)."""
        kj = build_key_json(key)
        path = os.path.join(self._builds_dir(provider),
                            _sha(kj) + ".pkl")
        if not os.path.exists(path):
            self.stats.builds_missed += 1
            if os.path.exists(self._foreign_build(provider,
                                                  _sha(kj) + ".pkl")):
                # the reference package's build for this key: a pickle
                # of ITS classes — counted, never opened, never served
                self.stats.foreign_rejected += 1
            return None
        try:
            doc = _load_pickle(path)
            if doc["format"] != FORMAT_VERSION or doc["key"] != kj:
                self.stats.corrupt_rejected += 1
                return None
        except Exception:
            self.stats.corrupt_rejected += 1
            return None
        if doc["cache_version"] != provider.cache_version:
            self.stats.stale_rejected += 1
            return None
        build = doc["build"]
        if not isinstance(build, EngineBuild):
            self.stats.corrupt_rejected += 1
            return None
        self.stats.builds_loaded += 1
        return build

    # ---- garbage collection / compaction ----

    def gc(self, provider: Optional[Provider] = None) -> Dict[str, int]:
        """Compact the store in place.

        Per namespace: merge every LIVE event shard (format matches,
        ``cache_version`` matches the live version) into ONE
        content-addressed shard, then delete all other shards —
        including stale-version orphans left behind by
        ``clear_cache()`` bumps and corrupt/truncated files. Build
        pickles are validated the same way; stale or corrupt ones are
        deleted, live ones stay (they are already one file per key).
        Another package's ``builds/`` directory is left untouched.

        The live version is ``provider.cache_version`` when a provider
        is given (its namespace only); otherwise, per namespace, the
        HIGHEST version present in any valid shard or build — the most
        recent writer wins, exactly matching what a current reader
        would accept.

        Idempotent, and atomic per write: a crash mid-gc leaves only
        valid content-addressed files. Returns a stats dict.
        """
        if provider is not None:
            namespaces = [provider_namespace(provider)]
        else:
            namespaces = sorted(
                fn for fn in os.listdir(self.path)
                if os.path.isdir(os.path.join(self.path, fn)))
        out = {"namespaces": 0, "shards_before": 0, "shards_after": 0,
               "events_live": 0, "events_dropped": 0,
               "builds_kept": 0, "builds_dropped": 0}
        for ns in namespaces:
            ns_dir = os.path.join(self.path, ns)
            if not os.path.isdir(ns_dir):
                continue
            out["namespaces"] += 1
            ev_dir = os.path.join(ns_dir, "events")
            b_dir = os.path.join(ns_dir, _BUILDS_DIR)

            # pass 1: parse everything, find the live version
            shards = []          # (filename, version, rows) for valid
            bad_shards = []
            if os.path.isdir(ev_dir):
                for fn in sorted(os.listdir(ev_dir)):
                    if not fn.endswith(".json"):
                        continue
                    out["shards_before"] += 1
                    try:
                        with open(os.path.join(ev_dir, fn), "rb") as f:
                            doc = json.loads(f.read().decode())
                        if doc["format"] != FORMAT_VERSION:
                            raise ValueError("format")
                        rows = [{**event_to_dict(event_from_dict(r)),
                                 "t": float(r["t"])}
                                for r in doc["events"]]
                        shards.append((fn, doc["cache_version"], rows))
                    except Exception:
                        bad_shards.append(fn)
            builds = []          # (filename, version) for valid
            bad_builds = []
            if os.path.isdir(b_dir):
                for fn in sorted(os.listdir(b_dir)):
                    if not fn.endswith(".pkl"):
                        continue
                    try:
                        doc = _load_pickle(os.path.join(b_dir, fn))
                        if (doc["format"] != FORMAT_VERSION
                                or _sha(doc["key"]) + ".pkl" != fn
                                or not isinstance(doc["build"],
                                                  EngineBuild)):
                            raise ValueError("corrupt")
                        builds.append((fn, doc["cache_version"]))
                    except Exception:
                        bad_builds.append(fn)
            if provider is not None:
                live = provider.cache_version
            else:
                versions = ([v for _, v, _ in shards]
                            + [v for _, v in builds])
                live = max(versions, default=0)

            # pass 2: rewrite live events as one shard (union,
            # first-sorted-shard incumbent wins — the merge_cache rule)
            merged: Dict[str, Dict] = {}
            for _, v, rows in shards:
                if v != live:
                    continue
                for r in rows:
                    k = _canon({k2: v2 for k2, v2 in r.items()
                                if k2 not in ("name", "t")})
                    merged.setdefault(k, r)
            keep = None
            if merged:
                rows = sorted(merged.values(), key=lambda r: _canon(r))
                doc = {"format": FORMAT_VERSION, "cache_version": live,
                       "events": rows}
                payload = _canon(doc)
                keep = _sha(payload) + ".json"
                self._atomic_write(os.path.join(ev_dir, keep),
                                   payload.encode())
                out["shards_after"] += 1
                out["events_live"] += len(rows)
            total = sum(len(rows) for _, v, rows in shards)
            out["events_dropped"] += total - len(merged)

            # pass 3: delete everything superseded
            for fn, _, _ in shards:
                if fn != keep:
                    os.unlink(os.path.join(ev_dir, fn))
            for fn in bad_shards:
                os.unlink(os.path.join(ev_dir, fn))
            for fn, v in builds:
                if v == live:
                    out["builds_kept"] += 1
                else:
                    out["builds_dropped"] += 1
                    os.unlink(os.path.join(b_dir, fn))
            for fn in bad_builds:
                out["builds_dropped"] += 1
                os.unlink(os.path.join(b_dir, fn))
        return out

    # ---- accounting ----

    def entry_counts(self, provider: Provider) -> Dict[str, int]:
        """On-disk entry counts for the provider's namespace."""
        def count(d: str, suffix: str) -> int:
            if not os.path.isdir(d):
                return 0
            return sum(1 for fn in os.listdir(d)
                       if fn.endswith(suffix))
        return {
            "event_shards": count(self._events_dir(provider), ".json"),
            "builds": count(self._builds_dir(provider), ".pkl"),
        }

    def snapshot(self) -> Dict[str, int]:
        return self.stats.to_dict()


def open_store(store) -> ProfileStore:
    """Coerce a path or an already-open store into a ProfileStore."""
    return store if isinstance(store, ProfileStore) \
        else ProfileStore(store)
