"""Sharding rules: logical parameter/activation axes → mesh axes — the
port of the reference package's ``repro.parallel.sharding`` onto
``torch.distributed`` device meshes and DTensor placements.

Megatron-style tensor parallelism over the ``model`` axis:
  * column-parallel: q/k/v projections, MLP up/gate, SSM in_proj
  * row-parallel:    attention out, MLP down, SSM out_proj
  * vocab-parallel:  embedding (vocab dim), LM head (vocab dim)
  * expert-parallel: MoE expert stacks (expert dim over ``model``)
Batch is sharded over ``("pod", "data")`` (or ``("data",)`` single-pod);
long-context decode shards KV-cache SEQUENCE over ``data`` (SP).
ZeRO-1 shards optimizer moments over ``data`` on the first divisible
replicated dim.

Every rule checks divisibility against the mesh and falls back to
replication — 40 heterogeneous (arch x shape) cells must all lower.

A spec is the port's own :class:`P`, one entry per tensor dimension,
equal to the tuple of the reference's ``PartitionSpec``. A mesh is
either a ``torch.distributed.device_mesh.DeviceMesh`` or any object with
the reference's duck type (a ``.shape`` mapping of axis sizes and
``.axis_names``), so the rules run on a mesh-like stand-in with no
process group. :func:`to_placements` turns a spec into the DTensor
placements of a real mesh; :func:`use_mesh` / :func:`current_mesh` are
the counterpart of ``jax.set_mesh`` / ``get_abstract_mesh``.
"""
from __future__ import annotations

import contextlib
import math
import sys
from typing import Any, Mapping, Optional, Tuple

import torch


def _canonical(entry):
    """An entry as ``PartitionSpec`` stores it: a name sequence becomes
    a tuple, one name alone, none ``None``."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


class P(tuple):
    """A partition spec: per tensor dimension a mesh-axis name, a tuple
    of names (that dimension over several mesh axes, major to minor) or
    ``None`` (replicated). Entries are stored as ``PartitionSpec``
    stores them (``("data",)`` as ``"data"``), so ``P(...)`` equals the
    tuple of the reference's ``PartitionSpec(...)``."""

    def __new__(cls, *dims):
        return super().__new__(cls, (_canonical(d) for d in dims))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# --------------------------------------------------------------------------
# meshes: a DeviceMesh or the reference's mesh-like duck type
# --------------------------------------------------------------------------

def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh or a mesh-like object."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axis, (tuple, list)):
        return int(math.prod([shape[a] for a in axis if a in shape]))
    return shape.get(axis, 1)


def _try(dim: int, mesh, axis):
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    if any(a not in axis_names(mesh) for a in axes if a is not None):
        return None                     # unknown axis (e.g. TP disabled)
    return axis if dim % max(1, _axis_size(mesh, axis)) == 0 else None


# --------------------------------------------------------------------------
# trees: the port's dicts, NamedTuples and sequences, named as
# jax.tree_util.tree_map_with_path names the reference's
# --------------------------------------------------------------------------

def _map(fn, tree, *rest, path: Tuple[str, ...] = ()):
    """``fn(path, leaf, *rest_leaves)`` over ``tree``'s leaves, rebuilt in
    its structure. A path part is a dict key, a NamedTuple's field name
    (``conv``, ``state``) or ``[i]`` for a sequence index; a :class:`P`
    is a leaf."""
    if isinstance(tree, Mapping):
        return {k: _map(fn, tree[k], *(r[k] for r in rest),
                        path=path + (str(k),)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, getattr(tree, f),
                                 *(getattr(r, f) for r in rest),
                                 path=path + (f,)) for f in tree._fields))
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return type(tree)(_map(fn, c, *(r[i] for r in rest),
                               path=path + (f"[{i}]",))
                          for i, c in enumerate(tree))
    return fn(path, tree, *rest)


def spec_leaves(tree: Any) -> list:
    """Every :class:`P` (or other leaf) of a spec tree, in tree order."""
    out: list = []
    _map(lambda _p, leaf: out.append(leaf), tree)
    return out


# --------------------------------------------------------------------------
# the rules (the reference's, rule for rule)
# --------------------------------------------------------------------------

# leaf-name → (which dim gets 'model',) using negative indices
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "w1", "in_proj",
        "bq", "bk", "bv", "b1", "conv_w", "conv_b", "dt_bias",
        "A_log", "D", "norm_scale"}
_ROW = {"wo", "w_down", "w2", "out_proj"}
_REPL = {"ln", "b2", "final_norm", "enc_norm", "router"}


def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
               mesh, model_axis: str = "model", fsdp_axes=None) -> P:
    name = path[-1]
    nd = len(shape)
    spec = [None] * nd
    if name == "embed":
        spec[0] = _try(shape[0], mesh, model_axis)        # vocab
    elif name == "head":
        spec[-1] = _try(shape[-1], mesh, model_axis)      # vocab
    elif name in _REPL or name.startswith("ln"):
        pass
    elif name in ("w_gate", "w_up", "w_down") and nd >= 4:
        # MoE expert stack (..., E, d, f): experts over `model`
        spec[-3] = _try(shape[-3], mesh, model_axis)
    elif name in _COL:
        spec[-1] = _try(shape[-1], mesh, model_axis)
    elif name in _ROW:
        spec[-2] = _try(shape[-2], mesh, model_axis)
    if fsdp_axes:
        # FSDP/ZeRO-3: shard the LARGEST remaining replicated dim over the
        # data axes (weights gathered per-layer inside the scan)
        cand = [(shape[i], i) for i in range(nd)
                if spec[i] is None
                and shape[i] % _axis_size(mesh, fsdp_axes) == 0
                and shape[i] > 1]
        if cand:
            _, i = max(cand)
            spec[i] = fsdp_axes
    return P(*spec)


def param_specs(params_shape: Any, mesh, model_axis: str = "model",
                fsdp_axes=None) -> Any:
    """A :class:`P` for every leaf of ``params_shape`` (tensors, meta
    tensors or anything with a ``.shape``)."""
    return _map(lambda path, leaf: param_spec(
        path, tuple(leaf.shape), mesh, model_axis, fsdp_axes), params_shape)


def zero1_specs(params_shape: Any, pspecs: Any, mesh,
                data_axis="data") -> Any:
    """Optimizer-moment specs: add `data` sharding on the first replicated
    dim that divides (ZeRO-1). Falls back to the param spec."""
    def f(_path, leaf, spec):
        shape = tuple(leaf.shape)
        dims = list(spec) + [None] * (len(shape) - len(spec))
        used = {a for d in dims if d is not None
                for a in (d if isinstance(d, tuple) else (d,))}
        if data_axis in used:          # FSDP already shards over data
            return P(*dims)
        for i, (d, s) in enumerate(zip(shape, dims)):
            if s is None and d % _axis_size(mesh, data_axis) == 0 and d > 1:
                dims[i] = data_axis
                break
        return P(*dims)
    return _map(f, params_shape, pspecs)


def batch_specs(batch_shape: Any, mesh, batch_axes) -> Any:
    """Shard dim0 (global batch) over the batch mesh axes."""
    def f(_path, leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if shape and shape[0] % _axis_size(mesh, batch_axes) == 0:
            spec[0] = batch_axes
        return P(*spec)
    return _map(f, batch_shape)


def cache_specs(cache_shape: Any, mesh, batch_axes,
                model_axis: str = "model",
                seq_axis: Optional[str] = None) -> Any:
    """Decode-cache sharding.

    KV leaves are (L, B, S, KH, hd) (or SSM conv (L,B,K,C) / state
    (L,B,H,P,N)). Priority: batch over batch_axes; KV-heads over `model`;
    if batch can't shard (e.g. long_500k B=1) shard SEQUENCE over
    `seq_axis` (sequence parallelism).
    """
    def f(names, leaf):
        name = names[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        if name == "pos":
            return P(_try(shape[0], mesh, batch_axes) if shape else None)
        if nd >= 2:
            spec[1] = _try(shape[1], mesh, batch_axes)    # batch dim

        def seq_spec(dim):
            """Shard a cache SEQUENCE dim: over `model` when KV heads
            can't shard (context parallelism), plus `data` for
            unshardable batch (long-context SP)."""
            axes = []
            if spec[1] is None and seq_axis is not None:
                axes.append(seq_axis)
            if dim % _axis_size(mesh, tuple(axes + [model_axis])) == 0:
                axes.append(model_axis)
            axes = [a for a in axes if dim % _axis_size(mesh, a) == 0]
            if not axes:
                return None
            return tuple(axes) if len(axes) > 1 else axes[0]

        if name in ("k", "v", "cross_k", "cross_v"):      # (L,B,S,KH,hd)
            spec[3] = _try(shape[3], mesh, model_axis)
            if spec[3] is None:
                spec[2] = seq_spec(shape[2])
            elif spec[1] is None and seq_axis is not None:
                spec[2] = _try(shape[2], mesh, seq_axis)
        elif name == "kpos":                              # (L,B,S)
            pass    # small int32; replicated across model
        elif name == "state":                             # (L,B,H,P,N)
            spec[2] = _try(shape[2], mesh, model_axis)
        elif name == "conv":                              # (L,B,K,C)
            spec[3] = _try(shape[3], mesh, model_axis)
        return P(*spec)

    return _map(f, cache_shape)


# --------------------------------------------------------------------------
# specs on a real mesh: DTensor placements
# --------------------------------------------------------------------------

def to_placements(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on the DeviceMesh ``mesh``
    (the reference's ``NamedSharding(mesh, spec)``): ``Shard(d)`` on
    every mesh dimension that the spec names at tensor dimension ``d``,
    ``Replicate()`` on the rest. A name tuple shards one tensor
    dimension over several mesh dimensions, major to minor; DTensor
    splits a dimension in mesh order, so the tuple must name them in
    that order."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        unknown = [a for a in axes if a not in names]
        if unknown:
            raise ValueError(f"spec {spec} names {unknown}, not axes of "
                             f"the mesh {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dimension {d} names mesh axes "
                             f"{axes} out of the mesh's order {names}")
        for i in idx:
            if not out[i].is_replicate():
                raise ValueError(f"spec {spec} names mesh axis "
                                 f"{names[i]!r} twice")
            out[i] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor: if its
    module was never imported, none exists)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def settle(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its pending sums (``Partial`` placements) reduced,
    its other placements kept; a plain tensor as it is. Megatron's
    all-reduce after a row-parallel product, where no residual-stream
    spec places the result (decode): left pending, the sum meets the
    next column-parallel weight, and DTensor gathers that weight whole
    on every rank instead."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def place(x: torch.Tensor, mesh, placements):
    """``x`` with ``placements`` on ``mesh``: a DTensor is redistributed;
    a plain tensor is taken as this rank's copy of a replicated value
    (each rank holds the whole of it) and then sharded, without
    communication."""
    from torch.distributed.tensor import DTensor, Replicate
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return _redistribute(x, placements)


def _redistribute(x, placements):
    """``x`` redistributed to ``placements``, and ``x`` itself where it
    has them already: a redistribution that moves nothing still puts a
    node in the autograd graph, whose backward reduces a gradient that
    holds a pending sum (an all-reduce) where the next real
    redistribution would have reduce-scattered it."""
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def distribute(x: torch.Tensor, spec, mesh):
    """``x`` placed on ``mesh`` by ``spec`` (:func:`place`)."""
    return place(x, mesh, to_placements(spec, mesh))


def distribute_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every leaf of ``tree`` placed on ``mesh`` by the :class:`P` at the
    same place of ``specs`` (:func:`distribute`)."""
    return _map(lambda _p, leaf, spec: distribute(leaf, spec, mesh), tree,
                specs)


def gather_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor with tensor dimension ``dim`` made whole on every rank
    (its other placements kept); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim %= x.ndim
    return _redistribute(x, [Replicate() if p.is_shard(dim) else p
                             for p in x.placements])


def gather_fsdp(x: torch.Tensor, tp_axis: str = "model") -> torch.Tensor:
    """A parameter DTensor with its FSDP shards gathered and its
    tensor-parallel shard kept (FSDP's gather before a layer runs): a
    dimension sharded over a mesh axis other than ``tp_axis``, or over
    ``tp_axis`` together with another (ZeRO-3 over both), is made whole;
    a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    names = x.device_mesh.mesh_dim_names
    dims = [p.dim for p in x.placements if p.is_shard()]
    placements = [p if not p.is_shard() or (names[i] == tp_axis
                                             and dims.count(p.dim) == 1)
                  else Replicate() for i, p in enumerate(x.placements)]
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def local(x: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor; a plain tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


# --------------------------------------------------------------------------
# the current mesh (jax.set_mesh / get_abstract_mesh)
# --------------------------------------------------------------------------

#: the meshes entered with :func:`use_mesh`, innermost last. Process-wide
#: like the process group it names: the autograd engine recomputes a
#: checkpointed layer on a thread of its own.
_MESHES: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Within the block, :func:`current_mesh` is ``mesh``."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current_mesh():
    """The innermost mesh entered with :func:`use_mesh`; raises without
    one, as a sharding constraint does in the reference outside a mesh."""
    if not _MESHES:
        raise RuntimeError("no mesh: enter repro_torch.parallel.sharding."
                           "use_mesh(mesh) first")
    return _MESHES[-1]


# --------------------------------------------------------------------------
# moving columns between ranks by hand (inside ``local_map``)
# --------------------------------------------------------------------------

def chunk_range(length: int, mesh, dim: Optional[int], placement,
                rank: Optional[int] = None) -> range:
    """The indices of a tensor dimension of ``length`` that rank ``rank``
    of mesh dimension ``dim`` holds (this rank's by default) under
    ``placement`` there: DTensor's chunks (``ceil(length / n)`` a rank,
    the last ones shorter or empty) for a ``Shard``, all of them
    otherwise."""
    if dim is None or not placement.is_shard():
        return range(length)
    n = mesh.size(dim)
    rank = mesh.get_local_rank(dim) if rank is None else rank
    per = -(-length // n)
    return range(min(rank * per, length), min((rank + 1) * per, length))


def regroup_columns(t: torch.Tensor, held, need, mesh, dim: Optional[int]):
    """The columns ``need(rank)`` of a 2-D local tensor ``t`` whose
    columns are the global indices ``held(rank)`` (a range) on each rank
    of mesh dimension ``dim``. ``need(rank)`` is a list of ranges of
    global indices, taken in that order. Each rank sends every other
    rank the columns it needs and does not hold, in one
    ``all_to_all_single`` over ``dim`` with uneven splits (none when
    every rank holds what it needs); a column held by several ranks
    comes from the lowest of them. ``dim`` None: this rank holds every
    column it needs."""
    n = 1 if dim is None else mesh.size(dim)
    me = 0 if dim is None else mesh.get_local_rank(dim)
    holds = [held(r) for r in range(n)]

    def pieces(rank):
        """(start, stop, source) covering need(rank) in order."""
        out, own = [], holds[rank]
        for seg in need(rank):
            pos = seg.start
            while pos < seg.stop:
                if pos in own:
                    out.append((pos, min(seg.stop, own.stop), rank))
                else:
                    src = next(s for s in range(n) if pos in holds[s])
                    stop = min(seg.stop, holds[src].stop)
                    if own.start > pos:
                        stop = min(stop, own.start)
                    out.append((pos, stop, src))
                pos = out[-1][1]
        return out

    def cols(ps, src, base):
        return [i - base for a, b, s in ps if s == src for i in range(a, b)]

    mine = pieces(me)
    send = [cols(pieces(j), me, holds[me].start) if j != me else []
            for j in range(n)]
    recv = [sum(b - a for a, b, s in mine if s == j) if j != me else 0
            for j in range(n)]
    parts = [t[:, cols(mine, me, holds[me].start)]]
    if any(send) or any(recv):
        import torch.distributed._functional_collectives as funcol
        got = funcol.all_to_all_single(
            t[:, [i for idx in send for i in idx]].T.contiguous(), recv,
            [len(x) for x in send], (mesh, dim))
        if isinstance(got, funcol.AsyncCollectiveTensor):
            got = got.wait()
        parts.append(got.T)
    # the columns come local first, then from each source in rank order,
    # each in need order: put them back in need order
    start, off = {me: 0}, sum(b - a for a, b, s in mine if s == me)
    for j in range(n):
        if j != me:
            start[j], off = off, off + recv[j]
    where = []
    for a, b, s in mine:
        where.extend(range(start[s], start[s] + b - a))
        start[s] += b - a
    return torch.cat(parts, dim=1)[:, where]
