"""Divisibility-aware sharding rule engine — the port of the JAX package's
``repro/dist/sharding.py``.

Maps parameter / optimizer / batch / KV-cache trees onto a mesh with
``data`` (+ optional ``pod``) and ``model`` axes. Rules are keyed by the
leaf's path name, and every rule is guarded by divisibility: a dimension
that does not divide the axis size falls back to replication instead of
failing (e.g. mamba2's 3352-wide ``in_proj`` shards on an 8-way model
axis but replicates on a 16-way one).

Conventions:

* column-parallel weights (``wq``/``wk``/``wv``/``w_up``/``w_gate``/
  ``in_proj`` …) shard their output (last) dim on ``model``;
* row-parallel weights (``wo``/``w_out``/``out_proj``) shard their
  contraction dim (second-to-last) on ``model`` — the Megatron pairing
  that keeps one all-reduce per block;
* the embedding table shards its vocab rows, the LM head its vocab
  columns;
* everything else (norm scales, biases, routers, positional tables)
  replicates;
* ``Plan(fsdp=True)`` additionally shards the largest remaining big dim
  over the data axes (ZeRO-3-equivalent since optimizer state mirrors
  parameter shardings).

A rule gives a **spec**: one entry a tensor dim, an axis name, a tuple of
axis names (the data axes ``("pod", "data")``, major first) or ``None``,
as JAX's ``PartitionSpec``. It reads only the mesh's axis names and sizes
(``mesh_dim_names`` and ``shape``: a ``DeviceMesh``, or a
:class:`MeshAxes` where no process group is up). :func:`placements` turns
a spec into DTensor placements, one ``Shard(d)`` or ``Replicate()`` a
mesh dim, for ``distribute_tensor``; ``(mesh, placements(spec, mesh))``
is the sharding ``dist.api``'s contexts pin.

The port keeps one module a layer (``params["layers"][i]``) where JAX
stacks each group along a leading layer dim, so a port layer leaf's spec
is JAX's with that leading entry dropped: ``layers/<i>/attn/wq`` stands
for ``groups/<g>/<c>/attn/wq``. Every rule reads dims from the end, or
the leading dim of an unstacked table, and FSDP's tie-break keeps the
order of the dims, so the rules need no change for it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from ..models.layers import ParamTree, plain_tree

__all__ = [
    "MODEL_AXIS", "MeshAxes", "Plan", "data_axes",
    "param_shardings", "opt_state_shardings",
    "batch_shardings", "cache_shardings",
    "placements",
]

MODEL_AXIS = "model"

#: weights whose output (last) dim is model-sharded (column-parallel)
_COL_PARALLEL = {"wq", "wk", "wv", "bq", "bk", "bv",
                 "w_up", "w_gate", "in_proj", "w_x", "w_y"}
#: weights whose contraction (second-to-last) dim is model-sharded
_ROW_PARALLEL = {"wo", "w_out", "out_proj"}
#: lookup tables that must never shard their index dim
_REPLICATED = {"pos_embed", "router"}

#: smallest dim FSDP will split over the data axes — below this the
#: per-shard tile is not worth the gather traffic
_FSDP_MIN_DIM = 512


class MeshAxes(NamedTuple):
    """A mesh's axis names and sizes: all that the rules read of a
    ``DeviceMesh``, which has the same two attributes."""

    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Plan:
    """Distribution knobs consumed by the rule engine."""

    fsdp: bool = False          # ZeRO param+opt sharding over the data axes
    kv_cache: str = "heads"     # decode KV layout: "heads" | "seq"


# ----------------------------------------------------------------------------
# mesh helpers
# ----------------------------------------------------------------------------
def data_axes(mesh) -> Tuple[str, ...]:
    """All non-model axes (``('data',)`` or ``('pod', 'data')``)."""
    return tuple(a for a in mesh.mesh_dim_names if a != MODEL_AXIS)


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _model_size(mesh) -> int:
    return _axis_sizes(mesh).get(MODEL_AXIS, 1)


def _data_size(mesh) -> int:
    sizes = _axis_sizes(mesh)
    return math.prod(sizes[a] for a in data_axes(mesh))


def _dp_axes(mesh):
    """The data axes as a single spec entry."""
    axes = data_axes(mesh)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _dp_spec(mesh, n: Optional[int]):
    """Spec entry for a batch-like dim of size ``n``: the data axes when
    ``n`` divides their product, else ``None`` (replicate)."""
    if n is None:
        return None
    return _dp_axes(mesh) if n % _data_size(mesh) == 0 else None


def _map_leaves(fn, tree, path: str = ""):
    """``tree`` (a :class:`ParamTree`, nested mappings and lists of
    tensors) with each tensor replaced by ``fn(path name, tensor)``:
    nested dicts with sorted keys and lists, as
    :func:`~repro_torch.models.layers.plain_tree` gives them."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, ParamTree):
        tree = plain_tree(tree)
    prefix = path + "/" if path else ""
    if isinstance(tree, Mapping):
        return {k: _map_leaves(fn, tree[k], prefix + str(k))
                for k in sorted(tree)}
    return [_map_leaves(fn, v, prefix + str(i)) for i, v in enumerate(tree)]


# ----------------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------------
def _param_spec(name: str, shape: Tuple[int, ...], msize: int
                ) -> Tuple[Tuple, str]:
    """→ (per-dim spec entries, human-readable rule tag)."""
    leaf = name.rsplit("/", 1)[-1]
    nd = len(shape)
    spec = [None] * nd

    def divisible(i: int) -> bool:
        return shape[i] % msize == 0

    if leaf in _REPLICATED:
        return tuple(spec), "replicate(table)"
    if leaf == "embed" and nd == 2:
        if divisible(0):
            spec[0] = MODEL_AXIS
            return tuple(spec), "vocab-rows"
        return tuple(spec), "replicate(vocab%model!=0)"
    if leaf == "head" and nd >= 2:
        if divisible(nd - 1):
            spec[nd - 1] = MODEL_AXIS
            return tuple(spec), "vocab-cols"
        return tuple(spec), "replicate(vocab%model!=0)"
    if leaf in _COL_PARALLEL and nd >= 1:
        if divisible(nd - 1):
            spec[nd - 1] = MODEL_AXIS
            return tuple(spec), "column-parallel"
        return tuple(spec), f"replicate({shape[nd - 1]}%{msize}!=0)"
    if leaf in _ROW_PARALLEL and nd >= 2:
        if divisible(nd - 2):
            spec[nd - 2] = MODEL_AXIS
            return tuple(spec), "row-parallel"
        return tuple(spec), f"replicate({shape[nd - 2]}%{msize}!=0)"
    return tuple(spec), "replicate"


def _apply_fsdp(spec: Tuple, shape: Tuple[int, ...], mesh) -> Tuple:
    """Add the data axes on the largest unsharded big dim (if divisible)."""
    dsize = _data_size(mesh)
    if dsize <= 1:
        return spec
    cands = [i for i in range(len(shape))
             if spec[i] is None and shape[i] % dsize == 0
             and shape[i] >= _FSDP_MIN_DIM]
    if not cands:
        return spec
    best = max(cands, key=lambda i: (shape[i], i))
    out = list(spec)
    out[best] = _dp_axes(mesh)
    return tuple(out)


def param_shardings(shapes, cfg, mesh, plan: Optional[Plan] = None, *,
                    explain: Optional[Dict[str, Tuple[str, Tuple]]] = None):
    """Parameter tree (of tensors, ``meta`` ones included: see
    ``Model.param_shapes``) → the same tree of specs.

    ``explain``, when given, is filled with ``path → (rule, spec)`` so
    tests and reports can audit every placement decision.
    """
    plan = plan or Plan()
    msize = _model_size(mesh)

    def one(name: str, leaf: torch.Tensor) -> Tuple:
        shape = tuple(leaf.shape)
        spec, rule = _param_spec(name, shape, msize)
        if plan.fsdp:
            fsdp_spec = _apply_fsdp(spec, shape, mesh)
            if fsdp_spec != spec:
                spec, rule = fsdp_spec, rule + "+fsdp"
        if explain is not None:
            explain[name] = (rule, spec)
        return spec

    return _map_leaves(one, shapes)


def opt_state_shardings(param_sh, mesh):
    """AdamW state specs: first/second moments mirror the parameter specs
    exactly (ZeRO-equivalent partitioning for free), the step counter
    replicates."""
    return {"m": param_sh, "v": param_sh, "count": ()}


# ----------------------------------------------------------------------------
# batches
# ----------------------------------------------------------------------------
def batch_shardings(batch_specs: Dict[str, Any], mesh) -> Dict[str, Tuple]:
    """Input batches shard their leading (batch) dim over the data axes;
    a non-divisible batch (e.g. a B=1 long-context shape) replicates.
    ``positions`` is [3, B, S] — its batch dim is second."""
    out = {}
    for k, v in batch_specs.items():
        if k == "positions":
            out[k] = (None, _dp_spec(mesh, v.shape[1]), None)
        else:
            rest = (None,) * (len(v.shape) - 1)
            out[k] = (_dp_spec(mesh, v.shape[0]),) + rest
    return out


# ----------------------------------------------------------------------------
# KV / recurrent caches
# ----------------------------------------------------------------------------
def cache_shardings(cache_shapes, cfg, mesh, plan: Optional[Plan] = None):
    """Decode-cache specs. KV leaves ([layers, B, S, Hkv, hd]) shard batch
    on data and, per ``plan.kv_cache``, either the sequence dim ("seq" —
    flash-decode split-K layout) or the kv-head dim ("heads") on model;
    recurrent/conv state shards batch only. Divisibility fallbacks apply
    per dim as for parameters. The port's cache keeps JAX's stacked
    leaves, so these are JAX's specs."""
    plan = plan or Plan()
    msize = _model_size(mesh)

    def one(name: str, leaf: torch.Tensor) -> Tuple:
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        if nd >= 2:
            spec[1] = _dp_spec(mesh, shape[1])  # batch dim
        if name.rsplit("/", 1)[-1] in ("k", "v") and nd == 5:
            if plan.kv_cache == "seq":
                if shape[2] % msize == 0:
                    spec[2] = MODEL_AXIS
            elif shape[3] % msize == 0:
                spec[3] = MODEL_AXIS
        return tuple(spec)

    return _map_leaves(one, cache_shapes)


# ----------------------------------------------------------------------------
# specs as DTensor placements
# ----------------------------------------------------------------------------
def placements(spec: Tuple, mesh) -> tuple:
    """A spec as DTensor placements over ``mesh``: ``Shard(d)`` on each
    mesh dim whose axis names tensor dim ``d``, ``Replicate()`` on the
    others. A dim named by several axes (``("pod", "data")``) is split
    over them in mesh order, major first, as a ``PartitionSpec`` splits
    it. A mesh dim of size 1 is ``Replicate()`` whatever the spec: its one
    shard is the whole tensor, and DTensor refuses some reshapes of a dim
    sharded even one way."""
    from torch.distributed.tensor import Replicate, Shard
    _key_topk_by_k()
    out = []
    for axis, size in zip(mesh.mesh_dim_names, tuple(mesh.shape)):
        dims = [d for d, entry in enumerate(spec)
                if entry == axis or (isinstance(entry, tuple)
                                     and axis in entry)]
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)


@functools.cache
def _key_topk_by_k() -> None:
    """Make DTensor's sharding-propagation cache key ``topk`` by its ``k``.

    DTensor registers ``aten.topk`` with ``static_argnum=2``: the cache
    keys an op by its DTensor specs and its arguments from that index on,
    so ``k`` (argument 1) is not in the key. A second ``topk`` of the same
    input specs with another ``k`` then gets the first one's output shape
    (a dbrx MoE layer, top-4, after a phi-3.5-moe one, top-2, sees [..., 2]
    experts). Every DTensor the port lays out gets its placements here,
    so this runs before any sharded ``topk``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    schemas = DTensor._op_dispatcher.sharding_propagator.op_to_schema_info
    topk = torch.ops.aten.topk.default
    info = schemas.get(topk)
    if info is not None and info.static_argnum > 1:
        schemas[topk] = dataclasses.replace(info, static_argnum=1)
