"""Sharding-hint API — the port of the JAX package's ``repro/dist/api.py``.

The model code calls ``stream`` (``hint``, JAX's residual-stream pin,
and the partition pin below), ``hint_vocab`` and ``hint_named``
unconditionally. Outside a distribution context ``hint``,
``hint_vocab`` and ``hint_named`` are the identity; inside one, a
``DTensor`` is redistributed to the pinned sharding and so is its
gradient, eager PyTorch's counterpart of ``with_sharding_constraint``.
A sharding is a
``(DeviceMesh, placements)`` pair (:func:`repro_torch.dist.sharding.
placements` gives a spec's placements). A plain tensor is never touched:
it lies whole on one device, so there is nothing to pin.

This indirection keeps the model free of mesh types: the layers never
import ``torch.distributed``, the launcher decides placement. Contexts are
thread-local, so concurrent actors (pipeline stages, engine workers) do
not leak pins into each other.

The layout helpers (``flatten``, ``unflatten``, ``unshard``,
``index_copy_``, ``match_layout``) stand in for the model's reshapes,
cache writes and reductions where GSPMD lays a sharded tensor out by
itself and eager DTensor refuses or gets the layout wrong. On a plain
tensor each is the plain operation.

GSPMD propagates one layout through the whole step; DTensor picks one op
by op, and left to itself it reshards partial attention scores, moves
activations where GSPMD gathers weights, and replicates what it cannot
split. The partition helpers pin the layout GSPMD reaches for the
Megatron blocks the model is made of:

* ``stream`` pins a block's input and output to the activation sharding
  in scope, and without one to the residual stream's layout: batch over
  the data axes, whole on ``model`` (a row-parallel product's partial
  sums are all-reduced there, as GSPMD reduces them);
* ``gather_weights`` gathers a block's FSDP-sharded weights over the data
  axes before their use, so its gradient is reduce-scattered back;
* ``local_attention`` and ``local_decode_attention`` run the attention of
  each device's own heads (or query rows) on the local shards, with no
  collective inside, and a cache sharded on its sequence dim by partial
  softmax statistics merged in two small all-reduces;
* ``local_heads`` and ``split_product`` run a layer on each device's
  own heads from a projection split by columns (the SSD mixer), and
  ``local_map`` a loop over channels on the local shards (the RG-LRU
  scan); ``logsumexp`` reduces a vocab-split row by local partials;
* ``idle_split_product`` splits the rows of a product over the data
  axes that a decode step's small batch leaves idle (the RG-LRU gates).
"""
from __future__ import annotations

import contextlib
import math
import sys
import threading
from typing import Any, Dict, Optional

import torch

__all__ = [
    "activation_sharding", "vocab_sharding", "spec_map",
    "hint", "stream", "hint_vocab", "hint_named", "flatten", "unflatten",
    "logsumexp", "unshard", "index_copy_", "match_layout", "gather_weights",
    "split_model", "local_attention", "local_decode_attention",
    "local_map", "local_heads", "split_product", "idle_split_product",
]

_state = threading.local()


def _get(name: str):
    return getattr(_state, name, None)


@contextlib.contextmanager
def activation_sharding(sharding):
    """Pin the residual stream ([B, S, D]) to ``sharding`` within scope."""
    prev = _get("act")
    _state.act = sharding
    try:
        yield
    finally:
        _state.act = prev


@contextlib.contextmanager
def vocab_sharding(sharding):
    """Pin vocab-dim tensors ([B, S, V]) to ``sharding`` within scope."""
    prev = _get("vocab")
    _state.vocab = sharding
    try:
        yield
    finally:
        _state.vocab = prev


@contextlib.contextmanager
def spec_map(mapping: Optional[Dict[str, Any]]):
    """Named-site pins (Megatron-style TP output pins). ``mapping`` maps
    hint-site names (``attn_q``, ``attn_kv``, ``mlp_hidden``) to
    shardings; ``None`` disables all named hints."""
    prev = _get("specmap")
    _state.specmap = mapping
    try:
        yield
    finally:
        _state.specmap = prev


def _dtensor(x):
    """``torch.distributed.tensor`` if ``x`` is a ``DTensor``, else None (a
    DTensor exists only once that module is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod if mod is not None and isinstance(x, mod.DTensor) else None


def _model_dim(mesh) -> Optional[int]:
    names = tuple(mesh.mesh_dim_names or ())
    return names.index("model") if "model" in names else None


def _batch_placements(mesh, batch: int, dt, batch_dim: int = 0) -> list:
    """``Shard(batch_dim)`` on every data mesh dim (each but ``model``) of
    size above 1 when ``batch`` splits over their product, ``Replicate()``
    on the others: the layout GSPMD gives a batch-major activation."""
    md = _model_dim(mesh)
    data = [i for i in range(mesh.ndim) if i != md and mesh.size(i) > 1]
    split = batch % math.prod(mesh.size(i) for i in data) == 0
    return [dt.Shard(batch_dim) if split and i in data else dt.Replicate()
            for i in range(mesh.ndim)]


def _global_stride(local, shape) -> tuple:
    """Contiguous strides of ``shape`` with its dims in the order of
    ``local``'s strides: the strides a DTensor of global ``shape`` records
    for the shard ``local``."""
    stride, acc = [0] * len(shape), 1
    for d in sorted(range(len(shape)), key=lambda d: (local.stride(d), -d)):
        stride[d] = acc
        acc *= shape[d]
    return tuple(stride)


def _from_local(local, mesh, places, shape):
    """The DTensor of global ``shape`` whose shard here is ``local``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=torch.Size(shape),
                              stride=_global_stride(local, shape))


def _constrain(x, sharding):
    if sharding is None:
        return x
    # imported here: torch.distributed.tensor takes about a second to
    # import, and only a pinned context needs it
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, placements = sharding
    return _Pin.apply(x, mesh, list(placements))


def hint(x):
    """Pin a residual-stream activation (identity outside a context)."""
    return _constrain(x, _get("act"))


def stream(x):
    """Pin a residual-stream activation [B, ..., D] to the activation
    sharding in scope, as :func:`hint` does. Outside one a ``DTensor`` is
    pinned to the stream's own layout, batch over the data axes and whole
    on ``model``: a block's partial sums are all-reduced, as GSPMD reduces
    a row-parallel product's, and the partial gradient of a block's input
    is reduced where it enters. A plain tensor is returned as it is."""
    act = _get("act")
    if act is not None:
        return _constrain(x, act)
    dt = _dtensor(x)
    if dt is None:
        return x
    return _Pin.apply(x, x.device_mesh,
                      _batch_placements(x.device_mesh, x.shape[0], dt))


def hint_vocab(x):
    """Pin a vocab-dim tensor (identity outside a context)."""
    return _constrain(x, _get("vocab"))


def hint_named(x, name: str):
    """Pin a named hint site, if the active spec map pins it."""
    mapping = _get("specmap")
    if not mapping:
        return x
    return _constrain(x, mapping.get(name))


def unflatten(x, dim: int, sizes):
    """``x.unflatten(dim, sizes)``. A ``DTensor`` whose ``dim`` is split
    over a number of shards that the first of ``sizes`` other than 1 is
    no multiple of is first replicated on those mesh dims: GSPMD lays
    such a reshape out by itself, DTensor refuses to unflatten a dim
    unevenly. A plain tensor is only unflattened."""
    # a DTensor exists only once torch.distributed.tensor is imported
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is not None and isinstance(x, dtensor.DTensor):
        d = dim % x.ndim
        ways = [i for i, p in enumerate(x.placements)
                if isinstance(p, dtensor.Shard) and p.dim == d]
        lead = next((n for n in sizes if n != 1), 1)
        if lead % math.prod(x.device_mesh.size(i) for i in ways):
            places = [dtensor.Replicate() if i in ways else p
                      for i, p in enumerate(x.placements)]
            x = x.redistribute(x.device_mesh, places)
    return x.unflatten(dim, sizes)


def flatten(x, start_dim: int, end_dim: int):
    """``x.flatten(start_dim, end_dim)``. A ``DTensor`` result that takes
    part in a gradient is pinned to its own layout (a no-op forward), so
    its gradient comes back in that layout and the flatten's backward, an
    unflatten, is one DTensor can take: a gradient sharded 16 ways on 16
    heads does not unflatten into 8 KV heads × 2. A ``DTensor`` split
    unevenly on ``start_dim`` (heads its mesh axis does not divide) is
    first gathered on those mesh dims: DTensor cannot flatten an uneven
    split, GSPMD pads it. A plain tensor is only flattened."""
    dtensor = _dtensor(x)
    if dtensor is not None:
        d = start_dim % x.ndim
        places = [dtensor.Replicate() if isinstance(p, dtensor.Shard) and
                  p.dim == d and x.shape[d] % x.device_mesh.size(i) else p
                  for i, p in enumerate(x.placements)]
        if places != list(x.placements):
            x = x.redistribute(x.device_mesh, places)
    y = x.flatten(start_dim, end_dim)
    if dtensor is not None and y.requires_grad:
        y = y.redistribute(y.device_mesh, y.placements)
    return y


def logsumexp(x, dim: int):
    """``torch.logsumexp(x, dim)``. A ``DTensor`` split along ``dim`` (the
    vocabulary of the logits) takes it as the maximum plus the log of the
    summed exponentials, each a reduction of the local shard and a small
    all-reduce, as GSPMD partitions ``jax.nn.logsumexp``; DTensor's own
    gathers the whole dim. A plain tensor takes ``torch.logsumexp``."""
    dt = _dtensor(x)
    d = dim % x.ndim
    if dt is None or not any(isinstance(p, dt.Shard) and p.dim == d
                             for p in x.placements):
        return torch.logsumexp(x, dim)
    # the reductions' partial results are all-reduced whole, where DTensor
    # would reduce-scatter them onto the batch and re-lay the logits to
    # meet them in the backward
    whole = [dt.Replicate() if isinstance(p, dt.Shard) and p.dim == d else p
             for p in x.placements]
    top = x.amax(dim, keepdim=True).detach().redistribute(x.device_mesh,
                                                            whole)
    total = _Pin.apply(torch.exp(x - top).sum(dim, keepdim=True),
                       x.device_mesh, whole)
    return (top + torch.log(total)).squeeze(dim)


def unshard(x, dim: int):
    """``x`` with ``dim`` whole on every device: a ``DTensor`` split along
    ``dim`` is replicated on those mesh dims (an all-gather), so a
    reduction over ``dim`` (the serve step's argmax over the vocabulary)
    runs on whole rows; DTensor's own split argmax fails at batch 1. A
    plain tensor is returned as it is."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is None or not isinstance(x, dtensor.DTensor):
        return x
    d = dim % x.ndim
    places = [dtensor.Replicate() if isinstance(p, dtensor.Shard) and
              p.dim == d else p for p in x.placements]
    return x.redistribute(x.device_mesh, places)


def index_copy_(dst, dim: int, index, src):
    """``dst.index_copy_(dim, index, src)`` for one index (``index`` [1]),
    ``dst`` keeping its layout whatever ``src``'s is, as GSPMD's
    ``dynamic_update_slice`` keeps a cache's sharding. DTensor's in-place
    ``index_copy_`` takes its placements from the operands and rewrites
    ``dst``'s to them while its local shard stays as it was, so the shard
    no longer fits them: on a ``dst`` sharded along ``dim`` (a decode
    cache sharded on its sequence dim) whatever ``src`` is, and on any
    ``dst`` whose placements ``src``'s differ from (a replicated cache
    and a new K/V row split on its head dim). So a ``dst`` sharded along
    ``dim`` takes the row by a select over the slots, which keeps its
    layout, and any other ``dst`` takes it in place from ``src`` laid out
    as ``dst`` is; a plain tensor is written in place."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is None or not isinstance(dst, dtensor.DTensor):
        return dst.index_copy_(dim, index, src)
    if any(isinstance(p, dtensor.Shard) and p.dim == dim % dst.ndim and
           dst.device_mesh.size(i) > 1 for i, p in enumerate(dst.placements)):
        slots = torch.arange(dst.shape[dim], device=index.device) == index
        shape = [1] * dst.ndim
        shape[dim] = -1
        return dst.copy_(torch.where(slots.reshape(shape), src.to(dst.dtype),
                                     dst))
    if isinstance(src, dtensor.DTensor):
        src = src.redistribute(dst.device_mesh, dst.placements)
    return dst.index_copy_(dim, index, src)


def match_layout(x):
    """``x``, or for a ``DTensor`` whose recorded strides order its dims
    otherwise than its local shard's do, the same shard rewrapped with
    strides in the shard's order; nothing is copied. DTensor records the
    strides its sharding propagation predicts from an op's inputs, but an
    input it has to redistribute first (a ``Partial`` one) comes out of
    the collective contiguous, and a later ``view`` that the recorded
    strides allow then fails on the shard. A plain tensor is returned as
    it is."""
    dtensor = _dtensor(x)
    if dtensor is None:
        return x
    local = x.to_local()

    def order(strides):
        return [d for d in sorted(range(x.ndim), key=lambda d: (-strides[d], d))
                if x.shape[d] > 1]

    if order(x.stride()) == order(local.stride()):
        return x
    return dtensor.DTensor.from_local(local, x.device_mesh, x.placements,
                                      run_check=False, shape=x.shape,
                                      stride=_global_stride(local, x.shape))


# ----------------------------------------------------------------------------
# the partition GSPMD reaches
# ----------------------------------------------------------------------------
def gather_weights(tree):
    """``tree`` (nested dicts and lists of tensors: one block's weights)
    with each ``DTensor`` leaf that FSDP splits over the data axes
    gathered whole on them, its ``model`` sharding kept: the all-gather
    GSPMD puts before a weight's use, whose backward reduce-scatters the
    gradient. Activations then keep their batch layout, where DTensor
    would otherwise move them to meet the weight's. A plain tree, or one
    without FSDP, is returned as it is."""
    dt = sys.modules.get("torch.distributed.tensor")
    if dt is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_weights(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_weights(v) for v in tree)
    if not isinstance(tree, dt.DTensor):
        return tree
    md = _model_dim(tree.device_mesh)
    places = [dt.Replicate() if i != md and isinstance(p, dt.Shard) else p
              for i, p in enumerate(tree.placements)]
    if places == list(tree.placements):
        return tree
    return tree.redistribute(tree.device_mesh, places)


def local_attention(fn, q, k, v):
    """``fn(q, k, v, first, combine)`` → out [B,Sq,H,Dv]: the attention of
    the queries ``q`` [B,Sq,H,D] over ``k``, ``v`` [B,Skv,Hkv,D*], where
    ``first`` is the index in ``q`` of the first query row ``fn`` gets.

    On a plain tensor this is ``fn(q, k, v, 0, None)``. On a ``DTensor``
    ``fn`` runs on each device's own shard, as GSPMD partitions the
    attention, and nothing is communicated inside it. The batch stays
    split over the data axes. On ``model`` the query heads are split when
    the axis divides them, K and V with them when it divides theirs, else
    K and V are whole and each device takes the KV heads its query heads
    read. Where the axis does not divide the query heads, the query rows
    are split instead (``first`` is then the device's first row, and the
    result is gathered whole on ``model``), or, with fewer rows than
    devices, the heads as ``torch.chunk`` splits them (the last devices
    hold none, where GSPMD pads); K and V are whole. The gradient of a
    whole K or V is a partial sum over ``model``. K and V split on their
    keys over ``model`` (a decode cache of the ``seq`` plan) stay where
    they lie: the whole query attends to each device's keys and ``fn``
    merges the partial softmaxes by ``combine``, as
    :func:`local_decode_attention` does."""
    dt = _dtensor(q)
    if dt is None:
        return fn(q, k, v, 0, None)
    mesh = q.device_mesh
    b, sq, h = q.shape[:3]
    hkv = k.shape[2]
    qp = _batch_placements(mesh, b, dt)
    kp, kgrad = list(qp), list(qp)
    md = _model_dim(mesh)
    m = mesh.size(md) if md is not None else 1
    if m > 1 and _dtensor(k) is not None and k.placements[md] == dt.Shard(1):
        ql = q.redistribute(mesh, qp).to_local()
        kp[md] = dt.Shard(1)
        out = fn(ql, k.redistribute(mesh, kp).to_local(),
                 v.redistribute(mesh, kp).to_local(), 0,
                 _combiner(mesh, md, qp, b))
        return _from_local(out, mesh, qp, (b, sq, h, out.shape[-1]))
    heads, first = None, 0
    if m > 1:
        c = mesh.get_local_rank(md)
        if h % m == 0 or sq < m:
            qp[md] = dt.Shard(2)
            if h % m == 0 and hkv % m == 0:
                kp[md] = kgrad[md] = dt.Shard(2)
            else:
                kgrad[md] = dt.Partial()
                per = -(-h // m)           # the chunk heads DTensor gives
                heads = [i // (h // hkv)
                         for i in range(min(c * per, h), min(c * per + per, h))]
        else:
            qp[md] = dt.Shard(1)
            kgrad[md] = dt.Partial()
            first = c * -(-sq // m)        # the chunk rows DTensor gives
    ql = _Local.apply(q.redistribute(mesh, qp), qp)
    kl = _Local.apply(k.redistribute(mesh, kp), kgrad)
    vl = _Local.apply(v.redistribute(mesh, kp), kgrad)
    if heads is not None:
        kl, vl = _kv_heads(kl, heads), _kv_heads(vl, heads)
    out = _from_local(fn(ql, kl, vl, first, None), mesh, qp,
                      (b, sq, h, v.shape[-1]))
    if md is not None and qp[md] == dt.Shard(1):
        # split rows are gathered: the products that follow would flatten
        # them into a strided split, whose redistributions DTensor plans
        # by a search over layouts
        out = out.redistribute(mesh, _batch_placements(mesh, b, dt))
    return out


def _combiner(mesh, md: int, whole, batch: int):
    """``combine(o, l, m)`` of a softmax split over ``model``'s keys:
    each device's unnormalised output ``o`` [B, ..., D], sums ``l`` and
    maxima ``m`` [B, ..., 1] (batch-local) → the normalised output,
    merged by a max and a sum all-reduce over ``model``. Forward only."""
    from torch.distributed.tensor import Partial

    def reduce(local, op):
        part = list(whole)
        part[md] = Partial(op)
        return _from_local(local, mesh, part, (batch,) + tuple(
            local.shape[1:])).redistribute(mesh, whole).to_local()

    def combine(o, l, m):
        top = reduce(m, "max")
        scale = torch.exp(m - top)
        ol = reduce(torch.cat([o * scale, l * scale], dim=-1), "sum")
        return ol[..., :-1] / ol[..., -1:]

    return combine


def local_decode_attention(fn, q, k, v, masked):
    """``fn(q, k, v, masked, combine)`` → out [B,Hkv,G,D]: one token's
    attention, ``q`` [B,Hkv,G,D], over a cache ``k``, ``v`` [B,S,Hkv,D]
    whose slots ``masked`` [S] marks.

    On a plain tensor, or a cache whose slots are not split over
    ``model``, this is ``fn(q, k, v, masked, None)``. A cache split on its
    slots (the ``seq`` plan) is read where it lies, as GSPMD partitions
    the softmax: each device attends over its own slots with the whole
    query, ``fn`` hands ``combine(o, l, m)`` its unnormalised output, sums
    and maximum, and these are merged by a max and a sum all-reduce of
    [B,Hkv,G,·] over ``model``, where DTensor would gather the scores of
    every slot."""
    dt = _dtensor(k)
    md = _model_dim(k.device_mesh) if dt is not None else None
    if md is None or k.device_mesh.size(md) == 1 or \
            k.placements[md] != dt.Shard(1):
        return fn(q, k, v, masked, None)
    mesh = k.device_mesh
    whole = list(k.placements)
    whole[md] = dt.Replicate()
    ql = q.redistribute(mesh, whole).to_local()
    slots = [dt.Replicate()] * mesh.ndim
    slots[md] = dt.Shard(0)
    if _dtensor(masked) is None:
        masked = _from_local(masked, mesh, [dt.Replicate()] * mesh.ndim,
                             masked.shape)
    ml = masked.redistribute(mesh, slots).to_local()
    out = fn(ql, k.to_local(), v.to_local(), ml,
             _combiner(mesh, md, whole, q.shape[0]))
    return _from_local(out, mesh, whole, tuple(q.shape[:-1]) +
                       (out.shape[-1],))


def _split_placements(x, dim: int, dt, batch_dim: int = 0) -> list:
    """The batch layout of ``x`` with ``dim`` split over ``model`` where
    the axis divides it."""
    mesh = x.device_mesh
    places = _batch_placements(mesh, x.shape[batch_dim], dt, batch_dim)
    md = _model_dim(mesh)
    if md is not None and x.shape[dim] % mesh.size(md) == 0:
        places[md] = dt.Shard(dim % x.ndim)
    return places


def split_model(x, dim: int, batch_dim: int = 0):
    """Pin ``x`` to its batch layout (the batch along ``batch_dim``) with
    ``dim`` split over ``model`` where the axis divides it: the product of
    a sharded input and a whole weight is reduce-scattered onto its output
    channels, as GSPMD lays it out for the channel-wise work that follows,
    and a whole decode state is laid out as its heads are stepped. A plain
    tensor is returned as it is."""
    dt = _dtensor(x)
    if dt is None:
        return x
    return _Pin.apply(x, x.device_mesh,
                      _split_placements(x, dim, dt, batch_dim))


def local_map(fn, *xs, dim: int):
    """``fn(*xs)`` for a function that computes each batch row and each
    index of ``dim`` (a channel, a head) on its own, such as a scan over
    time; the result has that batch and that ``dim`` too.

    On plain tensors this is ``fn(*xs)``. On ``DTensor``s ``fn`` runs on
    the local shards, as GSPMD partitions such a loop: the batch split
    over the data axes, and ``dim`` over ``model`` where the axis divides
    it, else whole. DTensor would reshard inside the loop, or run it whole
    on every device."""
    dt = _dtensor(xs[0])
    if dt is None:
        return fn(*xs)
    mesh, lead = xs[0].device_mesh, xs[0]
    places = _split_placements(lead, dim, dt)
    out = fn(*(_Local.apply(x.redistribute(mesh, places), places)
               for x in xs))
    shape = list(out.shape)
    shape[0], shape[dim] = lead.shape[0], lead.shape[dim]
    return _from_local(out, mesh, places, shape)


def local_heads(fn, n: int, xs, weights=(), dims=(-2,), split=()):
    """``fn(part, *xs, *split, *weights)``: a layer whose ``n`` heads are
    computed on their own, ``part`` a ``slice`` of them, from inputs
    ``xs`` [B, ...] and ``weights`` that every head reads whole and inputs
    ``split`` [B, H, ...] of which ``fn`` gets the heads ``part`` only.
    Each result holds its heads along a dim of its own: ``dims``, one for
    each of ``fn``'s results (a tuple where there are several).

    On plain tensors this is ``fn(slice(0, n), ...)``. On ``DTensor``s
    each device computes its own heads from its local shards, as GSPMD
    partitions the layer: the inputs whole on ``model`` with the batch
    over the data axes, the results split along ``dims`` as ``torch.chunk``
    splits ``n`` (where ``model`` does not divide ``n`` the last devices
    hold fewer heads, or none, where GSPMD pads). The gradient of an input
    is then a partial sum over ``model``, and a weight's over the data
    axes too."""
    dt = _dtensor(xs[0])
    md = _model_dim(xs[0].device_mesh) if dt is not None else None
    if md is None or xs[0].device_mesh.size(md) == 1:
        return fn(slice(0, n), *xs, *split, *weights)
    mesh, b = xs[0].device_mesh, xs[0].shape[0]
    k, c = -(-n // mesh.size(md)), mesh.get_local_rank(md)
    whole = _batch_placements(mesh, b, dt)
    grad = list(whole)
    grad[md] = dt.Partial()
    wgrad = [dt.Partial() if i == md or p != dt.Replicate() else
             dt.Replicate() for i, p in enumerate(whole)]
    heads = list(whole)
    heads[md] = dt.Shard(1)
    outs = fn(slice(min(c * k, n), min((c + 1) * k, n)),
              *(_Local.apply(x.redistribute(mesh, whole), grad) for x in xs),
              *(_Local.apply(x.redistribute(mesh, heads), heads)
                for x in split),
              *(_Local.apply(w.redistribute(mesh, [dt.Replicate()] *
                                            mesh.ndim), wgrad)
                for w in weights))

    def wrap(out, dim):
        dim %= out.ndim
        places, shape = list(whole), [b] + list(out.shape[1:])
        places[md], shape[dim] = dt.Shard(dim), n
        return _from_local(out, mesh, places, shape)

    if isinstance(outs, tuple):
        return tuple(wrap(o, d) for o, d in zip(outs, dims))
    return wrap(outs, dims[0])


def split_product(x, w):
    """``x @ w`` for a weight ``w`` [K, N] whole on ``model``: each device
    multiplies by its own chunk of ``w``'s columns (``torch.chunk``'s), as
    GSPMD splits the product of a weight the rules replicate, and the
    result is split on its last dim. A ``w`` already split, and a plain
    tensor, take the plain product."""
    dt = _dtensor(w)
    md = _model_dim(w.device_mesh) if dt is not None else None
    if md is None or w.device_mesh.size(md) == 1 or \
            w.placements[md] != dt.Replicate():
        return x @ w
    mesh = w.device_mesh
    ncol = w.shape[-1]
    k, c = -(-ncol // mesh.size(md)), mesh.get_local_rank(md)
    whole = _batch_placements(mesh, x.shape[0], dt)
    grad = list(whole)
    grad[md] = dt.Partial()
    wgrad = [dt.Partial() if i == md or p != dt.Replicate() else
             dt.Replicate() for i, p in enumerate(whole)]
    cols = slice(min(c * k, ncol), min((c + 1) * k, ncol))
    out = _Local.apply(x.redistribute(mesh, whole), grad) @ \
        _Local.apply(w, wgrad)[..., cols]
    places = list(whole)
    places[md] = dt.Shard(out.ndim - 1)
    return _from_local(out, mesh, places, tuple(x.shape[:-1]) + (ncol,))


def idle_split_product(x, w):
    """``x @ w`` in a decode step, for ``x`` [B, K] and a weight ``w`` [K,
    N] whole on every mesh dim, where the batch ``B`` does not split over
    the data axes. Each device multiplies its own chunk of the ``K`` rows,
    by its place on ``model`` and on the idle data axes, and the partial
    sums are reduced onto the batch layout with the columns split over
    ``model``. GSPMD partitions a decode step's product of one sequence by
    a replicated weight so, where DTensor would run it whole on every
    device of the data axes. A batch split over the data axes, ``K`` that
    the axes do not divide, a weight split on any mesh dim and a plain
    tensor take the plain product. Forward only."""
    dt = _dtensor(w)
    if dt is None:
        return x @ w
    mesh = w.device_mesh
    md = _model_dim(mesh)
    whole = _batch_placements(mesh, x.shape[0], dt)
    idle = [i for i in range(mesh.ndim) if i != md and mesh.size(i) > 1
            and whole[i] == dt.Replicate()]
    split = [md] if md is not None and mesh.size(md) > 1 else []
    n, k = math.prod(mesh.size(i) for i in split + idle), w.shape[0]
    if not idle or k % n or any(p != dt.Replicate() for p in w.placements):
        return x @ w
    # this device's chunk of the rows: its model index, then its place on
    # the idle data axes
    c = 0
    for i in split + idle:
        c = c * mesh.size(i) + mesh.get_local_rank(i)
    xp, part = list(whole), list(whole)
    for i in split + idle:
        part[i] = dt.Partial()
    if split:
        xp[md] = dt.Shard(x.ndim - 1)
    # x's shard on model holds the rows of this device's model chunk
    here = c % math.prod(mesh.size(i) for i in idle)
    rows = k // n
    out = x.redistribute(mesh, xp).to_local()[..., here * rows:
                                               (here + 1) * rows] @ \
        w.to_local()[c * rows:(c + 1) * rows]
    out = _from_local(out, mesh, part, tuple(x.shape[:-1]) + (w.shape[-1],))
    if split:
        # reduce-scatter over model first: the data axes then all-reduce
        # this device's columns only, as GSPMD's one all-reduce does
        part[md] = dt.Shard(x.ndim - 1)
        out = out.redistribute(mesh, part)
    return out.redistribute(mesh, [whole[i] if i in idle else p
                                   for i, p in enumerate(part)])


class _Pin(torch.autograd.Function):
    """``x.redistribute`` to ``placements``, whose gradient is pinned to
    the same placements, as ``with_sharding_constraint`` transposes to
    itself. DTensor's own backward lays the gradient out as the input
    was: the ``Partial`` cotangent of a column-parallel product's input
    then flows on into the block before, and each product it meets there
    runs whole on every device, where GSPMD all-reduces it once."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.placements = placements
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.placements), None, \
            None


class _Local(torch.autograd.Function):
    """A ``DTensor``'s local shard, whose gradient goes back as a DTensor
    of ``grad_placements`` with the strides the local gradient has.
    (``DTensor.to_local`` records the input's strides for it, and a view
    of the gradient that those allow then fails on the shard.)"""

    @staticmethod
    def forward(ctx, x, grad_placements):
        ctx.meta = (x.device_mesh, list(grad_placements), x.shape)
        local = x._local_tensor
        return local.view_as(local)

    @staticmethod
    def backward(ctx, grad):
        if grad is None:
            return None, None
        return _from_local(grad, *ctx.meta), None


def _kv_heads(x, heads):
    """The KV heads ``heads`` (one a local query head, ascending) of
    ``x`` [B,S,Hkv,D]: a slice of whole groups where the query heads
    split evenly over them, else one head a query head."""
    if not heads:
        return x[:, :, :0]
    n = len(set(heads))
    lo = heads[0]
    if heads == [lo + i * n // len(heads) for i in range(len(heads))]:
        return x[:, :, lo:lo + n]
    return x.index_select(2, torch.tensor(heads, device=x.device))
