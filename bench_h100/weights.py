"""The benchmark's weights and token ids, drawn from ``--seed`` on the
device in a few large calls.

The leaves take the shapes and dtypes of ``Model.param_shapes()``. All
leaves of one dtype are views into one buffer, filled by one
``normal_`` from a ``torch.Generator`` on the device, then scaled leaf by
leaf: a norm scale to 1 + 0.1·N(0, 1), the (tied) embedding to
1/√d_model, every other weight to 1/√fan-in (its second-last axis, which
the port multiplies from the left), any other 1-D leaf to 0.02·N(0, 1).
A configuration file's optional ``draw`` table overrides this by leaf
name: ``{"a_log": {"mean": m, "std": s}}`` makes every leaf of that name
m + s·N(0, 1), from the same buffer, so the leaves' order and the
generators' streams stay as they are. The same tensors go to the program
and to the reference; nothing here calls the program's own ``init``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

#: a seed may exceed 32 bits; generators take 64
SEED_MASK = (1 << 63) - 1


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for draw ``stream`` of ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) & SEED_MASK)
    return g


def _leaves(tree, path=()) -> Iterator[Tuple[Tuple, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return None


def std_of(path: Tuple, shape) -> float:
    """The scale of a leaf by its name and shape (0 marks a norm scale)."""
    name = path[-1]
    if name == "scale":
        return 0.0
    if name == "embed":
        return 1.0 / math.sqrt(shape[-1])
    if len(shape) >= 2:
        return 1.0 / math.sqrt(shape[-2])
    return 0.02


def draw(shapes, seed: int, device,
         rules: Optional[Dict[str, Dict[str, float]]] = None
         ) -> Dict[str, Any]:
    """A plain nested tree (dict keys sorted) of leaves like ``shapes``
    (a tree of ``meta`` tensors), drawn from ``seed`` on ``device``;
    ``rules`` is a configuration's ``draw`` table (leaf name → ``mean``,
    ``std``)."""
    rules = rules or {}
    leaves = list(_leaves(shapes))
    out = _skeleton(shapes)
    by_dtype: Dict[torch.dtype, List] = {}
    for path, t in leaves:
        by_dtype.setdefault(t.dtype, []).append((path, t))
    for i, dt in enumerate(sorted(by_dtype, key=str)):
        group = by_dtype[dt]
        total = sum(t.numel() for _, t in group)
        buf = torch.empty(total, dtype=dt, device=device)
        buf.normal_(generator=generator(seed, device, stream=1 + i))
        off = 0
        for path, t in group:
            view = buf[off:off + t.numel()].view(t.shape)
            off += t.numel()
            rule = rules.get(path[-1])
            std = std_of(path, tuple(t.shape))
            if rule is not None:
                view.mul_(float(rule["std"])).add_(float(rule["mean"]))
            elif std == 0.0:
                view.mul_(0.1).add_(1.0)
            else:
                view.mul_(std)
            _set(out, path, view)
    return out


def tokens(seed: int, index: int, batch: int, seq: int, vocab: int,
           device) -> torch.Tensor:
    """Token ids [batch, seq] int64 of request or step ``index``."""
    g = generator(seed, device, stream=1000 + index)
    return torch.randint(0, vocab, (batch, seq), generator=g, device=device)
