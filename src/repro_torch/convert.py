"""Carry data from the JAX package (or any host arrays) into the port.

Data — values, fills, literals and matrices — is made from a seed with
numpy and handed to both packages: :func:`from_jax_arrays` turns such a
tree into tensors on one device with every dtype kept, uint32 and
bfloat16 included, so both packages compute from identical inputs.
:func:`params_from_jax` does the same for a model's parameters, so both
packages run one set of random weights. :func:`cache_from_jax` carries a
decode cache across, so both packages decode from one nonzero cache, and
:func:`train_state_from_jax` a train state, so both packages train from
one state.
"""
from __future__ import annotations

import torch
import torch.utils._pytree as pytree

from .core.memref import as_device_array
from .models import rglru as rglru_mod
from .models import ssm as ssm_mod
from .models.layers import ParamTree, plain_tree
from .models.transformer import layer_groups

__all__ = ["from_jax_arrays", "params_from_jax", "cache_from_jax",
           "train_state_from_jax"]


def from_jax_arrays(tree, device=None):
    """Every array leaf of ``tree`` (numpy arrays or any object with
    ``__array__``, such as a ``jax.Array``) as a tensor on ``device``,
    with its dtype kept. A bfloat16 array (numpy dtype named
    ``bfloat16``) goes through float32, which is exact. ``None`` leaves
    pass through. ``device`` defaults to the current CUDA device
    (:class:`LookupError` without one); pass ``"cpu"`` for the CPU."""
    def convert(leaf):
        if leaf is None:
            return None
        return as_device_array(leaf, device=device)

    return pytree.tree_map(convert, tree)


def params_from_jax(cfg, jax_params, device=None) -> ParamTree:
    """The port's parameters for ``cfg`` from the JAX package's
    ``repro.models.Model(cfg).init(key)`` tree, given as numpy arrays (or
    anything with ``__array__``). Each group's leaves are stacked along a
    leading ``[count, ...]`` axis there (``repro/models/transformer.py:111``;
    the encdec stacks, ``repro/models/encdec.py:51``); here every layer
    becomes a module of its own, in execution order. Every leaf keeps its
    dtype, bfloat16 included, and the experts keep their stacked ``[E, d,
    f]``. ``device`` as in :func:`from_jax_arrays`."""
    return ParamTree(_unstack(cfg, from_jax_arrays(jax_params, device)))


def _layers(tree, groups) -> list:
    """The stacked groups of ``tree`` (``[(unit, count)]`` as
    ``layer_groups`` gives them) as one entry a layer, in execution
    order."""
    layers = []
    for gi, (unit, count) in enumerate(groups):
        for ci in range(count):
            for pi in range(len(unit)):
                layers.append(pytree.tree_map(lambda a: a[ci].clone(),
                                              tree[gi][pi]))
    return layers


def _unstack(cfg, tree) -> dict:
    """A JAX parameter-shaped tree of tensors (stacked groups) in the
    port's layout: one entry of ``layers`` a layer."""
    if cfg.family == "encdec":
        enc, dec = tree["enc"], tree["dec"]
        return {
            "enc": {"layers": _layers([[enc["blocks"]]],
                                      [(("enc",), cfg.encdec.n_enc_layers)]),
                    "final_norm": enc["final_norm"]},
            "dec": {"embed": dec["embed"], "pos_embed": dec["pos_embed"],
                    "layers": _layers([[dec["blocks"]]],
                                      [(("dec",), cfg.n_layers)]),
                    "final_norm": dec["final_norm"]}}
    params = {"embed": tree["embed"],
              "layers": _layers(tree["groups"], layer_groups(cfg)),
              "final_norm": tree["final_norm"]}
    if "head" in tree:
        params["head"] = tree["head"]
    return params


def _check_leaves(cache: dict, want: dict, where: str) -> None:
    """Each leaf of ``cache`` named in ``want`` has the shape there (None:
    any size on that axis); the leaves are exactly those of ``want``."""
    if set(cache) != set(want):
        raise ValueError(f"{where} has leaves {sorted(cache)}; expected "
                         f"{sorted(want)}")
    for name, shape in want.items():
        got = tuple(cache[name].shape)
        if len(got) != len(shape) or any(
                w is not None and g != w for g, w in zip(got, shape)):
            raise ValueError(f"{where} leaf {name!r} has shape {got}; "
                             f"expected {shape} (None: any)")


def _cache_leaves(cfg, kind: str, count: int) -> dict:
    """The leaf shapes of one unit block's stacked cache, batch and cache
    length left open."""
    if kind == "attn":
        kv = (count, None, None, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": kv, "v": kv}
    init = ssm_mod.init_ssm_cache if kind == "ssm" \
        else rglru_mod.init_rglru_cache
    meta = init(cfg, 1, torch.float32, count, "meta")
    return {name: (count, None) + tuple(leaf.shape[2:])
            for name, leaf in meta.items()}


def cache_from_jax(cfg, jax_cache, device=None) -> dict:
    """The port's decode cache from the JAX package's
    ``Model(cfg).init_cache`` / ``decode_step`` cache, given as numpy
    arrays (or anything with ``__array__``). Both packages keep one
    structure — ``{"len": int32 0-d, "groups": [[leaves]]}`` with leaves
    stacked ``[count, B, ...]`` (attention ``k``/``v``, ssm and rec
    ``state``/``conv``), or encdec's ``{"len", "self", "cross"}`` with
    ``k``/``v`` ``[L, B, S, Hkv, Dh]`` — so this converts leaf for leaf
    and checks the structure against ``cfg``. ``device`` as in
    :func:`from_jax_arrays`."""
    cache = from_jax_arrays(jax_cache, device)
    if cfg.family == "encdec":
        kv = (cfg.n_layers, None, None, cfg.n_kv_heads,
              cfg.resolved_head_dim)
        for part in ("self", "cross"):
            _check_leaves(cache[part], {"k": kv, "v": kv}, f"{part} cache")
    else:
        groups = layer_groups(cfg)
        if len(cache["groups"]) != len(groups):
            raise ValueError(f"cache has {len(cache['groups'])} layer "
                             f"groups; {cfg.name} has {len(groups)}")
        for (unit, count), gc in zip(groups, cache["groups"]):
            if len(gc) != len(unit):
                raise ValueError(f"cache group has {len(gc)} blocks; the "
                                 f"unit {unit} has {len(unit)}")
            for kind, c in zip(unit, gc):
                _check_leaves(c, _cache_leaves(cfg, kind, count),
                              f"{kind} cache")
    cache["len"] = cache["len"].to(torch.int32).reshape(())
    return cache


def train_state_from_jax(cfg, jax_state, device=None) -> dict:
    """The port's train state (``dist.step.init_train_state``'s pytree)
    from the JAX package's, given as numpy arrays (or anything with
    ``__array__``): ``params`` and the AdamW ``m`` and ``v`` unstacked as
    :func:`params_from_jax` unstacks the parameters, in
    :func:`~repro_torch.models.layers.plain_tree`'s form; ``count`` and
    ``step`` as int32 0-d tensors. ``device`` as in
    :func:`from_jax_arrays`."""
    tree = from_jax_arrays(jax_state, device)
    opt = tree["opt"]
    return {
        "params": plain_tree(_unstack(cfg, tree["params"])),
        "opt": {"m": plain_tree(_unstack(cfg, opt["m"])),
                "v": plain_tree(_unstack(cfg, opt["v"])),
                "count": opt["count"].to(torch.int32).reshape(())},
        "step": tree["step"].to(torch.int32).reshape(()),
    }
