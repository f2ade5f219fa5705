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
    leading ``[count, ...]`` axis there (``repro/models/transformer.py:111``);
    here every layer becomes a module of its own, in execution order.
    Dtypes are kept, bfloat16 included. ``device`` as in
    :func:`from_jax_arrays`."""
    return ParamTree(_unstack(cfg, from_jax_arrays(jax_params, device)))


def _unstack(cfg, tree) -> dict:
    """A JAX parameter-shaped tree of tensors (stacked groups) in the
    port's layout: one entry of ``layers`` a layer."""
    layers = []
    for gi, (unit, count) in enumerate(layer_groups(cfg)):
        group = tree["groups"][gi]
        for ci in range(count):
            for pi in range(len(unit)):
                layers.append(pytree.tree_map(lambda a: a[ci].clone(),
                                              group[pi]))
    params = {"embed": tree["embed"], "layers": layers,
              "final_norm": tree["final_norm"]}
    if "head" in tree:
        params["head"] = tree["head"]
    return params


def cache_from_jax(cfg, jax_cache, device=None) -> dict:
    """The port's decode cache from the JAX package's
    ``Model(cfg).init_cache`` / ``decode_step`` cache, given as numpy
    arrays (or anything with ``__array__``). Both packages keep one
    structure, ``{"len": int32 0-d, "groups": [[{"k", "v"}]]}`` with
    leaves ``[count, B, S, Hkv, Dh]``, so this converts leaf for leaf and
    checks the structure against ``cfg``. ``device`` as in
    :func:`from_jax_arrays`."""
    cache = from_jax_arrays(jax_cache, device)
    groups = layer_groups(cfg)
    if len(cache["groups"]) != len(groups):
        raise ValueError(f"cache has {len(cache['groups'])} layer groups; "
                         f"{cfg.name} has {len(groups)}")
    for (unit, count), gc in zip(groups, cache["groups"]):
        if len(gc) != len(unit):
            raise ValueError(f"cache group has {len(gc)} blocks; the unit "
                             f"{unit} has {len(unit)}")
        for c in gc:
            for name in ("k", "v"):
                shape = tuple(c[name].shape)
                if (len(shape) != 5 or shape[0] != count or
                        shape[3:] != (cfg.n_kv_heads, cfg.resolved_head_dim)):
                    raise ValueError(
                        f"cache leaf {name!r} has shape {shape}; expected "
                        f"[{count}, B, S, {cfg.n_kv_heads}, "
                        f"{cfg.resolved_head_dim}]")
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
