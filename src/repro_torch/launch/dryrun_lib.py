"""Dry-run cells: (arch × input-shape × mesh) → counts of one step and
its roofline — the port of the JAX package's ``repro/launch/dryrun_lib.py``.

JAX lowers and compiles each cell for placeholder devices. Eager PyTorch
has no compile step, so a cell is *run*: the model is built on ``meta``
tensors (shapes and dtypes, no storage), its parameters, optimizer
state, batch and cache are laid out as ``DTensor``s over a
``DeviceMesh`` by ``dist/sharding.py``'s rules, and the step runs once
under ``implicit_replication()``, :class:`~repro_torch.roofline.counter.
OpCounter` and ``CommDebugMode``. Nothing is computed and nothing is
allocated, so a 340 B-parameter cell runs on a laptop; what it needs is a
process group as large as the mesh, which ``launch/dryrun.py`` fakes.
Importing this module touches no process group.

The plan's attention names are the port's: ``xla`` → ``ref`` and
``xla_chunked:512`` → ``ref_chunked:512``. The flash-attention kernel
is never on the dry-run path, as JAX's dry run never runs Pallas.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, Optional

import torch
import torch.utils._pytree as pytree

from .. import configs
from ..configs.base import ModelConfig
from ..dist import api as dist_api
from ..dist import sharding as sh
from ..dist import step as step_mod
from ..models import Model
from ..models.layers import plain_tree
from ..models.model import train_input_specs
from ..optim import AdamWConfig
from ..roofline import analysis as roof
from ..roofline.counter import OpCounter

__all__ = ["ARTIFACT_DIR", "CellPlan", "plan_for", "lower_cell", "run_cells",
           "device_cell", "argument_bytes", "local_shape"]

ARTIFACT_DIR = os.environ.get("REPRO_DRYRUN_DIR", "experiments/dryrun_torch")


@dataclasses.dataclass
class CellPlan:
    """Per-cell distribution knobs (overridable — the §Perf lever set)."""

    grad_accum: int = 1
    accum_dtype: str = "float32"
    opt_dtype: str = "float32"
    kv_cache: str = "heads"          # decode KV layout: heads | seq
    seq_activations: bool = False    # Megatron-SP residual stream
    tp_hints: bool = False           # pin TP projection outputs (Megatron)
    fsdp: bool = False               # ZeRO param+opt sharding over 'data'
    attn_impl: str = "ref"           # ref | ref_chunked[:q_chunk]
    remat: str = "full"

    def to_dict(self):
        return dataclasses.asdict(self)


_ACT_BUDGET = 4.0e9   # rematted residual-stream bytes per device (train)
_BIG_PARAMS = 90e9    # switch optimizer/accum state to bf16 above this


def plan_for(cfg: ModelConfig, shape_name: str, mesh,
             overrides: Optional[Dict[str, Any]] = None) -> CellPlan:
    """The JAX package's decisions for one cell; ``mesh`` is a
    ``DeviceMesh`` or a :class:`~repro_torch.dist.sharding.MeshAxes`."""
    seq, global_batch, kind = configs.SHAPES[shape_name]
    plan = CellPlan()
    sizes = _mesh_axis_sizes(mesh)
    msize = sizes.get("model", 1)
    dp = math.prod(sizes[a] for a in sh.data_axes(mesh))
    plan.fsdp = cfg.param_count() >= 25e9
    if kind == "train":
        big = cfg.param_count() >= _BIG_PARAMS
        plan.opt_dtype = "bfloat16" if big else "float32"
        plan.accum_dtype = "bfloat16" if big else "float32"
        plan.seq_activations = cfg.d_model >= 8192 and seq % msize == 0
        shard_div = msize if plan.seq_activations else 1
        layers = cfg.n_layers + (cfg.encdec.n_enc_layers or 0)
        per_row = seq * cfg.d_model * 2 * max(layers, 1) / shard_div
        rows_budget = max(int(_ACT_BUDGET // max(per_row, 1)), 1)
        if plan.seq_activations:
            rows_budget = 1
        accum = 1
        while accum < global_batch // dp and \
                (global_batch // (accum * dp)) > rows_budget:
            accum *= 2
        plan.grad_accum = accum
    elif kind == "prefill":
        plan.attn_impl = "ref_chunked:512"
    else:  # decode
        plan.kv_cache = "seq"
    for k, v in (overrides or {}).items():
        setattr(plan, k, v)
    return plan


def _mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _model_for(cfg: ModelConfig, mesh, plan: CellPlan, seq: int,
               device="meta") -> Model:
    msize = _mesh_axis_sizes(mesh)["model"]
    padded_vocab = cfg.padded_vocab(msize)
    cfg = dataclasses.replace(cfg, remat=plan.remat)
    return Model(cfg, vocab=padded_vocab, attn_impl=plan.attn_impl,
                 max_dec_len=max(448, seq), device=device)


# ----------------------------------------------------------------------------
# laying meta tensors out as DTensors
# ----------------------------------------------------------------------------
def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one device's shard of a ``shape`` tensor laid out by
    ``spec`` over ``mesh`` (a ``DeviceMesh`` or a ``MeshAxes``). The rules
    shard only dims that split evenly; any other raises ``ValueError``."""
    from torch.distributed.tensor import Shard
    local = list(shape)
    for size, p in zip(tuple(mesh.shape), sh.placements(spec, mesh)):
        if isinstance(p, Shard):
            if local[p.dim] % size:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split {size} ways")
            local[p.dim] //= size
    return tuple(local)


def _sharded(t: torch.Tensor, spec, mesh, dtype=None):
    """A DTensor of ``t``'s global shape with ``spec``'s placements over
    ``mesh``, whose local shard is a fresh tensor on ``t``'s device."""
    from torch.distributed.tensor import DTensor
    shard = torch.empty(local_shape(t.shape, spec, mesh),
                        dtype=dtype or t.dtype, device=t.device)
    return DTensor.from_local(shard, mesh, sh.placements(spec, mesh),
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _lay_out(tree, specs, mesh, dtype=None):
    return pytree.tree_map(lambda t, s: _sharded(t, s, mesh, dtype), tree,
                           specs)


def argument_bytes(*trees) -> int:
    """The local bytes of every tensor leaf of ``trees`` (a DTensor's
    local shard; a plain tensor whole)."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in pytree.tree_leaves(trees):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if isinstance(t, DTensor) else t
            total += local.numel() * local.element_size()
    return total


def _sharding(mesh, spec):
    return (mesh, sh.placements(spec, mesh))


def _tp_spec_map(cfg, mesh, dp):
    """Megatron-style output pins for the TP projections: heads / hidden
    sharded on 'model' (when divisible), batch on the data axes."""
    msize = _mesh_axis_sizes(mesh)["model"]
    h_ok = cfg.n_heads and cfg.n_heads % msize == 0
    kv_ok = cfg.n_kv_heads and cfg.n_kv_heads % msize == 0
    ff_ok = cfg.d_ff and cfg.d_ff % msize == 0
    return {
        "attn_q": _sharding(mesh, (dp, None,
                                   sh.MODEL_AXIS if h_ok else None, None)),
        "attn_kv": _sharding(mesh, (dp, None,
                                    sh.MODEL_AXIS if kv_ok else None, None)),
        "mlp_hidden": _sharding(mesh, (dp, None,
                                       sh.MODEL_AXIS if ff_ok else None)),
    }


# ----------------------------------------------------------------------------
# the three kinds of step
# ----------------------------------------------------------------------------
def _presplit_specs(batch_specs, accum: int):
    """[B, ...] → [A, B/A, ...]; positions [3,B,S] → [A, 3, B/A, S]."""
    out = {}
    for k, v in batch_specs.items():
        if k == "positions":
            _, b, s = v.shape
            shape = (accum, 3, b // accum, s)
        else:
            shape = (accum, v.shape[0] // accum) + tuple(v.shape[1:])
        out[k] = torch.empty(shape, dtype=v.dtype, device=v.device)
    return out


def _presplit_shardings(batch_specs, mesh):
    out = {}
    for k, v in batch_specs.items():
        if k == "positions":           # [A, 3, B/A, S]
            out[k] = (None, None, sh._dp_spec(mesh, v.shape[2]), None)
        else:                           # [A, B/A, ...]
            out[k] = (None, sh._dp_spec(mesh, v.shape[1])) + \
                (None,) * (len(v.shape) - 2)
    return out


class _Sharded:
    """A cell's inputs as DTensors over ``mesh`` with ``meta`` shards."""

    def __init__(self, mesh):
        self.mesh = mesh

    def params(self, model, shapes, specs):
        return _lay_out(shapes, specs, self.mesh)

    def zeros(self, t, spec, dtype=None):
        return _sharded(t, spec, self.mesh, dtype)

    def data(self, t, spec, high: int):
        return _sharded(t, spec, self.mesh)

    def cache(self, model, params, shapes, batch: int, seq: int, plan_obj):
        cfg = model.cfg
        if cfg.family == "encdec":
            # the cache's shapes only: the encoder's prefill is not the step
            frames = torch.empty((batch, cfg.encdec.n_frames, cfg.d_model),
                                 dtype=cfg.dtype(), device="meta")
            cache = model.init_cache(batch, seq, params=shapes, frames=frames)
        else:
            cache = model.init_cache(batch, seq, device="meta")
        return _lay_out(cache, sh.cache_shardings(cache, cfg, self.mesh,
                                                  plan_obj), self.mesh)


class _OnDevice:
    """A cell's inputs as plain tensors on the model's device: parameters
    from ``model.init(seed)``, zero optimizer state and cache, integer
    inputs drawn below their bound and float inputs from a normal, both
    from a generator seeded with ``seed``."""

    def __init__(self, device, seed: int):
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.seed = seed

    def params(self, model, shapes, specs):
        return plain_tree(model.init(self.seed))

    def zeros(self, t, spec, dtype=None):
        return torch.zeros(t.shape, dtype=dtype or t.dtype,
                           device=self.device)

    def data(self, t, spec, high: int):
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=self.gen,
                               device=self.device).to(t.dtype)
        return torch.randint(0, high, t.shape, generator=self.gen,
                             dtype=t.dtype, device=self.device)

    def cache(self, model, params, shapes, batch: int, seq: int, plan_obj):
        cfg = model.cfg
        if cfg.family == "encdec":
            frames = torch.randn((batch, cfg.encdec.n_frames, cfg.d_model),
                                 generator=self.gen, device=self.device)
            return model.init_cache(batch, seq, params=params,
                                    frames=frames.to(cfg.dtype()))
        return model.init_cache(batch, seq)


def _batch(cfg, place, specs, shardings, seq: int):
    high = {"positions": seq}
    return {k: place.data(v, shardings[k], high.get(k, cfg.vocab_size))
            for k, v in specs.items()}


def _train_cell(model: Model, mesh, plan: CellPlan, seq: int,
                global_batch: int, place):
    cfg = model.cfg
    ocfg = AdamWConfig(state_dtype=plan.opt_dtype)
    shapes = plain_tree(model.param_shapes())
    p_spec = sh.param_shardings(shapes, cfg, mesh, sh.Plan(fsdp=plan.fsdp))
    scalar = torch.zeros((), dtype=torch.int32, device="meta")
    sdt = getattr(torch, plan.opt_dtype)
    zeros = lambda dt: pytree.tree_map(
        lambda t, s: place.zeros(t, s, dt), shapes, p_spec)
    state = {"params": place.params(model, shapes, p_spec),
             "opt": {"m": zeros(sdt), "v": zeros(sdt),
                     "count": place.zeros(scalar, ())},
             "step": place.zeros(scalar, ())}
    batch_specs = train_input_specs(cfg, global_batch, seq)
    presplit = plan.grad_accum > 1
    if presplit:
        batch_specs = _presplit_specs(batch_specs, plan.grad_accum)
        b_spec = _presplit_shardings(batch_specs, mesh)
    else:
        b_spec = sh.batch_shardings(batch_specs, mesh)
    batch = _batch(cfg, place, batch_specs, b_spec, seq)

    grad_places = pytree.tree_map(lambda s: sh.placements(s, mesh), p_spec,
                                  is_leaf=lambda s: isinstance(s, tuple))
    train_step = step_mod.build_train_step(
        model, ocfg, grad_accum=plan.grad_accum, accum_dtype=plan.accum_dtype,
        presplit=presplit, grad_shardings=grad_places)
    mb_rows = global_batch // max(plan.grad_accum, 1)
    dp = sh._dp_spec(mesh, mb_rows)
    act = _sharding(mesh, (dp, sh.MODEL_AXIS if plan.seq_activations
                           else None, None))
    vocab = _sharding(mesh, (dp, None, sh.MODEL_AXIS))
    spec_map = _tp_spec_map(cfg, mesh, dp) if plan.tp_hints else None

    def run():
        with dist_api.activation_sharding(act if plan.seq_activations
                                          else None), \
                dist_api.vocab_sharding(vocab), \
                dist_api.spec_map(spec_map):
            return train_step(state, batch)

    return run, (state, batch)


def _prefill_cell(model: Model, mesh, plan: CellPlan, seq: int,
                  global_batch: int, place):
    cfg = model.cfg
    shapes = plain_tree(model.param_shapes())
    p_spec = sh.param_shardings(shapes, cfg, mesh, sh.Plan(fsdp=plan.fsdp))
    params = place.params(model, shapes, p_spec)
    batch_specs = train_input_specs(cfg, global_batch, seq)
    batch_specs.pop("labels")
    batch = _batch(cfg, place, batch_specs,
                   sh.batch_shardings(batch_specs, mesh), seq)

    def run():
        logits, _ = model.forward(params, batch)
        return logits[:, -1, :]  # last-position logits (serving prefill)

    return run, (params, batch)


def _decode_cell(model: Model, mesh, plan: CellPlan, seq: int,
                 global_batch: int, place):
    cfg = model.cfg
    shapes = plain_tree(model.param_shapes())
    plan_obj = sh.Plan(kv_cache=plan.kv_cache, fsdp=plan.fsdp)
    p_spec = sh.param_shardings(shapes, cfg, mesh, plan_obj)
    params = place.params(model, shapes, p_spec)
    cache = place.cache(model, params, shapes, global_batch, seq, plan_obj)
    tok = torch.empty((global_batch, 1), dtype=torch.int32, device="meta")
    tokens = place.data(tok, (sh._dp_spec(mesh, global_batch), None),
                        cfg.vocab_size)
    serve_step = step_mod.build_serve_step(model)
    return (lambda: serve_step(params, cache, tokens)), (params, cache, tokens)


_CELLS = {"train": _train_cell, "prefill": _prefill_cell,
          "decode": _decode_cell}


def device_cell(cfg: ModelConfig, shape_name: str, device, *, seed: int = 0,
                plan_overrides: Optional[Dict[str, Any]] = None):
    """The step :func:`lower_cell` counts on a 1 × 1 mesh, on plain
    tensors on ``device`` (one card, no process group): ``(run, args,
    plan)``, where ``run()`` takes the step once on ``args`` (the
    parameters, optimizer state, batch and cache it reads)."""
    mesh = sh.MeshAxes(("data", "model"), (1, 1))
    seq, global_batch, kind = configs.SHAPES[shape_name]
    plan = plan_for(cfg, shape_name, mesh, plan_overrides)
    model = _model_for(cfg, mesh, plan, seq, device=device)
    run, args = _CELLS[kind](model, mesh, plan, seq, global_batch,
                             _OnDevice(model.device, seed))
    return run, args, plan


# ----------------------------------------------------------------------------
def lower_cell(arch: str, shape_name: str, mesh, mesh_name: str, *,
               plan_overrides: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
    """Run one cell on ``meta`` DTensors over ``mesh`` and return its
    report: ``status`` ("counted" or "skipped"), the plan, the step's
    local argument bytes and peak live bytes, and the roofline."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = configs.get_config(arch)
    if not configs.shape_applicable(cfg, shape_name):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped",
                "reason": "long_500k needs sub-quadratic attention"}
    seq, global_batch, kind = configs.SHAPES[shape_name]
    plan = plan_for(cfg, shape_name, mesh, plan_overrides)
    model = _model_for(cfg, mesh, plan, seq)
    chips = math.prod(tuple(mesh.shape))
    msize = _mesh_axis_sizes(mesh)["model"]
    seq_dims = {seq, seq // msize, 512, 1024, 2048}

    t0 = time.monotonic()
    run, args = _CELLS[kind](model, mesh, plan, seq, global_batch,
                             _Sharded(mesh))
    comm = CommDebugMode()
    with implicit_replication(), comm, \
            OpCounter("meta", seq_dims=seq_dims) as counter:
        out = run()
    del out
    stats = counter.stats
    memory = {"argument_size_in_bytes": float(argument_bytes(args)),
              "temp_size_in_bytes": float(stats.peak_live_bytes)}
    rl = roof.analyze(
        stats, arch=arch, shape=shape_name, mesh_name=mesh_name, chips=chips,
        model_flops=roof.model_flops_for(cfg, shape_name, seq, global_batch,
                                         kind),
        step_kind=kind, memory=memory)
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "kind": kind, "chips": chips, "plan": plan.to_dict(),
            "run_s": round(time.monotonic() - t0, 2), "status": "counted",
            "comm_debug_count": comm.get_total_counts(),
            "roofline": rl.to_dict()}


def run_cells(arch_list, shape_list, *, multi_pod_check: bool = True,
              out_dir: str = ARTIFACT_DIR,
              plan_overrides: Optional[Dict] = None,
              verbose: bool = True) -> Dict[str, Any]:
    """Every (arch, shape) on the (16, 16) production mesh and, with
    ``multi_pod_check``, the (2, 16, 16) one; one JSON a cell under
    ``out_dir``. A cell that raises is reported ``FAILED`` with its error
    and the run goes on."""
    from .mesh import make_production_mesh
    os.makedirs(out_dir, exist_ok=True)
    results = {}
    meshes = [(make_production_mesh(multi_pod=False), "1pod-256")]
    if multi_pod_check:
        meshes.append((make_production_mesh(multi_pod=True), "2pod-512"))
    for arch in arch_list:
        for shape in shape_list:
            for mesh, mname in meshes:
                tag = f"{arch}__{shape}__{mname}"
                try:
                    rep = lower_cell(arch, shape, mesh, mname,
                                     plan_overrides=plan_overrides)
                except Exception as exc:  # lint: a failed cell is reported, the run goes on
                    rep = {"arch": arch, "shape": shape, "mesh": mname,
                           "status": "FAILED", "error": repr(exc)[:2000]}
                results[tag] = rep
                with open(os.path.join(out_dir, tag + ".json"), "w") as f:
                    json.dump(rep, f, indent=1)
                if verbose:
                    rl = rep.get("roofline", {})
                    print(f"[{rep['status']:9s}] {tag} "
                          f"run={rep.get('run_s', '-')}s "
                          f"bottleneck={rl.get('bottleneck', '-')} "
                          f"err={rep.get('error', '')[:120]}", flush=True)
    return results
