"""The port's sharding rules, hints and meshes (``repro_torch.dist.
sharding``, ``dist.api``, ``launch.mesh``) against the JAX package's.

The rules read only a mesh's axis names and sizes, so they run here in
one process on :class:`MeshAxes`: every assertion of
``tests/test_sharding.py::_SPEC_CHECKS`` at (2, 8) and (1, 16); then every
leaf spec of all ten configs' ``Model.param_shapes()``, with and without
FSDP, and the batch and cache specs, against what the JAX package's rules
give on a mesh of forced host devices (a subprocess, as
``tests/test_sharding.py`` runs it), a port layer leaf against JAX's
stacked leaf with the layer dim dropped. In four gloo processes (a
``FileStore`` under ``tmp_path``): a 2 x 2 ``DeviceMesh``, qwen3-1.7b's
smoke parameters through ``distribute_tensor`` and back bit for bit,
hints that redistribute a ``DTensor`` inside a context and nowhere else,
and the train step's ``grad_shardings``.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.dist import api, sharding as sh, step as step_mod
from repro_torch.models import Model, train_input_specs
from repro_torch.models.transformer import layer_groups
from repro_torch.optim.adamw import AdamWConfig
from test_torch_collectives import run_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"2x8": ((2, 8), ("data", "model")),
          "1x16": ((1, 16), ("data", "model")),
          "2x4x4": ((2, 4, 4), ("pod", "data", "model"))}
#: the vocabulary is padded to the largest model axis, as the JAX test pads
VOCAB_MULTIPLE = 16
BATCHES = (4, 1)
SEQ = 128


def _axes(name: str) -> sh.MeshAxes:
    shape, axes = MESHES[name]
    return sh.MeshAxes(axes, shape)


# ----------------------------------------------------------------------------
# tests/test_sharding.py::_SPEC_CHECKS, on axis sizes alone
# ----------------------------------------------------------------------------
def test_spec_checks_of_the_jax_rules():
    mesh = _axes("2x8")
    cfg = get_config("llama3-8b")
    model = Model(cfg, vocab=cfg.padded_vocab(8), device="cpu")
    shapes = model.param_shapes()
    explain = {}
    sh.param_shardings(shapes, cfg, mesh, explain=explain)

    def spec(name):
        return explain[name][1]
    # a port layer leaf is JAX's stacked leaf without the layer dim
    assert spec("embed") == ("model", None)
    assert spec("head") == (None, "model")
    assert spec("layers/0/attn/wq") == (None, "model")
    assert spec("layers/0/attn/wo") == ("model", None)
    assert spec("layers/0/mlp/w_out") == ("model", None)
    assert spec("layers/0/norm1/scale") == (None,)

    # FSDP adds 'data' on the largest unsharded big dim
    explain2 = {}
    sh.param_shardings(shapes, cfg, mesh, sh.Plan(fsdp=True),
                       explain=explain2)
    assert explain2["layers/0/mlp/w_up"][1] == ("data", "model")
    assert explain2["layers/0/attn/wo"][1] == ("model", "data")

    # mamba2's in_proj is 3352 wide: 8 divides it, 16 does not
    cfgm = get_config("mamba2-130m")
    shm = Model(cfgm, vocab=cfgm.padded_vocab(8), device="cpu").param_shapes()
    em = {}
    sh.param_shardings(shm, cfgm, mesh, explain=em)
    assert em["layers/0/ssm/in_proj"][1] == (None, "model")
    assert em["layers/0/ssm/out_proj"][1] == ("model", None)
    em16 = {}
    sh.param_shardings(shm, cfgm, _axes("1x16"), explain=em16)
    assert em16["layers/0/ssm/in_proj"][1] == (None, None), \
        "3352 % 16 != 0 must fall back to replication"

    # batch specs: a non-divisible batch replicates
    one = {"tokens": torch.empty((1, 128), dtype=torch.int32, device="meta")}
    assert sh.batch_shardings(one, mesh)["tokens"] == (None, None)
    four = {"tokens": torch.empty((4, 128), dtype=torch.int32,
                                  device="meta")}
    assert sh.batch_shardings(four, mesh)["tokens"] == ("data", None)

    # cache specs: seq-sharded KV needs divisibility
    cache = model.init_cache(4, 128, device="meta")
    cs = sh.cache_shardings(cache, cfg, mesh, sh.Plan(kv_cache="seq"))
    assert cs["groups"][0][0]["k"] == (None, "data", "model", None, None)


def test_param_shapes_are_meta_and_match_init():
    for arch in list_archs():
        cfg = get_smoke_config(arch)
        model = Model(cfg, device="cpu")
        shapes = dict(model.param_shapes().named_parameters())
        params = dict(model.init(0).named_parameters())
        assert shapes.keys() == params.keys()
        for name, t in shapes.items():
            assert t.is_meta, name
            assert (t.shape, t.dtype) == (params[name].shape,
                                          params[name].dtype), name


# ----------------------------------------------------------------------------
# all ten configs against the JAX rules
# ----------------------------------------------------------------------------
_JAX_SPECS = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=32"
    import jax, jax.numpy as jnp
    from repro import configs
    from repro.dist import sharding as sh
    from repro.launch.mesh import make_mesh
    from repro.models import Model, train_input_specs
    meshes, multiple, batches, seq = json.loads(sys.argv[1])

    def enc(spec):
        return [list(e) if isinstance(e, tuple) else e for e in spec]

    out = {}
    for arch in configs.list_archs():
        cfg = configs.get_config(arch)
        model = Model(cfg, vocab=cfg.padded_vocab(multiple))
        shapes = jax.eval_shape(lambda: model.init(jax.random.key(0)))
        if cfg.family == "encdec":
            frames = jax.ShapeDtypeStruct(
                (batches[0], cfg.encdec.n_frames, cfg.d_model),
                jnp.dtype(cfg.compute_dtype))
            cache = jax.eval_shape(
                lambda p, f: model.init_cache(batches[0], seq, p, f),
                shapes, frames)
        else:
            cache = jax.eval_shape(lambda: model.init_cache(batches[0], seq))
        for name, (shape, axes) in meshes.items():
            mesh = make_mesh(tuple(shape), tuple(axes))
            for fsdp in (False, True):
                ex = {}
                sh.param_shardings(shapes, cfg, mesh, sh.Plan(fsdp=fsdp),
                                   explain=ex)
                out[f"{name}/{arch}/params/{fsdp}"] = {
                    k: [rule, enc(spec)] for k, (rule, spec) in ex.items()}
            for b in batches:
                bs = sh.batch_shardings(train_input_specs(cfg, b, seq), mesh)
                out[f"{name}/{arch}/batch/{b}"] = {
                    k: enc(v.spec) for k, v in bs.items()}
            for kv in ("heads", "seq"):
                cs = sh.cache_shardings(cache, cfg, mesh, sh.Plan(kv_cache=kv))
                leaves = jax.tree_util.tree_flatten_with_path(cs)[0]
                out[f"{name}/{arch}/cache/{kv}"] = {
                    sh._path_name(p): enc(v.spec) for p, v in leaves}
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_specs():
    arg = json.dumps([MESHES, VOCAB_MULTIPLE, BATCHES, SEQ])
    r = subprocess.run([sys.executable, "-c", _JAX_SPECS, arg],
                       capture_output=True, text=True, timeout=420,
                       env={**os.environ, "PYTHONPATH": "src"}, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def _named(tree, path: str = "") -> dict:
    """``{path name: spec}`` of a tree of specs (nested dicts and lists,
    a spec a tuple)."""
    prefix = path + "/" if path else ""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path: tree}
    return {k: v for key, sub in items
            for k, v in _named(sub, prefix + str(key)).items()}


def _enc(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _jax_name(cfg, name: str):
    """The JAX leaf a port leaf stands for, and whether JAX stacks it along
    a leading layer dim: ``layers/<i>/...`` is ``groups/<g>/<c>/...``;
    encdec's ``enc/layers/<i>/...`` is ``enc/blocks/...``."""
    parts = name.split("/")
    if cfg.family == "encdec":
        if len(parts) > 2 and parts[1] == "layers":
            return "/".join([parts[0], "blocks"] + parts[3:]), True
        return name, False
    if parts[0] != "layers":
        return name, False
    where = [(gi, ci) for gi, (unit, count) in enumerate(layer_groups(cfg))
             for _ in range(count) for ci in range(len(unit))]
    gi, ci = where[int(parts[1])]
    return "/".join(["groups", str(gi), str(ci)] + parts[2:]), True


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_every_spec_matches_the_jax_rules(jax_specs, arch, mesh_name):
    mesh = _axes(mesh_name)
    cfg = get_config(arch)
    model = Model(cfg, vocab=cfg.padded_vocab(VOCAB_MULTIPLE), device="meta")
    shapes = model.param_shapes()
    for fsdp in (False, True):
        want = jax_specs[f"{mesh_name}/{arch}/params/{fsdp}"]
        explain = {}
        tree = sh.param_shardings(shapes, cfg, mesh, sh.Plan(fsdp=fsdp),
                                  explain=explain)
        seen = set()
        for name, (rule, spec) in explain.items():
            jname, stacked = _jax_name(cfg, name)
            jrule, jspec = want[jname]
            assert (rule, _enc(spec)) == \
                (jrule, jspec[1:] if stacked else jspec), (name, fsdp)
            seen.add(jname)
        assert seen == set(want), set(want) ^ seen
        assert _named(tree).keys() == explain.keys()
    for b in BATCHES:
        specs = sh.batch_shardings(train_input_specs(cfg, b, SEQ), mesh)
        assert {k: _enc(v) for k, v in specs.items()} == \
            jax_specs[f"{mesh_name}/{arch}/batch/{b}"]
    if cfg.family == "encdec":
        frames = torch.empty((BATCHES[0], cfg.encdec.n_frames, cfg.d_model),
                             dtype=cfg.dtype(), device="meta")
        cache = model.init_cache(BATCHES[0], SEQ, params=shapes,
                                 frames=frames)
    else:
        cache = model.init_cache(BATCHES[0], SEQ)
    for kv in ("heads", "seq"):
        got = _named(sh.cache_shardings(cache, cfg, mesh,
                                        sh.Plan(kv_cache=kv)))
        assert {k: _enc(v) for k, v in got.items()} == \
            jax_specs[f"{mesh_name}/{arch}/cache/{kv}"]


def test_opt_state_mirrors_the_params():
    cfg = get_smoke_config("qwen3-1.7b")
    mesh = _axes("2x8")
    psh = sh.param_shardings(Model(cfg, device="cpu").param_shapes(), cfg,
                             mesh)
    assert sh.opt_state_shardings(psh, mesh) == \
        {"m": psh, "v": psh, "count": ()}


# ----------------------------------------------------------------------------
# hints on plain tensors, contexts across threads
# ----------------------------------------------------------------------------
def test_hints_leave_plain_tensors_and_contexts_stay_in_their_thread():
    x = torch.randn(2, 3)
    pin = ("a mesh", ("placements",))
    assert api.hint(x) is x and api.hint_vocab(x) is x
    assert api.hint_named(x, "attn_q") is x
    seen = {}

    def other_thread():
        seen["act"] = api._get("act")
        seen["hint"] = api.hint(x)

    with api.activation_sharding(pin), api.vocab_sharding(pin), \
            api.spec_map({"attn_q": pin}):
        # a plain tensor lies whole on one device: nothing to pin
        assert api.hint(x) is x and api.hint_vocab(x) is x
        assert api.hint_named(x, "attn_q") is x
        assert api._get("act") is pin
        with api.activation_sharding(None):
            assert api._get("act") is None
        assert api._get("act") is pin
        t = threading.Thread(target=other_thread)
        t.start()
        t.join(30)
        assert not t.is_alive()
    assert seen == {"act": None, "hint": x}
    assert api._get("act") is None and api._get("specmap") is None


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "recurrentgemma-9b"])
def test_forward_is_bit_equal_inside_a_context(arch):
    cfg = get_smoke_config(arch)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    want, _ = model.forward(params, {"tokens": tokens})
    pin = ("a mesh", ("placements",))
    for ctx in ((None, None, None), (pin, pin, {"mlp_hidden": pin})):
        with api.activation_sharding(ctx[0]), api.vocab_sharding(ctx[1]), \
                api.spec_map(ctx[2]):
            got, _ = model.forward(params, {"tokens": tokens})
        assert torch.equal(got, want)


def test_grad_shardings_leave_plain_gradients():
    cfg = get_smoke_config("qwen3-1.7b")
    model = Model(cfg, device="cpu")
    ocfg = AdamWConfig()
    state = step_mod.init_train_state(model, 0, ocfg)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    from torch.distributed.tensor import Replicate
    pins = torch.utils._pytree.tree_map(lambda p: (Replicate(),),
                                        state["params"])
    want, _ = step_mod.build_train_step(model, ocfg)(state, batch)
    got, _ = step_mod.build_train_step(model, ocfg,
                                       grad_shardings=pins)(state, batch)
    for a, b in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------------
# a 2 x 2 DeviceMesh over four gloo processes
# ----------------------------------------------------------------------------
_RANK = textwrap.dedent("""
    import json, sys, threading
    import torch, torch.distributed as dist
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import api, sharding as sh, step as step_mod
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.models import Model
    from repro_torch.models.layers import plain_tree
    from repro_torch.optim.adamw import AdamWConfig
    rank, world, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(path, world),
                            rank=rank, world_size=world)
    out = {}
    mesh = make_mesh((2, 2), ("data", "model"))
    out["mesh"] = [list(mesh.mesh_dim_names), list(mesh.shape),
                   mesh.device_type]
    try:
        make_production_mesh()
    except RuntimeError as e:
        out["production"] = str(e)
    # qwen3-1.7b smoke parameters, the same on every rank (seed 0), through
    # distribute_tensor and back
    cfg = get_smoke_config("qwen3-1.7b")
    params = plain_tree(Model(cfg, device="cpu").init(0))
    specs = sh.param_shardings(params, cfg, mesh, sh.Plan(fsdp=True))
    sharded, equal = 0, True
    for t, spec in zip(pytree.tree_leaves(params), pytree.tree_leaves(
            specs, is_leaf=lambda s: isinstance(s, tuple))):
        d = distribute_tensor(t, mesh, sh.placements(spec, mesh))
        sharded += any(isinstance(p, Shard) for p in d.placements)
        full = d.full_tensor()
        equal &= full.dtype == t.dtype and torch.equal(
            full.view(torch.int16) if t.dtype == torch.bfloat16 else full,
            t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
    out["round_trip"], out["sharded"] = bool(equal), sharded
    # hints: a DTensor is redistributed inside a context only
    x = distribute_tensor(torch.arange(64.0).reshape(4, 4, 4), mesh,
                          [Replicate(), Replicate()])
    rows, cols = (mesh, (Shard(0), Replicate())), (mesh, (Shard(1), Shard(2)))
    got = {}
    with api.activation_sharding(rows):
        got["outer"] = api.hint(x).placements
        with api.activation_sharding(cols):
            got["inner"] = api.hint(x).placements
        got["restored"] = api.hint(x).placements
        t = threading.Thread(target=lambda: got.setdefault(
            "thread", api.hint(x).placements))
        t.start(); t.join(60)
        with api.spec_map({"mlp_hidden": cols}):
            got["named"] = api.hint_named(x, "mlp_hidden").placements
            got["unnamed"] = api.hint_named(x, "attn_q").placements
        got["values"] = bool(torch.equal(api.hint(x).full_tensor(),
                                         x.full_tensor()))
    got["after"] = api.hint(x).placements
    out["hints"] = {k: str(v) for k, v in got.items()}
    # the train step's grad_shardings: DTensor gradients pinned to Shard(0)
    class Quadratic:
        device = torch.device("cpu")
        def loss(self, params, batch):
            w = params["w"]
            loss = (w * w).sum().full_tensor()
            return loss, {"ce": loss, "aux": torch.zeros(())}
    w = distribute_tensor(torch.arange(16.0).reshape(4, 4), mesh,
                          [Replicate(), Replicate()])
    ocfg = AdamWConfig()
    zero = torch.zeros((), dtype=torch.int32)
    state = {"params": {"w": w},
             "opt": {"m": {"w": torch.zeros_like(w)},
                     "v": {"w": torch.zeros_like(w)}, "count": zero},
             "step": zero}
    seen = {}
    class Seen(Exception):
        pass
    real_update = step_mod.adamw.update
    def spy(grads, *a, **k):
        seen["grad"] = grads["w"]
        raise Seen
    step_mod.adamw.update = spy
    try:
        step_mod.build_train_step(
            Quadratic(), ocfg,
            grad_shardings={"w": (Shard(0), Replicate())})(state, {})
    except Seen:
        pass
    finally:
        step_mod.adamw.update = real_update
    g = seen["grad"]
    out["grad"] = [str(g.placements),
                   bool(torch.equal(g.full_tensor(), 2 * w.full_tensor()))]
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out))
""")


def test_a_2x2_mesh_of_four_gloo_processes(tmp_path):
    for out in run_world(_RANK, 4, tmp_path):
        assert out["mesh"] == [["data", "model"], [2, 2], "cpu"]
        assert "needs 256 ranks, have 4" in out["production"]
        assert out["round_trip"] and out["sharded"] > 0
        hints = out["hints"]
        assert hints["outer"] == hints["restored"] == \
            "(Shard(dim=0), Replicate())"
        assert hints["inner"] == hints["named"] == \
            "(Shard(dim=1), Shard(dim=2))"
        assert hints["thread"] == hints["unnamed"] == hints["after"] == \
            "(Replicate(), Replicate())"
        assert hints["values"] == "True"
        assert out["grad"] == ["(Shard(dim=0), Replicate())", True]


_PARITY = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import sharding as sh, step as step_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.models.layers import plain_tree
    rank, world, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(path, world),
                            rank=rank, world_size=world)
    cfg = get_smoke_config("qwen3-1.7b")
    model = Model(cfg, vocab=cfg.padded_vocab(4), attn_impl="ref_chunked:16",
                  device="cpu")
    params = plain_tree(model.init(0))
    gen = torch.Generator().manual_seed(1)
    b, s, slots, filled = 4, 32, 64, 20
    batch = {k: torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    cache = model.init_cache(b, slots)
    for unit in cache["groups"]:
        for c in unit:
            for name in ("k", "v"):
                c[name] = torch.randn(c[name].shape, generator=gen)
    cache["len"] = torch.tensor(filled, dtype=torch.int32)
    step = step_mod.build_serve_step(model)

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    def err(got, want):
        return max(float((full(a) - b).abs().max()) for a, b in
                   zip(pytree.tree_leaves(got), pytree.tree_leaves(want)))

    want_logits, _ = model.forward(params, {"tokens": batch["tokens"]})
    want_loss, _, want_grads = step_mod.loss_and_grads(model, params, batch)
    want_decode = step(params, cache, batch["tokens"][:, :1])
    out = {}
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh(shape, ("data", "model"))

        def lay(tree, specs):
            return pytree.tree_map(lambda t, sp: distribute_tensor(
                t, mesh, sh.placements(sp, mesh)), tree, specs,
                is_leaf=lambda x: isinstance(x, torch.Tensor))

        dparams = lay(params, sh.param_shardings(params, cfg, mesh))
        dbatch = lay(batch, sh.batch_shardings(batch, mesh))
        dcache = lay(cache, sh.cache_shardings(
            cache, cfg, mesh, sh.Plan(kv_cache="seq")))
        with implicit_replication():
            logits, _ = model.forward(dparams, {"tokens": dbatch["tokens"]})
            loss, _, grads = step_mod.loss_and_grads(model, dparams, dbatch)
            decode = step(dparams, dcache, dbatch["tokens"][:, :1])
            out["x".join(map(str, shape))] = {
                "prefill": err(logits, want_logits),
                "loss": err(loss, want_loss),
                "grads": err(grads, want_grads),
                "decode": err(decode[1:], want_decode[1:]),
                "tokens": bool(torch.equal(full(decode[0]), want_decode[0])),
                "split": [str(dcache["groups"][0][0]["k"].placements),
                          str(logits.placements)]}
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out))
""")


def test_sharded_values_equal_the_plain_program_on_gloo(tmp_path):
    """The partition pins change where the work runs, not what it computes:
    qwen3-1.7b's smoke prefill logits (chunked attention), a train step's
    loss and every gradient, and a greedy decode step over a cache split on
    its slots (the ``seq`` plan: the partial softmaxes merged by
    all-reduces), its logits, token and new cache, on real CPU tensors
    over four gloo processes, equal the unsharded port's within 1e-5, on a
    2 × 2 mesh and on 1 × 4 (2 KV heads on 4: each device takes the KV
    head its query heads read)."""
    for out in run_world(_PARITY, 4, tmp_path):
        for mesh, got in out.items():
            for part in ("prefill", "loss", "grads", "decode"):
                assert got[part] <= 1e-5, (mesh, part, got)
            assert got["tokens"], mesh
        assert "Shard(dim=2)" in out["2x2"]["split"][0]


_ONE_SEQUENCE = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import api, sharding as sh, step as step_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.models.layers import plain_tree
    rank, world, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(path, world),
                            rank=rank, world_size=world)
    cfg = get_smoke_config("recurrentgemma-9b")
    model = Model(cfg, device="cpu")
    params = plain_tree(model.init(0))
    gen = torch.Generator().manual_seed(2)
    # one sequence 12 tokens in: random recurrent and conv states, a
    # random K/V window
    cache = model.init_cache(1, 24)
    cache = pytree.tree_map(
        lambda t: torch.randn(t.shape, generator=gen) if t.is_floating_point()
        else t, cache)
    cache["len"] = torch.tensor(12, dtype=torch.int32)
    token = torch.randint(0, cfg.vocab_size, (1, 1), generator=gen,
                          dtype=torch.int32)
    step = step_mod.build_serve_step(model)
    want = step(params, cache, token)

    # whether each gate product was split over the idle axes: the split
    # builds its partial sums with _from_local, the plain product does not
    made, split = [0], []
    real_from_local, real_product = api._from_local, api.idle_split_product
    def from_local(*a):
        made[0] += 1
        return real_from_local(*a)
    def product(x, w):
        before = made[0]
        out = real_product(x, w)
        split.append(made[0] > before)
        return out
    api._from_local, api.idle_split_product = from_local, product

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    def err(got, want):
        return max(float((full(a) - b).abs().max()) for a, b in
                   zip(pytree.tree_leaves(got), pytree.tree_leaves(want)))

    out = {}
    for shape in ((2, 2), (4, 1), (1, 4)):
        mesh = make_mesh(shape, ("data", "model"))

        def lay(tree, specs):
            return pytree.tree_map(lambda t, sp: distribute_tensor(
                t, mesh, sh.placements(sp, mesh)), tree, specs,
                is_leaf=lambda x: isinstance(x, torch.Tensor))

        dparams = lay(params, sh.param_shardings(params, cfg, mesh))
        dcache = lay(cache, sh.cache_shardings(cache, cfg, mesh,
                                               sh.Plan(kv_cache="@PLAN@")))
        dtoken = lay({"t": token}, sh.batch_shardings({"t": token}, mesh))
        del split[:]
        with implicit_replication():
            got = step(dparams, dcache, dtoken["t"])
        states = [(c["state"], w["state"])
                  for gc, gw in zip(got[2]["groups"], want[2]["groups"])
                  for c, w in zip(gc, gw) if "state" in c]
        kv = [(g[name], d[name])
              for gg, gd in zip(got[2]["groups"], dcache["groups"])
              for g, d in zip(gg, gd) for name in ("k", "v") if name in g]
        out["x".join(map(str, shape))] = {
            "logits": err(got[1], want[1]),
            "state": err(*zip(*states)),
            "cache": err(got[2], want[2]),
            "token": bool(torch.equal(full(got[0]), want[0])),
            "split": list(split),
            "kv_layout_kept": bool(kv) and all(
                g.placements == d.placements and
                g.to_local().shape == d.to_local().shape for g, d in kv)}
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out))
""")


def _one_sequence(plan: str) -> str:
    """The one-sequence decode of ``_ONE_SEQUENCE`` with its K/V caches
    laid out by ``sh.Plan(kv_cache=plan)``."""
    return _ONE_SEQUENCE.replace("@PLAN@", plan)


def test_one_sequence_rglru_decode_equals_the_plain_program_on_gloo(tmp_path):
    """A recurrentgemma-9b smoke decode step of one sequence, whose batch
    leaves the data axis idle: on 2 × 2 and 4 × 1 each RG-LRU gate product
    (``dist.api.idle_split_product``) splits its rows over the idle data
    axis and ``model``, on 1 × 4 (no idle axis) it stays whole; the
    logits, the new RG-LRU states and the whole new cache (the K/V window
    split on its slots, the ``seq`` plan of a decode cell), on real CPU
    tensors over four gloo processes, equal the unsharded port's within
    1e-5, and the token is the same."""
    gates = 2 * 3                   # w_a and w_i of the 3 recurrent layers
    for out in run_world(_one_sequence("seq"), 4, tmp_path):
        for mesh, got in out.items():
            for part in ("logits", "state", "cache"):
                assert got[part] <= 1e-5, (mesh, part, got)
            assert got["token"], mesh
        assert out["2x2"]["split"] == out["4x1"]["split"] == [True] * gates
        assert out["1x4"]["split"] == [False] * gates


def test_one_sequence_rglru_decode_on_the_heads_plan_equals_the_plain_program_on_gloo(
        tmp_path):
    """The same decode step with the K/V window laid out by the ``heads``
    plan (C13). recurrentgemma-9b's one KV head does not divide the model
    axis, so the caches stay replicated, while the new K/V row comes in
    split on its head dim over ``model``: the write
    (``dist.api.index_copy_``) must keep the cache's layout, as JAX's
    ``dynamic_update_slice`` does, where DTensor's in-place write would
    record the row's and keep the whole shard. On 2 × 2, 4 × 1 and 1 × 4
    the logits, the RG-LRU states and the whole new cache equal the
    unsharded port's within 1e-5, the token is the same, and every new
    K/V leaf keeps the placements and shard shape it came in with."""
    gates = 2 * 3
    for out in run_world(_one_sequence("heads"), 4, tmp_path):
        assert set(out) == {"2x2", "4x1", "1x4"}
        for mesh, got in out.items():
            for part in ("logits", "state", "cache"):
                assert got[part] <= 1e-5, (mesh, part, got)
            assert got["token"] and got["kv_layout_kept"], (mesh, got)
        assert out["2x2"]["split"] == out["4x1"]["split"] == [True] * gates
        assert out["1x4"]["split"] == [False] * gates


_INDEX_COPY = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.dist import api
    from repro_torch.launch.mesh import make_mesh
    rank, world, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(path, world),
                            rank=rank, world_size=world)
    mesh = make_mesh((2, 2), ("data", "model"))
    gen = torch.Generator().manual_seed(0)
    cache = torch.randn(2, 8, 4, 16, generator=gen)     # [B, S, Hkv, D]
    row = torch.randn(2, 1, 4, 16, generator=gen)
    index = torch.tensor([5])
    want = cache.clone().index_copy_(1, index, row)
    R, S = Replicate(), Shard
    out = {}
    for name, dst_p, src_p in (
            ("replicated_cache_head_split_row", (R, R), (R, S(3))),
            ("replicated_cache_batch_split_row", (R, R), (S(0), R)),
            ("head_split_cache_replicated_row", (S(0), S(2)), (R, R)),
            ("head_split_cache_dim_split_row", (S(0), S(2)), (S(0), S(3))),
            ("slot_split_cache_head_split_row", (S(0), S(1)), (R, S(2))),
            ("same_layout", (S(0), S(2)), (S(0), S(2)))):
        dst = distribute_tensor(cache, mesh, dst_p)
        local = tuple(dst.to_local().shape)
        with implicit_replication():
            api.index_copy_(dst, 1, index, distribute_tensor(row, mesh, src_p))
        out[name] = {
            "placements": dst.placements == tuple(dst_p),
            "local": tuple(dst.to_local().shape) == local,
            "err": float((dst.full_tensor() - want).abs().max())}
    plain = cache.clone()
    out["plain"] = {"same_storage": api.index_copy_(plain, 1, index, row)
                    .data_ptr() == plain.data_ptr(),
                    "err": float((plain - want).abs().max())}
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out))
""")


def test_index_copy_keeps_the_cache_layout_on_gloo(tmp_path):
    """``dist.api.index_copy_`` writes one K/V row into a decode cache
    [B, S, Hkv, D] on a 2 × 2 mesh of four gloo processes and leaves the
    cache laid out as it was, whatever the row's layout: replicated, split
    on its heads or on its slots (the written dim), against a row
    replicated or split on another dim; the cache then holds exactly the
    plain ``index_copy_``'s values. A plain tensor is written in place."""
    for out in run_world(_INDEX_COPY, 4, tmp_path):
        for case, got in out.items():
            if case == "plain":
                assert got == {"same_storage": True, "err": 0.0}
                continue
            assert got == {"placements": True, "local": True, "err": 0.0}, \
                (case, got)
