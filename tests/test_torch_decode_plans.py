"""Every smoke config's decode step on both K/V cache plans, sharded over
four gloo processes, against the unsharded port.

``sharding.cache_shardings`` lays a decode cache out by ``Plan.kv_cache``:
``"seq"`` splits the K/V slots over ``model`` (a decode cell's plan),
``"heads"`` the KV heads (the default), each only where ``model``
divides the dim. For each of the ten smoke configs, a greedy decode step
of a batch of four from a random cache 12 tokens into 24 slots runs on
2 × 2, 4 × 1 and 1 × 4 meshes on each plan (the batch split over the
data axis); its logits and the whole new cache equal the unsharded
step's within 1e-5, and its tokens are the same. The one-sequence
recurrentgemma-9b cases, with their gate splits, are
``tests/test_torch_sharding.py``'s.
"""
import textwrap

import pytest

from repro_torch.configs import list_archs
from test_torch_collectives import run_world

_DECODE = textwrap.dedent("""
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
    cfg = get_smoke_config("@ARCH@")
    model = Model(cfg, device="cpu")
    params = plain_tree(model.init(0))
    gen = torch.Generator().manual_seed(2)
    if cfg.family == "encdec":
        frames = torch.randn(4, cfg.encdec.n_frames, cfg.d_model,
                             generator=gen)
        cache = model.init_cache(4, 24, params=params, frames=frames)
    else:
        cache = model.init_cache(4, 24)
    cache = pytree.tree_map(
        lambda t: torch.randn(t.shape, generator=gen, dtype=t.dtype)
        if t.is_floating_point() else t, cache)
    cache["len"] = torch.tensor(12, dtype=torch.int32)
    token = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen,
                          dtype=torch.int32)
    step = step_mod.build_serve_step(model)
    want = step(params, cache, token)

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    def err(got, want):
        return max(float((full(a) - b).abs().max()) for a, b in
                   zip(pytree.tree_leaves(got), pytree.tree_leaves(want))
                   if b.is_floating_point())

    out = {}
    for plan in ("seq", "heads"):
        for shape in ((2, 2), (4, 1), (1, 4)):
            mesh = make_mesh(shape, ("data", "model"))

            def lay(tree, specs):
                return pytree.tree_map(lambda t, sp: distribute_tensor(
                    t, mesh, sh.placements(sp, mesh)), tree, specs,
                    is_leaf=lambda x: isinstance(x, torch.Tensor))

            dparams = lay(params, sh.param_shardings(params, cfg, mesh))
            dcache = lay(cache, sh.cache_shardings(
                cache, cfg, mesh, sh.Plan(kv_cache=plan)))
            dtoken = lay({"t": token}, sh.batch_shardings({"t": token}, mesh))
            with implicit_replication():
                got = step(dparams, dcache, dtoken["t"])
            out[plan + "/" + "x".join(map(str, shape))] = {
                "logits": err(got[1], want[1]),
                "cache": err(got[2], want[2]),
                "tokens": bool(torch.equal(full(got[0]), want[0]))}
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out))
""")


@pytest.mark.parametrize("arch", list_archs())
def test_decode_on_both_cache_plans_equals_the_plain_program_on_gloo(
        arch, tmp_path):
    for out in run_world(_DECODE.replace("@ARCH@", arch), 4, tmp_path):
        assert len(out) == 6
        for case, got in out.items():
            assert got["logits"] <= 1e-5 and got["cache"] <= 1e-5, \
                (arch, case, got)
            assert got["tokens"], (arch, case)
