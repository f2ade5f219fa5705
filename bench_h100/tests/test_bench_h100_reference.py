"""The plain reference against the port's plain path at smoke sizes, in
f32 on the CPU: the dense and the MoE forward (with capacity drops), and
one AdamW step."""
import dataclasses

import pytest
import torch

from bench_h100 import spec, weights
from bench_h100.reference import model as ref

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab_size=256, head_dim=16, param_dtype="float32",
             compute_dtype="float32")


def _setup(config_name, **moe):
    conf = spec.load_json(spec.HERE / "configs" / f"{config_name}.json")
    run = dict(conf["run"], **SMALL)
    if "moe" in run:
        run["moe"] = dict(run["moe"], **moe)
    conf = dict(conf, run=run)
    cfg = spec.model_config(conf)
    from repro_torch.models import Model
    from repro_torch.models.layers import plain_tree
    model = Model(cfg, attn_impl="ref", device="cpu")
    params = weights.draw(plain_tree(model.param_shapes()), 5, "cpu")
    return conf, cfg, model, params


@pytest.mark.parametrize("config_name,moe", [
    ("qwen3-1.7b", {}),
    ("phi3.5-moe", dict(n_experts=4, group_size=32, capacity_factor=0.75))])
def test_forward_matches_the_port(config_name, moe):
    conf, cfg, model, params = _setup(config_name, **moe)
    tok = weights.tokens(5, 0, 2, 64, cfg.vocab_size, "cpu")
    from repro_torch.models.layers import ParamTree
    want, _ = model.forward(ParamTree(params), {"tokens": tok})
    rows = torch.tensor([0, 0, 1, 1])
    cols = torch.tensor([0, 17, 40, 63])
    got = ref.logits_at(params, conf, tok, rows, cols)
    torch.testing.assert_close(got, want[rows, cols], rtol=2e-4, atol=2e-4)


def test_moe_capacity_drops_tokens_as_the_port_does():
    conf, cfg, _, params = _setup("phi3.5-moe", n_experts=4, group_size=32,
                                  capacity_factor=0.5)
    run = conf["run"]
    x = torch.randn(2, 64, 64, generator=torch.Generator().manual_seed(0))
    from repro_torch.models import moe as port_moe
    p = params["layers"][0]["moe"]
    want, _ = port_moe.apply_moe(p, cfg, x)
    got = ref.moe_block(p, run, x, ref.Arith())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    # capacity 0.5 x 2 x 32 / 4 = 8 pairs an expert a group: some dropped
    topi, _ = ref.route(run, x.reshape(-1, 64), p["router"], ref.Arith())
    ranks = torch.cat([ref.queue_rank(topi[i:i + 32].reshape(-1), 4)
                       for i in range(0, 128, 32)])
    assert int((ranks >= 8).sum()) > 0


def test_one_adamw_step_matches_the_port():
    conf, cfg, model, params = _setup("qwen3-1.7b")
    import torch.utils._pytree as pytree
    from repro_torch.dist.step import build_train_step
    from repro_torch.optim import AdamWConfig, adamw
    ocfg = AdamWConfig()
    seq = weights.tokens(5, 0, 2, 33, cfg.vocab_size, "cpu")
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    state = {"params": params, "opt": adamw.init(params, ocfg),
             "step": torch.zeros((), dtype=torch.int32)}
    new, metrics = build_train_step(model, ocfg)(state, batch)
    got = ref.train_steps(params, conf, [(batch["tokens"], batch["labels"])],
                          dataclasses.asdict(ocfg))
    assert abs(float(metrics["loss"]) - got["loss"][0]) < 1e-5
    m = pytree.tree_leaves(new["opt"]["m"])
    g_port = [float(t.norm()) / (1 - ocfg.b1) for t in m]
    torch.testing.assert_close(torch.tensor(g_port),
                               torch.tensor(got["grad_norm"]), rtol=1e-4,
                               atol=1e-7)
    d_port = [float((a - b).norm()) for a, b in zip(
        pytree.tree_leaves(new["params"]), pytree.tree_leaves(params))]
    torch.testing.assert_close(torch.tensor(d_port),
                               torch.tensor(got["delta_norm"]), rtol=1e-4,
                               atol=1e-7)
