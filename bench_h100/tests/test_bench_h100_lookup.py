"""What a configuration finds by name, and that the two configurations
the benchmark had before the lookup read what they read before it: the
weights drawn at ``small_cell`` sizes and the counts at the four cells'
shapes, bit for bit against values taken on the harness before the
lookup (``spec.counts``, ``draw`` tables, ``smoke`` sizes) existed. Every
configuration of the port round-trips through ``spec.model_config``."""
import dataclasses
import hashlib
import itertools
import json

import pytest
import torch

from bench_h100 import spec, traffic, weights

#: sha256 over each leaf's path and bytes, seed 2**33 + 7
WEIGHTS_SHA256 = {
    "qwen3-1.7b.prefill-mixed":
        "a3dfaa3962ab3f57ae95ceef919b95a4d65f28bacbb9c1b6b284dd34497e8fb4",
    "phi3.5-moe.prefill-mixed":
        "344d9d1ed8f7420161b352ab0b4962e54c250765c063aba3b770e43ca781da75",
}

#: (config, batch, seq) → prefill FLOPs, train FLOPs, the forward's B6
#: bound (n_layers launches), as float.hex()
COUNTS = {
    ("qwen3-1.7b", 16, 512): ("0x1.a133800000000p+44", "0x1.38e6a00000000p+46",
                              "0x1.b91e14888e917p-11"),
    ("qwen3-1.7b", 8, 1024): ("0x1.a833800000000p+44", "0x1.3e26a00000000p+46",
                              "0x1.fe82e8c86763fp-11"),
    ("qwen3-1.7b", 4, 2048): ("0x1.b633800000000p+44", "0x1.48a6a00000000p+46",
                              "0x1.fe43285b69967p-10"),
    ("qwen3-1.7b", 2, 4096): ("0x1.d233800000000p+44", "0x1.5da6a00000000p+46",
                              "0x1.fe234824eaafcp-9"),
    ("qwen3-1.7b", 1, 32768): ("0x1.ad19c00000000p+47", "0x1.41d3500000000p+49",
                               "0x1.fe0763f53ba5ep-4"),
    ("phi3.5-moe", 8, 512): ("0x1.8fca000000000p+44", "0x1.2bd7800000000p+46",
                             "0x1.a41ca5d763353p-12"),
    ("phi3.5-moe", 4, 1024): ("0x1.93ca000000000p+44", "0x1.2ed7800000000p+46",
                              "0x1.23b88504cd5dbp-11"),
    ("phi3.5-moe", 2, 2048): ("0x1.9bca000000000p+44", "0x1.34d7800000000p+46",
                              "0x1.2394170faa0cdp-10"),
    ("phi3.5-moe", 1, 4096): ("0x1.abca000000000p+44", "0x1.40d7800000000p+46",
                              "0x1.2381e01518647p-9"),
}

#: each cell's traced FLOPs and B6 bound as the per-layer readers sum them
#: (the prefill cells' ``traced_requests`` of seed 12346; four train
#: steps), as float.hex()
TRACED = {
    "qwen3-1.7b.prefill-mixed": ("0x1.b473800000000p+47",
                                 "0x1.f5968dd36e7c2p-7"),
    "phi3.5-moe.prefill-mixed": ("0x1.9aca000000000p+47",
                                 "0x1.195ed0cc86947p-7"),
    "qwen3-1.7b.prefill-32k": ("0x1.ad19c00000000p+49",
                               "0x1.fe0763f53ba5ep-2"),
    "qwen3-1.7b.train-8x1024": ("0x1.3e26a00000000p+48", None),
}


@pytest.mark.parametrize("workload", sorted(WEIGHTS_SHA256))
def test_weights_at_small_sizes_are_the_bits_drawn_before(workload, small):
    from repro_torch.models import Model
    from repro_torch.models.layers import plain_tree
    cell, cfg = small(spec.load_cell(workload), None)
    shapes = Model(cfg, device="meta").param_shapes()
    params = weights.draw(plain_tree(shapes), 2 ** 33 + 7, "cpu",
                          cell.config.get("draw"))
    h = hashlib.sha256()
    for path, t in weights._leaves(params):
        h.update("/".join(map(str, path)).encode())
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == WEIGHTS_SHA256[workload]


@pytest.mark.parametrize("config,batch,seq", sorted(COUNTS))
def test_counts_are_the_bits_counted_before(config, batch, seq):
    run = spec.load_json(spec.HERE / "configs" / f"{config}.json")["run"]
    c = spec.counts(config)
    got = (c.prefill_flops(run, batch, seq), c.train_flops(run, batch, seq),
           c.flash_bound_s(run, batch, seq))
    assert tuple(v.hex() for v in got) == COUNTS[config, batch, seq]


@pytest.mark.parametrize("workload", sorted(TRACED))
def test_readers_sum_the_bits_summed_before(workload):
    from bench_h100.metrics._common import traced_flash_bound_s, traced_flops
    cell = spec.load_cell(workload)
    mix = cell.traffic
    if mix["kind"] == "prefill":
        tr = {"requests": list(itertools.islice(
            traffic.backlog(mix, 12346, 1 << 30), mix["traced_requests"]))}
    else:
        tr = {"steps": 4}
    ctx = {"cell": cell, "run": cell.config["run"], "trace": tr}
    flops_hex, bound_hex = TRACED[workload]
    assert traced_flops(ctx).hex() == flops_hex
    if bound_hex is not None:
        assert traced_flash_bound_s(ctx).hex() == bound_hex


def test_a_configuration_without_files_of_its_own_takes_the_defaults():
    import bench_h100.reference.model as model
    from bench_h100 import flops
    assert spec.reference("qwen3-1.7b") is model
    assert spec.counts("qwen3-1.7b").prefill_flops is flops.prefill_flops


def test_every_configuration_of_the_port_round_trips():
    from repro_torch import configs
    for arch in configs.ARCHS:
        for cfg in (configs.get_config(arch), configs.get_smoke_config(arch)):
            run = json.loads(json.dumps(dataclasses.asdict(cfg)))
            assert spec.model_config({"run": run}) == cfg, arch


@pytest.mark.parametrize("where", ["top", "ssm", "hybrid"])
def test_an_unknown_key_is_refused_by_name(where):
    from repro_torch import configs
    run = json.loads(json.dumps(dataclasses.asdict(
        configs.get_smoke_config("recurrentgemma-9b"))))
    (run if where == "top" else run[where])["bogus_width"] = 1
    with pytest.raises(KeyError, match="bogus_width"):
        spec.model_config({"run": run})


def test_draw_table_gives_its_mean_and_std_and_leaves_the_rest():
    n = 200_000
    shapes = {"layers": [{"ssm": {
        "a_log": torch.empty(n, device="meta"),
        "dt_bias": torch.empty(n, device="meta"),
        "norm": {"scale": torch.empty(64, device="meta")},
        "in_proj": torch.empty(64, 96, device="meta")}}]}
    rules = {"a_log": {"mean": 1.3863, "std": 0.8},
             "dt_bias": {"mean": -4.6, "std": 1.0}}
    plain = weights.draw(shapes, 2 ** 31 + 3, "cpu")["layers"][0]["ssm"]
    ruled = weights.draw(shapes, 2 ** 31 + 3, "cpu", rules)["layers"][0]["ssm"]
    for name, r in rules.items():
        x = ruled[name].double()
        # five standard errors of the mean and of the std
        assert abs(float(x.mean()) - r["mean"]) < 5 * r["std"] / n ** 0.5
        assert abs(float(x.std()) - r["std"]) < 5 * r["std"] / (2 * n) ** 0.5
        # the same normals as without the table: order and streams kept
        torch.testing.assert_close((ruled[name] - r["mean"]) / r["std"],
                                   plain[name] / 0.02, rtol=1e-4, atol=1e-4)
    assert torch.equal(ruled["in_proj"], plain["in_proj"])
    assert torch.equal(ruled["norm"]["scale"], plain["norm"]["scale"])


@pytest.mark.parametrize("config,sub,kept", [
    ("recurrentgemma-9b", "hybrid", {"pattern": ["rec", "rec", "attn"],
                                     "conv_width": 4}),
    ("mamba2-130m", "ssm", {"expand": 2, "n_groups": 1})])
def test_smoke_sizes_apply_over_small_key_by_key(config, sub, kept, small):
    conf = spec.load_json(spec.HERE / "tests" / "new_family" / "configs" /
                          f"{config}.json")
    base = spec.load_cell("qwen3-1.7b.prefill-mixed")
    cell = dataclasses.replace(base, config_name=config, config=conf)
    cell, cfg = small(cell, None)
    run, smoke = cell.config["run"], conf["smoke"]
    for key, value in smoke.items():
        if isinstance(value, dict):
            assert run[key] == dict(conf["run"][key], **value)
        else:
            assert run[key] == value
    assert {k: run[sub][k] for k in kept} == kept
    assert run["param_dtype"] == "float32"          # SMALL's, kept
    assert cfg == spec.model_config(cell.config)
