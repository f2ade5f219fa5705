"""Test plumbing only, copied to ``reference/<config>.py`` by
``test_bench_h100_new_family.py``: the port's own plain path
(``attn_impl="ref"``) stands in for a configuration's plain reference, to
show that the harness finds and calls it. A benchmark configuration
brings a reference that imports nothing of the program."""
import torch

from bench_h100 import spec


def exact():
    torch.set_float32_matmul_precision("highest")


def logits_at(params, config, tokens, rows, cols, mode="f32"):
    if mode != "f32":
        raise ValueError(f"the stand-in has no {mode} control")
    from repro_torch.models import Model
    from repro_torch.models.layers import ParamTree
    model = Model(spec.model_config(config), attn_impl="ref",
                  device=tokens.device)
    logits, _ = model.forward(ParamTree(params), {"tokens": tokens})
    return logits[rows, cols].float()
