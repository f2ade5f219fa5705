"""The port's user examples (``repro_torch.examples``) against the JAX
package's (``examples/*.py``) on the CPU, on the same seeded inputs.

* quickstart: the ``m_mult`` actor's product against the JAX ``m_mult``
  actor's, within 1e-4 (the JAX example's own limit against ``m1 @ m2``);
* wah_indexing: at the default 2**17 values, the words, ``n_words``,
  ``starts`` and ``counts`` of ``repro.indexing.build_wah_index`` and the
  Listing 5 pipeline's ``out`` and ``total``, bit for bit;
* graph_diamond: the diamond's output equal to JAX's, and the same
  ``PortTypeMismatchError`` node path;
* serve_lm: from the JAX example's parameters (``Model.init(key(0))``,
  through ``convert.params_from_jax``), the 32 x 8 greedy tokens equal to
  those of a loop over JAX's ``build_serve_step``, and the logits of the
  port's step fed the example's tokens within
  ``tests/test_torch_decode.py``'s f32 limit (2e-4) of JAX's at each step;
* train_lm: 12 steps with a fault at step 6 from the JAX example's
  initial train state (``convert.train_state_from_jax``), every executed
  step's loss within the train-step limit of
  ``tests/test_torch_training.py`` (rtol 1e-4), and one recovery on both;
* dist_pipeline: ``main`` drives ``net.demo.main`` (two processes on the
  CPU) and prints its summary and PASS line.

The JAX examples are loaded from their files; their ``main`` is not run.
"""
import contextlib
import importlib.util
import io
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import ActorSystem as JActorSystem
from repro.core import Graph as JGraph
from repro.core import PortTypeMismatchError as JPortTypeMismatchError
from repro.data import SyntheticLM as JSyntheticLM
from repro.dist import fault as jfault
from repro.dist import step as jstep
from repro.indexing import build_wah_index as jbuild_wah_index
from repro.indexing import wah_index_pipeline_actors as jpipeline
from repro.models import Model as JModel
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import schedule as jschedule
from repro_torch import configs
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.dist.step import build_serve_step
from repro_torch.examples import (dist_pipeline, graph_diamond, quickstart,
                                  serve_lm, train_lm, wah_indexing)
from repro_torch.models import Model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def jax_example(name: str):
    """The JAX package's ``examples/<name>.py`` as a module (its
    ``__main__`` block does not run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_product_matches_the_jax_m_mult_actor():
    got = quickstart.run(device=CPU)
    jq = jax_example("quickstart")
    with JActorSystem() as system:
        want = np.asarray(system.spawn(jq.m_mult).ask(got["m1"], got["m2"]))
    assert [p.name for p in got["platforms"]] == ["cpu"]
    assert got["result"].shape == (quickstart.MX_DIM,) * 2
    np.testing.assert_allclose(got["result"], want, rtol=1e-4, atol=1e-4)


def test_wah_indexing_matches_the_jax_index_and_pipeline_bit_for_bit():
    got = wah_indexing.run(device=CPU)
    assert got["n"] == 1 << 17
    words, n_words, starts, counts = jbuild_wah_index(
        jnp.asarray(got["values"]), wah_indexing.CARDINALITY)
    assert got["n_words"] == int(n_words)
    np.testing.assert_array_equal(got["words"],
                                  np.asarray(words)[:int(n_words)])
    np.testing.assert_array_equal(got["starts"], np.asarray(starts))
    np.testing.assert_array_equal(got["counts"], np.asarray(counts))
    # the JAX example's draws after the values, in its order
    rng = np.random.default_rng(0)
    rng.integers(0, wah_indexing.CARDINALITY, got["n"])
    k = wah_indexing.PIPE_K
    fills = (rng.integers(0, 2, k) * ((1 << 31) | rng.integers(1, 99, k))
             ).astype(np.uint32)
    lits = rng.integers(1, 2 ** 31, k).astype(np.uint32)
    with JActorSystem() as system:
        out, total = jpipeline(system, k, mode="staged").ask(fills, lits)
    assert got["total"] == int(total)
    assert got["out"].dtype == np.uint32
    np.testing.assert_array_equal(got["out"], np.asarray(out))


def test_graph_diamond_output_and_build_error_match_jax():
    got = graph_diamond.run(device=CPU)
    jg = jax_example("graph_diamond")
    n = graph_diamond.N
    with JActorSystem(max_workers=8) as system:
        g = JGraph(system, name="diamond")
        x = g.source("x", jnp.float32, shape=(n,))
        left, right = g.broadcast(x, 2)
        j1, j2 = g.zip_join(g.apply(jg.double, left), g.apply(jg.sub3, right))
        g.output(g.apply(jg.add2, j1, j2))
        want = np.asarray(g.build().ask(got["input"]))
        bad = JGraph(system, name="bad")
        bad.output(bad.apply(jg.double, bad.source("x", jnp.int32,
                                                   shape=(n,))))
        with pytest.raises(JPortTypeMismatchError) as err:
            bad.build()
    np.testing.assert_array_equal(got["output"], want)
    assert set(got["placements"]) == {"diamond/double", "diamond/sub3",
                                      "diamond/add2"}
    assert got["readbacks"] == 1
    assert got["error"].split(":")[0] == str(err.value).split(":")[0] \
        == "bad/double"
    assert "bad/x" in got["error"] and "int32" in got["error"]


def test_serve_lm_greedy_tokens_match_the_jax_serve_step_loop():
    jcfg = jconfigs.get_smoke_config("qwen3-1.7b")
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    batch, steps = serve_lm.BATCH, serve_lm.STEPS
    step = jax.jit(jstep.build_serve_step(jmodel))
    cache = jmodel.init_cache(batch, steps + 1)
    toks = jnp.zeros((batch, 1), jnp.int32)
    outputs, logits = [np.asarray(toks)], []
    for _ in range(steps):
        toks, lg, cache = step(jparams, cache, toks)
        outputs.append(np.asarray(toks))
        logits.append(np.asarray(lg[:, -1]))
    cfg = configs.get_smoke_config("qwen3-1.7b")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device=CPU)
    got = serve_lm.run(cfg, params, device=CPU)
    assert got["tokens"].shape == (batch, steps + 1)
    # the example returns tokens only: its step's logits are read by
    # feeding the port's step the tokens it returned
    model = Model(cfg, device=CPU)
    step = build_serve_step(model)
    cache = model.init_cache(batch, steps + 1)
    toks = torch.from_numpy(got["tokens"])
    port = []
    with torch.no_grad():
        for t in range(steps):
            _, lg, cache = step(params, cache, toks[:, t:t + 1])
            port.append(lg[:, -1].numpy())
    np.testing.assert_allclose(np.stack(port), np.stack(logits),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(got["tokens"],
                                  np.concatenate(outputs, axis=1))


def test_train_lm_losses_and_recovery_match_the_jax_trainer():
    steps, fail_at = 12, 6
    jcfg = jconfigs.get_smoke_config("llama3-8b")
    jmodel = JModel(jcfg)
    jocfg = JAdamWConfig(lr=3e-3, weight_decay=0.01)
    jstate = jstep.init_train_state(jmodel, jax.random.key(0), jocfg)
    jtrain = jax.jit(jstep.build_train_step(
        jmodel, jocfg,
        lr_schedule=jschedule.warmup_cosine(steps // 10 + 1, steps)))
    jlosses = []

    def logged(state, batch):
        state, m = jtrain(state, batch)
        jlosses.append(float(m["loss"]))
        return state, m

    data = JSyntheticLM(jcfg, batch=8, seq=64, seed=0, noise=0.02)
    with tempfile.TemporaryDirectory() as ckpt_dir, \
            JActorSystem() as system:
        trainer = jfault.RecoverableTrainer(system, logged, jstate, data,
                                            ckpt_dir,
                                            ckpt_every=train_lm.CKPT_EVERY)
        trainer.run(steps, fail_at=fail_at)
    cfg = train_lm.smoke_config("llama3-8b")
    got = train_lm.run(cfg, steps=steps, fail_at=fail_at, device=CPU,
                       state=train_state_from_jax(
                           cfg, jax.tree.map(np.asarray, jstate),
                           device=CPU))
    assert got["steps"] == steps
    assert got["recoveries"] == trainer.recoveries == 1
    # steps 0-5, the fault, the restore of step 0, then steps 0-11
    assert len(got["losses"]) == len(jlosses) == fail_at + steps
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-4)
    assert got["loss_n"] < got["loss0"]


def test_dist_pipeline_main_drives_the_two_process_demo(monkeypatch):
    calls = []
    demo_main = dist_pipeline.demo.main

    def small(**kwargs):
        calls.append(kwargs)
        return demo_main(**{**kwargs, "n": 256, "device": CPU})

    monkeypatch.setattr(dist_pipeline.demo, "main", small)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dist_pipeline.main([])
    assert calls == [{"device": None}]
    text = out.getvalue()
    summary = json.loads(text[:text.index("\nPASS")])
    assert summary["worker_stats"]["spills"] == 1
    assert summary["worker_stats"]["unspills"] == 1
    assert summary["chunks"] == 12
    assert "local" in summary["sources"]
    assert text.rstrip().splitlines()[-1].startswith("PASS: 3-stage")
