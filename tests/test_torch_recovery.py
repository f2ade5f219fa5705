"""The port's fault tolerance on the CPU: ``tests/test_fault.py``'s
supervised recovery (bit-exact) and elastic data parallelism (re-split
over survivors, held to the single-worker result at loss rtol 1e-5 and
gradients rtol 1e-4 / atol 1e-5, as the JAX test holds its own), on
``ActorSystem(device="cpu")``; and the elastic driver over gradient
workers of a second node of this process (``repro_torch.net``).

``tests/test_fault.py::test_compressed_psum_multidevice`` waits for
``compressed_psum`` on ``torch.distributed`` (ROADMAP A8).
"""
import time

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro_torch import configs
from repro_torch.core import ActorSystem
from repro_torch.data import SyntheticLM
from repro_torch.dist import fault
from repro_torch.dist import step as step_mod
from repro_torch.models import Model
from repro_torch.models.layers import plain_tree
from repro_torch.net import NodeRuntime
from repro_torch.optim import AdamWConfig

CPU = "cpu"


@pytest.fixture(scope="module")
def setup():
    cfg = configs.get_smoke_config("qwen3-1.7b")
    model = Model(cfg, device=CPU)
    ocfg = AdamWConfig(lr=5e-3, weight_decay=0.0)
    data = SyntheticLM(cfg, batch=4, seq=16, seed=9)
    tstep = step_mod.build_train_step(model, ocfg)
    return cfg, model, ocfg, data, tstep


def _grad_fn(model):
    def grad_fn(params, batch):
        loss, _, grads = step_mod.loss_and_grads(model, params, batch)
        return loss, grads
    return grad_fn


def _leaves(tree):
    return pytree.tree_leaves(tree)


def test_recovery_is_bit_exact(setup, tmp_path):
    cfg, model, ocfg, data, tstep = setup
    total = 8

    def fresh_state():
        return step_mod.init_train_state(model, 0, ocfg)

    with ActorSystem(device=CPU) as sys_a:
        trainer = fault.RecoverableTrainer(
            sys_a, tstep, fresh_state(), data, str(tmp_path / "a"),
            ckpt_every=2)
        state_plain = trainer.run(total)
        assert trainer.recoveries == 0

    with ActorSystem(device=CPU) as sys_b:
        trainer = fault.RecoverableTrainer(
            sys_b, tstep, fresh_state(), data, str(tmp_path / "b"),
            ckpt_every=2)
        state_faulted = trainer.run(total, fail_at=5)
        assert trainer.recoveries == 1
        deadline = time.monotonic() + 10      # the supervisor hears the death
        while not trainer._downs and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(trainer._downs) == 1

    assert int(state_plain["step"]) == int(state_faulted["step"]) == total
    for a, b in zip(_leaves(state_plain), _leaves(state_faulted)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_elastic_dp_resplits_on_death(setup):
    cfg, model, ocfg, data, _ = setup
    params = plain_tree(model.init(1))
    grad_fn = _grad_fn(model)
    with ActorSystem(device=CPU) as system:
        driver = fault.ElasticDPDriver(system, grad_fn, n_workers=4,
                                       fail_at={2: 1})  # worker 2 dies @ step 1
        loss0, grads0, used0 = driver.step(params, 0, data.batch_at(0))
        assert used0 == 4
        loss1, grads1, used1 = driver.step(params, 1, data.batch_at(1))
        assert used1 == 3  # re-split over survivors

        # elastic result must equal the single-worker ground truth
        l_ref, g_ref = grad_fn(params, data.batch_at(1))
        np.testing.assert_allclose(loss1, float(l_ref), rtol=1e-5)
        for a, b in zip(_leaves(grads1), _leaves(g_ref)):
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       rtol=1e-4, atol=1e-5)


def test_elastic_dp_over_workers_of_a_second_node(setup):
    """Two gradient workers published by node b, driven from node a
    through ``RemoteActorRef``s; the one that dies at step 1 is re-split
    away and the result is the single-worker one."""
    cfg, model, ocfg, data, _ = setup
    params = plain_tree(model.init(2))
    grad_fn = _grad_fn(model)
    sa = ActorSystem("elastic-a", max_workers=4, device=CPU)
    sb = ActorSystem("elastic-b", max_workers=4, device=CPU)
    na = NodeRuntime(sa, name="a", listen=("127.0.0.1", 0))
    nb = NodeRuntime(sb, name="b")
    try:
        nb.connect(na.address)
        assert na.wait_for_peer("b", 10)
        for i in range(2):
            nb.publish(f"grad{i}", sb.spawn(fault._GradWorker(
                grad_fn, i, {1: 1})))
        workers = [na.remote_actor("b", f"grad{i}") for i in range(2)]
        driver = fault.ElasticDPDriver(sa, None, workers=workers,
                                       step_timeout=60)
        _, _, used0 = driver.step(params, 0, data.batch_at(0))
        loss1, grads1, used1 = driver.step(params, 1, data.batch_at(1))
        assert (used0, used1) == (2, 1)
        l_ref, g_ref = grad_fn(params, data.batch_at(1))
        np.testing.assert_allclose(loss1, float(l_ref), rtol=1e-5)
        assert pytree.tree_structure(grads1) == pytree.tree_structure(g_ref)
        for a, b in zip(_leaves(grads1), _leaves(g_ref)):
            np.testing.assert_allclose(a.numpy(), b.float().numpy(),
                                       rtol=1e-4, atol=1e-5)
    finally:
        na.shutdown()
        nb.shutdown()
        sa.shutdown()
        sb.shutdown()


def test_trainer_binds_the_card_unless_asked(setup):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    cfg, model, ocfg, data, tstep = setup
    with ActorSystem() as system:
        driver = fault.ElasticDPDriver(system, _grad_fn(model), n_workers=1)
        with pytest.raises(LookupError):
            driver.step(plain_tree(model.init(0)), 0, data.batch_at(0))
