"""The port stands alone: it imports neither JAX nor the JAX package, and
it never binds the CPU unless asked to."""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          timeout=120)


def test_port_imports_no_jax_and_no_repro():
    proc = _run("""
        import sys
        import repro_torch, repro_torch.core, repro_torch.indexing
        import repro_torch.kernels, repro_torch.convert, repro_torch.analysis
        import repro_torch.core.scheduler, repro_torch.configs
        import repro_torch.models, repro_torch.models.transformer
        import repro_torch.examples.mandelbrot_offload
        import repro_torch.serve, repro_torch.serve.engine
        import repro_torch.serve.kvpool, repro_torch.serve.batcher
        import repro_torch.serve.request, repro_torch.serve.stats
        import repro_torch.dist, repro_torch.dist.step
        import repro_torch.launch, repro_torch.launch.serve
        import repro_torch.models.model, repro_torch.models.attention
        import repro_torch.net, repro_torch.net.node, repro_torch.net.wire
        import repro_torch.net.demo, repro_torch.serve.mesh
        import repro_torch.launch.node, repro_torch.launch.serve_mesh
        import repro_torch.dist.collectives
        bad = sorted(m for m in sys.modules
                     if m.startswith("jax") or m == "repro"
                     or m.startswith("repro."))
        print("BAD", bad)
        print("TRITON", "triton" in sys.modules)
    """)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout
    assert "TRITON False" in proc.stdout, proc.stdout


def test_without_a_card_nothing_binds_the_cpu_unasked():
    proc = _run("""
        import numpy as np
        import torch
        torch.cuda.is_available = lambda: False
        from repro_torch.core import ActorSystem, DeviceRef, In, Out, kernel
        from repro_torch.core.memref import default_device
        from repro_torch.convert import from_jax_arrays
        from repro_torch.configs import get_smoke_config
        from repro_torch.kernels import ops
        from repro_torch.models import Model

        def raises(fn):
            try:
                fn()
            except LookupError:
                return True
            return False

        system = ActorSystem(max_workers=1)
        mngr = system.opencl_manager()
        double = kernel(In(torch.float32), Out(torch.float32))(lambda x: 2 * x)
        print("find_device", raises(mngr.find_device))
        print("default_device", raises(default_device))
        print("spawn", raises(lambda: system.spawn(double)))
        print("put", raises(lambda: DeviceRef.put(np.ones(3))))
        print("convert", raises(lambda: from_jax_arrays(np.ones(3))))
        print("mandelbrot", raises(lambda: ops.mandelbrot(
            height=8, width=8, max_iter=2, re_min=-2.0, re_max=1.0,
            im_min=-1.0, im_max=1.0)))
        print("model", raises(lambda: Model(get_smoke_config("qwen3-1.7b"))))
        from repro_torch.launch import serve as launch_serve
        from repro_torch.serve import PagePool
        print("launch_serve", raises(lambda: launch_serve.main(
            ["--arch", "qwen3-1.7b", "--requests", "1", "--steps", "1"])))
        print("launch_paged", raises(lambda: launch_serve.main(
            ["--arch", "qwen3-1.7b", "--paged", "--requests", "1",
             "--steps", "1"])))
        print("page_pool", raises(lambda: PagePool([((1,), "float32")])))
        from repro_torch.dist.collectives import quantize_ref
        from repro_torch.launch import serve_mesh
        from repro_torch.launch.node import run_worker
        from repro_torch.net import NodeRuntime, demo, wire
        print("node", raises(lambda: NodeRuntime(system, name="n")))
        print("run_worker", raises(lambda: run_worker(("127.0.0.1", 1),
                                                      "w")))
        print("net_demo", raises(lambda: demo.main(n=8, chunks=1)))
        print("serve_mesh", raises(lambda: serve_mesh.main(
            ["--duration", "0.1"])))
        print("toy_engine", raises(lambda: serve_mesh.toy_engine(system)))
        print("model_engine", raises(lambda: serve_mesh.model_engine(
            system)))
        print("quantize", raises(lambda: quantize_ref(np.ones(3))))
        spilled = DeviceRef(torch.ones(2)).spill()
        print("decode", raises(lambda: wire.decode(wire.encode((spilled,)))))
        with ActorSystem(max_workers=1, device="cpu") as cpu_system:
            node = NodeRuntime(cpu_system, name="c")
            print("asked_node", node.unspill_device)
            node.shutdown()
        print("asked_launch", launch_serve.main(
            ["--arch", "qwen3-1.7b", "--requests", "2", "--batch", "2",
             "--steps", "2", "--device", "cpu"]))
        print("devices", mngr.devices())
        cpu = mngr.find_device(platform="cpu")
        print("cpu", cpu.name, cpu.torch_device)
        w = system.spawn(double, device="cpu")
        print("asked", w.ask(np.ones(2, np.float32)).tolist())
        system.shutdown()
        with ActorSystem(max_workers=1, device="cpu") as cpu_system:
            print("system", cpu_system.opencl_manager().find_device().name)
    """)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    for name in ("find_device", "default_device", "spawn", "put", "convert",
                 "mandelbrot", "model", "launch_serve", "launch_paged",
                 "page_pool", "node", "run_worker", "net_demo",
                 "serve_mesh", "toy_engine", "model_engine", "quantize",
                 "decode"):
        assert f"{name} True" in out, out
    assert "devices []" in out
    assert "cpu cpu:0 cpu" in out
    assert "asked [2.0, 2.0]" in out
    assert "system cpu:0" in out
    assert "asked_launch 0" in out
    assert "asked_node cpu" in out


def test_find_device_raises_lookup_error_here():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from repro_torch.core import ActorSystem
    with ActorSystem(max_workers=1) as system:
        with pytest.raises(LookupError):
            system.opencl_manager().find_device()
