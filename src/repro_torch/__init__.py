"""repro_torch: the OpenCL-actor runtime of ``repro`` ported to PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

Paper: "OpenCL Actors — Adding Data Parallelism to Actor-based Programming
with CAF" (Hiesgen, Charousset, Schmidt; Agere/LNCS 2017). The JAX package
``repro`` beside this one is the reference it is held against; this
package imports neither JAX nor ``repro``.

* :mod:`repro_torch.core` — actors, kernel actors, ``DeviceRef``\\ s,
  ``Pipeline`` and ``Graph``.
* :mod:`repro_torch.kernels` — the CUDA kernels, their wrappers and plain
  PyTorch versions.
* :mod:`repro_torch.indexing` — the WAH bitmap index (paper §4).
* :mod:`repro_torch.convert` — host arrays to tensors.
* :mod:`repro_torch.models` and :mod:`repro_torch.serve` — the dense LM,
  its serving engine and the serve mesh.
* :mod:`repro_torch.net` — nodes, remote actor handles and the
  spill-based wire format across processes.

Entry points run on the CUDA device unless the caller asks for the CPU.
"""
__version__ = "0.1.0"
