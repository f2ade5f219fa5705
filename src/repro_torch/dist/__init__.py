"""Distribution layer of the port (``repro.dist`` in the JAX package):
sharding rules, train/serve steps, collectives, fault tolerance and
pipeline parallelism, all built on the kernel-actor surface in
``repro_torch.core``.

Modules:

* :mod:`repro_torch.dist.api`         — sharding-hint context managers used
                                        by the model code (``hint``/
                                        ``hint_vocab``/``hint_named``).
* :mod:`repro_torch.dist.sharding`    — the divisibility-aware sharding
                                        rule engine (params, optimizer
                                        state, batches, KV caches) for
                                        a ``DeviceMesh`` and DTensor.
* :mod:`repro_torch.dist.step`        — train/serve step builders (grad
                                        accum, LR schedules, greedy decode).
* :mod:`repro_torch.dist.collectives` — int8-compressed all-reduce with
                                        error feedback, and the wire codec.
* :mod:`repro_torch.dist.fault`       — supervised checkpoint/restart
                                        training and elastic data
                                        parallelism.
* :mod:`repro_torch.dist.pipeline`    — pipeline parallelism from stage
                                        actors, a consumer of
                                        :class:`repro_torch.core.Pipeline`.
"""
from . import api, collectives, fault, pipeline, sharding, step

__all__ = ["api", "collectives", "fault", "pipeline", "sharding", "step"]
