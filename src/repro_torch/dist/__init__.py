"""Step builders, fault tolerance and collectives of the port
(``repro.dist`` in the JAX package): the train and serve steps
(``dist.step``), supervised recovery and elastic data parallelism
(``dist.fault``), and the int8 wire codec (``dist.collectives``). The
compressed all-reduce, sharding and pipeline stages are still to be
ported (ROADMAP A10)."""
from .step import build_serve_step, build_train_step, init_train_state

__all__ = ["build_serve_step", "build_train_step", "init_train_state"]
