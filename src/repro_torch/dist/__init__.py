"""Step builders and collectives of the port (``repro.dist`` in the JAX
package). So far the serve step and the int8 wire codec
(``dist.collectives``); the train steps, compressed all-reduce, sharding
and fault tolerance come with training (ROADMAP A10)."""
from .step import build_serve_step

__all__ = ["build_serve_step"]
