"""Step builders of the port (``repro.dist`` in the JAX package). Only the
serve step so far; the train steps, sharding and fault tolerance come
with training (ROADMAP A10)."""
from .step import build_serve_step

__all__ = ["build_serve_step"]
