"""The H100 roofline of a dry-run cell: :mod:`.analysis` holds the card's
peaks and the three terms, :mod:`.counter` counts an eager step's FLOPs,
bytes and collectives op by op (the JAX package's ``hlo_stats``
counterpart)."""
from . import analysis
from .analysis import (CollectiveStats, Roofline, analyze, model_flops_for)

__all__ = ["analysis", "CollectiveStats", "Roofline", "analyze",
           "model_flops_for"]
