from . import adamw, schedule
from .adamw import AdamWConfig

__all__ = ["adamw", "schedule", "AdamWConfig"]
