from . import checkpoint
from .checkpoint import all_steps, latest_step, restore, save

__all__ = ["checkpoint", "all_steps", "latest_step", "restore", "save"]
