"""Model substrate of the port: layers, attention, the dense decoder."""
from .model import Model

__all__ = ["Model"]
