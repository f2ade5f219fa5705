"""Model substrate of the port: layers, attention, the dense decoder."""
from .model import Model, serve_input_specs, train_input_specs

__all__ = ["Model", "serve_input_specs", "train_input_specs"]
