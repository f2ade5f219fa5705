"""Model substrate of the port: layers, attention, the decoder-only
families (dense, moe, ssm, hybrid, vlm) and the encoder–decoder one."""
from .model import Model, serve_input_specs, train_input_specs

__all__ = ["Model", "serve_input_specs", "train_input_specs"]
