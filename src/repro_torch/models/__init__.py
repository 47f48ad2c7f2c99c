"""The port's LM scaffold: the serving path of the ported architectures."""
from .config import ModelConfig
from .model import Model
from .params import params_from_jax

__all__ = ["Model", "ModelConfig", "params_from_jax"]
