"""Models of the port: the dense decoder family so far."""
from . import layers, model
from .convert import from_reference
from .model import DecoderLayer, Model, init_model, lm_head

__all__ = ["layers", "model", "Model", "DecoderLayer", "init_model",
           "lm_head", "from_reference"]
