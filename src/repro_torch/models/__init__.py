"""Models of the port: the dense, ssm and hybrid decoder families."""
from . import layers, model, steps
from .convert import from_reference
from .model import (DecoderLayer, Model, decode_step, forward, init_caches,
                    init_model, layer_windows, lm_head)
from .steps import make_prefill_step, make_serve_step

__all__ = ["layers", "model", "steps", "Model", "DecoderLayer",
           "init_model", "lm_head", "layer_windows", "forward",
           "init_caches", "decode_step", "make_prefill_step",
           "make_serve_step", "from_reference"]
