"""Models of the port: the dense, moe, ssm, hybrid, encdec and vlm
families, their train, prefill and serve steps."""
from . import layers, model, steps
from .convert import from_reference, state_from_reference
from .model import (DecoderLayer, Model, decode_step, encoder_kv, forward,
                    init_caches, init_model, layer_windows, lm_head)
from .steps import (init_state, make_loss_fn, make_prefill_step,
                    make_serve_step, make_train_step, state_shapes)

__all__ = ["layers", "model", "steps", "Model", "DecoderLayer",
           "init_model", "lm_head", "layer_windows", "forward",
           "init_caches", "decode_step", "encoder_kv", "make_prefill_step",
           "make_serve_step", "make_loss_fn", "make_train_step",
           "init_state", "state_shapes", "from_reference",
           "state_from_reference"]
