from . import adamw
from .adamw import OptState, cosine_schedule, global_norm

__all__ = ["adamw", "OptState", "cosine_schedule", "global_norm"]
