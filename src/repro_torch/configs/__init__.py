"""Architecture registry: ``get_config("olmoe-1b-7b")`` etc.

Each module exports CONFIG (the exact public-literature configuration) and
the registry maps dashed arch ids to them.  ``CONFIG.smoke()`` gives the
reduced same-family config used by CPU smoke tests.
"""
from __future__ import annotations

from typing import Dict, List

from ..config import ModelConfig
from . import (olmoe_1b_7b, mixtral_8x22b, whisper_base, qwen2_5_14b,
               granite_34b, qwen3_1_7b, minitron_4b, hymba_1_5b,
               falcon_mamba_7b, internvl2_26b)

_MODULES = [olmoe_1b_7b, mixtral_8x22b, whisper_base, qwen2_5_14b,
            granite_34b, qwen3_1_7b, minitron_4b, hymba_1_5b,
            falcon_mamba_7b, internvl2_26b]

REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return REGISTRY[name[:-len("-smoke")]].smoke()
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_configs() -> List[str]:
    return sorted(REGISTRY)
