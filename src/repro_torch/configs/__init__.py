"""Assigned-architecture registry (public-literature pool, see DESIGN.md §5).

The same ten configurations as the JAX package's ``configs``.  Of their
families the port runs ``hybrid`` (zamba2-2.7b) so far; the model zoo
raises ``NotImplementedError`` for the others.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (
    deepseek_coder_33b,
    gemma_2b,
    granite_34b,
    kimi_k2_1t_a32b,
    olmoe_1b_7b,
    qwen2_vl_7b,
    seamless_m4t_medium,
    stablelm_3b,
    xlstm_125m,
    zamba2_2_7b,
)
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import SHAPES, InputShape

_MODULES = [
    deepseek_coder_33b,
    olmoe_1b_7b,
    qwen2_vl_7b,
    seamless_m4t_medium,
    gemma_2b,
    stablelm_3b,
    zamba2_2_7b,
    xlstm_125m,
    kimi_k2_1t_a32b,
    granite_34b,
]

ARCHS: Dict[str, object] = {m.ARCH_ID: m for m in _MODULES}


def list_archs() -> List[str]:
    return list(ARCHS.keys())


def get_config(arch_id: str) -> ModelConfig:
    return ARCHS[arch_id].config()


def get_smoke(arch_id: str) -> ModelConfig:
    return ARCHS[arch_id].smoke()

