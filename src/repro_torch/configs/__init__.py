"""Assigned-architecture registry (public-literature pool, see DESIGN.md §5).

The same ten configurations as the JAX package's ``configs``, and the
same sliding-window variant for long contexts (:func:`config_for_shape`).
The port's model zoo runs every family among them: dense, hybrid, moe,
ssm, vlm and audio.
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



# archs whose attention is full/quadratic: long_500k runs via a
# sliding-window variant (DESIGN.md §5); seamless skips long_500k entirely.
FULL_ATTENTION_ARCHS = {
    "deepseek-coder-33b", "olmoe-1b-7b", "qwen2-vl-7b", "gemma-2b",
    "stablelm-3b", "kimi-k2-1t-a32b", "granite-34b",
}
LONG_CONTEXT_SKIP = {"seamless-m4t-medium"}
LONG_CONTEXT_WINDOW = 4096


def config_for_shape(arch_id: str, shape_name: str) -> ModelConfig:
    """Resolve the config actually run for (arch, shape) — applies the
    sliding-window variant for full-attention archs on long_500k."""
    cfg = get_config(arch_id)
    if shape_name == "long_500k":
        if arch_id in LONG_CONTEXT_SKIP:
            raise ValueError(f"{arch_id} skips long_500k (DESIGN.md §5)")
        if arch_id in FULL_ATTENTION_ARCHS:
            cfg = cfg.replace(sliding_window=LONG_CONTEXT_WINDOW)
    return cfg
