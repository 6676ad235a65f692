"""stablelm-3b [dense] — hf:stabilityai/stablelm-2-1_6b family.

32L, d_model=2560, 32 heads (kv=32), d_ff=6912, vocab=50304.
LayerNorm + SwiGLU (stablelm-2 uses partial rotary 25%; we apply full
rotary — noted as an approximation in DESIGN.md).
"""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "stablelm-3b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="dense",
        num_layers=32,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=6912,
        vocab=50304,
        activation="swiglu",
        norm="layernorm",
        max_seq=4096,
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=8,
        d_ff=512, vocab=512, max_seq=128, q_chunk=32, kv_chunk=32, remat=False,
    )
