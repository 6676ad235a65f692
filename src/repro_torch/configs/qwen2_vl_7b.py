"""qwen2-vl-7b [vlm] — arXiv:2409.12191.

28L, d_model=3584, 28 heads (GQA kv=4), d_ff=18944, vocab=152064.
M-RoPE (t/h/w sections), dynamic resolution.  Vision tower is a STUB —
``input_specs`` supplies precomputed patch embeddings + 3D positions.
"""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen2-vl-7b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab=152064,
        activation="swiglu",
        norm="rmsnorm",
        rope_type="mrope",
        mrope_sections=(16, 24, 24),
        rope_theta=1_000_000.0,
        max_seq=32_768,
        frontend="vision",
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
        d_ff=512, vocab=512, max_seq=128, q_chunk=32, kv_chunk=32, remat=False,
        mrope_sections=(8, 4, 4),
    )
