"""gemma-2b [dense] — arXiv:2403.08295.

18L, d_model=2048, 8 heads, MQA (kv=1), GeGLU d_ff=16384, head_dim=256,
vocab=256000, tied embeddings, embeddings scaled by sqrt(d).
"""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "gemma-2b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="dense",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab=256000,
        activation="geglu",
        norm="rmsnorm",
        tie_embeddings=True,
        max_seq=8192,
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=1, head_dim=64,
        d_ff=512, vocab=512, max_seq=128, q_chunk=32, kv_chunk=32, remat=False,
    )
