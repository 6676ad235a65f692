"""granite-34b [dense, code] — arXiv:2405.04324.

88L, d_model=6144, 48 heads, MQA (kv=1), d_ff=24576, vocab=49152.
"""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "granite-34b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="dense",
        num_layers=88,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,
        head_dim=128,
        d_ff=24576,
        vocab=49152,
        activation="gelu",
        norm="layernorm",
        max_seq=8192,
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=1, head_dim=32,
        d_ff=512, vocab=512, max_seq=128, q_chunk=32, kv_chunk=32, remat=False,
    )
