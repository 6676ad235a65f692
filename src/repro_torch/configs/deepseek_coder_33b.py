"""deepseek-coder-33b [dense, llama-arch]  — arXiv:2401.14196.

62L, d_model=7168, 56 heads (GQA kv=8), d_ff=19200, vocab=32256.
"""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "deepseek-coder-33b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="dense",
        num_layers=62,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=19200,
        vocab=32256,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=100_000.0,
        max_seq=16_384,
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
        d_ff=512, vocab=512, max_seq=128, q_chunk=32, kv_chunk=32, remat=False,
    )
