"""olmoe-1b-7b [moe] — arXiv:2409.02060.

16L, d_model=2048, 16 heads (kv=16), expert d_ff=1024, vocab=50304,
64 experts top-8 (all layers MoE, no shared expert).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

ARCH_ID = "olmoe-1b-7b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1024,
        vocab=50304,
        activation="swiglu",
        norm="rmsnorm",
        max_seq=4096,
        moe=MoEConfig(num_experts=64, top_k=8, d_expert=1024),
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=64,
        vocab=512, max_seq=128, q_chunk=32, kv_chunk=32, remat=False,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64),
    )
