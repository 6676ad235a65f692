"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper table) arXiv:2501.kimi2.

61L, d_model=7168, 64 heads (GQA kv=8, head_dim=128), expert d_ff=2048,
vocab=163840, MoE 384 experts top-8 + 1 shared expert, first layer dense.

Memory note: ~1T params cannot hold fp32+Adam on 512 v5e chips
(16 GB HBM each).  This config uses bf16 params and the ``sgdm_bf16``
optimizer in the launcher (2+2+2 bytes/param fully sharded ≈ 11.7 GB/chip)
— see EXPERIMENTS.md §Dry-run.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

ARCH_ID = "kimi-k2-1t-a32b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=2048,
        vocab=163840,
        activation="swiglu",
        norm="rmsnorm",
        max_seq=131_072,
        param_dtype="bfloat16",
        moe=MoEConfig(
            num_experts=384, top_k=8, d_expert=2048,
            num_shared_experts=1, first_k_dense=1,
        ),
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=64, vocab=512, max_seq=128, q_chunk=32, kv_chunk=32, remat=False,
        param_dtype="float32",
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64,
                      num_shared_experts=1, first_k_dense=1),
    )
