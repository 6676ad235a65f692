"""zamba2-2.7b [hybrid] — arXiv:2411.15242.

54 Mamba2 layers, d_model=2560, ssm_state=64, with a SHARED attention+MLP
block (32 heads kv=32, d_ff=10240) applied every 6 layers (9 superblocks).
The shared block reuses the same parameters at every application — that
weight sharing is the architecture's defining trait.  (Real Zamba2 adds
per-invocation LoRA adapters on the shared block; omitted — see DESIGN.md.)

long_500k runs natively: decode state is O(1) for the Mamba2 layers and
O(window) per shared-attn invocation.
"""

from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

ARCH_ID = "zamba2-2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=10240,
        vocab=32000,
        activation="swiglu",
        norm="rmsnorm",
        max_seq=4096,
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk=256),
        hybrid=HybridConfig(attn_every=6, shared_d_ff=10240),
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
        vocab=512, max_seq=128, q_chunk=32, kv_chunk=32, remat=False,
        ssm=SSMConfig(state_dim=8, head_dim=16, expand=2, chunk=32),
        hybrid=HybridConfig(attn_every=2, shared_d_ff=256),
    )
