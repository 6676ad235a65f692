"""xlstm-125m [ssm] — arXiv:2405.04517.

12L, d_model=768, 4 heads, sLSTM + mLSTM blocks (every 4th block sLSTM),
no separate FFN (d_ff=0; blocks carry their own projections), vocab=50304.

Recurrent decode state is O(1) — long_500k runs natively.
"""

from repro_torch.configs.base import ModelConfig, XLSTMConfig

ARCH_ID = "xlstm-125m"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="ssm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab=50304,
        rope_type="none",
        norm="layernorm",
        max_seq=2048,
        xlstm=XLSTMConfig(slstm_every=4),
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        vocab=512, max_seq=128, remat=False,
        xlstm=XLSTMConfig(slstm_every=2),
    )
