"""seamless-m4t-medium [audio, enc-dec] — arXiv:2308.11596.

12 decoder layers (+12 encoder layers), d_model=1024, 16 heads (kv=16),
d_ff=4096, vocab=256206.  The mel/conv audio codec is a STUB — the encoder
consumes precomputed frame embeddings.

long_500k is SKIPPED for this arch (see DESIGN.md §5): an enc-dec speech
model has no sliding-window form for cross-attention and a 512k-token
decode is outside the family's operating regime.
"""

from repro_torch.configs.base import EncDecConfig, ModelConfig

ARCH_ID = "seamless-m4t-medium"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="audio",
        num_layers=12,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab=256206,
        activation="gelu",
        norm="layernorm",
        max_seq=4096,
        frontend="audio",
        encdec=EncDecConfig(num_encoder_layers=12, encoder_seq=4096),
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
        vocab=512, max_seq=128, q_chunk=32, kv_chunk=32, remat=False,
        encdec=EncDecConfig(num_encoder_layers=2, encoder_seq=64),
    )
