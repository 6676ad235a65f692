"""Unified model configuration covering all assigned architecture families.

A copy of the JAX package's ``configs/base.py`` with torch dtypes in
place of ``jnp`` ones (``pdtype`` / ``cdtype``); the numbers are data and
stay identical.

One dataclass describes dense / MoE / SSM / hybrid / enc-dec / VLM / audio
backbones; family-specific sections are optional sub-configs.  Every
assigned architecture in ``src/repro/configs/<id>.py`` instantiates this
with the exact numbers from the assignment table and also provides a
``smoke()`` reduced variant (<=2 layers, d_model<=512, <=4 experts).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    capacity_factor: float = 1.25
    num_shared_experts: int = 0  # always-on shared expert(s) (kimi-style)
    first_k_dense: int = 0  # leading dense layers before MoE starts
    router_aux_weight: float = 0.01  # load-balance loss weight


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64  # N — per-channel state size (Mamba2)
    head_dim: int = 64  # P — channels per SSM head
    expand: int = 2  # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256  # SSD chunk length


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 4  # every k-th block is sLSTM, rest mLSTM
    qk_dim_factor: float = 0.5
    v_dim_factor: float = 1.0
    proj_factor: float = 1.3334  # sLSTM post-MLP expansion


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: blocks of SSM layers with a shared attention block."""

    attn_every: int = 6  # one shared attn+MLP block per this many SSM layers
    shared_d_ff: int = 0  # hidden of the shared block's MLP (0 => 4*d_model)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    num_encoder_layers: int = 12
    encoder_seq: int = 4096  # max encoder memory length (frames)
    encoder_d_ff: int = 0  # 0 => same as decoder d_ff


@dataclasses.dataclass(frozen=True)
class CompositionConfig:
    """Heroes neural-composition settings for factorized training."""

    enabled: bool = False
    max_width: int = 2  # P — full model corresponds to width P
    rank: int = 0  # R; 0 => d_model // 4
    width: int = 0  # active width p for this instantiation; 0 => max_width
    factorized_forward: bool = True  # x@v@u (ours) vs compose-then-matmul (paper)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 => d_model // num_heads
    activation: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    rope_type: str = "rope"  # rope | mrope | none
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w for qwen2-vl
    max_seq: int = 8192
    sliding_window: int = 0  # 0 => full attention; >0 => SWA window
    tie_embeddings: bool = False
    parallel_block: bool = False  # stablelm/gpt-neox parallel attn+FFN
    logit_softcap: float = 0.0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True  # checkpoint each layer in the scan
    # attention chunking (flash-style streaming softmax in pure JAX)
    q_chunk: int = 2048
    kv_chunk: int = 1024
    # KV-cache storage dtype for decode: "compute" (= compute_dtype) or
    # "int8" (per-token-per-head scales; §Perf memory-term iteration)
    kv_cache_quant: str = "compute"
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    composition: CompositionConfig = dataclasses.field(default_factory=CompositionConfig)
    # frontend stub: 'none' | 'vision' | 'audio' — input is embeddings
    frontend: str = "none"

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        assert self.num_heads % max(self.num_kv_heads, 1) == 0
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def pdtype(self):
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self):
        return getattr(torch, self.compute_dtype)

    @property
    def comp_rank(self) -> int:
        c = self.composition
        return c.rank or max(self.d_model // 4, 8)

    @property
    def comp_width(self) -> int:
        c = self.composition
        return c.width or c.max_width

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # rough parameter count (for roofline MODEL_FLOPS = 6 N D)
    def param_count(self, active_only: bool = False) -> int:
        d, f, L = self.d_model, self.d_ff, self.num_layers
        hd = self.resolved_head_dim
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        if self.family in ("ssm",):
            attn = 0
        n_glu = 3 if self.activation in ("swiglu", "geglu") else 2
        if self.moe is not None:
            e = self.moe.top_k if active_only else self.moe.num_experts
            dense_layers = self.moe.first_k_dense
            moe_layers = L - dense_layers
            ffn = moe_layers * (n_glu * d * self.moe.d_expert * (e + self.moe.num_shared_experts)
                                + d * self.moe.num_experts)
            ffn += dense_layers * n_glu * d * f
            per_layer = attn
            total = L * per_layer + ffn
        elif self.family == "ssm":
            x = self.xlstm or XLSTMConfig()
            dqk = int(d * x.qk_dim_factor)
            per_layer = d * (2 * dqk + 2 * d) + 2 * d * d  # rough mLSTM proj
            total = L * per_layer
        elif self.family == "hybrid":
            s = self.ssm or SSMConfig()
            d_in = s.expand * d
            per_layer = 2 * d * d_in + d_in * d  # in/out proj (rough)
            hb = self.hybrid or HybridConfig()
            shared = attn + n_glu * d * (hb.shared_d_ff or 4 * d)
            total = L * per_layer + shared
        else:
            per_layer = attn + n_glu * d * f
            total = L * per_layer
        if self.encdec is not None:
            enc_f = self.encdec.encoder_d_ff or f
            enc_layer = attn + n_glu * d * enc_f
            cross = attn  # cross-attention per decoder layer
            total += self.encdec.num_encoder_layers * enc_layer + L * cross
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        return int(total)
