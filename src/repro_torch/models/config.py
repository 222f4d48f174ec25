"""Model configuration covering all assigned architecture families.

A copy of the reference package's ``models/config.py`` (a plain dataclass),
so the port's configs and counts are the reference's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # attention variants
    qk_norm: bool = False       # qwen3
    qkv_bias: bool = False      # qwen2/2.5
    nonparam_ln: bool = False   # olmo: LayerNorm without scale/bias
    rope_theta: float = 1_000_000.0
    mrope: bool = False         # qwen2-vl M-RoPE
    mrope_sections: tuple[int, int, int] = (16, 24, 24)

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0
    d_ff_first_dense: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "gspmd"     # "gspmd" (baseline) | "ep" (shard_map EP)
    attn_batch_shard: bool = False  # §Perf (REFUTED — see EXPERIMENTS.md):
                                # batch-over-(dp x model) attention
    attn_seq_shard: bool = False    # §Perf: shard attention over query-seq on
                                # "model" (Megatron-SP style) — softmax stays
                                # local, KV replicated per layer
    cache_update: str = "dus"   # "dus" (dynamic_update_slice baseline) |
                                # "masked" (§Perf: elementwise iota-select —
                                # no resharding of the seq-sharded cache)
    attn_decode_kernel: bool = False  # the reference's lever for its fused
                                # Pallas decode kernel.  The port does not
                                # read it: every s==1 step with a cache goes
                                # through the registry's decode_attention,
                                # dispatched by device (kept so configs copy
                                # over unchanged)

    # SSM (mamba)
    ssm_state: int = 0
    d_inner: int = 0            # 0 -> 2 * d_model
    conv_kernel: int = 4
    mamba_version: int = 1
    mamba_headdim: int = 64     # mamba2 head dim
    ssm_chunk: int = 256        # chunked-scan length

    # hybrid (zamba2): one SHARED attention+MLP block applied every period
    shared_attn_period: int = 0

    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_frames: int = 1500
    enc_d_model: int = 0        # 0 -> d_model

    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    remat: str = "block"        # "block": jax.checkpoint per layer | "none"
    unroll_scans: bool = False  # cost-accounting mode: XLA costs a While body
                                # ONCE regardless of trip count, so the dry-run
                                # compiles L-pairs with every scan unrolled
    kv_chunk: int = 1024        # flash-attention KV chunk length
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # notes for DESIGN.md provenance
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def din(self) -> int:
        return self.d_inner or 2 * self.d_model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- analytic parameter / FLOP counts (roofline §MODEL_FLOPS) ----------

    def param_count(self) -> int:
        d, hd = self.d_model, self.hd
        n = self.vocab * d                       # embed
        if not self.tie_embeddings:
            n += self.vocab * d                  # lm head
        att = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        mlp_dense = 3 * d * self.d_ff            # SwiGLU
        if self.family in ("dense", "vlm"):
            n += self.n_layers * (att + mlp_dense + 2 * d)
        elif self.family == "moe":
            moe = 3 * d * self.d_ff_expert * self.n_experts \
                + 3 * d * self.d_ff_expert * self.n_shared_experts \
                + d * self.n_experts
            nl_moe = self.n_layers - self.first_dense_layers
            n += nl_moe * (att + moe + 2 * d)
            n += self.first_dense_layers * (att + 3 * d * self.d_ff_first_dense + 2 * d)
        elif self.family == "ssm":
            din, st = self.din, self.ssm_state
            blk = d * 2 * din + din * self.conv_kernel + din * (2 * st + 2) \
                + din * st + din * d + d
            n += self.n_layers * (blk + d)
        elif self.family == "hybrid":
            din, st = self.din, self.ssm_state
            blk = d * 2 * din + din * self.conv_kernel \
                + 2 * din + din * d + d            # mamba2: scalar A/dt per head
            n += self.n_layers * (blk + d)
            n += att + mlp_dense + 2 * d           # ONE shared attn block
        elif self.family == "encdec":
            enc_att = att
            dec = att + d * self.n_kv_heads * hd * 2 + d * self.n_heads * hd \
                + self.n_heads * hd * d            # self + cross
            n += self.n_enc_layers * (enc_att + 2 * d * self.d_ff + 2 * d)
            n += self.n_layers * (dec + 2 * d * self.d_ff + 3 * d)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense_like = self.replace(family="dense", d_ff=0).param_count()
        act = dense_like + self.n_layers * 3 * d * self.d_ff_expert * (
            self.top_k + self.n_shared_experts)
        return act

    def model_flops_per_token(self) -> float:
        """6·N_active (training fwd+bwd) per token."""
        return 6.0 * self.active_param_count()
