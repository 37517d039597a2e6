"""Configuration dataclasses for models, shapes, and dry-run cells.

Every assigned architecture gets one module in this package defining CONFIG.
The registry in __init__.py maps the public ``--arch`` id to that config.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 256
    # groups of B and C: head h reads group h // (heads / n_groups), and the
    # gated norm is taken over each group's d_inner / n_groups columns
    n_groups: int = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid (zamba2) | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int
    qkv_bias: bool = False
    causal: bool = True
    is_encoder: bool = False
    input_kind: str = "tokens"   # tokens | embeds (modality frontend stub)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0          # hybrid: shared attention block after every N ssm layers
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # attention window applied for contexts beyond 32k (hybrid long-context
    # adaptation, see DESIGN.md §4); 0 = always full attention.
    sliding_window_long: int = 4096
    param_dtype: str = "bfloat16"
    source: str = ""             # provenance tag from the assignment table
    # hybrid, the published Zamba2 block (ids given; ``attn_every`` unused):
    # before the mamba layer at each id, one of ``num_mem_blocks`` tied
    # attention + gated-GELU MLP blocks (alternating) reads the stream
    # concatenated with the token embeddings (width 2 d_model, heads of
    # head_dim over it, rotate-half RoPE, scale (head_dim / 2)^-0.5); its
    # output, through the application's own linear, is added to that
    # layer's input and not to the stream
    hybrid_layer_ids: tuple = ()
    num_mem_blocks: int = 1
    adapter_rank: int = 0        # rank of each application's gate_up adapter

    def __post_init__(self):
        # a JSON list becomes a tuple, so the config stays hashable
        object.__setattr__(self, "hybrid_layer_ids",
                           tuple(self.hybrid_layer_ids))
        # ``zamba2`` names the hybrid family at the published layout (the
        # name portbench files its weights, work counts and reference under);
        # the port runs it as ``hybrid``
        if self.family == "zamba2":
            if not self.hybrid_layer_ids:
                raise ValueError("family 'zamba2' needs hybrid_layer_ids")
            object.__setattr__(self, "family", "hybrid")

    # ---- derived ----
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def rope_half(self) -> bool:
        """RoPE rotates (i, i + D/2) (the published Zamba2 block), not
        interleaved pairs."""
        return bool(self.hybrid_layer_ids)

    @property
    def attn_scale(self) -> float | None:
        """The softmax scale where it is not 1 / sqrt(head_dim): the
        published Zamba2 block's (head_dim / 2)^-0.5."""
        return (self.head_dim / 2) ** -0.5 if self.hybrid_layer_ids else None

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim if self.ssm else 0

    def has_attention(self) -> bool:
        return self.family != "ssm"

    def attn_layer_count(self) -> int:
        """Number of distinct attention cache slots."""
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            if self.hybrid_layer_ids:
                return len(self.hybrid_layer_ids)
            return self.num_layers // self.attn_every
        return self.num_layers

    def ssm_layer_count(self) -> int:
        if self.family == "ssm":
            return self.num_layers
        if self.family == "hybrid":
            return self.num_layers
        return 0

    # ---- parameter counting (exact, mirrors models/*.py init) ----
    def param_counts(self) -> dict:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d
        head = 0 if self.tie_embeddings else d * v
        per_attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            per_attn += self.q_dim + 2 * self.kv_dim
        per_mlp = 3 * d * f  # SwiGLU: w1, w3 (d->f), w2 (f->d)
        per_norms = 2 * d
        expert_total = 0
        n_layers_attn = 0
        n_layers_mlp = 0
        ssm_total = 0
        if self.family in ("dense", "vlm", "audio"):
            n_layers_attn = self.num_layers
            n_layers_mlp = self.num_layers
        elif self.family == "moe":
            n_layers_attn = self.num_layers
            router = d * self.moe.num_experts
            expert_total = self.num_layers * (self.moe.num_experts * per_mlp + router)
        elif self.hybrid_layer_ids:
            di, gn = self.d_inner, self.ssm.n_groups * self.ssm.d_state
            h, ch = self.ssm_heads, self.d_inner + 2 * gn
            # in_proj, conv weight and bias, A_log / D / dt_bias, the gated
            # norm, out_proj, the layer's norm (as ``hybrid.init_params``)
            per_ssm = (d * (2 * di + 2 * gn + h) + ch * (self.ssm.conv_kernel
                                                         + 1)
                       + 3 * h + di + di * d + d)
            ssm_total = self.num_layers * per_ssm
            # the tied blocks: norms of 2d and d, attention over 2d, the
            # gated MLP; per application its adapter and its linear
            per_block = (2 * d * self.q_dim + 2 * 2 * d * self.kv_dim
                         + self.q_dim * d + 3 * d * f + 3 * d)
            per_app = self.adapter_rank * (d + 2 * f) + d * d
            ssm_total += (self.num_mem_blocks * per_block
                          + len(self.hybrid_layer_ids) * per_app)
        elif self.family in ("ssm", "hybrid"):
            di, n = self.d_inner, self.ssm.d_state
            h = self.ssm_heads
            # in_proj: d -> (2*di + 2*n + h)   [x, z, B, C, dt]
            # out_proj: di -> d ; conv over (di + 2n); A_log, D, dt_bias: h each; norm d
            per_ssm = (d * (2 * di + 2 * n + h) + di * d
                       + (di + 2 * n) * self.ssm.conv_kernel
                       + 3 * h + di + d)
            ssm_total = self.num_layers * per_ssm
            if self.family == "hybrid":
                # one SHARED attn+mlp block (params reused at each application)
                ssm_total += per_attn + per_mlp + per_norms
        body = (n_layers_attn * (per_attn + per_norms)
                + n_layers_mlp * per_mlp
                + expert_total + ssm_total + d)  # final norm
        total = emb + head + body
        active = total
        if self.family == "moe":
            inactive = self.num_layers * (self.moe.num_experts - self.moe.top_k) * per_mlp
            active = total - inactive
        return {"total": total, "active": active, "embedding": emb + head}

    @property
    def num_params(self) -> int:
        return self.param_counts()["total"]

    @property
    def num_active_params(self) -> int:
        return self.param_counts()["active"]


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524_288, 1),
}


def cells_for(cfg: ModelConfig) -> list[ShapeConfig]:
    """Runnable (arch x shape) cells, applying the principled skips (DESIGN.md §4)."""
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"]]
    if not cfg.is_encoder:
        cells.append(SHAPES["decode_32k"])
        if cfg.family in ("ssm", "hybrid"):
            cells.append(SHAPES["long_500k"])
    return cells


def skipped_cells_for(cfg: ModelConfig) -> dict[str, str]:
    out = {}
    if cfg.is_encoder:
        out["decode_32k"] = "encoder-only arch: no autoregressive decode step"
        out["long_500k"] = "encoder-only + full attention"
    elif cfg.family not in ("ssm", "hybrid"):
        out["long_500k"] = "pure full-attention arch: 500k context needs sub-quadratic attention"
    return out


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Small same-family config for CPU smoke tests."""
    kv = 1 if cfg.num_kv_heads == 1 else (4 if cfg.num_kv_heads == cfg.num_heads else 2)
    changes = dict(
        num_layers=4 if cfg.family == "hybrid" else 2,
        d_model=64,
        num_heads=4,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        param_dtype="float32",
    )
    if cfg.moe:
        changes["moe"] = replace(cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2))
    if cfg.ssm:
        changes["ssm"] = replace(cfg.ssm, d_state=16, head_dim=16, chunk=32)
    if cfg.attn_every:
        changes["attn_every"] = 2
    return replace(cfg, **changes)
