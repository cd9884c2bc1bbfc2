"""Model / run configuration dataclasses for the architecture zoo."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """One architecture.  Every assigned arch instantiates this once in
    configs/<id>.py; smoke tests use .reduced()."""

    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # attention pattern
    window: int = 0             # sliding-window size; 0 = full attention
    local_global_ratio: int = 0  # k -> k local layers per 1 global (gemma3)
    local_window: int = 1024    # window used by "local" layers
    mlp: str = "swiglu"         # swiglu | relu2 | gelu
    rope_theta: float = 10_000.0
    mrope: bool = False         # qwen2-vl multimodal rope

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0         # zamba2: shared attn block every k layers
    block_pattern: Tuple[str, ...] = ()   # xlstm: ("m","s",...) per layer

    # encoder-decoder
    enc_layers: int = 0         # 0 -> decoder-only

    # multimodal frontend stub
    frontend: str = "none"      # none | frames (audio) | patches (vision)
    frontend_len: int = 0       # stub sequence length contributed

    dtype: str = "bfloat16"

    # long-context applicability (DESIGN.md §5)
    subquadratic: bool = False  # eligible for long_500k

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 128 so the embedding table
        shards evenly over a 16-wide `model` axis (loss masks the padding).
        Standard practice (every production LM pads its vocab)."""
        return -(-self.vocab // 128) * 128

    def reduced(self, **overrides) -> "ModelConfig":
        """CPU-smoke-test scale: same family/topology, tiny dimensions."""
        small = dict(
            n_layers=min(self.n_layers, 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            d_ff=128,
            vocab=503,
            head_dim=16,
            window=min(self.window, 32) if self.window else 0,
            local_window=16,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1)
            if self.n_shared_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            attn_every=2 if self.attn_every else 0,
            block_pattern=self.block_pattern[:4] if self.block_pattern else (),
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            frontend_len=min(self.frontend_len, 8) if self.frontend_len else 0,
            dtype="float32",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        d, ff, hd = self.d_model, self.d_ff, self.head_dim
        H, KV = self.n_heads, self.n_kv_heads
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        if self.mlp == "swiglu":
            mlp = 3 * d * ff
        else:
            mlp = 2 * d * ff
        if self.n_experts:
            moe = self.n_experts * 3 * d * ff + d * self.n_experts
            moe += self.n_shared_experts * 3 * d * ff
            layer = attn + moe + 2 * d
        else:
            layer = attn + mlp + 2 * d
        if self.family in ("ssm", "hybrid"):
            e = self.ssm_expand
            din = e * d
            nheads = din // self.ssm_head_dim
            mamba = (d * (2 * din + 2 * self.ssm_state + nheads)
                     + din * d + 2 * din)
            if self.family == "hybrid":
                n_attn_uses = self.n_layers // max(self.attn_every, 1)
                layer = mamba + 2 * d
                extra_shared = attn + 2 * d  # one shared block
                total = self.n_layers * layer + extra_shared
                return total + self.vocab * d + d
            if self.family == "ssm":  # xlstm: mix of mLSTM + FFN
                layer = mamba + mlp + 2 * d
        total_layers = self.n_layers + self.enc_layers
        total = total_layers * layer
        total += self.vocab * d + d  # embedding (+ tied head) + final norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if not self.n_experts:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        hd, H, KV = self.head_dim, self.n_heads, self.n_kv_heads
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        active_moe = (self.moe_top_k + self.n_shared_experts) * 3 * d * ff
        layer = attn + active_moe + d * self.n_experts + 2 * d
        return self.n_layers * layer + self.vocab * d + d


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what step to lower and at what size."""

    name: str
    kind: str                   # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


@dataclass(frozen=True)
class RunConfig:
    """Training/serving hyper-params attached to a launch."""

    microbatches: int = 1       # grad-accumulation steps per train step
    remat: str = "block"        # none | block (checkpoint each layer block)
    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    compress_grads: bool = False  # int8 error-feedback cross-pod reduction
    seed: int = 0
