"""Config system: ModelConfig (architecture) + RunConfig (execution/sharding).

One ``<arch>.py`` per assigned architecture builds its exact ModelConfig; the
registry exposes them by ``--arch`` id.  ``reduced()`` produces the same-family
tiny config used by CPU smoke tests.

A copy of ``repro.configs.base`` (the port imports nothing of ``repro``).
The port reads the numerics fields of ``RunConfig``; the sharding,
``kernel_mode`` and optimizer fields are kept so the two packages build
their configs the same way, and are ignored here: kernels are chosen by
the tensor's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # --- norm / mlp / logits ---
    norm: str = "rmsnorm"           # rmsnorm | layernorm | layernorm1p
    mlp: str = "swiglu"             # swiglu | geglu | squared_relu | gelu
    attn_softcap: float | None = None
    final_softcap: float | None = None
    query_scale: float | None = None      # gemma2 query_pre_attn_scalar
    post_norms: bool = False              # gemma2 sandwich norms
    tie_embeddings: bool = False
    embed_scale_by_sqrt_dim: bool = False  # gemma2 input scaling
    # --- positions ---
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    mrope_sections: tuple[int, ...] | None = None   # qwen2-vl M-RoPE
    use_rope: bool = True                 # hubert uses learned abs positions
    # --- attention pattern ---
    causal: bool = True
    local_window: int | None = None
    layer_pattern: str = "global"         # global | local_global (gemma2)
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # --- hybrid (zamba2) ---
    shared_attn_period: int = 0           # apply shared attn block every N
    shared_attn_lora: int = 0             # per-invocation LoRA rank
    # --- modality frontend (stub: precomputed embeddings) ---
    frontend: str | None = None           # audio | vision
    frontend_dim: int = 0
    vision_tokens: int = 0                # patches merged per sample (vlm)
    max_wavelength_pos: int = 65536       # learned-pos table size (audio)

    # ---- derived ----
    @property
    def vocab_padded(self) -> int:
        """Embedding tables pad the vocab to a multiple of 128 when it does
        not already divide a 16-way model axis: ~0.3 % padding instead of a
        16x-replicated table (logits over pad ids are masked)."""
        if self.vocab % 16 == 0:
            return self.vocab
        return (self.vocab + 127) // 128 * 128

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // max(self.ssm_headdim, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def param_count_dense_approx(self) -> float:
        """6ND bookkeeping helper; exact count comes from params.param_count."""
        return (self.n_layers * (4 * self.d_model * self.n_heads * self.head_dim
                                 + 3 * self.d_model * self.d_ff)
                + self.vocab * self.d_model)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution configuration (orthogonal to the architecture)."""

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # layer execution
    scan_layers: bool = True
    remat: str = "full"             # none | full | dots
    scan_unroll: int = 1
    # attention execution
    kernel_mode: str = "reference"  # reference | pallas | pallas_interpret
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    naive_attn_below: int = 2049    # use naive path for short seqs
    # loss
    logits_chunk: int = 1024
    # sharding
    rules_name: str = "default"     # default | fsdp (per-arch override)
    serve_rules_name: str = "default"  # serving never FSDPs weights: a
    # ZeRO-sharded layout would all-gather every layer's weights per token
    attn_shard: str = "heads"       # heads | seq  (seq when H % model != 0)
    # optimizer
    optimizer: str = "adamw"        # adamw | adafactor (memory-lean)
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    # gradient accumulation / compression
    grad_accum: int = 1
    grad_compression: str = "none"  # none | int8
    # MoE dispatch all-to-all wire format: int8 halves the dominant EP
    # collective (straight-through estimator keeps gradients flowing)
    moe_a2a_dtype: str = "bf16"     # bf16 | int8
    # power steering (the paper's technique, applied to the run)
    power_metric: str = "sed"       # sed | ed
    power_steering: bool = False

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def reduced(cfg: ModelConfig, **overrides: Any) -> ModelConfig:
    """Same-family tiny config for CPU smoke tests."""
    small: dict[str, Any] = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.shared_attn_period else 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 512),
        name=cfg.name + "-reduced",
    )
    if cfg.n_experts:
        small.update(n_experts=min(cfg.n_experts, 8),
                     top_k=min(cfg.top_k, 2))
    if cfg.ssm_state:
        small.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
    if cfg.shared_attn_period:
        small.update(shared_attn_period=2)
    if cfg.frontend:
        small.update(frontend_dim=min(cfg.frontend_dim, 64) or 64,
                     vision_tokens=min(cfg.vision_tokens, 16))
    if cfg.local_window:
        small.update(local_window=64)
    if cfg.mrope_sections is not None:
        # rescale sections to the reduced head_dim's rotary half
        half = int(small["head_dim"] * cfg.rotary_pct) // 2
        total = sum(cfg.mrope_sections)
        secs = [max(1, s * half // total) for s in cfg.mrope_sections]
        secs[0] += half - sum(secs)
        small.update(mrope_sections=tuple(secs))
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
