"""zamba2-1.2b — 38 Mamba-2 layers d_model=2048 + SHARED attention block
(32H, kv=32, d_ff=8192) applied periodically with per-invocation LoRA,
ssm_state=64.  [arXiv:2411.15242; hf]

A copy of ``repro/configs/zamba2_1p2b.py``."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=128,
    shared_attn_period=6, shared_attn_lora=64,
    mlp="swiglu", norm="rmsnorm", rope_theta=10000.0,
)

RUN_OVERRIDES = {"rules_name": "default"}
