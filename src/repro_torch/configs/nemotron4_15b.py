"""nemotron-4-15b — 32L d6144 48H (GQA kv=8) d_ff=24576 vocab=256000;
squared-ReLU MLP, layernorm1p, partial rotary.  [arXiv:2402.16819; unverified]

A copy of ``repro/configs/nemotron4_15b.py``."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=256000,
    mlp="squared_relu", norm="layernorm1p", rotary_pct=0.5,
    rope_theta=10000.0,
)

RUN_OVERRIDES = {"rules_name": "default"}
