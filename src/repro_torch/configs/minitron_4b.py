"""minitron-4b — 32L d3072 24H (GQA kv=8) d_ff=9216 vocab=256000; pruned
nemotron: squared-ReLU MLP, layernorm1p, partial rotary.
[arXiv:2407.14679; hf]

A copy of ``repro/configs/minitron_4b.py``."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab=256000,
    mlp="squared_relu", norm="layernorm1p", rotary_pct=0.5,
    rope_theta=10000.0,
)

# 24 heads do not divide the 16-way model axis -> sequence-parallel attention
RUN_OVERRIDES = {"rules_name": "seqparallel",
                 "serve_rules_name": "seqparallel"}
