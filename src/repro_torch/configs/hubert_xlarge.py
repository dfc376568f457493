"""hubert-xlarge — 48L d1280 16H (kv=16, head_dim=80) d_ff=5120 vocab=504;
encoder-only over precomputed frame embeddings (frontend stub per the
assignment).  No decode shapes.  [arXiv:2106.07447; unverified]

A copy of ``repro/configs/hubert_xlarge.py``.  ``RUN_OVERRIDES`` is the
reference's; its sharding rule names mean nothing on one card."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab=504,
    mlp="gelu", norm="layernorm", causal=False, use_rope=False,
    frontend="audio", frontend_dim=512, max_wavelength_pos=65536,
)

RUN_OVERRIDES = {"rules_name": "default"}
