"""qwen2-vl-72b — 80L d8192 64H (GQA kv=8) d_ff=29568 vocab=152064; M-RoPE,
dynamic resolution.  Vision frontend is a stub: input_specs() supplies
precomputed patch embeddings merged into the token stream.
[arXiv:2409.12191; hf]

A copy of ``repro/configs/qwen2_vl_72b.py``.  ``RUN_OVERRIDES`` is the
reference's (ZeRO-3 sharding of the big matrices), which the port
executes under a mesh (``models/layers.py``: weights gathered at use);
the full depth does not fit one card: 72.7 B params, 145 GB in bf16,
waiting for a host with two or more cards (ROADMAP queue 1 item 14b
(f))."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064,
    mlp="swiglu", norm="rmsnorm", rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),
    frontend="vision", frontend_dim=8192, vision_tokens=1024,
)

# largest assigned arch: shard the big weight matrices over data too (ZeRO-3)
RUN_OVERRIDES = {"rules_name": "fsdp"}
