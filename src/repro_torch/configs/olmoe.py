"""olmoe-1b-7b — 16L d2048 16H (GQA kv=16) d_ff=1024 vocab=50304,
MoE 64 experts top-8.  [arXiv:2409.02060; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab=50304,
    n_experts=64, top_k=8,
    mlp="swiglu", norm="rmsnorm", rope_theta=10000.0,
)

# measured (EXPERIMENTS.md §Perf): unlike phi3.5-moe, olmoe's tiny d_ff
# (1024) and top-8 routing make the seqparallel K/V gathers cost more than
# the residual gathers they remove -> default rules win here
RUN_OVERRIDES = {"rules_name": "default"}
