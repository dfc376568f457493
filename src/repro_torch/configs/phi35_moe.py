"""phi3.5-moe-42b-a6.6b — 32L d4096 32H (GQA kv=8) d_ff=6400 vocab=32064,
MoE 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=6400, vocab=32064,
    n_experts=16, top_k=2,
    mlp="swiglu", norm="layernorm", rope_theta=10000.0,
)

# §Perf C-iter1/2: sequence-parallel residual stream removes the per-layer
# post-MoE all-gathers (collective term 7.66 -> 2.69 s/step); dots-remat
# shaves recompute traffic.
RUN_OVERRIDES = {"rules_name": "seqparallel", "remat": "dots"}
