"""gemma2-2b — 26L d2304 8H (GQA kv=4, head_dim=256) d_ff=9216 vocab=256000;
local+global alternating attention, logit softcaps, GeGLU, sandwich norms.
[arXiv:2408.00118; hf]

A copy of ``repro/configs/gemma2_2b.py``.  ``RUN_OVERRIDES`` is the
reference's; its sharding rule names mean nothing on one card."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab=256000,
    mlp="geglu", norm="rmsnorm", rope_theta=10000.0,
    layer_pattern="local_global", local_window=4096,
    attn_softcap=50.0, final_softcap=30.0, query_scale=256.0,
    post_norms=True, tie_embeddings=True, embed_scale_by_sqrt_dim=True,
)

RUN_OVERRIDES = {"rules_name": "seqparallel",
                 "serve_rules_name": "seqparallel"}
