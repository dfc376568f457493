"""mamba2-370m — 48L d_model=1024 attention-free, vocab=50280,
ssm_state=128 (SSD / state-space duality).  [arXiv:2405.21060; unverified]

A copy of ``repro/configs/mamba2_370m.py``."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=128,
    use_rope=False, norm="rmsnorm", tie_embeddings=True,
)

RUN_OVERRIDES = {"rules_name": "default"}
