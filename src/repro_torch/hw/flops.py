"""Analytic MODEL_FLOPS accounting (the 6·N·D convention).

A copy of ``repro/hw/flops.py`` for the port.  The parameter count walks
the port's own ``models/lm.py::model_decls`` with ``repro_torch.tree``
(sorted-key order, as ``jax.tree_util.tree_flatten_with_path`` visits a
dict), so the sums are taken in the reference's order.

Used for the roofline's MODEL_FLOPS / HLO_FLOPs ratio ("useful fraction" —
catches remat recompute and dispatch overhead).  N counts non-embedding
parameters; MoE experts count at top_k/n_experts (active fraction);
attention adds the explicit quadratic term; SSD adds the state-expansion
term (its flops are state-size-, not param-, proportional).
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.models.params import PD
from repro_torch.tree import leaves_with_paths


def _count(decl_tree, scale_experts: float) -> float:
    total = 0.0
    for keys, pd in leaves_with_paths(decl_tree):
        if not isinstance(pd, PD):
            continue
        n = 1.0
        for d in pd.shape:
            n *= d
        if "embed" in keys[:1] or "unembed" in keys[:1] or \
           "frontend" in keys[:1]:
            continue  # embedding-like: excluded from N by convention
        if any(k in ("w_gate", "w_up", "w_down") for k in keys) and \
           "mlp" in keys and scale_experts != 1.0 and len(pd.shape) >= 3 \
           and pd.axes[1 if pd.axes[0] == "layers" else 0] == "expert":
            n *= scale_experts
        total += n
    return total


def active_param_count(cfg: ModelConfig) -> float:
    decls = lm.model_decls(cfg)
    scale = (cfg.top_k / cfg.n_experts) if cfg.n_experts else 1.0
    return _count(decls, scale)


def total_param_count(cfg: ModelConfig) -> float:
    return _count(lm.model_decls(cfg), 1.0)


def _attention_flops_fwd(cfg: ModelConfig, batch: int, s_q: int,
                         s_kv: int) -> float:
    """2 matmuls (QK^T, PV), 2 flops/MAC; causal halves the q x kv area."""
    if cfg.family == "ssm":
        return 0.0
    area = s_q * s_kv * (0.5 if (cfg.causal and s_q == s_kv) else 1.0)
    per_layer = 4.0 * batch * area * cfg.n_heads * cfg.head_dim
    if cfg.family == "hybrid":
        n_super, _, _ = lm.zamba_structure(cfg)
        return per_layer * n_super
    if cfg.layer_pattern == "local_global":
        # local layers see a clamped window
        win = min(cfg.local_window or s_kv, s_kv)
        local_area = s_q * min(win, s_kv)
        local = 4.0 * batch * local_area * cfg.n_heads * cfg.head_dim
        return (cfg.n_layers // 2) * (per_layer + local)
    return per_layer * cfg.n_layers


def _ssd_flops_fwd(cfg: ModelConfig, batch: int, seq: int) -> float:
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    Q = cfg.ssm_chunk
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    per_tok_head = 2.0 * (Q * N + Q * P + 2.0 * P * N)
    return per_tok_head * H * batch * seq * cfg.n_layers


def _logits_flops_fwd(cfg: ModelConfig, tokens: float) -> float:
    return 2.0 * tokens * cfg.d_model * cfg.vocab


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic useful flops for one step of this cell."""
    B, S = shape.global_batch, shape.seq_len
    N = active_param_count(cfg)
    if shape.kind == "train":
        tokens = float(B) * S
        return (6.0 * N * tokens
                + 3.0 * _attention_flops_fwd(cfg, B, S, S)
                + 3.0 * _ssd_flops_fwd(cfg, B, S)
                + 3.0 * _logits_flops_fwd(cfg, tokens))
    if shape.kind == "prefill":
        tokens = float(B) * S
        return (2.0 * N * tokens
                + _attention_flops_fwd(cfg, B, S, S)
                + _ssd_flops_fwd(cfg, B, S)
                + _logits_flops_fwd(cfg, float(B)))  # last-position logits
    # decode: one token against an S-long KV/state
    tokens = float(B)
    return (2.0 * N * tokens
            + _attention_flops_fwd(cfg, B, 1, S)
            + _ssd_flops_fwd(cfg, B, 1)
            + _logits_flops_fwd(cfg, tokens))


def _cache_bytes(cfg: ModelConfig, batch: int, seq: int) -> float:
    """KV-cache / SSM-state bytes (bf16 kv, f32 ssm state)."""
    kv_layers = 0.0
    if cfg.family in ("dense", "moe", "vlm"):
        kv_layers = cfg.n_layers
        if cfg.layer_pattern == "local_global":
            # local layers only need window-size entries at steady state
            win = min(cfg.local_window or seq, seq)
            kv_layers = cfg.n_layers / 2 * (1 + win / seq)
    elif cfg.family == "hybrid":
        kv_layers = lm.zamba_structure(cfg)[0]
    kv = 2.0 * kv_layers * batch * seq * cfg.n_kv_heads * cfg.head_dim * 2
    ssm = 0.0
    if cfg.family in ("ssm", "hybrid"):
        ssm = (cfg.n_layers * batch
               * (cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
                  + (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state)
                  * 2))
    return kv + ssm


def model_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic minimum HBM traffic for one step (global bytes).

    Conventions (documented in EXPERIMENTS.md §Roofline):
      train   : params+grads+moments touched once each way (16 B/param
                with f32 master+moments) + residual stream r/w per layer
                (bf16, fwd+bwd)
      prefill : active params read (bf16) + cache written + residual stream
      decode  : active params read (bf16) + cache read
    """
    B, S = shape.global_batch, shape.seq_len
    N_tot = total_param_count(cfg)
    N_act = active_param_count(cfg)
    resid = 2.0 * B * S * cfg.d_model * cfg.n_layers * 2  # bf16 r+w
    if shape.kind == "train":
        return 16.0 * N_tot + 2.0 * resid
    if shape.kind == "prefill":
        return 2.0 * N_act + _cache_bytes(cfg, B, S) + resid
    return 2.0 * N_act + _cache_bytes(cfg, B, S)
