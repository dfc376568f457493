"""Neural layers of the dense decoder, ported from ``repro/models/layers.py``.

Every ``*_decls`` returns a nested dict of PD declarations with the
reference's keys and shapes; the matching ``apply_*`` consumes the
materialized tensors.  ``Ctx`` holds the run config and the device; the
port has no sharding.  Weights are cast to the compute dtype at use with
``.to(c)``, a no-op once ``lm.prepare_params`` has cast them at load.  In
training the parameters stay f32 masters with ``requires_grad``: the cast
at use is differentiable, so autograd returns f32 gradients, as JAX
does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels import ops
from repro_torch.models.params import PD


@dataclasses.dataclass(frozen=True)
class Ctx:
    run: RunConfig
    device: str | torch.device = "cuda"

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.run.compute_dtype)


def _stack(shape, layers):
    return (layers,) + tuple(shape) if layers else tuple(shape)


def _saxes(axes, layers):
    return ("layers",) + tuple(axes) if layers else tuple(axes)


# ===========================================================================
# norms
# ===========================================================================

def norm_decls(cfg: ModelConfig, layers: int = 0,
               d: int | None = None) -> dict:
    d = d if d is not None else cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": PD(_stack((d,), layers), _saxes(("embed",), layers),
                            "ones")}
    if cfg.norm == "layernorm":
        return {"scale": PD(_stack((d,), layers), _saxes(("embed",), layers),
                            "ones"),
                "bias": PD(_stack((d,), layers), _saxes(("embed",), layers),
                           "zeros")}
    if cfg.norm == "layernorm1p":  # nemotron: (1 + scale) reparameterization
        return {"scale": PD(_stack((d,), layers), _saxes(("embed",), layers),
                            "zeros"),
                "bias": PD(_stack((d,), layers), _saxes(("embed",), layers),
                           "zeros")}
    raise ValueError(cfg.norm)


def apply_norm(cfg: ModelConfig, p: dict, x, eps: float = 1e-6):
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    else:
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        scale = p["scale"].float()
        if cfg.norm == "layernorm1p":
            scale = scale + 1.0
        out = (xf - mean) * torch.rsqrt(var + eps) * scale + p["bias"].float()
    return out.to(x.dtype)


# ===========================================================================
# rotary position embeddings (plain RoPE and partial rotary)
# ===========================================================================

def rope_cos_sin(cfg: ModelConfig, positions):
    """positions: (B, S) int.  Returns cos/sin of shape (B, S, rot_half)."""
    if cfg.mrope_sections is not None:
        raise NotImplementedError("M-RoPE: ROADMAP queue 1 item 12")
    rot_dim = int(cfg.head_dim * cfg.rotary_pct) // 2 * 2
    half = rot_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    inv_freq = cfg.rope_theta ** exponent
    ang = positions.float()[..., None] * inv_freq[None, None]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, rotary_pct: float = 1.0):
    """x: (B, S, H, D); cos/sin: (B, S, rot_half)."""
    D = x.shape[-1]
    rot_dim = int(D * rotary_pct) // 2 * 2
    half = rot_dim // 2
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr[..., :half], xr[..., half:]
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    x1f, x2f = x1.float(), x2.float()
    rotated = torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], -1)
    return torch.cat([rotated.to(x.dtype), xp], -1)


# ===========================================================================
# attention (GQA + optional KV cache)
# ===========================================================================

def attention_decls(cfg: ModelConfig, layers: int = 0,
                    d_in: int | None = None) -> dict:
    """Projections stored flat ((d, H*hd) etc.), as in the reference."""
    d = d_in if d_in is not None else cfg.d_model
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": PD(_stack((d, H * hd), layers),
                 _saxes(("embed", "qkv_flat"), layers), scale=d ** -0.5),
        "wk": PD(_stack((d, K * hd), layers),
                 _saxes(("embed", "kv_flat"), layers), scale=d ** -0.5),
        "wv": PD(_stack((d, K * hd), layers),
                 _saxes(("embed", "kv_flat"), layers), scale=d ** -0.5),
        "wo": PD(_stack((H * hd, cfg.d_model), layers),
                 _saxes(("qkv_flat", "embed"), layers),
                 scale=(H * hd) ** -0.5),
    }


def apply_attention(ctx: Ctx, cfg: ModelConfig, p: dict, x, cos, sin, *,
                    local_window=None, cache=None, cache_index=None,
                    block_tables=None):
    """x: (B, S, d).  With ``cache`` (dict k/v (B, Smax, K, hd), one
    layer's views of the stacked cache) the new k/v rows are written IN
    PLACE and attention reads the cache: a (B,) ``cache_index`` tensor is
    the per-slot decode write (the ``cache_update`` kernel, done slots
    dropped), a scalar index the batch-1 prefill write (a slice copy).
    With ``block_tables`` ((B, max_blocks) int32) the cache leaves are
    PAGED pools (n_blocks, bs, K, hd): every write and read goes through
    the table (``cache_update_paged``, ``flash_decode_paged``), and a
    scalar prefill cursor is broadcast to (B,).  Returns (y, cache)."""
    c = ctx.cdtype
    B, S = x.shape[:2]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(c)).reshape(B, S, H, hd)
    k = (x @ p["wk"].to(c)).reshape(B, S, K, hd)
    v = (x @ p["wv"].to(c)).reshape(B, S, K, hd)
    if cfg.use_rope:
        q = apply_rope(q, cos, sin, cfg.rotary_pct)
        k = apply_rope(k, cos, sin, cfg.rotary_pct)
    scale = (cfg.query_scale ** -0.5 if cfg.query_scale is not None
             else cfg.head_dim ** -0.5)

    if cache is not None and block_tables is not None:
        ck, cv = cache["k"], cache["v"]
        if torch.is_tensor(cache_index) and cache_index.ndim >= 1:
            idx = cache_index.to(torch.int32)
        else:
            idx = torch.full((B,), int(cache_index), dtype=torch.int32,
                             device=x.device)
        ops.kv_cache_update_paged(ck, cv, k.contiguous(), v.contiguous(),
                                  idx, block_tables)
        out = ops.decode_attention_paged(q.contiguous(), ck.to(c), cv.to(c),
                                         idx + S, block_tables,
                                         softcap=cfg.attn_softcap,
                                         local_window=local_window,
                                         scale=scale)
    elif cache is not None:
        ck, cv = cache["k"], cache["v"]
        if torch.is_tensor(cache_index) and cache_index.ndim >= 1:
            idx = cache_index.to(torch.int32)
            ops.kv_cache_update(ck, cv, k.contiguous(), v.contiguous(), idx)
            kv_len = idx + S
        else:
            start = int(cache_index)
            if start < 0 or start + S > ck.shape[1]:
                raise ValueError(f"prefill rows [{start}, {start + S}) "
                                 f"outside the cache's {ck.shape[1]} rows")
            ck[:, start:start + S] = k.to(ck.dtype)
            cv[:, start:start + S] = v.to(cv.dtype)
            kv_len = torch.full((B,), start + S, dtype=torch.int32,
                                device=x.device)
        out = ops.decode_attention(q.contiguous(), ck.to(c), cv.to(c),
                                   kv_len, softcap=cfg.attn_softcap,
                                   local_window=local_window, scale=scale)
    else:
        out = ops.attention(q, k, v, causal=cfg.causal,
                            local_window=local_window,
                            softcap=cfg.attn_softcap, scale=scale,
                            naive_below=ctx.run.naive_attn_below)
    y = out.reshape(B, S, H * hd) @ p["wo"].to(c)
    return y, cache


def empty_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                   layers: int = 0, device="cpu"):
    shape = _stack((batch, max_seq, cfg.n_kv_heads, cfg.head_dim), layers)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def empty_paged_kv_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                         dtype, layers: int = 0, device="cpu"):
    """Block pools (layers, n_blocks, block_size, K, hd) shared by all
    slots."""
    shape = _stack((n_blocks, block_size, cfg.n_kv_heads, cfg.head_dim),
                   layers)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ===========================================================================
# dense MLPs
# ===========================================================================

def mlp_decls(cfg: ModelConfig, layers: int = 0) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    decls = {
        "w_up": PD(_stack((d, f), layers), _saxes(("embed", "mlp"), layers)),
        "w_down": PD(_stack((f, d), layers), _saxes(("mlp", "embed"), layers)),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        decls["w_gate"] = PD(_stack((d, f), layers),
                             _saxes(("embed", "mlp"), layers))
    return decls


def apply_mlp(ctx: Ctx, cfg: ModelConfig, p: dict, x):
    c = ctx.cdtype
    up = x @ p["w_up"].to(c)
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["w_gate"].to(c)) * up
    elif cfg.mlp == "geglu":
        h = F.gelu(x @ p["w_gate"].to(c), approximate="tanh") * up
    elif cfg.mlp == "squared_relu":
        r = F.relu(up)
        h = r * r
    elif cfg.mlp == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(cfg.mlp)
    return h @ p["w_down"].to(c)


# ===========================================================================
# embeddings
# ===========================================================================

def embed_decls(cfg: ModelConfig) -> dict:
    return {"table": PD((cfg.vocab_padded, cfg.d_model), ("vocab", "embed"),
                        "embed", scale=0.02)}


def apply_embed(ctx: Ctx, cfg: ModelConfig, p: dict, tokens):
    emb = p["table"].to(ctx.cdtype)[tokens.long()]
    if cfg.embed_scale_by_sqrt_dim:      # gemma-style input scaling
        emb = emb * torch.tensor(cfg.d_model ** 0.5, dtype=ctx.cdtype)
    return emb


def unembed_decls(cfg: ModelConfig) -> dict:
    if cfg.tie_embeddings:
        return {}
    return {"w": PD((cfg.d_model, cfg.vocab_padded), ("embed", "vocab"),
                    scale=cfg.d_model ** -0.5)}
