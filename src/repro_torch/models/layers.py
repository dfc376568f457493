"""Neural layers of the dense and MoE decoders and of the Mamba-2 block,
ported from ``repro/models/layers.py``.

Every ``*_decls`` returns a nested dict of PD declarations with the
reference's keys and shapes; the matching ``apply_*`` consumes the
materialized tensors.  ``Ctx`` holds the run config and the device; the
port has no sharding.  Weights are cast to the compute dtype at use with
``.to(c)``, a no-op once ``lm.prepare_params`` has cast them at load.  In
training the parameters stay f32 masters with ``requires_grad``: the cast
at use is differentiable, so autograd returns f32 gradients, as JAX
does.

The MoE layer is the reference's local path (token-choice top-k router,
capacity dispatch, grouped expert FFN, weighted combine).  Its
expert-parallel ``shard_map`` path and the int8 all-to-all
(``repro/models/layers.py:546-640``) need a mesh, which the port does not
have yet: ROADMAP queue 1 item 14.

The Mamba-2 block runs its prefill chunks through ``ops.ssd`` (the
``ssd`` kernel on CUDA) and its single-token decode through the plain
one-step recurrence, as the reference does; its SSM and conv states are
the cache's views and are updated in place.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels import ops, ref
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


def rmsnorm_gated(scale, y, z, eps: float = 1e-6):
    """Mamba-2 RMSNormGated: rmsnorm(y * silu(z)) * scale."""
    yf = y.float() * F.silu(z.float())
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


# ===========================================================================
# rotary position embeddings (plain RoPE, partial rotary, M-RoPE)
# ===========================================================================

def rope_cos_sin(cfg: ModelConfig, positions):
    """positions: (B, S) int for RoPE, or (3, B, S) for M-RoPE
    (``cfg.mrope_sections``: section i of the rotary half takes its slice
    of the frequencies and position row i, ``repro/models/layers.py:
    100-117``).  Returns cos/sin of shape (B, S, rot_half).  Each angle is
    the same float32 product as plain RoPE's, so three equal position rows
    give plain RoPE's cos/sin bit for bit."""
    rot_dim = int(cfg.head_dim * cfg.rotary_pct) // 2 * 2
    half = rot_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    inv_freq = cfg.rope_theta ** exponent
    if cfg.mrope_sections is not None:
        if sum(cfg.mrope_sections) != half or positions.ndim != 3:
            raise ValueError(f"M-RoPE sections {cfg.mrope_sections} over a "
                             f"rotary half of {half} take (3, B, S) "
                             f"positions, got {tuple(positions.shape)}")
        parts, start = [], 0
        for i, sec in enumerate(cfg.mrope_sections):
            parts.append(positions[i].float()[..., None]
                         * inv_freq[start:start + sec][None, None])
            start += sec
        ang = torch.cat(parts, dim=-1)
    else:
        ang = positions.float()[..., None] * inv_freq[None, None]
    return torch.cos(ang), torch.sin(ang)


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
                    block_tables=None, q_delta=None):
    """x: (B, S, d).  With ``cache`` (dict k/v (B, Smax, K, hd), one
    layer's views of the stacked cache) RoPE of q and k and the write of
    the new k/v rows IN PLACE are one ``cache_update`` launch, and
    attention reads the cache: a (B,) ``cache_index`` tensor is the
    per-slot decode write (done slots dropped), a scalar index the prefill
    write, broadcast to (B,) (rows outside the cache raise first).  With
    ``block_tables`` ((B, max_blocks) int32) the cache leaves are PAGED
    pools (n_blocks, bs, K, hd): every write and read goes through the
    table (``cache_update_paged``, ``flash_decode_paged``).  ``q_delta``
    (B, S, H, hd), zamba2's per-invocation LoRA, is added to q before RoPE
    (the reference's ``_attention_with_qdelta``,
    ``repro/models/lm.py:372``).  Without a cache RoPE is ``apply_rope``
    and attention the differentiable ``ops.attention``.  Returns (y,
    cache)."""
    c = ctx.cdtype
    B, S = x.shape[:2]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(c)).reshape(B, S, H, hd)
    if q_delta is not None:
        q = q + q_delta
    k = (x @ p["wk"].to(c)).reshape(B, S, K, hd)
    v = (x @ p["wv"].to(c)).reshape(B, S, K, hd)
    scale = (cfg.query_scale ** -0.5 if cfg.query_scale is not None
             else cfg.head_dim ** -0.5)

    if cache is None:
        if cfg.use_rope:
            q = ref.apply_rope(q, cos, sin, cfg.rotary_pct)
            k = ref.apply_rope(k, cos, sin, cfg.rotary_pct)
        out = ops.attention(q, k, v, causal=cfg.causal,
                            local_window=local_window,
                            softcap=cfg.attn_softcap, scale=scale,
                            naive_below=ctx.run.naive_attn_below)
        return out.reshape(B, S, H * hd) @ p["wo"].to(c), cache

    ck, cv = cache["k"], cache["v"]
    if torch.is_tensor(cache_index) and cache_index.ndim >= 1:
        idx = cache_index.to(torch.int32)
    else:
        start = int(cache_index)
        if block_tables is None and (start < 0 or start + S > ck.shape[1]):
            raise ValueError(f"prefill rows [{start}, {start + S}) "
                             f"outside the cache's {ck.shape[1]} rows")
        idx = torch.full((B,), start, dtype=torch.int32, device=x.device)
    rope = (dict(q=q.contiguous(), cos=cos, sin=sin,
                 rotary_pct=cfg.rotary_pct) if cfg.use_rope else {})
    attn = dict(softcap=cfg.attn_softcap, local_window=local_window,
                scale=scale)
    if block_tables is not None:
        written = ops.kv_cache_update_paged(ck, cv, k.contiguous(),
                                            v.contiguous(), idx,
                                            block_tables, **rope)
    else:
        written = ops.kv_cache_update(ck, cv, k.contiguous(),
                                      v.contiguous(), idx, **rope)
    if rope:
        q = written[2]
    if block_tables is not None:
        out = ops.decode_attention_paged(q.contiguous(), ck.to(c), cv.to(c),
                                         idx + S, block_tables, **attn)
    else:
        out = ops.decode_attention(q.contiguous(), ck.to(c), cv.to(c),
                                   idx + S, **attn)
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
# mixture of experts (token-choice top-k, capacity-based dispatch)
# ===========================================================================

def moe_decls(cfg: ModelConfig, layers: int = 0) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": PD(_stack((d, e), layers), _saxes(("embed", None), layers),
                     scale=d ** -0.5),
        "w_gate": PD(_stack((e, d, f), layers),
                     _saxes(("expert", "embed", "expert_mlp"), layers),
                     scale=d ** -0.5),
        "w_up": PD(_stack((e, d, f), layers),
                   _saxes(("expert", "embed", "expert_mlp"), layers),
                   scale=d ** -0.5),
        "w_down": PD(_stack((e, f, d), layers),
                     _saxes(("expert", "expert_mlp", "embed"), layers),
                     scale=f ** -0.5),
    }


def _moe_router(cfg: ModelConfig, p: dict, xf):
    """Router probabilities, top-k and the Switch load-balancing aux loss,
    in float32 from the float32 router (``lm.prepare_params`` keeps it
    f32, as the reference reads its masters).  xf: (T, D).  Returns
    top_p (T, K) renormalised, top_e (T, K) and aux ()."""
    E, K = cfg.n_experts, cfg.top_k
    T = xf.shape[0]
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    me = probs.mean(dim=0)
    ce = torch.zeros((E,), dtype=torch.float32, device=xf.device).index_add_(
        0, top_e.reshape(-1),
        torch.full((T * K,), 1.0 / (T * K), dtype=torch.float32,
                   device=xf.device))
    aux = E * torch.sum(me * ce)
    return top_p, top_e, aux


def _moe_dispatch_local(cfg: ModelConfig, xf, top_e, capacity: int):
    """Capacity dispatch of the call's tokens into (E, capacity, D), with
    the combine indices.  Each (token, k) assignment, in row-major order,
    takes the next position of its expert (a cumulative count); positions
    past ``capacity`` go to an overflow row ``capacity`` that is cut off.
    Returns (expert_in, flat_e, slot, keep).  Nothing here reads a device
    value on the host."""
    E, K = cfg.n_experts, cfg.top_k
    T, D = xf.shape
    flat_e = top_e.reshape(-1)                                  # (T*K,)
    onehot = (flat_e[:, None]
              == torch.arange(E, device=xf.device)[None]).int()
    pos_in_e = torch.cumsum(onehot, dim=0) - 1
    pos = pos_in_e.gather(1, flat_e[:, None])[:, 0]
    keep = pos < capacity
    slot = torch.where(keep, pos, capacity)
    src = xf[:, None, :].expand(T, K, D).reshape(T * K, D)
    # only the overflow row ever takes two writes; kept rows take one
    expert_in = xf.new_zeros((E, capacity + 1, D)).index_put(
        (flat_e, slot), src, accumulate=True)
    return expert_in[:, :capacity], flat_e, slot, keep


def _moe_combine_local(out, flat_e, slot, keep, top_p, B: int, S: int):
    """Gather the expert outputs back to token order, weighted by the
    router probability (zero where capacity dropped the assignment); the
    weighting and the sum over K run in the output dtype."""
    E, _, D = out.shape
    K = top_p.shape[-1]
    out_p = torch.cat([out, out.new_zeros((E, 1, D))], dim=1)
    gathered = out_p[flat_e, slot]
    gathered = gathered * (top_p.reshape(-1)[:, None].to(out.dtype)
                           * keep[:, None].to(out.dtype))
    return gathered.reshape(B * S, K, D).sum(dim=1).reshape(B, S, D)


def _moe_expert_ffn(ctx: Ctx, cfg: ModelConfig, p: dict, expert_in):
    """SwiGLU per expert: three grouped matmuls (the ``grouped_matmul``
    kernel on CUDA)."""
    c = ctx.cdtype
    gate = ops.grouped_matmul(expert_in, p["w_gate"].to(c))
    up = ops.grouped_matmul(expert_in, p["w_up"].to(c))
    return ops.grouped_matmul(F.silu(gate) * up, p["w_down"].to(c))


def apply_moe(ctx: Ctx, cfg: ModelConfig, p: dict, x):
    """Token-choice top-k MoE with capacity-based dispatch, the
    reference's local path.  The capacity comes from the call's own token
    count, ``ceil(T * top_k * capacity_factor / E)``, so a token's output
    depends on the other tokens of the call (done decode lanes included).
    x: (B, S, D).  Returns (y, aux_loss)."""
    c = ctx.cdtype
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    xf = x.reshape(B * S, D)
    top_p, top_e, aux = _moe_router(cfg, p, xf)
    capacity = int(max(1, math.ceil(B * S * K * cfg.capacity_factor / E)))
    expert_in, flat_e, slot, keep = _moe_dispatch_local(cfg, xf, top_e,
                                                        capacity)
    out = _moe_expert_ffn(ctx, cfg, p, expert_in.to(c))
    return _moe_combine_local(out, flat_e, slot, keep, top_p, B, S), aux


# ===========================================================================
# mamba-2 block (SSD)
# ===========================================================================

def mamba_decls(cfg: ModelConfig, layers: int = 0) -> dict:
    d, din = cfg.d_model, cfg.d_inner
    H, N, G = cfg.ssm_heads, cfg.ssm_state, 1
    conv_dim = din + 2 * G * N
    d_in_proj = 2 * din + 2 * G * N + H
    return {
        "in_proj": PD(_stack((d, d_in_proj), layers),
                      _saxes(("embed", "ssm_inner"), layers)),
        "conv_w": PD(_stack((cfg.ssm_conv, conv_dim), layers),
                     _saxes(("conv", "ssm_inner"), layers),
                     scale=cfg.ssm_conv ** -0.5),
        "conv_b": PD(_stack((conv_dim,), layers),
                     _saxes(("ssm_inner",), layers), "zeros"),
        "A_log": PD(_stack((H,), layers), _saxes(("ssm_heads",), layers),
                    "embed", scale=0.5),
        "D": PD(_stack((H,), layers), _saxes(("ssm_heads",), layers), "ones"),
        "dt_bias": PD(_stack((H,), layers), _saxes(("ssm_heads",), layers),
                      "embed", scale=0.5),
        "norm": PD(_stack((din,), layers), _saxes(("ssm_inner",), layers),
                   "ones"),
        "out_proj": PD(_stack((din, d), layers),
                       _saxes(("ssm_inner", "embed"), layers)),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv via shifted adds. x: (B,S,C); w: (W,C)."""
    W, S = w.shape[0], x.shape[1]
    out = x * w[-1][None, None, :]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[W - 1 - i][None, None, :]
    return out + b[None, None, :]


def _split_mamba(cfg: ModelConfig, zxbcdt):
    din, N = cfg.d_inner, cfg.ssm_state
    G = 1
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:din + din + 2 * G * N]
    dt = zxbcdt[..., din + din + 2 * G * N:]
    return z, xbc, dt


def apply_mamba(ctx: Ctx, cfg: ModelConfig, p: dict, x, *, ssm_state=None,
                conv_state=None):
    """Mamba-2 block, the reference's three modes
    (``repro/models/layers.py:686-746``):
      * cache-free (both states None): zero-padded causal conv, SSD from a
        zero state;
      * prefill into a cache slot (S > 1, or S == 1 without ``ssm_state``):
        the carried conv window is the chunk's true left context, and the
        chunk's SSD (the ``ssd`` kernel on CUDA) starts from ``ssm_state``;
      * single-step decode (S == 1 and ``ssm_state`` given): the conv
        window rolls by one row and the recurrence takes one step.
    ``ssm_state`` (B, H, P, N) float32 and ``conv_state`` (B, W-1, conv)
    are one layer's views of the cache and are updated IN PLACE.
    Returns (y, (ssm_state, conv_state))."""
    c = ctx.cdtype
    B, S, _ = x.shape
    din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    G = 1
    zxbcdt = x @ p["in_proj"].to(c)
    z, xbc, dt_raw = _split_mamba(cfg, zxbcdt)

    conv_w = p["conv_w"].to(c)
    conv_b = p["conv_b"].to(c)
    decode = S == 1 and ssm_state is not None
    if decode:
        # decode: roll the window, apply the conv at the newest position
        window = torch.cat([conv_state, xbc], dim=1)           # (B, W, C)
        xbc = (window * conv_w[None]).sum(dim=1, keepdim=True) + conv_b
        conv_state.copy_(window[:, 1:])
    elif conv_state is not None:
        # prefill into a cache slot, possibly continuing an earlier chunk:
        # the carried window is the true left context (a fresh slot carries
        # zeros, which is plain zero-padding), so chunked prefill is exact
        window = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
        conv_state.copy_(window[:, -(cfg.ssm_conv - 1):])
        xbc = _causal_conv(window, conv_w, conv_b)[:, cfg.ssm_conv - 1:]
    else:
        xbc = _causal_conv(xbc, conv_w, conv_b)
    xbc = F.silu(xbc)

    xs = xbc[..., :din].reshape(B, S, H, P)
    Bm = xbc[..., din:din + G * N].reshape(B, S, G, N)
    Cm = xbc[..., din + G * N:].reshape(B, S, G, N)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    D = p["D"].float()

    if decode:
        y1, new_state = ref.ssd_decode_step(ssm_state, xs[:, 0],
                                            dt[:, 0].to(c), A, Bm[:, 0],
                                            Cm[:, 0], D=D)
        ssm_state.copy_(new_state)
        y = y1[:, None]
    else:
        chunk = min(cfg.ssm_chunk, S)
        while S % chunk:
            chunk -= 1
        y, _ = ops.ssd(xs, dt.to(c), A, Bm, Cm, D=D, h0=ssm_state,
                       chunk=chunk, state_out=ssm_state)
    y = y.reshape(B, S, din)
    y = rmsnorm_gated(p["norm"], y, z)
    return y @ p["out_proj"].to(c), (ssm_state, conv_state)


def empty_mamba_state(cfg: ModelConfig, batch: int, dtype, layers: int = 0,
                      device="cpu"):
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "ssm": torch.zeros(_stack((batch, H, P, N), layers),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros(_stack((batch, cfg.ssm_conv - 1, conv_dim),
                                   layers), dtype=dtype, device=device),
    }


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
