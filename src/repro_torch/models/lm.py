"""LM assembly, dense and MoE families, ported from ``repro/models/lm.py``.

One declarative parameter tree (the reference's keys and shapes, so the
JAX package's weights load unchanged) and one forward: a pre-norm decoder
whose layers run in a Python loop over the stacked ``layers`` leaves
(the reference's ``lax.scan``); with ``n_experts > 0`` every layer's MLP
is the MoE layer and ``forward`` returns the layers' summed aux loss.
Other families and the gemma2 local/global pattern raise, naming the
ROADMAP item that ports them.

Forward modes:
  forward(...)                     full-sequence hidden states (no cache);
                                   with grad enabled each layer is
                                   checkpointed under ``run.remat="full"``
  forward(..., cache, cache_index) prefill chunk or decode step; the cache
                                   (dense ``init_cache`` or paged
                                   ``init_paged_cache``) is updated in place
"""

from __future__ import annotations

import functools
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def _require_ported(cfg: ModelConfig) -> None:
    """The families the port runs: dense and MoE decoders."""
    if cfg.family not in ("dense", "moe"):
        item = {"ssm": "8", "hybrid": "8", "vlm": "12",
                "audio": "12"}.get(cfg.family, "?")
        raise NotImplementedError(
            f"{cfg.family} family: ROADMAP queue 1 item {item}")
    if cfg.layer_pattern != "global" or cfg.post_norms:
        raise NotImplementedError("gemma2 local/global layers and post-norms: "
                                  "ROADMAP queue 1 item 11")


# ===========================================================================
# declarations
# ===========================================================================

def model_decls(cfg: ModelConfig) -> dict:
    _require_ported(cfg)
    n = cfg.n_layers
    d: dict[str, Any] = {
        "embed": L.embed_decls(cfg),
        "layers": {
            "ln1": L.norm_decls(cfg, layers=n),
            "attn": L.attention_decls(cfg, layers=n),
            "ln2": L.norm_decls(cfg, layers=n),
            "mlp": (L.moe_decls(cfg, layers=n) if cfg.n_experts
                    else L.mlp_decls(cfg, layers=n)),
        },
        "final_norm": L.norm_decls(cfg),
    }
    ue = L.unembed_decls(cfg)
    if ue:
        d["unembed"] = ue
    return d


def prepare_params(ctx: L.Ctx, params):
    """The params on ``ctx.device`` with the matrices and the embedding
    table cast ONCE to the compute dtype.  The reference casts its f32
    masters at every use; casting once rounds identically.  Norm scales
    stay float32 (norm maths is float32), and so does the MoE router: the
    reference computes its logits from the f32 masters, and a bf16 router
    would route differently."""
    c, dev = ctx.cdtype, torch.device(ctx.device)

    def cast(tree, key=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        if key in ("scale", "bias", "router"):
            return tree.to(dev)
        return tree.to(device=dev, dtype=c)

    return cast(params)


# ===========================================================================
# forward
# ===========================================================================

def _tf_block(ctx: L.Ctx, cfg: ModelConfig, p, h, cos, sin, *,
              local_window=None, cache=None, cache_index=None,
              block_tables=None):
    """One transformer block; returns (h, cache, aux), aux the MoE
    layer's load-balancing loss (None in a dense block)."""
    a_in = L.apply_norm(cfg, p["ln1"], h)
    attn_out, cache = L.apply_attention(
        ctx, cfg, p["attn"], a_in, cos, sin, local_window=local_window,
        cache=cache, cache_index=cache_index, block_tables=block_tables)
    h = h + attn_out
    m_in = L.apply_norm(cfg, p["ln2"], h)
    if cfg.n_experts:
        mlp_out, aux = L.apply_moe(ctx, cfg, p["mlp"], m_in)
    else:
        mlp_out, aux = L.apply_mlp(ctx, cfg, p["mlp"], m_in), None
    return h + mlp_out, cache, aux


def _remat_block(ctx: L.Ctx, cfg: ModelConfig, p, h, cos, sin):
    """A cache-free block for ``torch.utils.checkpoint``: (h, aux)."""
    h, _, aux = _tf_block(ctx, cfg, p, h, cos, sin)
    return h, aux


def _remat(ctx: L.Ctx):
    """The reference's ``remat`` (``repro/models/lm.py:127-133``) for a
    training forward: ``"full"`` keeps only each layer's input and runs
    the layer again in the backward pass (``torch.utils.checkpoint``,
    non-reentrant), ``"none"`` keeps every activation.  Returns True for
    a checkpointed forward."""
    if ctx.run.remat == "dots":
        raise NotImplementedError('remat="dots": ROADMAP queue 1 item 15')
    return ctx.run.remat == "full"


def _unstack(tree, n: int) -> list:
    """The stacked layer params as ``n`` per-layer trees of views, by one
    ``torch.unbind`` per leaf.  Indexing ``leaf[i]`` per layer would cost
    a training step dearly: each ``select`` backward zero-fills a
    gradient of the whole stacked leaf and adds it into ``.grad``, once
    per layer; ``unbind``'s backward stacks the layers' gradients once."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return torch.unbind(tree, 0)


def _positions_default(batch: int, seq: int, device, cache_index=None):
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    if cache_index is not None:
        if torch.is_tensor(cache_index) and cache_index.ndim == 1:
            # (B,) index: per-slot offsets (continuous batching)
            pos = pos + cache_index.to(torch.int32)[:, None]
        else:
            pos = pos + int(cache_index)   # scalar: shared offset
    return pos.expand(batch, seq)


def forward(ctx: L.Ctx, cfg: ModelConfig, params, batch: dict, *,
            cache=None, cache_index=None):
    """Returns (hidden (B,S,D), aux_loss, cache).  ``cache`` is the
    ``init_cache`` dict (or one slot's views of it), or the
    ``init_paged_cache`` dict (pools passed whole, possibly with one
    slot's table row), and is written in place; the same dict comes back.
    A paged cache's top-level ``block_tables`` addresses every layer's
    pools; the model never remaps blocks."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = L.apply_embed(ctx, cfg, params["embed"], tokens)
    positions = batch.get("positions")
    if positions is None:
        positions = _positions_default(B, S, tokens.device, cache_index)
    cos, sin = (L.rope_cos_sin(cfg, positions) if cfg.use_rope
                else (None, None))
    kv = cache["kv"] if cache is not None else None
    block_tables = cache.get("block_tables") if cache is not None else None
    remat = cache is None and torch.is_grad_enabled() and _remat(ctx)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, p in enumerate(_unstack(params["layers"], cfg.n_layers)):
        if remat:
            h, a = torch.utils.checkpoint.checkpoint(
                functools.partial(_remat_block, ctx, cfg), p, h, cos, sin,
                use_reentrant=False)
        else:
            layer_cache = ({"k": kv["k"][i], "v": kv["v"][i]}
                           if kv is not None else None)
            h, _, a = _tf_block(ctx, cfg, p, h, cos, sin,
                                cache=layer_cache, cache_index=cache_index,
                                block_tables=block_tables)
        if a is not None:
            aux = aux + a
    h = L.apply_norm(cfg, params["final_norm"], h)
    return h, aux, cache


# ===========================================================================
# logits / caches
# ===========================================================================

def unembed_matrix(cfg: ModelConfig, params, dtype):
    if cfg.tie_embeddings:
        return params["embed"]["table"].to(dtype).T
    return params["unembed"]["w"].to(dtype)


def logits_for(ctx: L.Ctx, cfg: ModelConfig, params, h):
    """Full float32 logits (decode path; small S).  Pad-vocab columns
    masked."""
    w = unembed_matrix(cfg, params, ctx.cdtype)
    logits = (h @ w).float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def init_cache(ctx: L.Ctx, cfg: ModelConfig, batch: int, max_seq: int):
    """Decode state: stacked (L, B, max_seq, K, hd) k/v zeros in the
    compute dtype on ``ctx.device``."""
    _require_ported(cfg)
    return {"kv": L.empty_kv_cache(cfg, batch, max_seq, ctx.cdtype,
                                   layers=cfg.n_layers, device=ctx.device)}


def init_paged_cache(ctx: L.Ctx, cfg: ModelConfig, batch: int, max_seq: int,
                     block_size: int, n_blocks: int | None = None):
    """Paged decode state on ``ctx.device``: the rows become block POOLS
    (L, n_blocks, block_size, K, hd) shared by all slots, plus one
    top-level ``block_tables`` ((batch, max_seq // block_size) int32)
    mapping each slot's logical rows to pool blocks.  Tables start at zero,
    as the reference's: an unmapped entry aliases block 0, harmless since
    reads past kv_len are masked and writes only reach mapped entries.
    ``n_blocks`` defaults to ``batch * max_blocks`` (the dense capacity)."""
    _require_ported(cfg)
    if max_seq % block_size:
        raise ValueError(f"max_seq {max_seq} must be a multiple of "
                         f"block_size {block_size}")
    max_blocks = max_seq // block_size
    if n_blocks is None:
        n_blocks = batch * max_blocks
    return {"kv": L.empty_paged_kv_cache(cfg, n_blocks, block_size,
                                         ctx.cdtype, layers=cfg.n_layers,
                                         device=ctx.device),
            "block_tables": torch.zeros((batch, max_blocks),
                                        dtype=torch.int32,
                                        device=ctx.device)}


#: Slot semantics of a cache kind (as the reference): "rows" leaves carry
#: sequence rows on axis 2, valid up to the slot's kv_len.
SLOT_ROWS = "rows"


def cache_slot_spec(cfg: ModelConfig) -> dict[str, str]:
    """Per-top-level-key slot schema of ``init_cache``'s dict."""
    _require_ported(cfg)
    return {"kv": SLOT_ROWS}
