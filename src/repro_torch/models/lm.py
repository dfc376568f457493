"""LM assembly, ported from ``repro/models/lm.py``: the dense and MoE
decoders, the Mamba-2 stack (``ssm``), the zamba2 hybrid, the audio
encoder and the vision-language decoder.

One declarative parameter tree (the reference's keys and shapes, so the
JAX package's weights load unchanged) and one forward whose layers run in
a Python loop over the stacked ``layers`` leaves (the reference's
``lax.scan``):
  dense, moe  a pre-norm decoder; with ``n_experts > 0`` every layer's
              MLP is the MoE layer and ``forward`` returns the layers'
              summed aux loss; with ``post_norms`` the sandwich norms and
              with ``layer_pattern="local_global"`` alternating (local,
              global) layer pairs, each stack with its own cache (gemma2)
  ssm         pre-norm residual Mamba-2 blocks (mamba2)
  hybrid      Mamba-2 blocks with one SHARED attention block applied after
              every ``shared_attn_period`` of them, on concat(h, the
              embedding output), with per-invocation LoRA on q (zamba2)
  audio       an encoder-only, bidirectional transformer over precomputed
              frame embeddings: ``frontend`` projects them and adds a
              learned position table (hubert; the frontend is a stub, as
              in the reference); it has no decode cache
  vlm         a decoder with M-RoPE over (3, B, S) positions, precomputed
              patch embeddings (``vision_embeds``) overwriting the leading
              token rows (qwen2-vl; the vision tower is a stub); its cache
              is the dense decoder's

Forward modes:
  forward(...)                     full-sequence hidden states (no cache);
                                   with grad enabled each layer is
                                   checkpointed under ``run.remat="full"``
                                   (nothing saved) or ``"dots"`` (the 2-D
                                   matrix products saved)
  forward(..., cache, cache_index) prefill chunk or decode step; the cache
                                   (dense ``init_cache`` or paged
                                   ``init_paged_cache``) is updated in place

Portable slot state (``export_slot``/``import_slot``, their paged
variants, int8 payloads) moves one slot's lane between caches of any
batch size and ``max_seq``: the serving engine's drain and restore.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models.params import PD
from repro_torch.sharding import collectives as C


def require_mesh_family(cfg: ModelConfig, rules) -> None:
    """The Mamba-2 stack and the hybrid run head-parallel under
    ``default`` and ``fsdp``; under a sequence-parallel rule set
    (``act_seq`` on ``model``, where the reference's ``act_ssm`` resolves
    to replicated and GSPMD decides how the scan crosses ranks) they have
    no per-rank program yet."""
    if cfg.family in ("ssm", "hybrid") and rules.get("act_seq") == L.MODEL:
        raise NotImplementedError(
            f"{cfg.family} layers under the sequence-parallel rule set "
            f"{rules.name!r}: ROADMAP item 14b (c2)")


def _require_cache(cfg: ModelConfig) -> None:
    """The audio encoder has no decode cache: the reference's error
    (``repro/models/lm.py:524``)."""
    if cfg.family == "audio":
        raise ValueError(f"{cfg.family} has no decode cache (encoder-only)")


# ===========================================================================
# declarations
# ===========================================================================

def _tf_layer_decls(cfg: ModelConfig, n: int) -> dict:
    """A stack of ``n`` transformer layers; with ``post_norms`` the
    sandwich norms on the attention and MLP outputs."""
    d = {
        "ln1": L.norm_decls(cfg, layers=n),
        "attn": L.attention_decls(cfg, layers=n),
        "ln2": L.norm_decls(cfg, layers=n),
        "mlp": (L.moe_decls(cfg, layers=n) if cfg.n_experts
                else L.mlp_decls(cfg, layers=n)),
    }
    if cfg.post_norms:
        d["post_ln1"] = L.norm_decls(cfg, layers=n)
        d["post_ln2"] = L.norm_decls(cfg, layers=n)
    return d


def _shared_attn_decls(cfg: ModelConfig, n_inv: int) -> dict:
    """Zamba2 shared transformer block over concat(h, emb) (width
    2*d_model), plus per-invocation LoRA adapters on the q projection."""
    d2 = 2 * cfg.d_model
    r = cfg.shared_attn_lora or 32
    return {
        "ln1": L.norm_decls(cfg, d=d2),
        "attn": L.attention_decls(cfg, d_in=d2),
        "ln2": L.norm_decls(cfg, d=d2),
        "mlp": {
            "w_up": PD((d2, cfg.d_ff), ("embed", "mlp")),
            "w_gate": PD((d2, cfg.d_ff), ("embed", "mlp")),
            "w_down": PD((cfg.d_ff, cfg.d_model), ("mlp", "embed")),
        },
        "lora_a": PD((n_inv, d2, r), ("layers", "embed", "lora"),
                     scale=d2 ** -0.5),
        "lora_b": PD((n_inv, r, cfg.n_heads * cfg.head_dim),
                     ("layers", "lora", "qkv_flat"), "zeros"),
    }


def zamba_structure(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_super, mamba_per_super, trailing) with
    n_super*mamba_per_super + trailing == n_layers."""
    period = max(cfg.shared_attn_period, 1)
    n_super = cfg.n_layers // period
    trailing = cfg.n_layers - n_super * period
    return n_super, period, trailing


def model_decls(cfg: ModelConfig) -> dict:
    n = cfg.n_layers
    if cfg.family == "audio":
        # the frontend stub: a projection of the frames and a learned
        # position table (``repro/models/lm.py:88-93``)
        d: dict[str, Any] = {"frontend": {
            "proj": PD((cfg.frontend_dim, cfg.d_model),
                       ("frontend", "embed")),
            "pos": PD((cfg.max_wavelength_pos, cfg.d_model),
                      (None, "embed"), "embed", scale=0.02)}}
    else:
        d = {"embed": L.embed_decls(cfg)}
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "audio", "vlm"):
        raise ValueError(cfg.family)
    if cfg.family in ("ssm", "hybrid"):
        d["layers"] = {"ln": L.norm_decls(cfg, layers=n),
                       "mamba": L.mamba_decls(cfg, layers=n)}
        if cfg.family == "hybrid":
            d["shared"] = _shared_attn_decls(cfg, zamba_structure(cfg)[0])
    elif cfg.layer_pattern == "local_global":
        d["layers_local"] = _tf_layer_decls(cfg, n // 2)
        d["layers_global"] = _tf_layer_decls(cfg, n // 2)
    else:
        d["layers"] = _tf_layer_decls(cfg, n)
    d["final_norm"] = L.norm_decls(cfg)
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
    would route differently.  So do the Mamba block's ``A_log``, ``D``,
    ``dt_bias`` and gated-norm ``norm``, which the reference reads as
    float32 from its masters (``repro/models/layers.py:93, 725-740``):
    rounded to bf16, A and D would make the bf16 streams drift."""
    def cast(tree, key=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        return prepare_leaf(ctx, (key,), tree)

    return cast(params)


def prepare_leaf(ctx: L.Ctx, path, t):
    """One leaf of ``prepare_params``, named by its key ``path``: on
    ``ctx.device``, float32 if its last key is in ``L.F32_LEAVES``, else in
    the compute dtype.  ``init_params(..., prepare=...)`` applies it to
    each leaf as it is drawn, so the f32 masters never exist whole."""
    if path[-1] in L.F32_LEAVES:
        return t.to(ctx.device)
    return t.to(device=ctx.device, dtype=ctx.cdtype)


# ===========================================================================
# forward
# ===========================================================================

def _tf_block(ctx: L.Ctx, cfg: ModelConfig, p, h, cos, sin, *,
              local_window=None, cache=None, cache_index=None,
              block_tables=None):
    """One transformer block; returns (h, cache, aux), aux the MoE
    layer's load-balancing loss (None in a dense block).  With the
    sandwich norms (``post_ln1``, ``post_ln2``) the attention and MLP
    outputs are normed before their residual adds
    (``repro/models/lm.py:155-177``).  Under a mesh the layer's weights
    are first gathered where the program needs them whole
    (``L.use_weights``)."""
    if ctx.mesh is not None:
        p = L.use_weights(ctx, p, _tf_layer_decls(cfg, 0))
    a_in = L.apply_norm(cfg, p["ln1"], h)
    attn_out, cache = L.apply_attention(
        ctx, cfg, p["attn"], a_in, cos, sin, local_window=local_window,
        cache=cache, cache_index=cache_index, block_tables=block_tables)
    if "post_ln1" in p:
        attn_out = L.apply_norm(cfg, p["post_ln1"], attn_out)
    h = h + attn_out
    m_in = L.apply_norm(cfg, p["ln2"], h)
    if cfg.n_experts:
        mlp_out, aux = L.apply_moe(ctx, cfg, p["mlp"], m_in)
    else:
        mlp_out, aux = L.apply_mlp(ctx, cfg, p["mlp"], m_in), None
    if "post_ln2" in p:
        mlp_out = L.apply_norm(cfg, p["post_ln2"], mlp_out)
    return h + mlp_out, cache, aux


def _remat_block(ctx: L.Ctx, cfg: ModelConfig, local_window, p, h, cos,
                 sin):
    """A cache-free block for ``torch.utils.checkpoint``: (h, aux)."""
    h, _, aux = _tf_block(ctx, cfg, p, h, cos, sin, local_window=local_window)
    return h, aux


#: what ``remat="dots"`` saves: the outputs of 2-D matrix products, as
#: ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims`` saves
#: the ``dot_general``s without batch dimensions (the projections
#: ``x @ W``, the router).  Everything else runs again in the backward
#: pass: ``aten.bmm`` and the batched einsums (attention, the grouped
#: expert product's plain version, the scan's), the elementwise work and
#: the kernels' autograd Functions, whose ctypes launches are no aten op,
#: as a ``pallas_call`` is no dot.
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(ctx: L.Ctx):
    """The reference's ``remat`` (``repro/models/lm.py:127-133``) for a
    training forward, as the keyword arguments of a non-reentrant
    ``torch.utils.checkpoint`` of each layer: ``"full"`` keeps only each
    layer's input and runs the layer again in the backward pass, ``"dots"``
    also keeps the outputs of its 2-D matrix products (``DOTS_SAVED``).
    None for ``"none"``, which keeps every activation."""
    if ctx.run.remat == "full":
        return {}
    if ctx.run.remat == "dots":
        return {"context_fn": _dots_contexts}
    return None


def _checkpoint(remat: dict, fn, *args):
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             **remat)


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


def _mamba_layer(ctx: L.Ctx, cfg: ModelConfig, p, h, ssm_state=None,
                 conv_state=None):
    """One pre-norm residual Mamba-2 layer; the states (one layer's cache
    views) are updated in place.  Under a mesh the layer's weights are
    first gathered where the program needs them whole
    (``L.use_weights``)."""
    if ctx.mesh is not None:
        p = L.use_weights(ctx, p, {"ln": L.norm_decls(cfg),
                                   "mamba": L.mamba_decls(cfg)})
    out, _ = L.apply_mamba(ctx, cfg, p["mamba"], L.apply_norm(cfg, p["ln"], h),
                           ssm_state=ssm_state, conv_state=conv_state)
    return h + out


def _shared_block(ctx: L.Ctx, cfg: ModelConfig, p, inv_idx: int, h, emb0, cos,
                  sin, *, cache=None, cache_index=None, block_tables=None):
    """Zamba2 shared attention block on concat(h, emb0), with invocation
    ``inv_idx``'s LoRA on q (``repro/models/lm.py:344-369``).  Under a
    mesh it is the Megatron block: ``lora_b`` is split by heads in line
    with ``wq`` (``qkv_flat``), so the rank's ``q_delta`` is
    ``copy_to(a_in @ lora_a) @ lora_b_r`` (``copy_to``: each rank's heads
    read the replicated ``a_in @ lora_a``, whose gradient sums them), the
    attention runs on the rank's heads and the MLP is ``L.apply_mlp``'s
    column- and row-parallel pair; ``emb0`` and the concatenated inputs
    are replicated, so ``ln1`` and ``ln2`` run whole."""
    c = ctx.cdtype
    if ctx.mesh is not None:
        p = L.use_weights(ctx, p, _shared_attn_decls(
            cfg, zamba_structure(cfg)[0]))
    a_in = L.apply_norm(cfg, p["ln1"], torch.cat([h, emb0], dim=-1))
    la = p["lora_a"][inv_idx].to(c)
    lb = p["lora_b"][inv_idx].to(c)
    B, S = a_in.shape[:2]
    low = a_in @ la
    if ctx.mesh is not None and lb.shape[-1] != cfg.n_heads * cfg.head_dim:
        low = C.copy_to(low, L.MODEL, ctx.mesh)
    q_delta = (low @ lb).reshape(B, S, -1, cfg.head_dim)
    out, _ = L.apply_attention(ctx, cfg, p["attn"], a_in, cos, sin,
                               cache=cache, cache_index=cache_index,
                               block_tables=block_tables, q_delta=q_delta)
    h = h + out
    m_in = L.apply_norm(cfg, p["ln2"], torch.cat([h, emb0], dim=-1))
    return h + L.apply_mlp(ctx, cfg, p["mlp"], m_in)


def _ssm_forward(ctx: L.Ctx, cfg: ModelConfig, params, h, cos, sin, *,
                 cache, cache_index, block_tables, remat):
    """The Mamba-2 stack; for the hybrid, the shared block after every
    ``shared_attn_period`` layers (invocation i after layer (i+1)*period-1,
    its KV in ``kv_shared`` layer i), trailing layers after the last.
    ``emb0`` is the embedding output, as in the reference's
    ``_zamba_forward`` (``repro/models/lm.py:445``)."""
    st = cache["mamba"] if cache is not None else None
    kv = cache.get("kv_shared") if cache is not None else None
    per = zamba_structure(cfg)[1] if cfg.family == "hybrid" else 0
    emb0 = h
    for i, p in enumerate(_unstack(params["layers"], cfg.n_layers)):
        if remat is not None:
            h = _checkpoint(remat, functools.partial(_mamba_layer, ctx, cfg),
                            p, h)
        else:
            h = _mamba_layer(ctx, cfg, p, h,
                             st["ssm"][i] if st is not None else None,
                             st["conv"][i] if st is not None else None)
        if per and (i + 1) % per == 0:
            inv = (i + 1) // per - 1
            block = functools.partial(_shared_block, ctx, cfg,
                                      params["shared"], inv)
            if remat is not None:
                h = _checkpoint(remat, block, h, emb0, cos, sin)
            else:
                h = block(h, emb0, cos, sin,
                          cache=({"k": kv["k"][inv], "v": kv["v"][inv]}
                                 if kv is not None else None),
                          cache_index=cache_index, block_tables=block_tables)
    return h


def forward(ctx: L.Ctx, cfg: ModelConfig, params, batch: dict, *,
            cache=None, cache_index=None):
    """Returns (hidden (B,S,D), aux_loss, cache).  ``cache`` is the
    ``init_cache`` dict (or one slot's views of it), or the
    ``init_paged_cache`` dict (pools passed whole, possibly with one
    slot's table row and, for the hybrid, its Mamba lane views), and is
    written in place; the same dict comes back.  A paged cache's top-level
    ``block_tables`` addresses every layer's pools; the model never remaps
    blocks.

    The audio encoder reads ``batch["frames"]`` (B, S, frontend_dim): h =
    frames @ proj + pos[:S].  A vlm batch may carry ``vision_embeds`` (B,
    Nv, d), which overwrite the first Nv rows of the token embeddings,
    and ``positions`` (3, B, S); without them the default positions are
    broadcast to the three M-RoPE sections (``repro/models/lm.py:
    217-240``).

    Under a mesh ``cache`` is this rank's state (``init_cache``'s or
    ``init_paged_cache``'s under the same ``ctx``, or ``shard_cache``'s).
    Under a sequence-parallel rule set a cache-free forward runs on this
    rank's rows of the sequence (``L.seq_rows``; the rows must divide the
    model axis) from the embedding to the final norm, at their global
    positions, and returns them (B, S / n, D).  With a cache, a chunk
    whose rows divide the axis runs on the rank's rows likewise, and the
    normed rows are gathered over ``model`` at the end, so the whole chunk
    (B, S, D), its last row included, comes back on every rank; a chunk
    whose rows do not divide (a decode step's one row) runs replicated, as
    the reference replicates ``act_seq`` where it does not divide."""
    c = ctx.cdtype
    rows = slice(None)
    if ctx.mesh is not None:
        from repro_torch.sharding import executed_rules
        executed_rules(ctx.rules.name)
        require_mesh_family(cfg, ctx.rules)
        if L.seq_parallel(ctx):
            seq = batch["frames" if cfg.family == "audio" else "tokens"]
            if cache is None or seq.shape[1] % L._n_model(ctx) == 0:
                rows = L.seq_rows(ctx, seq.shape[1])
                ctx = dataclasses.replace(ctx, seq_shard=True)
    if cfg.family == "audio":
        frames = batch["frames"].to(c)
        B, S = frames.shape[:2]
        fe = params["frontend"]
        if ctx.mesh is not None:
            fe = L.use_weights(ctx, fe, model_decls(cfg)["frontend"])
        h = (frames[:, rows] @ fe["proj"].to(c)
             + fe["pos"][:S][rows].to(c)[None])
        device = frames.device
    else:
        tokens = batch["tokens"]
        B, S = tokens.shape
        if cache is not None and ctx.seq_shard:
            # a chunk's tokens are on every rank: the vocab-parallel lookup
            # of all of them, then the rank's rows, keeps the table cut
            # (the cache-free program gathers it whole)
            h = L.apply_embed(dataclasses.replace(ctx, seq_shard=False), cfg,
                              params["embed"], tokens)[:, rows]
        else:
            h = L.apply_embed(ctx, cfg, params["embed"], tokens[:, rows])
        if cfg.family == "vlm" and "vision_embeds" in batch:
            # the patch embeddings of the rows this rank holds
            ve = batch["vision_embeds"][:, rows].to(c)
            h = torch.cat([ve, h[:, ve.shape[1]:]], dim=1)
        device = tokens.device
    cos = sin = None
    if cfg.use_rope:
        positions = batch.get("positions")
        if positions is None:
            positions = _positions_default(B, S, device, cache_index)
            if cfg.mrope_sections is not None:
                positions = positions[None].expand(3, B, S)
        cos, sin = L.rope_cos_sin(cfg, positions[..., rows])
    block_tables = cache.get("block_tables") if cache is not None else None
    remat = (_remat(ctx) if cache is None and torch.is_grad_enabled()
             else None)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family in ("ssm", "hybrid"):
        h = _ssm_forward(ctx, cfg, params, h, cos, sin, cache=cache,
                         cache_index=cache_index, block_tables=block_tables,
                         remat=remat)
        norm = L.use_weights(ctx, params["final_norm"], L.norm_decls(cfg))
        return L.apply_norm(cfg, norm, h), aux, cache
    for p, kv, i, window in _tf_layers(cfg, params, cache):
        if remat is not None:
            h, a = _checkpoint(
                remat, functools.partial(_remat_block, ctx, cfg, window),
                p, h, cos, sin)
        else:
            layer_cache = ({"k": kv["k"][i], "v": kv["v"][i]}
                           if kv is not None else None)
            h, _, a = _tf_block(ctx, cfg, p, h, cos, sin,
                                local_window=window, cache=layer_cache,
                                cache_index=cache_index,
                                block_tables=block_tables)
        if a is not None:
            aux = aux + a
    h = L.apply_norm(cfg, L.use_weights(ctx, params["final_norm"],
                                        L.norm_decls(cfg)), h)
    if cache is not None and ctx.seq_shard:
        h = C.all_gather(h, L.MODEL, ctx.mesh, 1)
    return h, aux, cache


def _tf_layers(cfg: ModelConfig, params, cache):
    """The transformer layers in order, as (params, the stack's cache or
    None, the layer's index in it, its attention window).  gemma2's
    ``local_global`` runs (local, global) pairs, the local layer with
    ``cfg.local_window`` and its own ``kv_local`` cache, the global one
    unwindowed with ``kv_global`` (``repro/models/lm.py:259-280``);
    every other decoder its ``layers`` stack with ``kv``.  The reference
    checkpoints a pair as one body; the port checkpoints each block, the
    same numbers."""
    if cfg.layer_pattern != "local_global":
        kv = cache["kv"] if cache is not None else None
        for i, p in enumerate(_unstack(params["layers"], cfg.n_layers)):
            yield p, kv, i, None
        return
    half = cfg.n_layers // 2
    kv_l = cache["kv_local"] if cache is not None else None
    kv_g = cache["kv_global"] if cache is not None else None
    pairs = zip(_unstack(params["layers_local"], half),
                _unstack(params["layers_global"], half))
    for i, (p_l, p_g) in enumerate(pairs):
        yield p_l, kv_l, i, cfg.local_window
        yield p_g, kv_g, i, None


# ===========================================================================
# logits / caches
# ===========================================================================

def unembed_matrix(cfg: ModelConfig, params, dtype):
    if cfg.tie_embeddings:
        return params["embed"]["table"].to(dtype).T
    return params["unembed"]["w"].to(dtype)


def unembed_weight(ctx: L.Ctx, cfg: ModelConfig, params):
    """``unembed_matrix`` in the compute dtype as this rank's program uses
    it: under a mesh the table (or ``w``) first gathered where the program
    needs it whole (``L.use_weights``: the embed dim under fsdp, the vocab
    under sequence parallelism)."""
    if cfg.tie_embeddings:
        p = L.use_weights(ctx, params["embed"], L.embed_decls(cfg))
        return p["table"].to(ctx.cdtype).T
    p = L.use_weights(ctx, params["unembed"], L.unembed_decls(cfg))
    return p["w"].to(ctx.cdtype)


def vocab_shard(ctx: L.Ctx, cfg: ModelConfig, w) -> tuple[int, bool]:
    """(first vocab column, sharded?) of this rank's unembedding columns
    ``w`` (D, V_l): under the Megatron program the rules shard ``vocab``
    over ``model`` (``vocab_padded`` divides it)."""
    if ctx.mesh is None or w.shape[-1] == cfg.vocab_padded:
        return 0, False
    return L._model_index(ctx) * w.shape[-1], True


def logits_for(ctx: L.Ctx, cfg: ModelConfig, params, h):
    """Full float32 logits (decode path; small S).  Pad-vocab columns
    masked.  Under a mesh each rank computes its vocab columns and the
    logits are gathered over ``model``, so every rank holds all of them
    (the reference's ``:494``, whose logits GSPMD leaves vocab-sharded)."""
    w = unembed_weight(ctx, cfg, params)
    lo, sharded = vocab_shard(ctx, cfg, w)
    if sharded:
        h = L.C.copy_to(h, L.MODEL, ctx.mesh)
    logits = (h @ w).float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cfg.vocab_padded != cfg.vocab:
        cols = lo + torch.arange(w.shape[-1], device=logits.device)
        logits = logits.masked_fill(cols >= cfg.vocab, -1e30)
    if sharded:
        logits = L.C.gather_from(logits, L.MODEL, ctx.mesh, logits.ndim - 1)
    return logits


def init_cache(ctx: L.Ctx, cfg: ModelConfig, batch: int, max_seq: int):
    """Decode state on ``ctx.device``: stacked (L, B, max_seq, K, hd) k/v
    zeros in the compute dtype (``kv``, or gemma2's ``kv_local`` and
    ``kv_global``); for the Mamba families the
    recurrent state (``mamba``: ``ssm`` (L, B, H, P, N) float32 and
    ``conv`` (L, B, W-1, conv_dim)) and, for the hybrid, the shared
    block's k/v stacked over its ``n_super`` invocations (``kv_shared``).
    A vlm's cache is the dense decoder's; the audio encoder has none.

    Under a mesh ``batch`` and ``max_seq`` are the global sizes and the
    cache is this rank's state, allocated at its shard's size: its batch
    rows over the data-parallel axes (``ctx.dp_batch``; the batch must
    divide them), its slice of the rows over ``model`` (which must divide
    too: the sharded steps read the cache cut by sequence), its heads of
    the SSM state and the conv lane in the head-parallel program's layout
    (x of its heads, B and C whole: ``_conv_shard``'s).  ``shard_cache``
    of the unsharded cache gives the same shapes."""
    _require_cache(cfg)
    c, dev = ctx.cdtype, ctx.device
    if ctx.mesh is not None:
        full = init_cache(dataclasses.replace(ctx, mesh=None, device="meta"),
                          cfg, batch, max_seq)
        return _local_zeros(ctx, cfg, full, batch)
    if cfg.family in ("ssm", "hybrid"):
        out = {"mamba": L.empty_mamba_state(cfg, batch, c,
                                            layers=cfg.n_layers, device=dev)}
        if cfg.family == "hybrid":
            out["kv_shared"] = L.empty_kv_cache(
                cfg, batch, max_seq, c, layers=zamba_structure(cfg)[0],
                device=dev)
        return out
    return {key: L.empty_kv_cache(cfg, batch, max_seq, c, layers=n,
                                  device=dev)
            for key, n in _rows_stacks(cfg).items()}


def _rows_stacks(cfg: ModelConfig) -> dict[str, int]:
    """A decoder's KV cache keys and their layer counts: ``kv_local`` and
    ``kv_global`` of ``n_layers // 2`` each for gemma2's local/global
    pairs (``repro/models/lm.py:513-516``), else ``kv``."""
    if cfg.layer_pattern == "local_global":
        half = cfg.n_layers // 2
        return {"kv_local": half, "kv_global": half}
    return {"kv": cfg.n_layers}


def init_paged_cache(ctx: L.Ctx, cfg: ModelConfig, batch: int, max_seq: int,
                     block_size: int, n_blocks: int | None = None):
    """Paged decode state on ``ctx.device``: the rows keys become block
    POOLS (layers, n_blocks, block_size, K, hd) shared by all slots, plus
    one top-level ``block_tables`` ((batch, max_seq // block_size) int32)
    mapping each slot's logical rows to pool blocks.  State keys (the
    hybrid's Mamba lanes) are not row-addressable and stay dense; an
    ``ssm`` cache has no rows and raises.  Tables start at zero, as the
    reference's: an unmapped entry aliases block 0, harmless since reads
    past kv_len are masked and writes only reach mapped entries.
    ``n_blocks`` defaults to ``batch * max_blocks`` (the dense capacity).

    Under a mesh the pools stay whole on every rank, as the reference's
    ``PAGED_KV_CACHE_AXES`` keep them; the rank holds the table rows of
    its own slots (the batch over the data-parallel axes) and, for the
    hybrid, its Mamba lanes as ``init_cache`` cuts them."""
    _require_cache(cfg)
    if max_seq % block_size:
        raise ValueError(f"max_seq {max_seq} must be a multiple of "
                         f"block_size {block_size}")
    if cfg.family == "ssm":
        raise ValueError("ssm caches have no sequence rows to page")
    c, dev = ctx.cdtype, ctx.device
    max_blocks = max_seq // block_size
    if n_blocks is None:
        n_blocks = batch * max_blocks
    table = torch.zeros((_local_batch(ctx, batch), max_blocks),
                        dtype=torch.int32, device=dev)
    if cfg.family == "hybrid":
        return {"mamba": _mamba_lanes(ctx, cfg, batch),
                "kv_shared": L.empty_paged_kv_cache(
                    cfg, n_blocks, block_size, c,
                    layers=zamba_structure(cfg)[0], device=dev),
                "block_tables": table}
    out = {key: L.empty_paged_kv_cache(cfg, n_blocks, block_size, c,
                                       layers=n, device=dev)
           for key, n in _rows_stacks(cfg).items()}
    out["block_tables"] = table
    return out


def cache_logical_axes(cfg: ModelConfig):
    """Logical axes of ``init_cache``'s leaves (``repro/models/lm.py:
    573``): KV rows (layers, act_batch, act_kv_seq, None, None), the batch
    over the data-parallel axes and the sequence over ``model``; Mamba
    state (layers, act_batch, ssm_heads, ...).  The conv state's channels
    are ``act_ssm``, a contiguous cut of [x | B | C] in the reference; the
    port's head-parallel program reads x of its heads and all of B and C,
    so ``shard_cache`` cuts that leaf to the program's layout instead
    (``L.mamba_spans``), B and C replicated over ``model``."""
    _require_cache(cfg)
    if cfg.family in ("ssm", "hybrid"):
        out = {"mamba": dict(L.MAMBA_STATE_AXES)}
        if cfg.family == "hybrid":
            out["kv_shared"] = dict(L.KV_CACHE_AXES)
        return out
    return {key: dict(L.KV_CACHE_AXES) for key in _rows_stacks(cfg)}


def shard_cache(ctx: L.Ctx, cfg: ModelConfig, cache):
    """This rank's shard of a full (unsharded) decode cache, by
    ``cache_logical_axes`` under ``ctx.rules``: the batch over the
    data-parallel axes, the KV rows over ``model`` where they divide, the
    SSM state by heads.  The conv state is cut to the head-parallel
    program's layout: its batch as the rules cut it, and on a rank whose
    heads are split over ``model`` the channels of ``L.mamba_spans`` (x of
    its heads, B and C whole).  A KV cache whose rows do not divide the
    model axis raises: the decode step under a mesh reads its cache
    sharded by sequence."""
    from repro_torch.sharding import local_slice
    out = {}
    for key, axes in cache_logical_axes(cfg).items():
        out[key] = {}
        for k, a in cache[key].items():
            spec = _leaf_spec(ctx, cfg, key, k, axes[k], tuple(a.shape))
            if key == "mamba" and k == "conv":
                out[key][k] = _conv_shard(ctx, cfg, cache[key], spec)
                continue
            out[key][k] = local_slice(ctx.mesh, spec, a).clone()
    return out


def _mamba_lanes(ctx: L.Ctx, cfg: ModelConfig, batch: int):
    """``init_cache``'s ``mamba`` state alone: the paged cache's lanes."""
    if ctx.mesh is None:
        return L.empty_mamba_state(cfg, batch, ctx.cdtype,
                                   layers=cfg.n_layers, device=ctx.device)
    full = L.empty_mamba_state(cfg, batch, ctx.cdtype, layers=cfg.n_layers,
                               device="meta")
    return _local_zeros(ctx, cfg, {"mamba": full}, batch)["mamba"]


def _local_batch(ctx: L.Ctx, batch: int) -> int:
    """This rank's batch rows of a cache of ``batch`` slots: the batch
    over the data-parallel axes when ``ctx.dp_batch`` (it must divide
    them), else all of it."""
    dp = L.dp_size(ctx)
    if batch % dp:
        raise ValueError(f"a batch of {batch} over {dp} data-parallel "
                         f"ranks: the caches under a mesh split it evenly")
    return batch // dp


def _local_zeros(ctx: L.Ctx, cfg: ModelConfig, full, batch: int):
    """Zeros of this rank's shard of each leaf of ``full`` (meta tensors of
    the unsharded cache, or of some of its keys): ``shard_cache``'s cuts,
    the batch by ``_local_batch``."""
    from repro_torch.sharding import shard_shape
    out = {}
    for key, leaves in full.items():
        axes = cache_logical_axes(cfg)[key]
        out[key] = {}
        for k, a in leaves.items():
            spec = _leaf_spec(ctx, cfg, key, k, axes[k], tuple(a.shape))
            shape = list(shard_shape(ctx.mesh, spec, a.shape))
            shape[1] = _local_batch(ctx, batch)
            spans = (_conv_spans(ctx, cfg, full[key])
                     if key == "mamba" and k == "conv" else None)
            if spans is not None:
                shape[3] = sum(b - a for a, b in spans)
            out[key][k] = torch.zeros(shape, dtype=a.dtype,
                                      device=ctx.device)
    return out


def _leaf_spec(ctx: L.Ctx, cfg: ModelConfig, key: str, k: str, axes, shape):
    """The spec of one cache leaf under ``ctx``'s rules; KV rows that do
    not divide the model axis raise: the decode step under a mesh reads
    its cache sharded by sequence."""
    from repro_torch.sharding import resolve_spec
    spec = resolve_spec(ctx.rules, ctx.mesh, axes, shape)
    if key != "mamba" and L._n_model(ctx) > 1 and (
            len(spec) < 3 or spec[2] != L.MODEL):
        raise ValueError(f"{key}/{k}: {shape[2]} rows do not divide the "
                         f"{L._n_model(ctx)}-way model axis")
    return spec


def _conv_spans(ctx: L.Ctx, cfg: ModelConfig, mamba):
    """The conv lane's channel spans on this rank, ``L.mamba_spans``' (x
    of its heads, B and C whole), when the SSM heads are split over
    ``model``; else None (every channel)."""
    from repro_torch.sharding import resolve_spec
    ssm = resolve_spec(ctx.rules, ctx.mesh, L.MAMBA_STATE_AXES["ssm"],
                       tuple(mamba["ssm"].shape))
    if len(ssm) > 2 and ssm[2] == L.MODEL:
        return L.mamba_spans(cfg, L._model_index(ctx), L._n_model(ctx))[1]
    return None


def _conv_shard(ctx: L.Ctx, cfg: ModelConfig, mamba, spec):
    """This rank's conv-state lane (``shard_cache``): the batch as ``spec``
    cuts it, and the channels the rank's program convolves
    (``_conv_spans``)."""
    from repro_torch.sharding import local_slice
    conv = local_slice(ctx.mesh, spec[:2], mamba["conv"])
    spans = _conv_spans(ctx, cfg, mamba)
    if spans is not None:
        conv = L.take_spans(conv, spans)
    return conv.clone()


#: Slot semantics of a cache kind (as the reference): "rows" leaves carry
#: sequence rows on axis 2, valid up to the slot's kv_len (attention masks
#: the rest); "state" leaves carry the whole lane unconditionally
#: (recurrent SSM / conv state has no row mask: it is the left context).
SLOT_ROWS, SLOT_STATE = "rows", "state"


def cache_slot_spec(cfg: ModelConfig) -> dict[str, str]:
    """Per-top-level-key slot schema of ``init_cache``'s dict."""
    _require_cache(cfg)
    if cfg.family == "ssm":
        return {"mamba": SLOT_STATE}
    if cfg.family == "hybrid":
        return {"mamba": SLOT_STATE, "kv_shared": SLOT_ROWS}
    return dict.fromkeys(_rows_stacks(cfg), SLOT_ROWS)


# ===========================================================================
# portable slot state (``repro/models/lm.py:617-877``)
# ===========================================================================
#
# Every decode-cache leaf is laid out (stack, B, ...): axis 0 is the layer
# stack (n_layers, or n_super for the zamba2 shared-attention cache) and
# axis 1 is the batch SLOT.  ``export_slot``/``import_slot`` lift a lane
# out of one engine's cache and install it into another's, of any batch
# size and ``max_seq``, so a drained request travels as data instead of
# being regenerated.  A payload is ``{key: {leaf: tensor}}`` with the batch
# axis removed; rows leaves are trimmed to ``[row_start, kv_len)``.  The
# importers write IN PLACE: an engine's cache is storage its CUDA graphs
# hold, never rebound.

class QuantizedLeaf:
    """One payload leaf compressed at rest: per-row symmetric int8 ``q``
    with a float32 ``scale`` sidecar, and the original dtype's name.  A
    node of the port's tree helpers (``repro_torch.tree``), so
    ``slot_payload_bytes`` counts q and scale bytes (about half the raw
    bf16 bytes for head_dim-sized rows)."""

    def __init__(self, q, scale, dtype):
        self.q, self.scale = q, scale
        self.dtype = str(dtype).removeprefix("torch.")

    def tree_flatten(self):
        return (self.q, self.scale), self.dtype

    @classmethod
    def tree_unflatten(cls, dtype, children):
        return cls(children[0], children[1], dtype)

    def __repr__(self):
        return (f"QuantizedLeaf(q={tuple(getattr(self.q, 'shape', ()))}, "
                f"dtype={self.dtype})")


def _payload_map(fn, payload):
    """``fn`` over every leaf of a payload, a ``QuantizedLeaf`` counting as
    one leaf."""
    return {key: {k: fn(a) for k, a in leaves.items()}
            for key, leaves in payload.items()}


def quantize_payload(payload):
    """int8-compress every leaf of an ``export_slot`` payload, or of a
    ``slot_lane``'s sources (per-row scale over the last axis: head_dim
    for KV rows, the state feature axis for Mamba lanes).  Lossy: the
    worst-case error per element is the row absmax / 254 plus the storage
    dtype's own rounding."""
    return _payload_map(
        lambda a: QuantizedLeaf(*ref.int8_quantize(
            a.read() if isinstance(a, PoolRows) else a), dtype=a.dtype),
        payload)


def dequantize_payload(payload, device=None):
    """Undo ``quantize_payload`` (identity on raw leaves), with every leaf
    first moved to ``device`` if given: a quantized leaf travels as int8
    and is widened there."""

    def leaf(x):
        if isinstance(x, QuantizedLeaf):
            return ref.int8_dequantize(_to(x.q, device), _to(x.scale, device),
                                       getattr(torch, x.dtype))
        return _to(x, device)

    return _payload_map(leaf, payload)


def _to(a, device):
    # non_blocking: the runtime stages pageable memory, so the host does
    # not wait for the device's queue
    return a if device is None else a.to(device, non_blocking=True)


def payload_is_quantized(payload) -> bool:
    return any(isinstance(a, QuantizedLeaf)
               for leaves in payload.values() for a in leaves.values())


def int8_payload_ratio(cfg: ModelConfig, itemsize: int = 2) -> float:
    """Modeled on-wire size ratio of an int8-quantized payload vs raw: 1
    int8 byte per element plus a 4-byte f32 scale per ``head_dim`` row,
    over ``itemsize`` raw bytes per element."""
    row = max(int(getattr(cfg, "head_dim", 64) or 64), 1)
    return (1.0 + 4.0 / row) / float(itemsize)


class PoolRows:
    """Rows of one paged pool leaf (stack, n_blocks, block_size, ...) that
    a slot's block list maps, gathered only when read: ``read(out)``
    writes them, (stack, rows, ...), straight into ``out`` in one
    ``index_select``."""

    def __init__(self, pool, index):
        self.pool = pool.view(pool.shape[0], -1, *pool.shape[3:])
        self.index = index
        self.shape = (pool.shape[0], index.numel()) + tuple(pool.shape[3:])
        self.dtype = pool.dtype

    def read(self, out=None):
        return torch.index_select(self.pool, 1, self.index, out=out)


def slot_lane(cfg: ModelConfig, cache, slot: int, kv_len: int,
              row_start: int = 0, blocks=None, block_size: int = 0) -> dict:
    """Slot ``slot``'s payload as device sources, unchecked and not yet
    copied: views of the dense lane ("rows" leaves trimmed to [row_start,
    kv_len)) and of "state" leaves, or, with ``blocks`` (a paged cache),
    ``PoolRows`` of the rows leaves.  ``export_slot``/``export_slot_paged``
    check their arguments and copy these (``read_lane_leaf``); the serving
    engine writes them straight into its one transfer buffer."""
    if blocks is not None:
        blk, off = _paged_row_coords(blocks, block_size, row_start, kv_len,
                                     cache["block_tables"].device)
        index = blk * block_size + off
    lane = {}
    for key, kind in cache_slot_spec(cfg).items():
        if kind == SLOT_STATE:
            lane[key] = {k: a.select(1, slot) for k, a in cache[key].items()}
        elif blocks is None:
            lane[key] = {k: a[:, slot, row_start:kv_len]
                         for k, a in cache[key].items()}
        else:
            lane[key] = {k: PoolRows(a, index) for k, a in cache[key].items()}
    return lane


def read_lane_leaf(x):
    """A ``slot_lane`` source as a tensor of its own: a copy of a view
    (``slot_gather``'s value), or the gathered pool rows."""
    return x.read() if isinstance(x, PoolRows) else x.clone()


def export_slot(cfg: ModelConfig, cache, slot: int, kv_len: int,
                quantize: bool = False, row_start: int = 0) -> dict:
    """Lift slot ``slot``'s state out of a batched decode cache, as a copy
    on the cache's device: "rows" leaves trimmed to rows [row_start,
    kv_len) (the only rows attention can read at this fill, less a shared
    prefix the receiver rebuilds), "state" leaves whole.  The payload
    installs into any slot of any cache of the same ``cfg`` whose
    ``max_seq`` holds it (``import_slot``).  ``quantize=True`` compresses
    it (``quantize_payload``).  ``row_start > 0`` needs a pure-rows
    schema: a state lane is the whole left context and cannot be split at
    a row."""
    if kv_len < 0:
        raise ValueError(f"kv_len must be >= 0, got {kv_len}")
    if not 0 <= row_start <= kv_len:
        raise ValueError(f"row_start {row_start} outside [0, {kv_len}]")
    spec = cache_slot_spec(cfg)
    if row_start and any(k == SLOT_STATE for k in spec.values()):
        raise ValueError("row_start > 0 requires a pure-rows cache schema")
    if set(spec) != set(cache):
        raise ValueError(f"cache keys {sorted(cache)} do not match the "
                         f"slot schema {sorted(spec)}")
    for key, kind in spec.items():
        if kind == SLOT_ROWS \
                and any(kv_len > a.shape[2] for a in cache[key].values()):
            raise ValueError(f"kv_len {kv_len} exceeds the cache rows of "
                             f"{key}")
    # trim before the copy: only the payload rows are read
    lane = slot_lane(cfg, cache, slot, kv_len, row_start)
    return quantize_payload(lane) if quantize \
        else _payload_map(read_lane_leaf, lane)


def import_slot(cfg: ModelConfig, cache, payload, slot: int,
                row_offset: int = 0):
    """Install an ``export_slot`` payload into slot ``slot`` of ``cache``,
    IN PLACE, and return the cache.  The WHOLE lane is overwritten, as the
    reference's zero pad and scatter (``repro/models/lm.py:756-783``):
    rows below ``row_offset`` and past the payload are zeroed, so a
    prefix-trimmed payload's prefix must be rebuilt AFTER this call;
    "state" leaves overwrite the lane as they are.  The payload may lie on
    the host: each leaf is moved to the cache's device, and a quantized
    one widened there.  Every check runs before the first write."""
    spec = cache_slot_spec(cfg)
    if row_offset and any(k == SLOT_STATE for k in spec.values()):
        raise ValueError("row_offset > 0 requires a pure-rows cache schema")
    if set(spec) != set(payload) or set(spec) != set(cache):
        raise ValueError(f"payload keys {sorted(payload)} do not match the "
                         f"slot schema {sorted(spec)}")
    for key, kind in spec.items():
        for k, full in cache[key].items():
            a = _payload_leaf(payload[key][k])
            if kind == SLOT_ROWS:
                rows = full.shape[2]           # destination max_seq
                if a.shape[0] != full.shape[0] \
                        or tuple(a.shape[2:]) != tuple(full.shape[3:]):
                    raise ValueError(
                        f"{key}: payload lane {tuple(a.shape)} does not fit "
                        f"cache {tuple(full.shape)}")
                if row_offset + a.shape[1] > rows:
                    raise ValueError(
                        f"{key}: payload carries rows up to "
                        f"{row_offset + a.shape[1]} but the destination "
                        f"cache holds only {rows}")
            elif a.shape[0] != full.shape[0] \
                    or tuple(a.shape[1:]) != tuple(full.shape[2:]):
                raise ValueError(
                    f"{key}: payload lane {tuple(a.shape)} does not fit "
                    f"cache {tuple(full.shape)}")
    device = next(iter(cache[next(iter(spec))].values())).device
    payload = dequantize_payload(payload, device)
    for key, kind in spec.items():
        for k, full in cache[key].items():
            a = payload[key][k]
            if kind == SLOT_ROWS:
                lane = full[:, slot]
                end = row_offset + a.shape[1]
                lane[:, :row_offset].zero_()
                lane[:, row_offset:end].copy_(a)
                lane[:, end:].zero_()
            else:
                ref.slot_scatter(full, a, slot)
    return cache


def _payload_leaf(x):
    """A payload leaf's shape carrier: q of a quantized leaf."""
    return x.q if isinstance(x, QuantizedLeaf) else x


def _paged_row_coords(blocks, block_size: int, row_start: int, row_stop: int,
                      device=None):
    """(pool block ids, in-block offsets) int64 vectors addressing logical
    rows [row_start, row_stop) of a slot whose table maps logical block i
    to pool block ``blocks[i]`` (host-side list, in logical order), on
    ``device``."""
    rows = torch.arange(row_start, row_stop)
    blk = torch.tensor(list(blocks), dtype=torch.int64)[rows // block_size]
    return _to(blk, device), _to(rows % block_size, device)


def export_slot_paged(cfg: ModelConfig, cache, slot: int, blocks,
                      block_size: int, kv_len: int, *, row_start: int = 0,
                      quantize: bool = False):
    """``export_slot`` for a paged cache: rows leaves are gathered out of
    the block pools through the slot's host-side block list, giving the
    SAME payload as the dense exporter (payloads are layout-portable).
    ``row_start`` ships only the private suffix of a prefix-shared slot."""
    if not 0 <= row_start <= kv_len:
        raise ValueError(f"row_start {row_start} outside [0, {kv_len}]")
    if kv_len > len(blocks) * block_size:
        raise ValueError(f"kv_len {kv_len} exceeds the {len(blocks)} mapped "
                         f"blocks of size {block_size}")
    spec = cache_slot_spec(cfg)
    if row_start and any(k == SLOT_STATE for k in spec.values()):
        raise ValueError("row_start > 0 requires a pure-rows cache schema")
    if set(spec) != set(cache) - {"block_tables"}:
        raise ValueError(f"cache keys {sorted(cache)} do not match the "
                         f"slot schema {sorted(spec)}")
    lane = slot_lane(cfg, cache, slot, kv_len, row_start, blocks,
                     block_size)
    return quantize_payload(lane) if quantize \
        else _payload_map(read_lane_leaf, lane)


def import_slot_paged(cfg: ModelConfig, cache, payload, slot: int, blocks,
                      block_size: int, *, row_offset: int = 0):
    """Install an ``export_slot``/``export_slot_paged`` payload into a
    paged cache, IN PLACE, and return it: rows scatter to the (block,
    offset) rows the slot's block list maps [row_offset, row_offset +
    rows) to.  Unlike the dense importer this writes ONLY the payload
    rows: shared prefix blocks below ``row_offset`` are never touched
    (other slots' tables may map them).  Every check runs before the
    first write."""
    spec = cache_slot_spec(cfg)
    if row_offset and any(k == SLOT_STATE for k in spec.values()):
        raise ValueError("row_offset > 0 requires a pure-rows cache schema")
    if set(spec) != set(payload):
        raise ValueError(f"payload keys {sorted(payload)} do not match the "
                         f"slot schema {sorted(spec)}")
    rows = {}
    for key, kind in spec.items():
        if kind == SLOT_STATE:
            continue
        rows[key] = _payload_leaf(next(iter(payload[key].values()))).shape[1]
        if row_offset + rows[key] > len(blocks) * block_size:
            raise ValueError(
                f"{key}: payload rows reach {row_offset + rows[key]} but "
                f"only {len(blocks)} blocks of size {block_size} are mapped")
        for k, full in cache[key].items():
            lane = _payload_leaf(payload[key][k])
            if lane.shape[0] != full.shape[0] \
                    or tuple(lane.shape[2:]) != tuple(full.shape[3:]):
                raise ValueError(f"{key}: payload lane {tuple(lane.shape)} "
                                 f"does not fit pool {tuple(full.shape)}")
    device = cache["block_tables"].device
    payload = dequantize_payload(payload, device)
    for key, kind in spec.items():
        if kind == SLOT_STATE:
            for k, full in cache[key].items():
                ref.slot_scatter(full, payload[key][k], slot)
            continue
        blk, off = _paged_row_coords(blocks, block_size, row_offset,
                                     row_offset + rows[key], device)
        for k, full in cache[key].items():
            full[:, blk, off] = payload[key][k].to(full.dtype)
    return cache


def slot_payload_bytes(payload) -> int:
    """On-wire size of an ``export_slot`` payload: what a cross-node
    migration moves (q and scale of a quantized leaf)."""
    return int(sum(a.numel() * a.element_size() for a in tree.leaves(payload)))
