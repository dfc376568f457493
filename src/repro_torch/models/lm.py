"""LM assembly, ported from ``repro/models/lm.py``: the dense and MoE
decoders, the Mamba-2 stack (``ssm``) and the zamba2 hybrid.

One declarative parameter tree (the reference's keys and shapes, so the
JAX package's weights load unchanged) and one forward whose layers run in
a Python loop over the stacked ``layers`` leaves (the reference's
``lax.scan``):
  dense, moe  a pre-norm decoder; with ``n_experts > 0`` every layer's
              MLP is the MoE layer and ``forward`` returns the layers'
              summed aux loss
  ssm         pre-norm residual Mamba-2 blocks (mamba2)
  hybrid      Mamba-2 blocks with one SHARED attention block applied after
              every ``shared_attn_period`` of them, on concat(h, the
              embedding output), with per-invocation LoRA on q (zamba2)
The vlm and audio families and the gemma2 local/global pattern raise,
naming the ROADMAP item that ports them.

Forward modes:
  forward(...)                     full-sequence hidden states (no cache);
                                   with grad enabled each layer is
                                   checkpointed under ``run.remat="full"``
  forward(..., cache, cache_index) prefill chunk or decode step; the cache
                                   (dense ``init_cache`` or paged
                                   ``init_paged_cache``) is updated in place

Portable slot state (``export_slot``/``import_slot``, their paged
variants, int8 payloads) moves one slot's lane between caches of any
batch size and ``max_seq``: the serving engine's drain and restore.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models.params import PD


def _require_ported(cfg: ModelConfig) -> None:
    """The families the port runs: dense and MoE decoders, Mamba-2 and the
    zamba2 hybrid."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        item = {"vlm": "12", "audio": "12"}.get(cfg.family, "?")
        raise NotImplementedError(
            f"{cfg.family} family: ROADMAP queue 1 item {item}")
    if cfg.layer_pattern != "global" or cfg.post_norms:
        raise NotImplementedError("gemma2 local/global layers and post-norms: "
                                  "ROADMAP queue 1 item 11")


# ===========================================================================
# declarations
# ===========================================================================

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
    _require_ported(cfg)
    n = cfg.n_layers
    d: dict[str, Any] = {"embed": L.embed_decls(cfg)}
    if cfg.family in ("ssm", "hybrid"):
        d["layers"] = {"ln": L.norm_decls(cfg, layers=n),
                       "mamba": L.mamba_decls(cfg, layers=n)}
        if cfg.family == "hybrid":
            d["shared"] = _shared_attn_decls(cfg, zamba_structure(cfg)[0])
    else:
        d["layers"] = {
            "ln1": L.norm_decls(cfg, layers=n),
            "attn": L.attention_decls(cfg, layers=n),
            "ln2": L.norm_decls(cfg, layers=n),
            "mlp": (L.moe_decls(cfg, layers=n) if cfg.n_experts
                    else L.mlp_decls(cfg, layers=n)),
        }
    d["final_norm"] = L.norm_decls(cfg)
    ue = L.unembed_decls(cfg)
    if ue:
        d["unembed"] = ue
    return d


#: parameter leaves that stay float32 on the compute path
_F32_LEAVES = ("scale", "bias", "router", "A_log", "D", "dt_bias", "norm")


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
    c, dev = ctx.cdtype, torch.device(ctx.device)

    def cast(tree, key=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        if key in _F32_LEAVES:
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


def _mamba_layer(ctx: L.Ctx, cfg: ModelConfig, p, h, ssm_state=None,
                 conv_state=None):
    """One pre-norm residual Mamba-2 layer; the states (one layer's cache
    views) are updated in place."""
    out, _ = L.apply_mamba(ctx, cfg, p["mamba"], L.apply_norm(cfg, p["ln"], h),
                           ssm_state=ssm_state, conv_state=conv_state)
    return h + out


def _shared_block(ctx: L.Ctx, cfg: ModelConfig, p, inv_idx: int, h, emb0, cos,
                  sin, *, cache=None, cache_index=None, block_tables=None):
    """Zamba2 shared attention block on concat(h, emb0), with invocation
    ``inv_idx``'s LoRA on q (``repro/models/lm.py:344-369``)."""
    c = ctx.cdtype
    a_in = L.apply_norm(cfg, p["ln1"], torch.cat([h, emb0], dim=-1))
    la = p["lora_a"][inv_idx].to(c)
    lb = p["lora_b"][inv_idx].to(c)
    B, S = a_in.shape[:2]
    q_delta = (a_in @ la @ lb).reshape(B, S, cfg.n_heads, cfg.head_dim)
    out, _ = L.apply_attention(ctx, cfg, p["attn"], a_in, cos, sin,
                               cache=cache, cache_index=cache_index,
                               block_tables=block_tables, q_delta=q_delta)
    h = h + out
    m_in = L.apply_norm(cfg, p["ln2"], torch.cat([h, emb0], dim=-1))
    gate = m_in @ p["mlp"]["w_gate"].to(c)
    up = m_in @ p["mlp"]["w_up"].to(c)
    return h + (F.silu(gate) * up) @ p["mlp"]["w_down"].to(c)


def _ssm_forward(ctx: L.Ctx, cfg: ModelConfig, params, h, cos, sin, *,
                 cache, cache_index, block_tables, remat: bool):
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
        if remat:
            h = torch.utils.checkpoint.checkpoint(
                functools.partial(_mamba_layer, ctx, cfg), p, h,
                use_reentrant=False)
        else:
            h = _mamba_layer(ctx, cfg, p, h,
                             st["ssm"][i] if st is not None else None,
                             st["conv"][i] if st is not None else None)
        if per and (i + 1) % per == 0:
            inv = (i + 1) // per - 1
            block = functools.partial(_shared_block, ctx, cfg,
                                      params["shared"], inv)
            if remat:
                h = torch.utils.checkpoint.checkpoint(
                    block, h, emb0, cos, sin, use_reentrant=False)
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
    blocks."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = L.apply_embed(ctx, cfg, params["embed"], tokens)
    positions = batch.get("positions")
    if positions is None:
        positions = _positions_default(B, S, tokens.device, cache_index)
    cos, sin = (L.rope_cos_sin(cfg, positions) if cfg.use_rope
                else (None, None))
    block_tables = cache.get("block_tables") if cache is not None else None
    remat = cache is None and torch.is_grad_enabled() and _remat(ctx)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family in ("ssm", "hybrid"):
        h = _ssm_forward(ctx, cfg, params, h, cos, sin, cache=cache,
                         cache_index=cache_index, block_tables=block_tables,
                         remat=remat)
        return L.apply_norm(cfg, params["final_norm"], h), aux, cache
    kv = cache["kv"] if cache is not None else None
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
    """Decode state on ``ctx.device``: stacked (L, B, max_seq, K, hd) k/v
    zeros in the compute dtype (``kv``); for the Mamba families the
    recurrent state (``mamba``: ``ssm`` (L, B, H, P, N) float32 and
    ``conv`` (L, B, W-1, conv_dim)) and, for the hybrid, the shared
    block's k/v stacked over its ``n_super`` invocations (``kv_shared``)."""
    _require_ported(cfg)
    c, dev = ctx.cdtype, ctx.device
    if cfg.family in ("ssm", "hybrid"):
        out = {"mamba": L.empty_mamba_state(cfg, batch, c,
                                            layers=cfg.n_layers, device=dev)}
        if cfg.family == "hybrid":
            out["kv_shared"] = L.empty_kv_cache(
                cfg, batch, max_seq, c, layers=zamba_structure(cfg)[0],
                device=dev)
        return out
    return {"kv": L.empty_kv_cache(cfg, batch, max_seq, c,
                                   layers=cfg.n_layers, device=dev)}


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
    ``n_blocks`` defaults to ``batch * max_blocks`` (the dense capacity)."""
    _require_ported(cfg)
    if max_seq % block_size:
        raise ValueError(f"max_seq {max_seq} must be a multiple of "
                         f"block_size {block_size}")
    if cfg.family == "ssm":
        raise ValueError("ssm caches have no sequence rows to page")
    c, dev = ctx.cdtype, ctx.device
    max_blocks = max_seq // block_size
    if n_blocks is None:
        n_blocks = batch * max_blocks
    table = torch.zeros((batch, max_blocks), dtype=torch.int32, device=dev)
    if cfg.family == "hybrid":
        return {"mamba": L.empty_mamba_state(cfg, batch, c,
                                             layers=cfg.n_layers, device=dev),
                "kv_shared": L.empty_paged_kv_cache(
                    cfg, n_blocks, block_size, c,
                    layers=zamba_structure(cfg)[0], device=dev),
                "block_tables": table}
    return {"kv": L.empty_paged_kv_cache(cfg, n_blocks, block_size, c,
                                         layers=cfg.n_layers, device=dev),
            "block_tables": table}


#: Slot semantics of a cache kind (as the reference): "rows" leaves carry
#: sequence rows on axis 2, valid up to the slot's kv_len (attention masks
#: the rest); "state" leaves carry the whole lane unconditionally
#: (recurrent SSM / conv state has no row mask: it is the left context).
SLOT_ROWS, SLOT_STATE = "rows", "state"


def cache_slot_spec(cfg: ModelConfig) -> dict[str, str]:
    """Per-top-level-key slot schema of ``init_cache``'s dict."""
    _require_ported(cfg)
    if cfg.family == "ssm":
        return {"mamba": SLOT_STATE}
    if cfg.family == "hybrid":
        return {"mamba": SLOT_STATE, "kv_shared": SLOT_ROWS}
    return {"kv": SLOT_ROWS}


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
