"""Neural layers of the dense and MoE decoders and of the Mamba-2 block,
ported from ``repro/models/layers.py``.

Every ``*_decls`` returns a nested dict of PD declarations with the
reference's keys and shapes; the matching ``apply_*`` consumes the
materialized tensors.  ``Ctx`` holds the run config, the device and,
for a sharded run, the logical rules and the mesh.  Weights are cast to
the compute dtype at use with ``.to(c)``, a no-op once
``lm.prepare_params`` has cast them at load.  In training the parameters
stay f32 masters with ``requires_grad``: the cast at use is
differentiable, so autograd returns f32 gradients, as JAX does.

The MoE layer is the reference's local path (token-choice top-k router,
capacity dispatch, grouped expert FFN, weighted combine).

Under a mesh (``ctx.mesh``) every layer is one rank's program of the
reference's sharded execution under its rule set (``ctx.rules``).  The
stored weights are this rank's shards (``sharding.rules.local_slice`` of
the reference's specs).  Where the rules shard a dim that the rank's
program needs whole, ``use_weights`` all-gathers the leaf just before its
use, cast to the compute dtype, with a reduce-scatter for its gradient
(``collectives.gather_dims``): the ``embed`` dim over the data-parallel
axes under ``fsdp`` (ZeRO-3), every ``model``-sharded dim but the
experts' under the sequence-parallel rule sets.  The optimizer, the
checkpoint and the gradient sums keep seeing the shards.

``default`` and ``fsdp`` run the Megatron program: activations are
replicated over ``model`` and split over the data-parallel axes, and each
layer reads its local sizes from its local weights and issues its own
collectives (``sharding/collectives.py``):
  attention   q/k/v columns sharded by heads (``qkv_flat``/``kv_flat``),
              this rank's heads through the kernels, ``wo`` row-parallel
              and summed over ``model``; with a cache the step's q, k
              and v are gathered to every head (``_cache_attention``): a
              dense cache is cut by sequence over ``model``, each rank
              writes the rows of the chunk or step that fall in its slice
              (the write's row-level clip) and attends every query over
              its slice, and the slices combine by their log-sum-exp (the
              reference's ``_decode_attention_seqsharded``, ``:293-384``,
              for one row; GSPMD gathers the prefix rows for a prefill
              instead); a paged pool is whole on every rank, which writes
              every kv head (every slot's, gathered over the data-parallel
              axes) so the ranks' pools stay equal;
  MLP         ``w_up``/``w_gate`` column-, ``w_down`` row-parallel;
  MoE         with experts sharded over ``model`` and the sequence
              divisible by it, the reference's expert parallelism
              (``_moe_shard_map``, ``:580-640``): each rank dispatches its
              sequence slice, one all-to-all (bf16 or the int8 wire of
              ``_A2AInt8``) takes each expert's rows to its rank, the
              local experts run, a second all-to-all brings the rows back;
              otherwise (a decode step) each rank runs its experts on the
              common dispatch and the outputs are summed over ``model``.
A leaf the rules leave replicated (its dim not divisible) is computed
whole on every rank, with no collective.  A cut inside a head, or q
sharded while kv is not, raises.

``seqparallel`` and ``fsdp_seqparallel`` (``act_seq`` on ``model``) run
the sequence-parallel program: a training forward's activations are this
rank's rows [r S/n, (r+1) S/n) of the sequence (``ctx.seq_shard``), every
head and the full MLP width, on whole weights.  Attention computes q, k
and v of its rows, gathers k and v over ``model`` along the sequence
(``_attention_seq``) and runs the kernels with the query offset of its
first row; the MLP runs on its rows with no collective; the MoE layer is
expert parallelism over the rank's own rows.  With a cache, a chunk
whose rows divide the axis runs on the rank's rows too: q, k and v of its
rows with every head are gathered along the sequence and take the cache
path above with every head (the rank's rows of the output kept), and
``lm.forward`` gathers the hidden rows at the end, so the last row is on
every rank.  A decode step (one row: ``act_seq`` resolves to replicated),
or any chunk whose rows do not divide, runs replicated: the
sequence-sharded cache with every head computed on every rank; its
embedding and logits stay vocab-parallel, as the rows are the same on
every rank.

The Mamba-2 block runs its prefill chunks through ``ops.ssd`` (the
``ssd`` kernel on CUDA) and its single-token decode through the plain
one-step recurrence, as the reference does; its SSM and conv states are
the cache's views and are updated in place.  Under ``default`` and
``fsdp`` (``ssm_inner``, ``ssm_heads`` and ``act_ssm`` on ``model``) it
is head-parallel: rank r of n runs heads [r H/n, (r+1) H/n).  The stored
``in_proj``, ``conv_w`` and ``conv_b`` shards are the reference's
contiguous cuts of packed layouts ([z | x | B | C | dt] columns, [x | B |
C] channels) that do not fall on heads, so ``use_weights`` gathers them
whole (``MODEL_GATHERED``) and the rank indexes its z, x and dt and all of
B and C (one group: every head reads them; the gather's reduce-scatter
sums the ranks' partial gradients of those columns).  The input goes
through ``copy_to``, the conv and ``ssd`` run on the rank's channels and
heads (``A_log``, ``D``, ``dt_bias`` and ``norm`` are head-aligned
shards), the gated norm all-reduces its sum of squares over ``model``
with an all-reduce backward (``C.all_reduce``), and ``out_proj`` is
row-parallel, summed with ``reduce_from``.  With a cache (``lm.init_cache``
under the mesh, or ``lm.shard_cache``: the conv lane in this layout, x of
its heads and B and C whole, the SSM state by heads) a prefill chunk
carries the rank's conv window and runs ``ssd`` from its heads' state,
writing the new state in place, and a decode step rolls the rank's conv
channels and steps its heads of the SSM state.  zamba2's shared block
is the Megatron attention with its ``q_delta`` on the rank's heads and
the Megatron MLP (``lm._shared_block``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.params import PD
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import resolve_spec


@dataclasses.dataclass(frozen=True)
class Ctx:
    run: RunConfig
    device: str | torch.device = "cuda"
    rules: Any = None    # sharding.LogicalRules | None
    mesh: Any = None     # launch.mesh.Mesh | None: this rank's program
    #: the activations are this rank's rows of the sequence (set by
    #: ``lm.forward`` for a sequence-parallel forward)
    seq_shard: bool = False
    #: the batch rows (of the activations and of a cache's slots) are this
    #: rank's share over the data-parallel axes; False where every
    #: data-parallel rank holds the same rows (a serving engine's one-slot
    #: prefill chunk, which the reference runs replicated over ``data``)
    dp_batch: bool = True

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.run.compute_dtype)


MODEL = "model"
DP_AXES = ("pod", "data")
#: parameter leaves that stay float32 on the compute path
#: (``lm.prepare_params``); gathered at use in float32
F32_LEAVES = ("scale", "bias", "router", "A_log", "D", "dt_bias", "norm")
#: leaves whose ``model`` shard the Megatron program does not consume as
#: it lies, gathered whole at use: the Mamba-2 block's packed projection
#: and conv, cut contiguously across the z/x/B/C/dt and x/B/C boundaries
MODEL_GATHERED = ("in_proj", "conv_w", "conv_b")


def _n_model(ctx: Ctx) -> int:
    return ctx.mesh.axis_size(MODEL) if ctx.mesh is not None else 1


def _model_index(ctx: Ctx) -> int:
    return ctx.mesh.coord(MODEL) if _n_model(ctx) > 1 else 0


def seq_parallel(ctx: Ctx) -> bool:
    """The rules split activations over the sequence on ``model``
    (``seqparallel``, ``fsdp_seqparallel``) and the mesh has more than one
    model rank."""
    return (ctx.mesh is not None and _n_model(ctx) > 1
            and ctx.rules.get("act_seq") == MODEL)


def token_axes(seq: bool, dp: bool = True) -> tuple[str, ...]:
    """The mesh axes a call's tokens are split over: the data-parallel
    axes (unless ``dp`` is False: rows replicated over them), and
    ``model`` when each rank holds its rows of the sequence."""
    return (DP_AXES if dp else ()) + ((MODEL,) if seq else ())


def dp_size(ctx: Ctx) -> int:
    """The data-parallel ranks the call's batch is split over: 1 without a
    mesh or with ``ctx.dp_batch`` False."""
    if ctx.mesh is None or not ctx.dp_batch:
        return 1
    return ctx.mesh.axis_size(DP_AXES)


def seq_rows(ctx: Ctx, S: int) -> slice:
    """This rank's rows [r S/n, (r+1) S/n) of a sequence of ``S`` rows
    split over ``model``.  The reference replicates a sequence that does
    not divide; the sequence-parallel program refuses it."""
    n = _n_model(ctx)
    if S % n:
        raise NotImplementedError(
            f"a sequence of {S} rows over a {n}-way model axis: the "
            f"sequence-parallel program needs S divisible by the axis")
    r = _model_index(ctx)
    return slice(r * (S // n), (r + 1) * (S // n))


def _gather_parts(ctx: Ctx, axes, dims, whole: bool = False) -> tuple:
    """The (dim, mesh axes) a leaf of logical ``axes`` and global ``dims``
    is all-gathered over before use: every dim the rules shard, but the
    ``model`` shards the program consumes as they lie (the Megatron
    program's heads, MLP columns and vocab; the experts under expert
    parallelism; the vocab of a sequence-parallel call whose rows are
    replicated, a decode step's, which the vocab-parallel lookup and
    logits take as the Megatron program does).  With ``whole`` (a
    ``MODEL_GATHERED`` leaf) the ``model`` shard is gathered too."""
    seq = seq_parallel(ctx)
    parts = []
    for d, (part, ax) in enumerate(zip(resolve_spec(ctx.rules, ctx.mesh,
                                                    axes, dims), axes)):
        flat = (part,) if isinstance(part, str) else (part or ())
        kept = not whole and (not seq or ax == "expert" or (
            ax == "vocab" and not ctx.seq_shard))
        if not flat or (MODEL in flat and kept):
            continue
        parts.append((d, part))
    return tuple(parts)


def use_weights(ctx: Ctx, p: dict, decls: dict) -> dict:
    """The layer's weights ``p`` (one layer's, matching ``decls``) as this
    rank's program uses them: a leaf whose spec shards a dim the program
    needs whole is cast (float32 for ``F32_LEAVES``, else the compute
    dtype) and all-gathered (``C.gather_dims``: its gradient is the
    reduce-scatter, in float32, onto the shard); the others come back as
    they are.  Without a mesh, ``p`` itself."""
    if ctx.mesh is None:
        return p
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out[k] = use_weights(ctx, v, decls[k])
            continue
        parts = _gather_parts(ctx, decls[k].axes, decls[k].shape,
                              k in MODEL_GATHERED)
        if parts:
            dtype = torch.float32 if k in F32_LEAVES else ctx.cdtype
            v = C.gather_dims(v, parts, ctx.mesh, dtype)
        out[k] = v
    return out


def _local_heads(ctx: Ctx, what: str, total: int, cols: int, hd: int) -> int:
    """Heads of a projection whose local columns are ``cols`` of
    ``total * hd``: ``total`` when replicated, ``total / n`` when sharded
    on whole heads; a cut inside a head raises."""
    if cols == total * hd:
        return total
    n = _n_model(ctx)
    if total % n or cols * n != total * hd:
        raise NotImplementedError(
            f"{what}: {cols} local columns of {total} heads x {hd} cut a "
            f"head on a {n}-way model axis; the port shards attention by "
            f"whole heads")
    return total // n


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


def rmsnorm_gated(scale, y, z, eps: float = 1e-6, mesh=None,
                  width: int | None = None):
    """Mamba-2 RMSNormGated: rmsnorm(y * silu(z)) * scale.  With ``mesh``
    the last dim is this rank's slice of ``width`` over ``model``: the
    float32 sums of squares are all-reduced with an all-reduce backward
    (``C.all_reduce``: every rank's output reads every rank's sum, so
    each rank's gradient of its sum is all the ranks' summed) and divided
    by the whole ``width``."""
    yf = y.float() * F.silu(z.float())
    if mesh is None:
        var = torch.mean(yf * yf, dim=-1, keepdim=True)
    else:
        var = C.all_reduce(torch.sum(yf * yf, dim=-1, keepdim=True), MODEL,
                           mesh) / width
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
    if ctx.mesh is not None:
        if ctx.seq_shard:
            if q_delta is not None:
                raise NotImplementedError(
                    "the hybrid's shared attention under a sequence-"
                    "parallel rule set: ROADMAP item 14b (c2)")
            return _attention_seq(ctx, cfg, p, x, cos, sin,
                                  local_window=local_window, cache=cache,
                                  cache_index=cache_index,
                                  block_tables=block_tables), cache
        return _attention_sharded(ctx, cfg, p, x, cos, sin,
                                  local_window=local_window, cache=cache,
                                  cache_index=cache_index,
                                  block_tables=block_tables, q_delta=q_delta)
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


def _attention_sharded(ctx: Ctx, cfg: ModelConfig, p: dict, x, cos, sin, *,
                       local_window, cache, cache_index, block_tables,
                       q_delta=None):
    """``apply_attention`` on one rank of a mesh: this rank's heads (q/k/v
    columns sharded by the rules, or all of them where a projection is
    replicated), ``wo`` row-parallel and summed over ``model``; ``q_delta``
    (B, S, H_l, hd), the rank's heads of zamba2's LoRA, is added to q
    before RoPE.  With a cache (a prefill chunk at a scalar offset, a (B,)
    per-slot index, a paged pool) q, k and v are gathered to every head
    and ``_cache_attention`` gives every head's output, of which the rank
    keeps its own."""
    c, mesh = ctx.cdtype, ctx.mesh
    B, S = x.shape[:2]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    H_l = _local_heads(ctx, "wq", H, p["wq"].shape[-1], hd)
    K_l = _local_heads(ctx, "wk", K, p["wk"].shape[-1], hd)
    if (H_l == H) != (K_l == K):
        raise NotImplementedError(
            f"{H_l} of {H} query heads and {K_l} of {K} kv heads on this "
            f"rank: the port shards q and kv together or neither")
    sharded = H_l != H
    # column-parallel projections: their input's gradient sums over model
    x_in = C.copy_to(x, MODEL, mesh) if sharded else x
    q = (x_in @ p["wq"].to(c)).reshape(B, S, H_l, hd)
    if q_delta is not None:
        q = q + q_delta
    k = (x_in @ p["wk"].to(c)).reshape(B, S, K_l, hd)
    v = (x_in @ p["wv"].to(c)).reshape(B, S, K_l, hd)
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
    else:
        if sharded:                    # q, k, v gathered in one exchange
            n = _n_model(ctx)
            qkv = C.all_gather(torch.cat([q, k, v], dim=2), MODEL, mesh,
                               dim=2).reshape(B, S, n, H_l + 2 * K_l, hd)
            q, k, v = (qkv[:, :, :, a:b].flatten(2, 3) for a, b in (
                (0, H_l), (H_l, H_l + K_l), (H_l + K_l, H_l + 2 * K_l)))
        out = _cache_attention(ctx, cfg, q, k, v, cache, cache_index,
                               block_tables, cos, sin, scale=scale,
                               local_window=local_window)
        if sharded:
            m = _model_index(ctx)
            out = out[:, :, m * H_l:(m + 1) * H_l]
    y = out.reshape(B, S, H_l * hd) @ p["wo"].to(c)
    return C.reduce_from(y, MODEL, mesh) if sharded else y, cache


def _attention_seq(ctx: Ctx, cfg: ModelConfig, p: dict, x, cos, sin, *,
                   local_window, cache=None, cache_index=None,
                   block_tables=None):
    """Attention of the sequence-parallel program on one rank: ``x`` (B,
    S_l, d) holds rows [a, a + S_l) of the sequence (a chunk's rows, with
    a cache), a = r S_l, and ``cos``/``sin`` their global positions.  q, k
    and v of those rows with every head (``use_weights`` gathered the
    projections whole).  Without a cache k and v are gathered over
    ``model`` along the sequence in one exchange (``C.gather_sum``: each
    rank's gradient of the gathered rows is a partial sum, reduce-scattered
    back) and cut to the rows the rank's queries can see -- up to its last
    row when causal, from its first row's window start -- then
    ``ops.attention`` runs at the query offset of its first row over them.
    With a cache q, k, v and cos/sin are gathered along the sequence (the
    whole chunk on every rank), ``_cache_attention`` writes the cache and
    attends every row, and the rank keeps its rows.  ``wo`` on the rank's
    rows, with no reduction."""
    c = ctx.cdtype
    B, S_l = x.shape[:2]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(c)).reshape(B, S_l, H, hd)
    k = (x @ p["wk"].to(c)).reshape(B, S_l, K, hd)
    v = (x @ p["wv"].to(c)).reshape(B, S_l, K, hd)
    scale = (cfg.query_scale ** -0.5 if cfg.query_scale is not None
             else cfg.head_dim ** -0.5)
    a = _model_index(ctx) * S_l
    if cache is not None:
        qkv = C.all_gather(torch.cat([q, k, v], dim=2), MODEL, ctx.mesh, 1)
        if cfg.use_rope:
            cos, sin = C.all_gather(torch.stack([cos, sin]), MODEL,
                                    ctx.mesh, 2)
        out = _cache_attention(
            ctx, cfg, qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:],
            cache, cache_index, block_tables, cos, sin, scale=scale,
            local_window=local_window)[:, a:a + S_l]
        return out.reshape(B, S_l, H * hd) @ p["wo"].to(c)
    if cfg.use_rope:
        q = ref.apply_rope(q, cos, sin, cfg.rotary_pct)
        k = ref.apply_rope(k, cos, sin, cfg.rotary_pct)
    kv = C.gather_sum(torch.cat([k, v], dim=2), MODEL, ctx.mesh, 1)
    hi = a + S_l if cfg.causal else kv.shape[1]
    lo = max(0, a - local_window + 1) if local_window is not None else 0
    kv = kv[:, lo:hi]
    out = ops.attention(q, kv[:, :, :K], kv[:, :, K:], causal=cfg.causal,
                        local_window=local_window, softcap=cfg.attn_softcap,
                        scale=scale, naive_below=ctx.run.naive_attn_below,
                        q_offset=a - lo)
    return out.reshape(B, S_l, H * hd) @ p["wo"].to(c)


def seq_shard_kv_len(index, rank: int, rows: int, S: int = 1):
    """The kv_len rank ``rank`` passes the decode kernels for query rows
    [index, index + S) over its cache slice [rank * rows, (rank + 1) *
    rows): ``index + S - rank * rows``, or 0 where that is <= 0.  The
    kernels place query row i at ``kv_len - S + i``, the slice's local
    position of global ``index + i``, and read at most the slice's
    ``rows`` rows, so with the GLOBAL window (counted back from each
    query's position) this is the reference's mask ``k_pos <= q_pos``,
    ``k_pos > q_pos - window`` (``repro/models/layers.py:361-364``)
    restricted to the slice: a query before the slice, or one whose window
    ends before it, sees no key there (output 0, log-sum-exp -inf).
    ``index`` is an int or a (B,) tensor."""
    if torch.is_tensor(index):
        return torch.clamp(index + (S - rank * rows), min=0).to(torch.int32)
    return max(0, index + S - rank * rows)


def _cache_attention(ctx: Ctx, cfg: ModelConfig, q, k, v, cache,
                     cache_index, block_tables, cos, sin, *, scale,
                     local_window):
    """The cache write and attention of one rank's step or chunk under a
    mesh, every head: q (B, S, H, hd), k and v (B, S, K, hd), S rows at a
    scalar ``cache_index`` (a prefill chunk, broadcast to (B,)) or a (B,)
    per-slot index (continuous batching: done lanes at max_seq).  Returns
    (B, S, H, hd) in the compute dtype.

    A dense cache (B, R, K, hd) is this rank's slice [r R, (r+1) R) of
    the sequence over ``model``.  One ``cache_update`` launch rotates q
    and k and writes, at the local index ``index - r R`` with the row-level
    clip, exactly the rows that fall in the slice (a chunk that straddles
    two slices leaves each its rows; a done lane's max_seq lies past every
    slice, so it is dropped on every rank).  ``flash_decode`` then runs
    every query over the slice (``seq_shard_kv_len``, the global window)
    and returns its output and log-sum-exp, and ``m = pmax(lse)``, ``o =
    psum(o_l e^(lse - m)) / psum(e^(lse - m))`` over ``model`` combine the
    slices (the reference's ``_decode_attention_seqsharded``,
    ``repro/models/layers.py:307-384``, for any number of rows).  Staged
    for the combine: lse (B, H, S) and o with its weight (B, S, H, hd + 1)
    in float32, not the prefix rows GSPMD gathers.

    A paged pool (``block_tables``) is whole on every rank (the reference's
    ``PAGED_KV_CACHE_AXES``): each rank writes every kv head of every slot
    (``cache_update_paged``), so the ranks' pools stay equal; when the
    batch is split over the data-parallel axes the step's q, k, v, cos,
    sin, index and table rows are first gathered over them, every slot's
    rows written, and the rank's slots attended (``flash_decode_paged``)."""
    c, mesh = ctx.cdtype, ctx.mesh
    B, S = q.shape[:2]
    ck, cv = cache["k"], cache["v"]
    rope = (dict(cos=cos, sin=sin, rotary_pct=cfg.rotary_pct)
            if cfg.use_rope else {})
    attn = dict(softcap=cfg.attn_softcap, local_window=local_window,
                scale=scale)
    if torch.is_tensor(cache_index) and cache_index.ndim >= 1:
        idx = cache_index.to(torch.int32)
    else:
        start = int(cache_index)
        rows = (block_tables.shape[1] * ck.shape[1] if block_tables is not None
                else ck.shape[1] * _n_model(ctx))
        if start < 0 or start + S > rows:
            raise ValueError(f"prefill rows [{start}, {start + S}) outside "
                             f"the cache's {rows} rows")
        idx = torch.full((B,), start, dtype=torch.int32, device=q.device)
    if block_tables is not None:
        mine = slice(None)
        dp = dp_size(ctx)
        if dp > 1:
            d = mesh.index(DP_AXES)
            mine = slice(d * B, (d + 1) * B)
            H = q.shape[2]
            qkv = C.all_gather(torch.cat([q, k, v], dim=2), DP_AXES, mesh, 0)
            q, k, v = qkv[:, :, :H], qkv[:, :, H:H + k.shape[2]], \
                qkv[:, :, H + k.shape[2]:]
            idx = C.all_gather(idx, DP_AXES, mesh, 0)
            block_tables = C.all_gather(block_tables, DP_AXES, mesh, 0)
            if rope:
                rope["cos"], rope["sin"] = C.all_gather(
                    torch.stack([cos, sin]), DP_AXES, mesh, 1)
        if rope:
            rope["q"] = q.contiguous()
        written = ops.kv_cache_update_paged(ck, cv, k.contiguous(),
                                            v.contiguous(), idx,
                                            block_tables, **rope)
        if rope:
            q = written[2]
        return ops.decode_attention_paged(
            q[mine].contiguous(), ck.to(c), cv.to(c), (idx + S)[mine],
            block_tables[mine].contiguous(), **attn)
    n, r = _n_model(ctx), _model_index(ctx)
    R = ck.shape[1]
    local = idx - r * R
    if rope:
        rope["q"] = q.contiguous()
    written = ops.kv_cache_update(ck, cv, k.contiguous(), v.contiguous(),
                                  local, clip_rows=True, **rope)
    if rope:
        q = written[2]
    o, lse = ops.decode_attention(q.contiguous(), ck.to(c), cv.to(c),
                                  seq_shard_kv_len(idx, r, R, S),
                                  return_lse=True, **attn)
    if n == 1:
        return o
    # a row no slice shows a key (a done lane under a window of 1) takes
    # weight 0 everywhere, not exp(-inf + inf)
    m = C.pmax(lse, MODEL, mesh).clamp(min=torch.finfo(torch.float32).min)
    w = torch.exp(lse - m).permute(0, 2, 1)[..., None]   # (B, S, H, 1)
    both = C.psum(torch.cat([o.float() * w, w], dim=-1), MODEL, mesh)
    return (both[..., :-1] / torch.clamp(both[..., -1:], min=1e-30)).to(c)


#: logical axes of the stacked KV cache and Mamba state leaves
#: (``repro/models/layers.py:265, 656``)
KV_CACHE_AXES = {"k": ("layers", "act_batch", "act_kv_seq", None, None),
                 "v": ("layers", "act_batch", "act_kv_seq", None, None)}
MAMBA_STATE_AXES = {"ssm": ("layers", "act_batch", "ssm_heads", None, None),
                    "conv": ("layers", "act_batch", None, "act_ssm")}


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
    """The dense MLP; under a mesh with ``mlp`` sharded, ``w_up``/``w_gate``
    column- and ``w_down`` row-parallel, summed over ``model``."""
    c = ctx.cdtype
    sharded = ctx.mesh is not None and p["w_up"].shape[-1] != cfg.d_ff
    if sharded:
        x = C.copy_to(x, MODEL, ctx.mesh)
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
    y = h @ p["w_down"].to(c)
    return C.reduce_from(y, MODEL, ctx.mesh) if sharded else y


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


def _moe_router(cfg: ModelConfig, p: dict, xf, mesh=None, axes=DP_AXES):
    """Router probabilities, top-k and the Switch load-balancing aux loss,
    in float32 from the float32 router (``lm.prepare_params`` keeps it
    f32, as the reference reads its masters).  xf: (T, D).  Returns
    top_p (T, K) renormalised, top_e (T, K) and aux ().

    Under a mesh the tokens are this rank's share of the tokens split over
    ``axes`` (the data-parallel axes, and ``model`` under sequence
    parallelism), and the aux is this rank's term of the global one: the
    mean probabilities over the global token count times the global
    dispatch fractions (a sum over ``axes``, without gradient), so the
    ranks' terms sum to the reference's aux and their gradients, summed
    as every gradient is, to its gradient."""
    E, K = cfg.n_experts, cfg.top_k
    T = xf.shape[0]
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    if mesh is None or mesh.axis_size(axes) == 1:
        me = probs.mean(dim=0)
        ce = torch.zeros((E,), dtype=torch.float32,
                         device=xf.device).index_add_(
            0, top_e.reshape(-1),
            torch.full((T * K,), 1.0 / (T * K), dtype=torch.float32,
                       device=xf.device))
        return top_p, top_e, E * torch.sum(me * ce)
    counts = torch.zeros((E + 1,), dtype=torch.float32,
                         device=xf.device).index_add_(
        0, top_e.reshape(-1),
        torch.ones((T * K,), dtype=torch.float32, device=xf.device))
    counts[E] = T
    counts = C.psum(counts, axes, mesh)        # global counts and tokens
    me = probs.sum(dim=0) / counts[E]
    ce = counts[:E] / (counts[E] * K)
    return top_p, top_e, E * torch.sum(me * ce)


def _moe_dispatch_local(cfg: ModelConfig, xf, top_e, capacity: int,
                        offset=None):
    """Capacity dispatch of the call's tokens into (E, capacity, D), with
    the combine indices.  Each (token, k) assignment, in row-major order,
    takes the next position of its expert (a cumulative count, after
    ``offset[e]`` positions taken by earlier tokens elsewhere); positions
    past ``capacity`` go to an overflow row ``capacity`` that is cut off.
    Returns (expert_in, flat_e, slot, keep).  Nothing here reads a device
    value on the host."""
    E, K = cfg.n_experts, cfg.top_k
    T, D = xf.shape
    flat_e = top_e.reshape(-1)                                  # (T*K,)
    onehot = (flat_e[:, None]
              == torch.arange(E, device=xf.device)[None]).int()
    pos_in_e = torch.cumsum(onehot, dim=0) - 1
    if offset is not None:
        pos_in_e = pos_in_e + offset[None]
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
    x: (B, S, D).  Returns (y, aux_loss).

    Under a mesh with the experts sharded over ``model`` (``E`` divisible
    by it): expert parallelism when ``S`` divides too and the batch is
    split over the data-parallel axes (or there is one), or when the rows
    are already this rank's share of the sequence (``_moe_ep``), else
    each rank's experts on the common dispatch (``_moe_local_experts``).
    The router runs on every rank's whole share of the tokens; its aux is
    that rank's term (``_moe_router``).  With the experts replicated (E
    not divisible by the axis) under sequence parallelism, each rank
    dispatches its own rows at their own capacity, where the reference's
    GSPMD dispatch counts the global tokens: with a binding capacity the
    two drop other tokens."""
    c = ctx.cdtype
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    xf = x.reshape(B * S, D)
    top_p, top_e, aux = _moe_router(cfg, p, xf, ctx.mesh,
                                    token_axes(ctx.seq_shard, ctx.dp_batch))
    n = _n_model(ctx)
    if n > 1 and p["w_gate"].shape[0] != E:
        # the reference's ``use_ep`` also needs the batch to divide the
        # data-parallel axes: rows replicated over them (a one-slot
        # prefill chunk) take the common dispatch
        if ctx.seq_shard or S % n == 0 and (
                ctx.dp_batch or ctx.mesh.axis_size(DP_AXES) == 1):
            return _moe_ep(ctx, cfg, p, x, top_p, top_e), aux
        return _moe_local_experts(ctx, cfg, p, x, top_p, top_e), aux
    capacity = int(max(1, math.ceil(B * S * K * cfg.capacity_factor / E)))
    expert_in, flat_e, slot, keep = _moe_dispatch_local(cfg, xf, top_e,
                                                        capacity)
    out = _moe_expert_ffn(ctx, cfg, p, expert_in.to(c))
    return _moe_combine_local(out, flat_e, slot, keep, top_p, B, S), aux


class _A2AInt8(torch.autograd.Function):
    """The int8-wire all-to-all over ``model`` (the reference's
    ``_a2a_int8``, ``repro/models/layers.py:554-578``).  Forward: each row
    (the last dim) quantized to int8 with a float32 scale
    (``ref.int8_quantize``), both exchanged, then dequantized to the
    input's dtype: a quarter of f32's bytes, half of bf16's, plus the
    scales.  Backward: the cotangent rides a plain all-to-all."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        q, scale = ref.int8_quantize(t)
        q_x = C.all_to_all(q, MODEL, mesh)
        s_x = C.all_to_all(scale, MODEL, mesh)
        return ref.int8_dequantize(q_x, s_x, t.dtype)

    @staticmethod
    def backward(ctx, g):
        return C.all_to_all(g.contiguous(), MODEL, ctx.mesh), None


def _a2a(ctx: Ctx, t):
    if ctx.run.moe_a2a_dtype == "int8":
        return _A2AInt8.apply(t, ctx.mesh)
    return C.all_to_all_grad(t, MODEL, ctx.mesh)


def _moe_ep(ctx: Ctx, cfg: ModelConfig, p: dict, x, top_p, top_e):
    """Expert parallelism (the reference's ``_moe_shard_map``,
    ``repro/models/layers.py:580-640``) on one rank: its slice of the
    sequence is dispatched locally into (E, cap, D) with cap from its own
    (B_l * S / n) tokens, as each shard's in the reference; the
    all-to-all sends expert e's rows to the rank holding e, the rank's
    ``E / n`` experts run on their ``n * cap`` rows (three
    ``grouped_matmul``), the all-to-all brings them back, and the rank
    combines its slice; the slices are gathered over ``model``.  Under
    sequence parallelism (``ctx.seq_shard``) ``x`` is the rank's slice
    already, and its output stays so: no scatter, no gather."""
    c, mesh = ctx.cdtype, ctx.mesh
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    n = _n_model(ctx)
    e_local = p["w_gate"].shape[0]
    if ctx.seq_shard:
        S_l, x_l, tp_l = S, x, top_p.reshape(B, S, K)
        te_l = top_e.reshape(B, S, K)
    else:
        S_l = S // n
        x_l = C.scatter_to(x, MODEL, mesh, 1)             # (B, S_l, D)
        tp_l = C.scatter_to(top_p.reshape(B, S, K), MODEL, mesh, 1)
        m = _model_index(ctx)
        te_l = top_e.reshape(B, S, K)[:, m * S_l:(m + 1) * S_l]
    cap = int(max(1, math.ceil(B * S_l * K * cfg.capacity_factor / E)))
    disp, flat_e, slot, keep = _moe_dispatch_local(
        cfg, x_l.reshape(B * S_l, D).to(c), te_l.reshape(B * S_l, K), cap)
    recv = _a2a(ctx, disp.reshape(n, e_local, cap, D).contiguous())
    # recv[i]: source rank i's rows for this rank's experts
    recv = recv.permute(1, 0, 2, 3).reshape(e_local, n * cap, D)
    out = _moe_expert_ffn(ctx, cfg, p, recv.contiguous())
    out = out.reshape(e_local, n, cap, D).permute(1, 0, 2, 3).contiguous()
    back = _a2a(ctx, out).reshape(E, cap, D)
    y_l = _moe_combine_local(back, flat_e, slot, keep,
                             tp_l.reshape(B * S_l, K), B, S_l)
    return y_l if ctx.seq_shard else C.gather_from(y_l, MODEL, mesh, 1)


def _moe_local_experts(ctx: Ctx, cfg: ModelConfig, p: dict, x, top_p,
                       top_e):
    """Experts sharded over ``model`` where expert parallelism does not
    divide the sequence (a decode step): the reference's GSPMD dispatch of
    the global batch, cut by rank.  The capacity counts the global tokens
    (this rank's times the data-parallel ranks), and this rank's
    assignments take their expert's positions after those of the
    data-parallel ranks before it (their per-expert counts, gathered), so
    a token is dropped exactly where one device drops it.  The ``model``
    ranks of a data-parallel rank dispatch the same tokens, each runs its
    ``E / n`` experts on their rows, and the combined outputs are summed
    over ``model``."""
    c, mesh = ctx.cdtype, ctx.mesh
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    e_local = p["w_gate"].shape[0]
    dp = dp_size(ctx)
    capacity = int(max(1, math.ceil(B * S * dp * K * cfg.capacity_factor
                                    / E)))
    offset = None
    if dp > 1:
        counts = torch.zeros((E,), dtype=torch.int64,
                             device=x.device).index_add_(
            0, top_e.reshape(-1), torch.ones((B * S * K,), dtype=torch.int64,
                                             device=x.device))
        counts = C.all_gather(counts[None], DP_AXES, mesh, 0)    # (dp, E)
        offset = counts[:mesh.index(DP_AXES)].sum(0)
    xf = C.copy_to(x, MODEL, mesh).reshape(B * S, D)
    expert_in, flat_e, slot, keep = _moe_dispatch_local(cfg, xf, top_e,
                                                        capacity, offset)
    e0 = _model_index(ctx) * e_local
    out_l = _moe_expert_ffn(ctx, cfg, p,
                            expert_in[e0:e0 + e_local].to(c).contiguous())
    out = torch.cat([out_l.new_zeros((e0,) + out_l.shape[1:]), out_l,
                     out_l.new_zeros((E - e0 - e_local,) + out_l.shape[1:])])
    y = _moe_combine_local(out, flat_e, slot, keep,
                           C.copy_to(top_p, MODEL, mesh), B, S)
    return C.reduce_from(y, MODEL, mesh)


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


def _split_mamba(cfg: ModelConfig, zxbcdt, din: int | None = None):
    """(z, xBC, dt) of the packed projection; ``din`` the d_inner it
    holds (a rank's share under a mesh, default the whole)."""
    N = cfg.ssm_state
    din = cfg.d_inner if din is None else din
    G = 1
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:din + din + 2 * G * N]
    dt = zxbcdt[..., din + din + 2 * G * N:]
    return z, xbc, dt


def mamba_spans(cfg: ModelConfig, rank: int, n: int):
    """The column spans rank ``rank`` of ``n`` over ``model`` computes in
    the Mamba-2 block's packed layouts, for heads [r H/n, (r+1) H/n):
    ``in_proj``'s [z | x | B | C | dt] gives its z, x and dt and all of B
    and C (one group: every head reads them), the conv's [x | B | C] its
    x and all of B and C.  Returns (projection spans, conv spans), each a
    tuple of (start, stop)."""
    din, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dl, hl = din // n, H // n
    x, bc = (rank * dl, (rank + 1) * dl), (din, din + 2 * N)
    dt0 = 2 * din + 2 * N
    proj = ((rank * dl, (rank + 1) * dl), (din + x[0], din + x[1]),
            (2 * din, dt0), (dt0 + rank * hl, dt0 + (rank + 1) * hl))
    return proj, (x, bc)


def take_spans(t, spans, dim: int = -1):
    """The ``spans`` of ``t`` along ``dim``, concatenated in order."""
    return torch.cat([t.narrow(dim, a, b - a) for a, b in spans], dim=dim)


def _mamba_heads(cfg: ModelConfig, p: dict) -> int:
    """The heads of this rank's Mamba-2 program: ``H / n`` when the rules
    split ``ssm_heads`` over an n-way ``model`` axis, else ``H``; the
    head-aligned leaves (``norm``, ``out_proj``'s rows) must be split
    alike, or the call raises."""
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    H_l = p["A_log"].shape[-1]
    if p["norm"].shape[-1] != H_l * P or p["out_proj"].shape[0] != H_l * P:
        raise NotImplementedError(
            f"Mamba-2 block with {H_l} of {H} heads and {p['norm'].shape[-1]}"
            f" of {cfg.d_inner} d_inner on this rank: the port splits the "
            f"block by whole heads")
    return H_l


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

    Under a mesh whose rules split the heads over ``model`` (``p`` from
    ``use_weights``: ``in_proj``, ``conv_w`` and ``conv_b`` whole, the
    others this rank's shards) the rank runs its heads (``mamba_spans``):
    the input through ``copy_to``, the states its heads' and its conv
    channels' (``lm.shard_cache``), the gated norm's sum all-reduced and
    ``out_proj``'s partial product summed with ``reduce_from``; a prefill
    chunk into a cache carries the rank's conv window and runs ``ssd``
    from its heads' state, writing it in place.
    Returns (y, (ssm_state, conv_state))."""
    c = ctx.cdtype
    B, S, _ = x.shape
    N, P = cfg.ssm_state, cfg.ssm_headdim
    G = 1
    H = _mamba_heads(cfg, p)
    n = cfg.ssm_heads // H
    din = H * P
    in_proj, conv_w, conv_b = p["in_proj"], p["conv_w"], p["conv_b"]
    decode = S == 1 and ssm_state is not None
    if n > 1:
        proj, conv = mamba_spans(cfg, _model_index(ctx), n)
        in_proj = take_spans(in_proj, proj)
        conv_w, conv_b = take_spans(conv_w, conv), take_spans(conv_b, conv)
        # column-parallel: the input's gradient sums over model
        x = C.copy_to(x, MODEL, ctx.mesh)
    zxbcdt = x @ in_proj.to(c)
    z, xbc, dt_raw = _split_mamba(cfg, zxbcdt, din)

    conv_w = conv_w.to(c)
    conv_b = conv_b.to(c)
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
    if n == 1:
        y = rmsnorm_gated(p["norm"], y, z)
        return y @ p["out_proj"].to(c), (ssm_state, conv_state)
    y = rmsnorm_gated(p["norm"], y, z, mesh=ctx.mesh, width=cfg.d_inner)
    return (C.reduce_from(y @ p["out_proj"].to(c), MODEL, ctx.mesh),
            (ssm_state, conv_state))


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
    """The table lookup; under a mesh with the table's rows (the vocab)
    sharded over ``model`` (the Megatron program), each rank looks up the
    tokens its rows hold, zeros elsewhere, and the lookups are summed over
    ``model``; where ``use_weights`` gathers the table (the vocab under
    sequence parallelism, the embed dim under fsdp) the lookup is on the
    gathered table."""
    table = use_weights(ctx, p, embed_decls(cfg))["table"].to(ctx.cdtype)
    if ctx.mesh is not None and table.shape[0] != cfg.vocab_padded:
        lo = _model_index(ctx) * table.shape[0]
        ids = tokens.long() - lo
        mine = (ids >= 0) & (ids < table.shape[0])
        emb = table[ids.clamp(0, table.shape[0] - 1)] \
            * mine[..., None].to(table.dtype)
        emb = C.reduce_from(emb, MODEL, ctx.mesh)
    else:
        emb = table[tokens.long()]
    if cfg.embed_scale_by_sqrt_dim:      # gemma-style input scaling
        emb = emb * torch.tensor(cfg.d_model ** 0.5, dtype=ctx.cdtype)
    return emb


def unembed_decls(cfg: ModelConfig) -> dict:
    if cfg.tie_embeddings:
        return {}
    return {"w": PD((cfg.d_model, cfg.vocab_padded), ("embed", "vocab"),
                    scale=cfg.d_model ** -0.5)}
