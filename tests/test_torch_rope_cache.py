"""RoPE folded into the KV-cache writes, on the CPU against the JAX package.

``cache_update`` and ``cache_update_paged`` given q, cos and sin rotate q
and the new k rows and write k and v in one launch on the card; on the CPU
they run the plain composition (``ref.rope_kv_cache_update_ref``: two
``apply_rope`` passes, then the plain scatter).  Here that composition is
held against JAX's ``apply_rope`` followed by the Pallas ``cache_update``
/ ``cache_update_paged`` in interpret mode on seeded numpy inputs, at
llama's, olmoe's and zamba2's head counts (narrow D), f32 and bf16, a
decode step and a 256-row chunk, with done, negative and overrunning
slots, and partial rotary: bit for bit (JAX's eager ``apply_rope`` rounds
every product and sum on its own, as the port does).  The CUDA branch
(reached through a tensor that reports itself as CUDA) checks its RoPE
arguments, refuses tensors that require grad, and never takes the plain
version; reduced llama and zamba2 engines, dense and paged, still give the
JAX engine's f32 token streams, with every cache write taking RoPE along
and ``apply_rope`` reached only inside it.  The CUDA kernels themselves
are held to the plain composition on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_model_config as jget_cfg  # noqa: E402
from repro.configs.registry import get_run_config as jget_run  # noqa: E402
from repro.kernels.flash_attention import cache_update as jcache_update  # noqa: E402,E501
from repro.kernels.flash_attention import (  # noqa: E402
    cache_update_paged as jcache_update_paged)
from repro.models import layers as jL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.layers import Ctx as JCtx  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.sharding import RULE_SETS  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import (get_model_config,  # noqa: E402
                                          get_run_config)
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import load_numpy_params  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

#: (H, K) of llama3.2-3b, olmoe-1b-7b and zamba2-1.2b's attention, at a
#: narrow head_dim
HEADS = {"llama": (24, 8), "olmoe": (16, 16), "zamba2": (32, 32)}
D = 16
#: (new rows, cache) dtype pairs the wrappers accept
DTYPES = [("float32", "float32"), ("float32", "bfloat16"),
          ("bfloat16", "bfloat16"), ("bfloat16", "float32")]


def _index(Sn, S, B):
    """Per-slot offsets: done (S), negative and overrunning slots, and
    ragged valid ones, one of them a write ending on the last row."""
    return np.array([3, S, -1, S - Sn + 1, 0, S - Sn, 11, 37][:B], np.int32)


def _inputs(B, Sn, H, K, rotary_pct, theta, index, seed):
    """q, k, v (f32) and the f32 cos/sin of positions index[b] + j, as the
    JAX ``rope_cos_sin`` gives them."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sn, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sn, K, D)).astype(np.float32)
    v = rng.standard_normal((B, Sn, K, D)).astype(np.float32)
    half = int(D * rotary_pct) // 2
    pos = np.maximum(index, 0)[:, None] + np.arange(Sn)[None]
    inv = theta ** (-np.arange(half, dtype=np.float32) / half)
    ang = (pos.astype(np.float32)[..., None] * inv).astype(np.float32)
    cos = np.array(jnp.cos(jnp.asarray(ang)))
    sin = np.array(jnp.sin(jnp.asarray(ang)))
    return q, k, v, cos, sin


def _jax_rope(q, k, cos, sin, rotary_pct, new_dt):
    """JAX's apply_rope on q and k, op by op (no jit, no fusion)."""
    j = getattr(jnp, new_dt)
    c, s = jnp.asarray(cos), jnp.asarray(sin)
    return (jL.apply_rope(jnp.asarray(q, j), c, s, rotary_pct),
            jL.apply_rope(jnp.asarray(k, j), c, s, rotary_pct))


def _torch(x, dt):
    return torch.from_numpy(np.asarray(x)).to(getattr(torch, dt))


def _assert_bits(got, want):
    """got (torch) equals want (JAX) bit for bit, in got's dtype."""
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), w)


CASES = [(m, Sn, nd, cd, 1.0) for m in HEADS for Sn in (1, 256)
         for nd, cd in DTYPES]
CASES += [("llama", Sn, nd, "bfloat16", 0.5) for Sn in (1, 256)
          for nd in ("float32", "bfloat16")]
IDS = [f"{m}-Sn{Sn}-{nd[0]}{nd[-2:]}to{cd[0]}{cd[-2:]}-rot{rp}"
       for m, Sn, nd, cd, rp in CASES]


@pytest.mark.parametrize("model,Sn,new_dt,cache_dt,rotary_pct", CASES,
                         ids=IDS)
def test_dense_rope_and_write_equal_jax_rope_then_cache_update(
        model, Sn, new_dt, cache_dt, rotary_pct):
    H, K = HEADS[model]
    B, S = (8, 32) if Sn == 1 else (6, 512)
    index = _index(Sn, S, B)
    q, k, v, cos, sin = _inputs(B, Sn, H, K, rotary_pct, 10000.0, index,
                                seed=Sn + H + K)
    rng = np.random.default_rng(1)
    kc = rng.standard_normal((B, S, K, D)).astype(np.float32)
    vc = rng.standard_normal((B, S, K, D)).astype(np.float32)
    jq, jk = _jax_rope(q, k, cos, sin, rotary_pct, new_dt)
    jc = getattr(jnp, cache_dt)
    want_k, want_v = jcache_update(
        jnp.asarray(kc, jc), jnp.asarray(vc, jc), jk,
        jnp.asarray(v, getattr(jnp, new_dt)), jnp.asarray(index),
        interpret=True)

    tk, tv = _torch(kc, cache_dt), _torch(vc, cache_dt)
    got = ops.kv_cache_update(
        tk, tv, _torch(k, new_dt), _torch(v, new_dt),
        torch.from_numpy(index), q=_torch(q, new_dt),
        cos=torch.from_numpy(cos), sin=torch.from_numpy(sin),
        rotary_pct=rotary_pct)
    assert got[0] is tk and got[1] is tv              # written in place
    assert got[2].dtype == getattr(torch, new_dt)
    for g, w in zip(got, (want_k, want_v, jq)):
        _assert_bits(g, w)


@pytest.mark.parametrize("model,Sn,new_dt,cache_dt,rotary_pct", CASES,
                         ids=IDS)
def test_paged_rope_and_write_equal_jax_rope_then_cache_update_paged(
        model, Sn, new_dt, cache_dt, rotary_pct):
    """Through scattered block tables (bs = 8), the rows of a 256-row
    chunk crossing 32 blocks; blocks no table maps stay untouched."""
    H, K = HEADS[model]
    bs = 8
    B, S = (8, 32) if Sn == 1 else (6, 512)
    mb = S // bs
    n_blocks = B * mb + 3
    index = _index(Sn, S, B)
    q, k, v, cos, sin = _inputs(B, Sn, H, K, rotary_pct, 500000.0, index,
                                seed=7 * Sn + H)
    rng = np.random.default_rng(2)
    kp = rng.standard_normal((n_blocks, bs, K, D)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, bs, K, D)).astype(np.float32)
    tables = rng.permutation(B * mb).reshape(B, mb).astype(np.int32)
    jq, jk = _jax_rope(q, k, cos, sin, rotary_pct, new_dt)
    jc = getattr(jnp, cache_dt)
    want_k, want_v = jcache_update_paged(
        jnp.asarray(kp, jc), jnp.asarray(vp, jc), jk,
        jnp.asarray(v, getattr(jnp, new_dt)), jnp.asarray(index),
        jnp.asarray(tables), interpret=True)

    tk, tv = _torch(kp, cache_dt), _torch(vp, cache_dt)
    before = tk.clone()
    got = ops.kv_cache_update_paged(
        tk, tv, _torch(k, new_dt), _torch(v, new_dt),
        torch.from_numpy(index), torch.from_numpy(tables),
        q=_torch(q, new_dt), cos=torch.from_numpy(cos),
        sin=torch.from_numpy(sin), rotary_pct=rotary_pct)
    assert got[0] is tk and got[1] is tv
    for g, w in zip(got, (want_k, want_v, jq)):
        _assert_bits(g, w)
    unmapped = [B * mb, B * mb + 1, B * mb + 2]
    assert torch.equal(tk[unmapped], before[unmapped])


def test_without_rope_the_wrappers_are_the_bare_scatters():
    """No q, cos or sin: the plain scatter, two results, k unrotated."""
    B, S, Sn, K = 3, 16, 2, 2
    rng = np.random.default_rng(3)
    kn = torch.from_numpy(rng.standard_normal((B, Sn, K, D))
                          .astype(np.float32))
    idx = torch.tensor([0, 5, S], dtype=torch.int32)
    kc, vc = torch.zeros((B, S, K, D)), torch.zeros((B, S, K, D))
    got = tfa.cache_update(kc, vc, kn, kn, idx)
    assert len(got) == 2
    assert torch.equal(kc[1, 5:7], kn[1]) and not kc[2].any()


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports itself as CUDA, to reach a wrapper's
    CUDA branch without a card."""

    @property
    def is_cuda(self):
        return True


def _cuda_args(paged):
    B, Sn, H, K = 2, 3, 4, 2
    new = torch.zeros((B, Sn, K, D)).as_subclass(_OnCuda)
    cache = torch.zeros((7, 8, K, D) if paged else (B, 16, K, D)) \
        .as_subclass(_OnCuda)
    extra = (torch.zeros((B, 2), dtype=torch.int32),) if paged else ()
    fn = tfa.cache_update_paged if paged else tfa.cache_update
    rope = dict(q=torch.zeros((B, Sn, H, D)).as_subclass(_OnCuda),
                cos=torch.zeros((B, Sn, D // 2)),
                sin=torch.zeros((B, Sn, D // 2)))
    idx = torch.zeros((B,), dtype=torch.int32)
    return fn, (cache, cache, new, new, idx) + extra, rope


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cuda_branch_checks_rope_arguments_and_never_falls_back(monkeypatch,
                                                                paged):
    fn, args, rope = _cuda_args(paged)
    name = fn.__name__
    with pytest.raises(TypeError, match="come together"):
        fn(*args, q=rope["q"])
    with pytest.raises(TypeError, match="come together"):
        fn(*args, cos=rope["cos"], sin=rope["sin"])
    with pytest.raises(TypeError, match="q "):
        fn(*args, **dict(rope, q=rope["q"].bfloat16()))
    with pytest.raises(TypeError, match="q "):
        fn(*args, **dict(rope, q=rope["q"][:, :2]))
    with pytest.raises(TypeError, match="cos"):
        fn(*args, **dict(rope, cos=rope["cos"].double()))
    with pytest.raises(TypeError, match="sin"):
        fn(*args, **dict(rope, sin=rope["sin"][..., :4]))
    with pytest.raises(TypeError, match="cos"):   # rotary_pct 0.5: 4 wide
        fn(*args, **rope, rotary_pct=0.5)

    def no_nvcc(lib):
        raise RuntimeError(f"nvcc not found building {lib}")

    monkeypatch.setattr(tfa.build, "library", no_nvcc)
    monkeypatch.setattr(ref, "rope_kv_cache_update_ref", None)
    monkeypatch.setattr(ref, "apply_rope", None)
    with pytest.raises(RuntimeError, match=name):
        fn(*args, **rope)
    assert fn.launches == 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cuda_branch_refuses_tensors_that_require_grad(monkeypatch, paged):
    """The fused write has no backward: training keeps apply_rope and the
    cache-free attention.  Without a graph to record (no_grad) the call
    goes on to the kernel."""
    fn, args, rope = _cuda_args(paged)
    q = rope["q"].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        fn(*args, **dict(rope, q=q))

    def no_nvcc(lib):
        raise RuntimeError(f"nvcc not found building {lib}")

    monkeypatch.setattr(tfa.build, "library", no_nvcc)
    with torch.no_grad(), pytest.raises(RuntimeError, match="nvcc"):
        fn(*args, **dict(rope, q=q))


# ===========================================================================
# the serving engines: reduced llama3.2-3b and zamba2-1.2b in f32
# ===========================================================================

def _pair(arch):
    jcfg = jreduced(jget_cfg(arch))
    jrun = jget_run(arch, remat="none", compute_dtype="float32")
    jctx = JCtx(jrun, RULE_SETS[jrun.rules_name], None)
    jparams = jinit(jlm.model_decls(jcfg), jax.random.PRNGKey(0))
    cfg = reduced(get_model_config(arch))
    run = get_run_config(arch, remat="none", compute_dtype="float32")
    params = load_numpy_params(jax.tree.map(np.asarray, jparams), "cpu")
    return (jcfg, jrun, jctx, jparams), (cfg, run, Ctx(run, "cpu"), params)


def _reqs(cls, n=6):
    """More requests than slots, prompts longer than a prefill chunk."""
    rng = np.random.default_rng(4)
    lens = [19, 4, 11, 23, 2, 9][:n]
    return [cls(uid=i, prompt=rng.integers(2, 200, lens[i]).tolist(),
                max_new_tokens=int(rng.integers(2, 9))) for i in range(n)]


KW = dict(batch_size=3, max_seq=48, prefill_chunk=8, decode_chunk=4)
MODES = {"dense": {}, "paged": dict(paged=True, block_size=8)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-1.2b"])
def test_engine_streams_equal_the_jax_engine(monkeypatch, arch, mode):
    """f32 streams equal the JAX engine's; every cache write (decode steps
    and prefill chunks, dense and paged) carries q, cos and sin, and
    ``apply_rope`` runs only inside the fused write's plain version."""
    (jcfg, jrun, jctx, jparams), (cfg, run, ctx, params) = _pair(arch)
    want = {r.uid: r.generated for r in JServeEngine(
        jcfg, jrun, jctx, jparams, **MODES[mode], **KW)
        .generate(_reqs(JRequest))}

    writes, inside = [], [False]
    fused, rope = ref.rope_kv_cache_update_ref, ref.apply_rope

    def spy_fused(*a, **kw):
        inside[0] = True
        try:
            return fused(*a, **kw)
        finally:
            inside[0] = False

    def spy_rope(*a, **kw):
        assert inside[0], "apply_rope outside the fused cache write"
        return rope(*a, **kw)

    name = "cache_update_paged" if mode == "paged" else "cache_update"
    wrapper = getattr(tfa, name)

    def spy_wrapper(*a, **kw):
        writes.append(sorted(kw))
        return wrapper(*a, **kw)

    monkeypatch.setattr(ref, "rope_kv_cache_update_ref", spy_fused)
    monkeypatch.setattr(ref, "apply_rope", spy_rope)
    monkeypatch.setattr(tfa, name, spy_wrapper)
    eng = ServeEngine(cfg, run, ctx, params, **MODES[mode], **KW)
    got = {r.uid: r.generated for r in eng.generate(_reqs(Request))}
    assert got == want
    assert writes and all(kw == ["cos", "q", "rotary_pct", "sin"]
                          for kw in writes)
