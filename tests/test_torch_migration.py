"""Portable slot state and the serving engine's preemption interface in the
port (``repro_torch.models.lm`` export/import, ``kernels/ref.py``'s slot
and int8 primitives, ``ServeEngine.drain/restore/checkpoint/abandon``),
held against ``repro`` on the same numpy-seeded inputs, on reduced f32
llama3.2-3b, olmoe-1b-7b (capacity factor 8.0: nothing dropped, so no
done lane reaches a live one), mamba2-370m and zamba2-1.2b:

  * payloads of ``export_slot`` (raw and int8) and the caches
    ``import_slot`` leaves equal ``repro.models.lm``'s bit for bit, across
    batch and ``max_seq`` changes, with ``row_start``/``row_offset``; the
    paged exporter gives the dense exporter's payload and the paged
    importer touches only its rows; every rejection raises the
    reference's ``ValueError`` message;
  * ``int8_quantize`` equals ``int8_quantize_ref`` bit for bit on f32 and
    bf16 (zero rows, .5 ties), every quantized leaf within the reference's
    error budget, payload bytes and ``int8_payload_ratio`` equal;
  * scripted engine scenarios (whole and partial drains, cold snapshots,
    checkpoint, abandon, slot limits, restore order) run on the JAX engine
    and on the port's: equal streams, snapshots, victims and, at every
    step, ``in_flight_tokens``, ``queue_depth``, ``pending``,
    ``sync_count`` and ``active_slots``; streams equal the JAX engine's
    unpreempted ones;
  * paged <-> dense restores and prefix-trimmed payloads;
  * the graphed engine (a stand-in graph on the CPU): a drain/restore
    cycle adds no capture, moves no storage and gives the eager streams.

The JAX engines are made once per geometry and module, and torch runs on
one intra-op thread.  The round trips on the card are in
``tests/test_torch_migration_card.py``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_model_config as jget_cfg  # noqa: E402
from repro.configs.registry import get_run_config as jget_run  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.layers import Ctx as JCtx  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.serving.engine import SlotSnapshot as JSlotSnapshot  # noqa: E402
from repro.sharding import RULE_SETS  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import (get_model_config,  # noqa: E402
                                          get_run_config)
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import load_numpy_params  # noqa: E402
from repro_torch.serving import graphs  # noqa: E402
from repro_torch.serving.engine import (Request, ServeEngine,  # noqa: E402
                                        SlotSnapshot)

FAMILIES = ["llama3.2-3b", "olmoe-1b-7b", "mamba2-370m", "zamba2-1.2b"]
ROWS_ONLY = {"llama3.2-3b", "olmoe-1b-7b"}
GEOM = {"g3": dict(batch_size=3, max_seq=32, decode_chunk=4),
        "g2": dict(batch_size=2, max_seq=48, decode_chunk=4),
        "g1": dict(batch_size=1, max_seq=32, decode_chunk=4),
        "paged": dict(batch_size=3, max_seq=32, decode_chunk=4, paged=True,
                      block_size=8),
        "shared": dict(batch_size=3, max_seq=32, decode_chunk=4, paged=True,
                       block_size=8, prefix_sharing=True)}

MIXED_PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [2, 4],
                 [9, 8, 7, 6, 5], [3, 1, 4, 1, 5, 9, 2, 6, 5]]
MIXED_NEW = [4, 6, 3, 5, 2]
# the reference's workloads (tests/test_migration.py)
WORKLOADS = {
    "mixed": [(p, n, 0) for p, n in zip(MIXED_PROMPTS, MIXED_NEW)],
    "partial": [([1, 2, 3], 10, 0), ([4, 5], 9, 0), ([7, 6, 5, 4], 8, 0)],
    "cold": [([1 + i, 2, 3], 8, 0) for i in range(5)],
    "int8": [([1, 2, 3], 12, 0), ([4, 5, 6, 7, 8, 9, 10], 10, 0),
             ([2, 4], 14, 0)],
    "long": [([1, 2, 3], 10, 0), ([7, 5], 9, 0)],
}


def _prefix_specs(prefix_len):
    """``tests/test_paging.py::_reqs``: an 11-token shared prefix."""
    prefix = [(7 * j + 5) % 97 + 2 for j in range(11)]
    out = []
    for i in range(5):
        suffix = [(13 * i + 3 * j + 1) % 97 + 2 for j in range(3 + i)]
        prompt = prefix[:prefix_len] + suffix if prefix_len \
            else prefix + suffix
        out.append((prompt, 4 + i % 3, prefix_len))
    return out


WORKLOADS["prefix0"] = _prefix_specs(0)
WORKLOADS["prefix11"] = _prefix_specs(11)


def _reqs(cls, name):
    return [cls(uid=i, prompt=list(p), max_new_tokens=n, prefix_len=pl)
            for i, (p, n, pl) in enumerate(WORKLOADS[name])]


def _streams(done):
    return {r.uid: list(r.generated) for r in done}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Thousands of tiny ops: one intra-op thread runs them as fast and
    leaves the cores to other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ===========================================================================
# the two packages on one weight set
# ===========================================================================

def _cfgs(arch):
    jcfg, cfg = jreduced(jget_cfg(arch)), reduced(get_model_config(arch))
    if cfg.n_experts:
        jcfg = dataclasses.replace(jcfg, capacity_factor=8.0)
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return jcfg, cfg


class _Pair:
    """JAX and port setups of one reduced family, f32, on one weight set.
    JAX engines are made once per geometry (their jitted programs compile
    once) and handed out reset; port engines are made fresh."""

    def __init__(self, arch):
        self.jcfg, self.cfg = _cfgs(arch)
        self.jrun = jget_run(arch, remat="none", compute_dtype="float32")
        self.jctx = JCtx(self.jrun, RULE_SETS[self.jrun.rules_name], None)
        self.jparams = jinit(jlm.model_decls(self.jcfg),
                             jax.random.PRNGKey(0))
        self.run = get_run_config(arch, remat="none",
                                  compute_dtype="float32")
        self.ctx = Ctx(self.run, "cpu")
        self.params = load_numpy_params(
            jax.tree.map(np.asarray, self.jparams), "cpu")
        self._jengines = {}
        self._unpreempted = {}

    def jax_engine(self, geom, **kw):
        key = (geom, tuple(sorted(kw.items())))
        eng = self._jengines.get(key)
        if eng is None:
            eng = self._jengines[key] = JServeEngine(
                self.jcfg, self.jrun, self.jctx, self.jparams,
                **GEOM[geom], **kw)
        # as made: no stream, no books, the default limit
        eng._sched = None
        eng._restore_q.clear()
        eng.finished = []
        eng.sync_count = 0
        eng._slot_limit = eng.batch_size
        return eng

    def port_engine(self, geom, **kw):
        return ServeEngine(self.cfg, self.run, self.ctx, self.params,
                           **GEOM[geom], **kw)

    def unpreempted(self, workload):
        """The JAX engine's streams of ``workload``, uninterrupted."""
        if workload not in self._unpreempted:
            self._unpreempted[workload] = _streams(
                self.jax_engine("g3").generate(_reqs(JRequest, workload)))
        return self._unpreempted[workload]


@pytest.fixture(scope="module")
def pairs():
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = _Pair(arch)
        return made[arch]

    return get


# ===========================================================================
# models layer: export / import against repro.models.lm
# ===========================================================================

def _filled(jcache):
    """``tests/test_migration.py::_filled_cache`` over any cache tree: every
    element distinct, so a misplaced row or lane shows as a value."""
    leaves, treedef = jax.tree.flatten(jcache)
    out = []
    for i, a in enumerate(leaves):
        if a.dtype == jnp.int32:                        # block tables
            out.append(a)
            continue
        vals = jnp.arange(a.size, dtype=jnp.float32) * 0.25 + 7 + 31 * i
        out.append(vals.reshape(a.shape).astype(a.dtype))
    return jax.tree.unflatten(treedef, out)


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _port_tree(jtree):
    if isinstance(jtree, dict):
        return {k: _port_tree(v) for k, v in jtree.items()}
    return _to_torch(jtree)


def _same(jtree, ttree, path=()):
    """Equal bit for bit: structure, shapes, dtypes and values."""
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), path
        for k in jtree:
            _same(jtree[k], ttree[k], path + (k,))
        return
    if isinstance(jtree, jlm.QuantizedLeaf):
        assert isinstance(ttree, lm.QuantizedLeaf), path
        assert jtree.dtype == ttree.dtype, path
        _same(jtree.q, ttree.q, path + ("q",))
        _same(jtree.scale, ttree.scale, path + ("scale",))
        return
    want = np.asarray(jtree)
    got = ttree.detach().cpu()
    assert tuple(got.shape) == want.shape, (path, got.shape, want.shape)
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name, path
    if want.dtype.name == "bfloat16":
        want, got = want.astype(np.float32), got.float()
    assert np.array_equal(got.numpy(), want), path


def _ctxs(arch, dtype):
    jrun = jget_run(arch, remat="none", compute_dtype=dtype)
    return JCtx(jrun, RULE_SETS[jrun.rules_name], None)


# (src batch, src slot, src max_seq, dst batch, dst slot, dst max_seq,
#  kv_len, row_start)
GEOMETRIES = {
    "3to2": (3, 1, 16, 2, 0, 24, 9, 0),
    "1to4": (1, 0, 16, 4, 3, 16, 0, 0),
    "full": (2, 1, 16, 3, 2, 40, 16, 0),
    "suffix": (2, 0, 16, 2, 1, 32, 13, 5),
}


# row_start > 0 needs a pure-rows schema (the others raise: a rejection case)
EXPORT_CASES = [(a, g) for a in FAMILIES for g in GEOMETRIES
                if a in ROWS_ONLY or not GEOMETRIES[g][7]]


@pytest.mark.parametrize("quantize", [False, True], ids=["raw", "int8"])
@pytest.mark.parametrize("arch,geom", EXPORT_CASES)
def test_export_and_import_equal_the_reference(arch, geom, quantize):
    """The payload of ``export_slot`` and the whole destination cache after
    ``import_slot`` equal ``repro``'s bit for bit (bf16 rows, f32 state),
    raw and int8; the cache is written in place and returned; the other
    slots keep their values; a second export gives the payload back."""
    bs, ss, ms, bd, sd, md, kv_len, row_start = GEOMETRIES[geom]
    jcfg, cfg = _cfgs(arch)
    jctx = _ctxs(arch, "bfloat16")
    jsrc = _filled(jlm.init_cache(jctx, jcfg, bs, ms))
    jpay = jlm.export_slot(jcfg, jsrc, ss, kv_len, quantize=quantize,
                           row_start=row_start)
    pay = lm.export_slot(cfg, _port_tree(jsrc), ss, kv_len,
                         quantize=quantize, row_start=row_start)
    _same(jax.device_get(jpay), pay)
    jdst = _filled(jlm.init_cache(jctx, jcfg, bd, md))
    jout = jlm.import_slot(jcfg, jdst, jpay, sd, row_offset=row_start)
    dst = _port_tree(jdst)
    out = lm.import_slot(cfg, dst, pay, sd, row_offset=row_start)
    assert out is dst
    _same(jout, dst)
    if not quantize:
        again = lm.export_slot(cfg, dst, sd, kv_len, row_start=row_start)
        _same(jax.device_get(jpay), again)


@pytest.mark.parametrize("quantize", [False, True], ids=["raw", "int8"])
@pytest.mark.parametrize("arch,row_start", [
    ("llama3.2-3b", 0), ("llama3.2-3b", 5), ("olmoe-1b-7b", 5),
    ("zamba2-1.2b", 0)])
def test_paged_export_and_import_equal_the_reference(arch, row_start,
                                                     quantize):
    """Through a scattered block list: the paged exporter's payload (raw
    and int8) equals ``repro``'s and the dense exporter's over the same
    rows; the paged importer's pools equal ``repro``'s and every block
    outside the list keeps its values."""
    jcfg, cfg = _cfgs(arch)
    jctx = _ctxs(arch, "bfloat16")
    bs, kv_len = 8, 13
    blocks = [5, 2]                       # logical block 0 -> pool block 5
    jpool = _filled(jlm.init_paged_cache(jctx, jcfg, 2, 16, bs, n_blocks=7))
    pool = _port_tree(jpool)
    jpay = jlm.export_slot_paged(jcfg, jpool, 1, blocks, bs, kv_len,
                                 row_start=row_start, quantize=quantize)
    pay = lm.export_slot_paged(cfg, pool, 1, blocks, bs, kv_len,
                               row_start=row_start, quantize=quantize)
    _same(jax.device_get(jpay), pay)
    # the dense exporter over the same rows gives the same payload
    key = "kv" if arch in ROWS_ONLY else "kv_shared"
    dense = {k: dict(v) for k, v in pool.items() if k != "block_tables"}
    for name, p in pool[key].items():
        rows = torch.cat([p[:, b] for b in blocks], dim=1)     # (L, 16, ..)
        dense[key][name] = rows[:, None].repeat(1, 2, 1, 1, 1)
    _same(jax.device_get(jpay), lm.export_slot(cfg, dense, 1, kv_len,
                                               quantize=quantize,
                                               row_start=row_start))
    # import into another pool through other blocks
    jdst = _filled(jlm.init_paged_cache(jctx, jcfg, 2, 16, bs, n_blocks=7))
    dst = _port_tree(jdst)
    before = {k: v.clone() for k, v in dst[key].items()}
    to = [3, 6]
    jout = jlm.import_slot_paged(jcfg, jdst, jpay, 0, to, bs,
                                 row_offset=row_start)
    out = lm.import_slot_paged(cfg, dst, pay, 0, to, bs,
                               row_offset=row_start)
    assert out is dst
    _same(jout, dst)
    for name, p in dst[key].items():
        other = [b for b in range(p.shape[1]) if b not in to]
        assert torch.equal(p[:, other], before[name][:, other])


@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-1.2b"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_slot_lane_sources_are_not_copies(arch, paged):
    """``lm.slot_lane`` (what the engine packs into its transfer buffer)
    copies nothing: dense rows and state leaves are views of the cache,
    paged rows ``PoolRows`` that gather only when read, into the ``out``
    given; read, they equal the exporter's payload bit for bit."""
    jcfg, cfg = _cfgs(arch)
    jctx = _ctxs(arch, "bfloat16")
    kv_len = 13
    row_start = 5 if arch in ROWS_ONLY else 0
    if paged:
        blocks, bs = [5, 2], 8
        cache = _port_tree(_filled(jlm.init_paged_cache(
            jctx, jcfg, 2, 16, bs, n_blocks=7)))
        want = lm.export_slot_paged(cfg, cache, 1, blocks, bs, kv_len,
                                    row_start=row_start)
        lane = lm.slot_lane(cfg, cache, 1, kv_len, row_start, blocks, bs)
    else:
        cache = _port_tree(_filled(jlm.init_cache(jctx, jcfg, 2, 16)))
        want = lm.export_slot(cfg, cache, 1, kv_len, row_start=row_start)
        lane = lm.slot_lane(cfg, cache, 1, kv_len, row_start)
    for key, leaves in lane.items():
        for k, a in leaves.items():
            if isinstance(a, lm.PoolRows):
                assert paged and tuple(a.shape) == tuple(want[key][k].shape)
                out = torch.empty(a.shape, dtype=a.dtype)
                assert a.read(out=out) is out
                got = out
            else:
                assert a.untyped_storage().data_ptr() \
                    == cache[key][k].untyped_storage().data_ptr()
                got = lm.read_lane_leaf(a)
                assert got.untyped_storage().data_ptr() \
                    != a.untyped_storage().data_ptr()
            assert torch.equal(got, want[key][k]), (key, k)


def _rejections():
    """(name, call(lm module, cfg, cache maker)) pairs; each call must
    raise ValueError with the same message in both packages."""
    def cache(pkg, cfg, ctx, batch=2, max_seq=16):
        return pkg.init_cache(ctx, cfg, batch, max_seq)

    def paged(pkg, cfg, ctx):
        return pkg.init_paged_cache(ctx, cfg, 2, 16, 8, n_blocks=4)

    def other_lane(pkg, cfg, ctx, olmoe):
        return pkg.export_slot(olmoe, cache(pkg, olmoe, ctx), 0, 8)

    return {
        "kv_len<0": ("llama3.2-3b", lambda pkg, cfg, ctx, _: pkg.export_slot(
            cfg, cache(pkg, cfg, ctx), 0, -1)),
        "kv_len>rows": ("llama3.2-3b", lambda pkg, cfg, ctx, _:
                        pkg.export_slot(cfg, cache(pkg, cfg, ctx), 0, 17)),
        "row_start>kv_len": ("llama3.2-3b", lambda pkg, cfg, ctx, _:
                             pkg.export_slot(cfg, cache(pkg, cfg, ctx), 0, 3,
                                             row_start=5)),
        "row_start-state": ("mamba2-370m", lambda pkg, cfg, ctx, _:
                            pkg.export_slot(cfg, cache(pkg, cfg, ctx), 0, 4,
                                            row_start=1)),
        "export-keys": ("zamba2-1.2b", lambda pkg, cfg, ctx, _:
                        pkg.export_slot(cfg, {"mamba": cache(pkg, cfg, ctx)[
                            "mamba"]}, 0, 4)),
        "import-rows": ("llama3.2-3b", lambda pkg, cfg, ctx, _:
                        pkg.import_slot(cfg, cache(pkg, cfg, ctx), pkg.export_slot(
                            cfg, cache(pkg, cfg, ctx, max_seq=32), 0, 24), 0)),
        "row_offset-state": ("zamba2-1.2b", lambda pkg, cfg, ctx, _:
                             pkg.import_slot(cfg, cache(pkg, cfg, ctx),
                                             pkg.export_slot(
                                                 cfg, cache(pkg, cfg, ctx),
                                                 0, 4), 0, row_offset=2)),
        "import-lane": ("llama3.2-3b", lambda pkg, cfg, ctx, olmoe:
                        pkg.import_slot(cfg, cache(pkg, cfg, ctx),
                                        other_lane(pkg, cfg, ctx, olmoe), 0)),
        "import-keys": ("llama3.2-3b", lambda pkg, cfg, ctx, _:
                        pkg.import_slot(cfg, cache(pkg, cfg, ctx),
                                        {"mamba": {}}, 0)),
        "paged-kv_len": ("llama3.2-3b", lambda pkg, cfg, ctx, _:
                         pkg.export_slot_paged(cfg, paged(pkg, cfg, ctx), 0,
                                               [1, 2], 8, 20)),
        "paged-row_start": ("llama3.2-3b", lambda pkg, cfg, ctx, _:
                            pkg.export_slot_paged(cfg, paged(pkg, cfg, ctx),
                                                  0, [1, 2], 8, 6,
                                                  row_start=7)),
        "paged-rows": ("llama3.2-3b", lambda pkg, cfg, ctx, _:
                       pkg.import_slot_paged(cfg, paged(pkg, cfg, ctx),
                                             pkg.export_slot(
                                                 cfg, cache(pkg, cfg, ctx),
                                                 0, 12), 0, [1, 2], 8,
                                             row_offset=8)),
        "paged-lane": ("llama3.2-3b", lambda pkg, cfg, ctx, olmoe:
                       pkg.import_slot_paged(cfg, paged(pkg, cfg, ctx),
                                             other_lane(pkg, cfg, ctx, olmoe),
                                             0, [1, 2], 8)),
    }


REJECTIONS = _rejections()


@pytest.mark.parametrize("case", list(REJECTIONS))
def test_rejections_raise_the_reference_errors(case):
    arch, call = REJECTIONS[case]
    jcfg, cfg = _cfgs(arch)
    jolmoe, olmoe = _cfgs("olmoe-1b-7b")
    with pytest.raises(ValueError) as want:
        call(jlm, jcfg, _ctxs(arch, "bfloat16"), jolmoe)
    run = get_run_config(arch, remat="none")
    with pytest.raises(ValueError) as got:
        call(lm, cfg, Ctx(run, "cpu"), olmoe)
    assert str(got.value) == str(want.value)


def test_a_rejected_import_writes_nothing():
    """Every check runs before the first write: an oversize payload leaves
    the destination cache as it was."""
    cfg = reduced(get_model_config("llama3.2-3b"))
    ctx = Ctx(get_run_config("llama3.2-3b", remat="none"), "cpu")
    dst = lm.init_cache(ctx, cfg, 2, 16)
    dst["kv"]["k"].fill_(3.0)
    pay = lm.export_slot(cfg, lm.init_cache(ctx, cfg, 1, 32), 0, 20)
    with pytest.raises(ValueError, match="holds only 16"):
        lm.import_slot(cfg, dst, pay, 1)
    assert bool((dst["kv"]["k"] == 3.0).all())


# ===========================================================================
# int8 payloads
# ===========================================================================

def _int8_inputs(case):
    rng = np.random.default_rng(7)
    if case == "normal":
        return rng.standard_normal((6, 40)).astype(np.float32) * 3.0
    if case == "scales":
        a = rng.standard_normal((3, 96)).astype(np.float32)
        return a * np.array([[0.01], [1.0], [300.0]], np.float32)
    if case == "zero-rows":
        a = rng.standard_normal((4, 16)).astype(np.float32)
        a[1] = 0.0
        a[3] = -0.0
        return a
    # .5 ties: absmax 127 gives scale 1.0, 254 gives 2.0
    return np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5],
                     [254.0, 1.0, 3.0, 5.0, -1.0, -3.0, 7.0, -253.0]],
                    np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["normal", "scales", "zero-rows", "ties"])
def test_int8_quantize_equals_the_reference(case, dtype):
    a = _int8_inputs(case)
    ja = jnp.asarray(a).astype(dtype)
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    jq, js = jref.int8_quantize_ref(ja)
    q, s = ref.int8_quantize(ta)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    jd = jref.int8_dequantize_ref(jq, js, ja.dtype)
    d = ref.int8_dequantize(q, s, ta.dtype)
    assert d.dtype == ta.dtype
    assert np.array_equal(d.float().numpy(), np.asarray(jd, np.float32))


def _int8_budget(a):
    """The reference's per-leaf error budget: row absmax / 254 (half a
    quantization step) plus the storage dtype's own rounding."""
    f = a.float().abs()
    rowmax = f.amax(dim=-1, keepdim=True) if f.numel() else f
    rel = 2.0 ** -8 if a.element_size() <= 2 else 2.0 ** -20
    return rowmax * (1.0 / 254.0 + rel) + 1e-8


@pytest.mark.parametrize("arch", FAMILIES)
def test_int8_payload_error_bytes_and_ratio_equal_the_reference(arch):
    """Every quantized leaf within the budget of its raw one; raw and
    quantized payload bytes and ``int8_payload_ratio`` equal ``repro``'s;
    the port's measured ratio within 1 % of the modelled one for rows
    leaves (state leaves are f32: the ratio there is 1/4 + 1/row)."""
    jcfg, cfg = _cfgs(arch)
    jctx = _ctxs(arch, "bfloat16")
    jcache = _filled(jlm.init_cache(jctx, jcfg, 2, 16))
    cache = _port_tree(jcache)
    raw = lm.export_slot(cfg, cache, 1, 8)
    quant = lm.export_slot(cfg, cache, 1, 8, quantize=True)
    assert lm.payload_is_quantized(quant)
    assert not lm.payload_is_quantized(raw)
    deq = lm.dequantize_payload(quant)
    for key in raw:
        for k, a in raw[key].items():
            b = deq[key][k]
            assert b.shape == a.shape and b.dtype == a.dtype, (key, k)
            assert bool(((a.float() - b.float()).abs()
                         <= _int8_budget(a)).all()), (arch, key, k)
    for q in (False, True):
        assert lm.slot_payload_bytes(quant if q else raw) \
            == jlm.slot_payload_bytes(jlm.export_slot(jcfg, jcache, 1, 8,
                                                      quantize=q))
    assert lm.int8_payload_ratio(cfg) == jlm.int8_payload_ratio(jcfg)
    if arch in ROWS_ONLY:
        ratio = lm.slot_payload_bytes(quant) / lm.slot_payload_bytes(raw)
        assert abs(ratio / lm.int8_payload_ratio(cfg) - 1) < 0.01


# ===========================================================================
# engine scenarios: the JAX engine and the port's, step by step
# ===========================================================================

def _note(eng, what, log):
    log.append((what, eng.in_flight_tokens, eng.queue_depth, eng.pending,
                eng.sync_count, eng.active_slots))


def _drive(eng, log, what="step"):
    while eng.pending:
        eng.step()
        _note(eng, what, log)


def _view(snaps):
    """What a snapshot carries, comparable across the packages."""
    return [(s.request.uid, s.warm, s.kv_len, s.rem, s.cur, s.prefix_len,
             s.payload_bytes, list(s.request.generated)) for s in snaps]


def _drain_same(mk, R, log):
    eng = mk("g3")
    eng.start(_reqs(R, "mixed"))
    eng.step()
    _note(eng, "step", log)
    snaps = eng.drain()
    _note(eng, "drain", log)
    log.append(_view(snaps))
    assert not eng.pending and any(s.warm for s in snaps)
    eng.restore(snaps)
    _note(eng, "restore", log)
    _drive(eng, log)
    return _streams(eng.finished)


def _drain_cross(mk, R, log):
    src = mk("g3")
    src.start(_reqs(R, "mixed"))
    src.step()
    snaps = src.drain()
    log.append(_view(snaps))
    dst = mk("g2")
    dst.restore(snaps)
    _note(dst, "restore", log)
    _drive(dst, log)
    return _streams(src.finished + dst.finished)


def _partial(mk, R, log):
    eng = mk("g3")
    eng.start(_reqs(R, "partial"))
    eng.step()
    eng.set_slot_limit(2)
    victims = eng.select_victims(1)
    log.append(("victims", victims, eng.select_victims(3)))
    snaps = eng.drain(slots=victims)
    _note(eng, "partial", log)
    log.append(_view(snaps))
    assert len(snaps) == 1 and snaps[0].warm and eng.pending
    _drive(eng, log)
    survivors = _streams(eng.finished)
    assert len(survivors) == 2 and snaps[0].request.uid not in survivors
    dst = mk("g2")
    dst.restore(snaps)
    _drive(dst, log, "restored")
    return {**survivors, **_streams(dst.finished)}


def _drain_every_cut(mk, R, log):
    out = {}
    for cut in range(1, 4):
        src = mk("g3")
        src.start(_reqs(R, "long"))
        for _ in range(cut):
            src.step()
        snaps = src.drain()
        log.append(_view(snaps))
        dst = mk("g2")
        dst.restore(snaps)
        _drive(dst, log)
        out[cut] = _streams(src.finished + dst.finished)
        assert out[cut] == out[1]
    return out[1]


def _cold(mk, R, log):
    eng = mk("g1")
    assert eng.drain() == [] and eng.checkpoint() == []    # never started
    _note(eng, "idle", log)
    eng.start(_reqs(R, "cold"))            # 5 requests, 1 slot: 4 queued
    _note(eng, "start", log)
    eng.step()
    _note(eng, "step", log)
    snaps = eng.drain()
    log.append(_view(snaps))
    assert [s.warm for s in snaps] == [True] + [False] * 4
    assert all(s.payload_bytes == 0 for s in snaps[1:])
    dst = mk("g3")
    dst.restore(snaps)
    _note(dst, "restore", log)
    _drive(dst, log)
    return _streams(eng.finished + dst.finished)


def _restored_first(mk, R, log):
    src = mk("g1")
    src.start(_reqs(R, "cold")[:1])
    src.step()
    snaps = src.drain()
    dst = mk("g3")
    dst.set_slot_limit(1)
    dst.start([R(uid=99, prompt=[4, 5], max_new_tokens=2)])
    dst.restore(snaps)
    _note(dst, "restore", log)
    _drive(dst, log)
    log.append([r.uid for r in dst.finished])
    assert [r.uid for r in dst.finished] == [0, 99]
    return {u: s for u, s in _streams(dst.finished).items() if u != 99}


def _checkpoint(mk, R, log):
    eng = mk("g3")
    eng.start(_reqs(R, "mixed"))
    eng.step()
    ck = eng.checkpoint()
    _note(eng, "checkpoint", log)
    frozen = _view(ck)
    log.append(frozen)
    _drive(eng, log)
    live = _streams(eng.finished)
    assert _view(ck) == frozen             # later decode did not reach it
    eng.start([])
    eng.restore(ck)
    _note(eng, "restore", log)
    _drive(eng, log)
    replay = _streams(eng.finished)
    assert replay == {u: live[u] for u in replay}
    assert set(replay) == {s.request.uid for s in ck}
    return live


def _abandon(mk, R, log):
    eng = mk("g3")
    eng.start(_reqs(R, "mixed"))
    eng.step()
    eng.abandon()
    _note(eng, "abandon", log)
    assert not eng.pending and eng.queue_depth == 0 \
        and eng.in_flight_tokens == 0 and eng.drain() == []
    eng.start(_reqs(R, "mixed"))
    _drive(eng, log)
    return _streams(eng.finished)


def _slot_limit(mk, R, log):
    eng = mk("g3")
    eng.set_slot_limit(1)
    eng.start(_reqs(R, "mixed")[:3])
    eng.step()
    _note(eng, "limit 1", log)
    assert eng.active_slots <= 1 and eng.slot_limit == 1
    for bad in (0, 4):
        with pytest.raises(ValueError, match="slot limit must be in"):
            eng.set_slot_limit(bad)
    eng.set_slot_limit(3)
    _drive(eng, log)
    first = _streams(eng.finished)
    # the limit survives a whole drain and its restore
    eng.start(_reqs(R, "mixed"))
    eng.step()
    eng.set_slot_limit(2)
    snaps = eng.drain()
    eng.restore(snaps)
    _note(eng, "restore", log)
    while eng.pending:
        eng.step()
        _note(eng, "step", log)
        assert eng.active_slots <= 2
    assert eng.slot_limit == 2
    assert _streams(eng.finished) == {**first, **_streams(eng.finished)}
    return _streams(eng.finished)


SCENARIOS = {"drain-same": (_drain_same, "mixed"),
             "drain-cross": (_drain_cross, "mixed"),
             "partial": (_partial, "partial"),
             "every-cut": (_drain_every_cut, "long"),
             "cold": (_cold, "cold"),
             "restored-first": (_restored_first, "cold"),
             "checkpoint": (_checkpoint, "mixed"),
             "abandon": (_abandon, "mixed"),
             "slot-limit": (_slot_limit, "mixed")}
# every family runs the drains; llama runs every scenario
ENGINE_CASES = ([(a, s) for a in FAMILIES
                 for s in ("drain-same", "drain-cross", "partial")]
                + [("llama3.2-3b", s) for s in SCENARIOS
                   if s not in ("drain-same", "drain-cross", "partial")])


@pytest.mark.parametrize("arch,scenario", ENGINE_CASES)
def test_engine_scenario_equals_the_jax_engine(pairs, arch, scenario):
    """The scenario on the JAX engine and on the port's: the same streams
    (equal to the JAX engine's unpreempted ones), the same snapshots and
    victims, and at every step the same ``in_flight_tokens``,
    ``queue_depth``, ``pending``, ``sync_count`` and ``active_slots``."""
    pair = pairs(arch)
    fn, workload = SCENARIOS[scenario]
    jlog, log = [], []
    want = fn(pair.jax_engine, JRequest, jlog)
    got = fn(pair.port_engine, Request, log)
    assert log == jlog
    assert got == want
    gold = pair.unpreempted(workload)
    assert got == {u: gold[u] for u in got}


def test_restore_rejects_what_does_not_fit(pairs):
    """An oversize snapshot raises the reference's message before any
    device work (dense ``max_seq``, paged pool), as does a cold one."""
    pair = pairs("llama3.2-3b")
    cases = [("g1", dict(max_seq=16), 21, 0, True),
             ("paged", dict(n_blocks=2), 10, 8, True),
             ("g1", dict(max_seq=16), 0, 0, False)]
    for geom, over, kv_len, rem, warm in cases:
        msgs = []
        for make, cls, snap_cls, kw in (
                (JServeEngine, JRequest, JSlotSnapshot,
                 (pair.jcfg, pair.jrun, pair.jctx, pair.jparams)),
                (ServeEngine, Request, SlotSnapshot,
                 (pair.cfg, pair.run, pair.ctx, pair.params))):
            eng = make(*kw, **{**GEOM[geom], **over})
            req = cls(uid=0, prompt=[1] * 12, max_new_tokens=8)
            snap = snap_cls(request=req, rem=rem or 8, kv_len=kv_len, cur=1,
                            payload={} if warm else None)
            with pytest.raises(ValueError) as e:
                eng.restore([snap])
            msgs.append(str(e.value))
            assert not eng.pending and eng.queue_depth == 0
        assert msgs[0] == msgs[1]


def test_one_sync_per_chunk_and_two_per_export(pairs):
    """A drain adds the reference's two host syncs (the cursor vectors,
    then every payload in one transfer) and the fetch double sees each."""
    pair = pairs("llama3.2-3b")
    eng = pair.port_engine("g3")
    fetched = []
    real = eng._fetch
    eng._fetch = lambda x: (fetched.append(tuple(x.shape)), real(x))[1]
    eng.start(_reqs(Request, "mixed"))
    eng.step()
    assert fetched == [(3, 4)] and eng.sync_count == 1
    snaps = eng.drain()
    assert eng.sync_count == 3 and len(fetched) == 3
    assert fetched[1] == (3, 3)                  # cur, index, rem stacked
    assert len(fetched[2]) == 1                   # one flat byte buffer
    assert all(a.device.type == "cpu" for s in snaps if s.warm
               for leaves in s.payload.values() for a in leaves.values())


def test_payloads_are_host_copies(pairs):
    """A checkpoint's payload is no view of the cache: the stream decoding
    on after it leaves the payload as it was."""
    pair = pairs("llama3.2-3b")
    eng = pair.port_engine("g3")
    eng.start(_reqs(Request, "mixed"))
    eng.step()
    ck = eng.checkpoint()
    warm = [s for s in ck if s.warm]
    before = [{k: a.clone() for k, a in s.payload["kv"].items()}
              for s in warm]
    while eng.pending:
        eng.step()
    for s, b in zip(warm, before):
        for k, a in s.payload["kv"].items():
            assert torch.equal(a, b[k])
            assert a.untyped_storage().data_ptr() \
                != eng._cache["kv"][k].untyped_storage().data_ptr()


# ===========================================================================
# paged snapshots
# ===========================================================================

PAGED_CASES = [("paged", "g3", "prefix0"), ("paged", "paged", "prefix0"),
               ("shared", "shared", "prefix11"), ("shared", "g3", "prefix11"),
               ("g3", "paged", "prefix0"), ("g3", "shared", "prefix11")]


@pytest.mark.parametrize("src,dst,workload", PAGED_CASES)
def test_paged_and_dense_restores_equal_the_jax_streams(pairs, src, dst,
                                                        workload):
    """A mid-decode drain from a dense, paged or prefix-sharing engine
    restores into a dense, paged or prefix-sharing one: the JAX dense
    engine's streams (``tests/test_paging.py:249-266``); a
    prefix-trimmed payload rebuilds its prefix (registry hit or
    re-prefill) and no block leaks."""
    pair = pairs("llama3.2-3b")
    gold = pair.unpreempted(workload)
    a = pair.port_engine(src)
    a.start(_reqs(Request, workload))
    a.step()
    snaps = a.drain()
    assert any(s.warm for s in snaps)
    if src == "shared":
        assert all(s.prefix_len == 11 for s in snaps if s.warm)
    b = pair.port_engine(dst)
    b.restore(snaps)
    while b.pending:
        b.step()
    assert _streams(a.finished + b.finished) == gold
    if b.paged:
        held = b._alloc.blocks_for(11) if b.prefix_sharing else 0
        assert b._alloc.used_blocks == held


def test_prefix_trimmed_snapshots_ship_fewer_bytes(pairs):
    """``tests/test_paging.py:269-280``: a prefix-sharing engine's warm
    snapshots carry only their private rows, fewer bytes than a dense
    engine's, and the same snapshots as the JAX engine's."""
    pair = pairs("llama3.2-3b")
    views = {}
    for geom, workload in (("g3", "prefix0"), ("shared", "prefix11")):
        for mk, cls in ((pair.jax_engine, JRequest),
                        (pair.port_engine, Request)):
            eng = mk(geom)
            eng.start(_reqs(cls, workload))
            eng.step()
            views.setdefault(geom, []).append(_view(eng.drain()))
    for geom, (jv, tv) in views.items():
        assert tv == jv, geom
    dense = sum(v[6] for v in views["g3"][1])
    shared = sum(v[6] for v in views["shared"][1])
    assert 0 < shared < dense


# ===========================================================================
# int8 snapshots end to end
# ===========================================================================

def _edit_distance(a, b):
    m, n = len(a), len(b)
    dp = list(range(n + 1))
    for i in range(1, m + 1):
        prev, dp[0] = dp[0], i
        for j in range(1, n + 1):
            cur = dp[j]
            dp[j] = min(dp[j] + 1, dp[j - 1] + 1,
                        prev + (a[i - 1] != b[j - 1]))
            prev = cur
    return dp[n]


@pytest.mark.parametrize("cut", [1, 2])
def test_int8_restore_divergence_within_the_reference_bound(pairs, cut):
    """``test_int8_restore_decode_divergence_bounded``: streams restored
    from int8 snapshots keep their token counts and diverge from the JAX
    engine's unpreempted streams by at most 25 % of the tokens (edit
    distance); every warm payload is int8 at rest and its bytes within 1 %
    of the modelled ratio."""
    pair = pairs("llama3.2-3b")
    gold = pair.unpreempted("int8")
    src = pair.port_engine("g3", snapshot_int8=True)
    src.start(_reqs(Request, "int8"))
    for _ in range(cut):
        src.step()
    snaps = src.drain()
    warm = [s for s in snaps if s.warm]
    assert warm and all(lm.payload_is_quantized(s.payload) for s in warm)
    dst = pair.port_engine("g3")
    dst.restore(snaps)
    while dst.pending:
        dst.step()
    got = _streams(src.finished + dst.finished)
    assert {u: len(g) for u, g in got.items()} \
        == {u: len(g) for u, g in gold.items()}
    total = sum(len(g) for g in gold.values())
    assert sum(_edit_distance(gold[u], got[u]) for u in gold) \
        <= 0.25 * total


# ===========================================================================
# the graphed engine: no new capture, no storage moved
# ===========================================================================

class _ReplayBody:
    """Stands in for a CUDA graph on the CPU: a replay runs the captured
    body again on the tensors it was captured with."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


def _capture_on_cpu(body, device, share=None):
    body()
    return graphs.ChunkGraph(body, None,
                             record=lambda b, stream: _ReplayBody(b))


def _storage(eng):
    """Every device tensor a graph reads or writes, by name."""
    out = {"cur": eng._cur, "index": eng._index, "rem": eng._rem,
           "done": eng._done, "out": eng._out, "offset": eng._offset,
           "logits": eng._logits}
    for name, tree in (("cache", eng._cache), ("lane", eng._lane)):
        for key, leaves in tree.items():
            if key == "block_tables":
                out[f"{name}.{key}"] = leaves
            else:
                out.update({f"{name}.{key}.{k}": a
                            for k, a in leaves.items()})
    out.update({f"tokens{n}": t for n, t in eng._lane_tokens.items()})
    return {k: t.data_ptr() for k, t in out.items()}


def _cycle(eng, R, workload):
    """Drain mid-decode and restore into the same engine, then shed one
    slot (if one is still decoding) and restore it there again once the
    survivors are done.  Returns the streams and the exports made."""
    eng.start(_reqs(R, workload))
    eng.step()
    whole = eng.drain()
    eng.restore(whole)
    eng.step()
    snaps = eng.drain(slots=eng.select_victims(1))
    while eng.pending:
        eng.step()
    eng.restore(snaps)
    while eng.pending:
        eng.step()
    return _streams(eng.finished), sum(any(s.warm for s in x)
                                       for x in (whole, snaps))


GRAPHED = [("llama3.2-3b", "g3", "mixed"), ("llama3.2-3b", "paged", "mixed"),
           ("olmoe-1b-7b", "g3", "mixed"), ("mamba2-370m", "g3", "mixed"),
           ("zamba2-1.2b", "paged", "mixed"),
           ("llama3.2-3b", "shared", "prefix11")]


@pytest.mark.parametrize("arch,geom,workload", GRAPHED)
def test_graphed_cycle_keeps_graphs_and_storage(pairs, arch, geom, workload,
                                                monkeypatch):
    """On a graphed engine (stand-in graphs), after a warm-up that
    captures the decode chunk and every prefill size: whole and partial
    drain/restore cycles capture nothing more, keep every address the
    graphs hold, and give the eager engine's streams, which equal the JAX
    engine's unpreempted ones.  The prefix case re-prefills the trimmed
    prefix in the prefill lane."""
    pair = pairs(arch)
    eager, _ = _cycle(pair.port_engine(geom, prefill_chunk=16), Request,
                      workload)
    monkeypatch.setattr(graphs, "capture", _capture_on_cpu)
    eng = pair.port_engine(geom, prefill_chunk=16)
    eng.eager = False
    eng.generate([Request(uid=-1, prompt=list(range(2, 33)),
                          max_new_tokens=1)])         # 31 = 16+8+4+2+1
    graph, prefill = eng.graph, dict(eng.prefill_graphs)
    assert graph is not None and sorted(prefill) == [1, 2, 4, 8, 16]
    ptrs = _storage(eng)
    got, exports = _cycle(eng, Request, workload)
    assert got == eager
    gold = pair.unpreempted(workload)
    assert got == {u: gold[u] for u in got}
    assert eng.graph is graph and eng.prefill_graphs == prefill
    assert _storage(eng) == ptrs
    # every decode chunk but the warm-up's first is a replay; each export
    # adds two syncs
    assert exports >= 1
    assert graph.replays == eng.sync_count - 1 - 2 * exports
