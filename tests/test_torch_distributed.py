"""The port's distributed layer on the CPU: four gloo ranks on a (2, 2)
(data x model) mesh, held against the port's one-device runs and against
the JAX package's sharded paths (pjit's train step under each of the four
rule sets, the head-parallel Mamba-2 stack under ``default`` and ``fsdp``
and the zamba2 hybrid under ``default`` among them, the ``shard_map``
sequence-sharded decode under ``default`` and ``seqparallel``, the
Mamba-2 families' decode steps, expert parallelism, ``compressed_psum``)
on the same numbers; the serving step functions under a mesh (the
whole-batch prefill, prefill chunks across the cache slices' edge,
per-slot decode with a done lane, the paged pool) against one device and
JAX's own step functions under each arch's serve rules, and the eager
``ServeEngine`` on every rank against one device's; and the same ranks as
a (1, 4) mesh, where reduced llama's kv heads are cut in storage.

The JAX oracle runs once for the module, in a subprocess with eight
forced host devices and an Auto-axis ``jax.sharding.Mesh`` of four of them
(``tests/_jax_mesh_oracle.py``), while the port's ranks run
(``tests/_dist_cases.py``).  Reduced configs, float32 compute.  Every
spawn and the oracle have a timeout."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _dist_cases as DC  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.runtime.supervisor import plan_mesh_shape  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ORACLE_TIMEOUT_S = 300
SPAWN_TIMEOUT_S = 240

# float32 tolerances: the loss relative, gradients against each leaf's
# largest entry, decode logits and MoE outputs absolute against their
# largest entry
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
OUT_TOL = 1e-5
# the parameters after one AdamW step: the update is about lr * sign(g)
# per entry (m / sqrt(v) = g / |g| at the first step), so an entry whose
# gradient is near zero flips its sign under another order of summation
# and moves by up to 2 lr; every other entry agrees closely
PARAM_TOL_LR = 2.0
# the launcher runs reduced olmoe in its own bf16 compute, where the mesh
# sums each product's halves in another order (7e-4 of the loss without
# drops), and expert parallelism counts each rank's tokens for its capacity,
# as the reference's ``shard_map`` does, so it drops other tokens than one
# device (2.7e-3 in f32).  Seen: 5.3e-3 and 3.5e-3 at the two steps.  The
# rank cases above hold the same paths in f32 to 1e-5.
LAUNCH_ARCH, LAUNCH_LOSS_RTOL = "olmoe-1b-7b", 1e-2


class _Oracle:
    def __init__(self, tmp):
        self.out = tmp / "jax_out.npz"
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
                   JAX_PLATFORMS="cpu")
        self.proc = subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "_jax_mesh_oracle.py"),
             str(tmp / "inputs.npz"), str(self.out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(REPO))
        self._result = None

    def result(self) -> dict:
        if self._result is None:
            try:
                log, _ = self.proc.communicate(timeout=ORACLE_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                raise
            assert self.proc.returncode == 0, log[-3000:]
            self._result = dict(np.load(self.out))
        return self._result


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    return tmp, DC.make_inputs(tmp / "inputs.npz")


@pytest.fixture(scope="module")
def oracle(inputs):
    o = _Oracle(inputs[0])
    yield o
    if o.proc.poll() is None:
        o.proc.kill()


@pytest.fixture(scope="module")
def ranks(inputs, oracle):
    """The four ranks' results (the oracle runs meanwhile)."""
    return spawn_ranks(DC.rank_cases, 4, "gloo", args=(inputs[1],),
                       timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def single(inputs):
    torch.set_num_threads(2)
    return DC.one_device(inputs[1])


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * max(scale, 1e-30), f"{what}: {err} > {tol} x {scale}"


def test_mesh_coordinates_are_row_major(ranks):
    assert [r["coords"] for r in ranks] == [
        {"data": d, "model": m} for d in range(2) for m in range(2)]


def test_shard_then_gather_round_trips_bit_for_bit(ranks):
    assert all(r["roundtrip_equal"] for r in ranks)


def test_train_step_loss_matches_one_device_and_jax(ranks, single, oracle):
    jax_out = oracle.result()
    for r in ranks:
        assert abs(r["train/loss"] - single["train/loss"]) \
            <= LOSS_RTOL * abs(single["train/loss"])
        assert abs(r["train/loss"] - float(jax_out["train/loss"])) \
            <= LOSS_RTOL * abs(single["train/loss"])
        assert abs(r["train/grad_norm"] - single["train/grad_norm"]) \
            <= LOSS_RTOL * single["train/grad_norm"]
        assert abs(r["train/grad_norm"] - float(jax_out["train/grad_norm"])) \
            <= LOSS_RTOL * single["train/grad_norm"]


def test_train_step_gradients_match_one_device_and_jax(ranks, single,
                                                       oracle):
    jax_out = oracle.result()
    want = dict(leaves_with_paths(single["train/grads"]))
    got = dict(leaves_with_paths(ranks[0]["train/grads"]))
    assert set(got) == set(want)
    for path, g in got.items():
        name = "/".join(path)
        _close(g, want[path], GRAD_TOL, f"grad {name} vs one device")
        _close(g, jax_out[f"train/grads/{name}"], GRAD_TOL,
               f"grad {name} vs JAX")


def test_train_step_parameters_match_one_device_and_jax(ranks, single,
                                                        oracle):
    jax_out = oracle.result()
    cfg, run = DC.train_cfg()
    lr = run.learning_rate
    want = dict(leaves_with_paths(single["train/new_params"]))
    flipped = 0
    for path, p in leaves_with_paths(ranks[0]["train/new_params"]):
        name = "/".join(path)
        for ref, what in ((want[path], "one device"),
                          (jax_out[f"train/new_params/{name}"], "JAX")):
            diff = np.abs(_np(p) - _np(ref))
            assert diff.max() <= PARAM_TOL_LR * lr * 1.001, (name, what)
            flipped += int((diff > 1e-3 * lr).sum())
    total = sum(p.numel() for p in DC.leaves(single["train/new_params"]))
    assert flipped <= 1e-3 * total, f"{flipped} of {total} entries moved"


def test_int8_compressed_step_matches_one_device(ranks, single):
    """grad_compression="int8" on the mesh quantizes the summed gradients
    with each leaf's global scale, as one device quantizes its own: the
    parameters after the step agree but where a rounding at the half-step
    moves an entry between 0 and one step (up to lr apart)."""
    lr = DC.train_cfg()[1].learning_rate
    for r in ranks:
        assert abs(r["int8/loss"] - single["int8/loss"]) \
            <= LOSS_RTOL * abs(single["int8/loss"])
    want = dict(leaves_with_paths(single["int8/new_params"]))
    apart, total = 0, 0
    for path, p in leaves_with_paths(ranks[0]["int8/new_params"]):
        diff = np.abs(_np(p) - _np(want[path]))
        assert diff.max() <= PARAM_TOL_LR * lr * 1.001, path
        apart += int((diff > 1e-3 * lr).sum())
        total += diff.size
    assert apart <= 1e-3 * total, f"{apart} of {total} entries moved"


@pytest.mark.parametrize("name", list(DC.DECODE))
def test_seqsharded_decode_matches_unsharded_and_jax(ranks, single, oracle,
                                                     name):
    jax_out = oracle.result()
    for r in ranks:
        n = single[f"decode/{name}/logits_0"].shape[0] // 2
        d = r["coords"]["data"]
        rows = slice(d * n, (d + 1) * n)
        for i in range(2):
            got = r[f"decode/{name}/logits_{i}"]
            _close(got, single[f"decode/{name}/logits_{i}"][rows], OUT_TOL,
                   f"{name} step {i} vs unsharded")
            _close(got, jax_out[f"decode/{name}/logits1_{i}"][rows], OUT_TOL,
                   f"{name} step {i} vs JAX sharded")
            _close(single[f"decode/{name}/logits_{i}"],
                   jax_out[f"decode/{name}/logits0_{i}"], OUT_TOL,
                   f"{name} step {i} unsharded vs JAX")


def test_seqsharded_decode_window_spans_both_slices():
    """The per-rank kv_len rule with the global window, at gemma2's
    reduced window 8: a step at 33 over slices of 32 rows sees rows
    26..33, 26..31 on rank 0 (kv_len 34 reads its 32 rows, the query at
    local position 33) and 32..33 on rank 1 (kv_len 2); rank 0 sees
    nothing of a step at 45 (its window starts at 38), rank 1 nothing of
    one at 10; and a 16-row chunk at 24 puts its queries at the slices'
    local positions.  Combined by their log-sum-exp, the slices give the
    unsliced attention."""
    from repro_torch.kernels import ref
    from repro_torch.models.layers import seq_shard_kv_len
    assert seq_shard_kv_len(33, 0, 32) == 34
    assert seq_shard_kv_len(33, 1, 32) == 2
    assert seq_shard_kv_len(10, 1, 32) == 0
    assert seq_shard_kv_len(24, 1, 32, 16) == 8
    assert seq_shard_kv_len(torch.tensor([40, 64, 3]), 1, 32).tolist() == [
        9, 33, 0]
    g = torch.Generator().manual_seed(0)
    k, v = (torch.randn((1, 64, 2, 16), generator=g) for _ in range(2))
    for index, S in ((33, 1), (45, 1), (10, 1), (24, 16)):
        q = torch.randn((1, S, 4, 16), generator=g)
        want = ref.decode_attention_ref(q, k, v, torch.tensor([index + S]),
                                        local_window=8)
        parts = [ref.decode_attention_lse_ref(
            q, k[:, r * 32:(r + 1) * 32], v[:, r * 32:(r + 1) * 32],
            torch.tensor([seq_shard_kv_len(index, r, 32, S)]),
            local_window=8) for r in range(2)]
        m = torch.maximum(parts[0][1], parts[1][1])
        w = [torch.exp(lse - m).permute(0, 2, 1)[..., None]
             for _, lse in parts]
        got = sum(o * wi for (o, _), wi in zip(parts, w)) / sum(w)
        assert (got - want).abs().max() < 1e-6, (index, S)


def test_cache_update_row_clip_plain_version():
    """The write's row-level clip (a rank's slice of a cache cut by
    sequence): row j of a slot lands iff 0 <= index + j < S, where the
    whole-slot rule drops a slot whose rows cross either end.  A chunk
    straddling two slices leaves each its rows."""
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(1)
    k_new, v_new = (torch.randn((4, 8, 2, 16), generator=g) for _ in range(2))
    index = torch.tensor([-5, 3, 12, 16], dtype=torch.int32)
    for clip in (False, True):
        kc, vc = torch.zeros((4, 16, 2, 16)), torch.zeros((4, 16, 2, 16))
        ref.kv_cache_update_ref(kc, vc, k_new, v_new, index, clip_rows=clip)
        for b, i in enumerate(index.tolist()):
            for j in range(8):
                lands = 0 <= i + j < 16 if clip else 0 <= i and i + 8 <= 16
                if lands:
                    assert torch.equal(kc[b, i + j], k_new[b, j])
                    assert torch.equal(vc[b, i + j], v_new[b, j])
            kept = {i + j for j in range(8)} if (clip or 0 <= i <= 8) \
                else set()
            for row in set(range(16)) - kept:
                assert not kc[b, row].any() and not vc[b, row].any()
    # the two 16-row slices of a 32-row cache take a 16-row chunk at 8
    # between them: rows 8..15 on the first, 16..23 on the second
    full, halves = torch.zeros((1, 32, 2, 16)), torch.zeros((2, 1, 16, 2, 16))
    kn = torch.randn((1, 16, 2, 16), generator=g)
    ref.kv_cache_update_ref(full, full.clone(), kn, kn,
                            torch.tensor([8], dtype=torch.int32))
    for r in range(2):
        ref.kv_cache_update_ref(halves[r], halves[r].clone(), kn, kn,
                                torch.tensor([8 - 16 * r], dtype=torch.int32),
                                clip_rows=True)
    assert torch.equal(torch.cat([halves[0], halves[1]], dim=1), full)


def _rank_ctx(run, rules, coords):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.layers import Ctx
    from repro_torch.sharding import RULE_SETS
    rank = coords["data"] * 2 + coords["model"]
    return Ctx(run, "cpu", RULE_SETS[rules], Mesh(DC.MESH, ("data", "model"),
                                                  rank=rank))


def _flat_cache(flat):
    """The cache dict of a flat ``<key>/<leaf>`` map."""
    out: dict = {}
    for k, a in flat.items():
        key, leaf = k.split("/")
        out.setdefault(key, {})[leaf] = torch.from_numpy(np.array(a))
    return out


def _rank_cache(got, full, name, rules, coords, what):
    """This rank's cache ``got`` (flat) against ``lm.shard_cache`` of the
    unsharded ``full`` (flat) on its coordinates."""
    from repro_torch.models import lm
    cfg, run = DC.decode_cfg(name)
    want = lm.shard_cache(_rank_ctx(run, rules, coords), cfg,
                          _flat_cache(full))
    for key, leaves in want.items():
        for k, w in leaves.items():
            _close(got[f"{key}/{k}"], w, OUT_TOL,
                   f"{name} {rules} {what} {key}/{k} {coords}")


def _jax_flat(jax_out, prefix):
    return {k[len(prefix) + 1:]: a for k, a in jax_out.items()
            if k.startswith(prefix + "/")}


@pytest.mark.parametrize("case", [f"{n}/{r}" for n, r in DC.SERVE_CASES])
def test_serve_steps_under_a_mesh_match_one_device_and_jax(ranks, single,
                                                           oracle, case):
    """Item 14b (d): the whole-batch prefill of a 40-row prompt over
    slices of 32 rows (last logits, every rank's cache), two per-slot
    decode steps at offsets on each side of the slices' edge with a done
    lane, prefill chunks of 24 and 16 rows at 0 and 24 (the second
    straddling the edge; logits and the cache) and, for llama, the paged
    pool (chunks, a per-slot decode step, the pool whole and equal on
    every rank; against JAX under llama's serve rules),
    on every rank under the arch's serve rules against the port's one
    device and JAX's own step functions on its mesh.  olmoe's prefill is
    expert parallelism (each rank's tokens count for its capacity), so it
    and the steps after it are held against JAX alone."""
    name, rules = case.split("/")
    jax_out = oracle.result()
    one = single[f"serve/{name}"]
    jx = _jax_flat(jax_out, f"serve/{case}")
    ep = name == "olmoe"
    for r in ranks:
        got = r[f"serve/{case}"]
        d, coords = r["coords"]["data"], r["coords"]
        n = DC.SERVE_B // 2
        rows = slice(d * n, (d + 1) * n)
        wants = [("JAX", jx)] + ([] if ep else [("one device", one)])
        for what, want in wants:
            _close(got["prefill"], want["prefill"][rows], OUT_TOL,
                   f"{case} prefill vs {what}")
            for j in range(len(DC.SERVE_INDEX)):
                _close(got[f"decode{j}"], want[f"decode{j}"][rows], OUT_TOL,
                       f"{case} decode {j} vs {what}")
        _rank_cache(got["cache"], _jax_flat(jx, "cache"), name, rules,
                    coords, "prefill cache vs JAX")
        if not ep:
            _rank_cache(got["cache"], one["cache"], name, rules, coords,
                        "prefill cache vs one device")
        for what, want in (("JAX", jx), ("one device", one)):
            for j in range(len(DC.SERVE_CHUNKS)):
                _close(got[f"chunk{j}"], want[f"chunk{j}"], OUT_TOL,
                       f"{case} chunk {j} vs {what}")
        _rank_cache(got["chunk_cache"], _jax_flat(jx, "chunk_cache"), name,
                    rules, coords, "chunk cache vs JAX")
        _rank_cache(got["chunk_cache"], one["chunk_cache"], name, rules,
                    coords, "chunk cache vs one device")
        if name != "llama":
            continue
        # the paged pool against JAX under llama's serve rules
        pools = [("one device", one)] + ([("JAX", jx)]
                                         if rules == "seqparallel" else [])
        for what, want in pools:
            for j in range(3):
                _close(got[f"paged{j}"], want[f"paged{j}"], OUT_TOL,
                       f"{case} paged chunk {j} vs {what}")
            _close(got["paged_decode"], want["paged_decode"][rows], OUT_TOL,
                   f"{case} paged decode vs {what}")
            for k in ("kv/k", "kv/v"):
                _close(got["pool"][k], _jax_flat(want, "pool")[k]
                       if what == "JAX" else want["pool"][k], OUT_TOL,
                       f"{case} {k} vs {what}")
        for k in ("kv/k", "kv/v"):
            assert np.array_equal(got["pool"][k],
                                  ranks[0][f"serve/{case}"]["pool"][k])


@pytest.mark.parametrize("case", [f"{n}/{r}" for n, r in DC.SERVE_FSDP])
def test_serve_steps_under_fsdp_match_one_device(ranks, single, case):
    """The same steps of reduced llama under ``fsdp`` (the Megatron
    program with its weights gathered over ``data`` at use) and
    ``fsdp_seqparallel`` against the port's one device."""
    name, rules = case.split("/")
    one = single[f"serve/{name}"]
    for r in ranks:
        got, coords = r[f"serve/{case}"], r["coords"]
        n = DC.SERVE_B // 2
        rows = slice(coords["data"] * n, (coords["data"] + 1) * n)
        for k in ("prefill", "decode0", "decode1", "paged_decode"):
            _close(got[k], one[k][rows], OUT_TOL, f"{case} {k}")
        for k in ("chunk0", "chunk1", "paged0", "paged1", "paged2"):
            _close(got[k], one[k], OUT_TOL, f"{case} {k}")
        for k in ("cache", "chunk_cache"):
            _rank_cache(got[k], one[k], name, rules, coords, k)


def test_mesh_engine_streams_equal_one_device(ranks, single):
    """The eager ``ServeEngine`` on every rank of (2, 2) under llama's
    serve rules, dense and paged with prefix sharing, serving the same
    ten requests: every rank's streams equal one device's engine's, the
    paged ranks' pools are equal, and the prefix registry skipped the same
    rows."""
    want = single["engine"]
    for r in ranks:
        got = r["engine"]
        assert got["dense"] == want["dense"]
        assert got["paged"] == want["paged"]
        assert got["skipped"] == want["skipped"] > 0
        assert torch.equal(got["pool"], ranks[0]["engine"]["pool"])


def test_cache_init_under_a_mesh_is_the_rank_shard():
    """``lm.init_cache`` under a mesh allocates this rank's shard: the
    shapes ``lm.shard_cache`` cuts from the unsharded cache, on every rank
    of (2, 2) and under each rule set; ``init_paged_cache`` keeps the
    pools whole and the rank's table rows; a batch that does not divide
    the data-parallel axes raises."""
    from repro_torch.models import lm
    for name in ("llama", "gemma2", "mamba2", "zamba2"):
        cfg, run = DC.decode_cfg(name)
        full = lm.init_cache(DC.Ctx(run, "cpu"), cfg, 4, DC.MAX_SEQ)
        for rules in ("default", "fsdp", "seqparallel", "fsdp_seqparallel"):
            if cfg.family in ("ssm", "hybrid") and "seq" in rules:
                continue
            for d in range(2):
                for m in range(2):
                    ctx = _rank_ctx(run, rules, {"data": d, "model": m})
                    got = lm.init_cache(ctx, cfg, 4, DC.MAX_SEQ)
                    want = lm.shard_cache(ctx, cfg, full)
                    for key, leaves in want.items():
                        for k, w in leaves.items():
                            assert got[key][k].shape == w.shape, (
                                name, rules, key, k)
                            assert not got[key][k].any()
                    if cfg.family == "ssm":
                        continue
                    pc = lm.init_paged_cache(ctx, cfg, 4, DC.MAX_SEQ, 16)
                    assert pc["block_tables"].shape == (2, 4)
                    pool = next(v for key, v in pc.items()
                                if key not in ("block_tables", "mamba"))
                    assert pool["k"].shape[1:3] == (16, 16)
            with pytest.raises(ValueError, match="data-parallel"):
                lm.init_cache(_rank_ctx(run, "default",
                                        {"data": 0, "model": 0}), cfg, 3,
                              DC.MAX_SEQ)


def test_moe_expert_parallel_matches_local_path_and_jax(ranks, single,
                                                        oracle):
    jax_out = oracle.result()
    y0 = single["moe/y0"]
    _close(y0, jax_out["moe/y0"], OUT_TOL, "local path vs JAX")
    for r in ranks:
        _close(r["moe/y_bf16"], y0, OUT_TOL, "EP vs local")
        _close(r["moe/y_bf16"], jax_out["moe/y1"], OUT_TOL, "EP vs JAX EP")
        y1, yq = _np(r["moe/y_bf16"]), _np(r["moe/y_int8"])
        q_rel = np.linalg.norm(yq - y1) / np.linalg.norm(y1)
        assert q_rel < 0.05
        assert abs(q_rel - float(jax_out["moe/q_rel"])) < 1e-3


def test_moe_expert_parallel_gradients(ranks, single):
    want = dict(leaves_with_paths(single["moe/grads"]))
    for a2a in ("bf16", "int8"):
        for path, g in leaves_with_paths(ranks[0][f"moe/grads_{a2a}"]):
            assert np.isfinite(_np(g)).all(), (a2a, path)
            if a2a == "bf16":    # the plain wire: the local path's gradient
                _close(g, want[path], GRAD_TOL, f"EP grad {path}")


def test_compressed_psum_matches_reference(ranks, inputs, oracle):
    jax_out = oracle.result()
    g = inputs[1]["psum/g"]
    for rank, r in enumerate(ranks):
        for name in ("data_model", "data"):
            want = jax_out[f"psum/{name}"][rank]
            _close(r[f"psum/{name}"], want, 1e-6, f"compressed_psum {name}")
    # and it is a mean of the ranks' gradients within int8's resolution
    mean = g.mean(0)
    step = np.abs(g).max() / 127
    assert np.abs(_np(ranks[0]["psum/data_model"]) - mean).max() <= step


def test_elastic_restart_on_a_smaller_mesh(tmp_path):
    """(2, 2) for two steps and a checkpoint, then the restart on
    ``plan_mesh_shape(2, model_parallel=2)`` = (1, 2): its third step's
    loss is the straight-through third step's."""
    shape, names = plan_mesh_shape(2, model_parallel=2)
    assert (shape, names) == ((1, 2), ("data", "model"))
    ckpt = str(tmp_path / "ckpt")
    big = spawn_ranks(DC.rank_elastic, 4, "gloo",
                      args=((2, 2), ckpt, "train"), timeout_s=SPAWN_TIMEOUT_S)
    small = spawn_ranks(DC.rank_elastic, 2, "gloo",
                        args=(shape, ckpt, "restart"),
                        timeout_s=SPAWN_TIMEOUT_S)
    ref = big[0]["loss"]
    for r in small:
        assert r["start"] == 2
        assert abs(r["loss"] - ref) <= LOSS_RTOL * abs(ref), (r, ref)


def _launcher(tmp_path, mesh_args, world):
    tmp_path.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), WORLD_SIZE=str(world),
               DIST_INIT_METHOD="file://" + str(tmp_path / "store"),
               DIST_TIMEOUT_S="120", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           LAUNCH_ARCH, "--reduced", "--device", "cpu", "--steps", "2",
           "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp_path / "ckpt"),
           *mesh_args]
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r),
                                            LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return outs


def _losses(out):
    return [float(line.split()[2].split("=")[1]) for line in out.splitlines()
            if line.startswith("step ")]


def test_launcher_mesh_prints_the_one_device_losses(tmp_path):
    """Reduced olmoe under its own rule set (``default``) in the run's
    bf16: the mesh's losses are one device's within LAUNCH_LOSS_RTOL."""
    one = _losses(_launcher(tmp_path / "one", [], 1)[0])
    mesh = _launcher(tmp_path / "mesh", ["--mesh", "2x2", "--backend",
                                         "gloo"], 4)
    got = _losses(mesh[0])
    assert len(one) == 2 and len(got) == 2, (one, mesh[0])
    for a, b in zip(got, one):
        assert abs(a - b) <= LAUNCH_LOSS_RTOL * abs(b), (got, one)
    assert all(not _losses(o) for o in mesh[1:])     # rank 0 prints


def test_rule_sets_not_executed_raise_naming_14b(tmp_path):
    """The rule sets item 14b (a)-(b) left unexecuted now execute:
    ``executed_rules`` takes all four, and reduced llama's launcher run
    under its own ``seqparallel`` on ``--mesh 1x1`` prints its loss.  The
    Mamba-2 stack and the hybrid run under ``default`` and ``fsdp`` (item
    14b (c)); what 14b still leaves for them, a sequence-parallel rule
    set, raises naming its sub-item (c2), in ``lm.forward`` as in the
    launcher's check.  What (d) left unexecuted runs: on a (1, 1) mesh
    reduced llama's whole-batch prefill, a per-slot decode step and a
    paged prefill chunk give one device's logits, and the mesh engine
    serves; its migration (``drain``, ``checkpoint``, ``restore``) raises
    naming ROADMAP item 24."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import init_params
    from repro_torch.sharding import RULE_SETS, executed_rules
    for name in ("default", "fsdp", "seqparallel", "fsdp_seqparallel"):
        assert executed_rules(name) is RULE_SETS[name]
    mesh = Mesh((1, 1), ("data", "model"), rank=0, backend="gloo")
    for arch in ("mamba2-370m", "zamba2-1.2b"):
        cfg = reduced(get_model_config(arch))
        for name in ("default", "fsdp"):
            lm.require_mesh_family(cfg, RULE_SETS[name])
        params = init_params(lm.model_decls(cfg),
                             torch.Generator().manual_seed(0), "cpu")
        tokens = torch.zeros((1, 8), dtype=torch.long)
        for name in ("seqparallel", "fsdp_seqparallel"):
            run = get_run_config(arch, rules_name=name,
                                 compute_dtype="float32")
            with pytest.raises(NotImplementedError, match=r"14b \(c2\)"):
                lm.forward(Ctx(run, "cpu", RULE_SETS[name], mesh), cfg,
                           params, {"tokens": tokens})
    from repro_torch.serving.engine import (
        Request, ServeEngine, make_decode_step, make_prefill_chunk_step_paged,
        make_prefill_step)
    cfg, run = DC.decode_cfg("llama")
    params = init_params(lm.model_decls(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    got, want = {}, {}
    for out, ctx in ((want, Ctx(run, "cpu")),
                     (got, Ctx(run, "cpu", RULE_SETS["default"], mesh))):
        with torch.no_grad():
            cache, out["prefill"] = make_prefill_step(cfg, run, ctx, 32)(
                params, {"tokens": tokens})
            _, out["decode"] = make_decode_step(cfg, run, ctx)(
                params, cache, tokens[:, :1],
                torch.tensor([12, 32], dtype=torch.int32))
            pc = lm.init_paged_cache(ctx, cfg, 2, 32, 16)
            pc["block_tables"].copy_(torch.tensor([[2, 3], [0, 1]]))
            _, out["paged"] = make_prefill_chunk_step_paged(cfg, run, ctx)(
                params, pc, tokens[1:], 1, 0)
    for k in want:
        _close(got[k], want[k], OUT_TOL, f"(1, 1) {k}")
    eng = ServeEngine(cfg, run, Ctx(run, "cpu", RULE_SETS["default"], mesh),
                      params, batch_size=2, max_seq=32)
    eng.generate([Request(uid=0, prompt=[1, 2, 3], max_new_tokens=2)])
    for what, call in (("drain", eng.drain), ("checkpoint", eng.checkpoint),
                       ("restore", lambda: eng.restore([]))):
        with pytest.raises(NotImplementedError, match="item 24"):
            call()

    def launch(arch, sub):
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"), WORLD_SIZE="1",
                   RANK="0", OMP_NUM_THREADS="1",
                   DIST_INIT_METHOD="file://" + str(tmp_path / f"{sub}-store"))
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             arch, "--reduced", "--device", "cpu", "--steps", "1", "--batch",
             "2", "--seq", "32", "--mesh", "1x1", "--backend", "gloo",
             "--ckpt-dir", str(tmp_path / sub / "ckpt")],
            env=env, capture_output=True, text=True, timeout=120)

    out = launch("llama3.2-3b", "llama")
    assert out.returncode == 0, out.stderr[-3000:]
    assert len(_losses(out.stdout)) == 1, out.stdout


def test_launcher_seqparallel_mesh_prints_the_one_device_losses(tmp_path):
    """Reduced llama under its own rule set (``seqparallel``) on ``--mesh
    2x2`` in the run's bf16: the losses are one device's within
    LAUNCH_LOSS_RTOL (no capacity here: only the order of sums differs)."""
    args = ["--arch", "llama3.2-3b"]
    one = _losses(_launcher(tmp_path / "one", args, 1)[0])
    mesh = _launcher(tmp_path / "mesh", args + ["--mesh", "2x2", "--backend",
                                                "gloo"], 4)
    got = _losses(mesh[0])
    assert len(one) == 2 and len(got) == 2, (one, mesh[0])
    for a, b in zip(got, one):
        assert abs(a - b) <= LAUNCH_LOSS_RTOL * abs(b), (got, one)


def test_launcher_mesh_trains_zamba2(tmp_path):
    """Reduced zamba2 under its own rule set (``default``) on ``--mesh
    2x2`` in the run's bf16: the head-parallel Mamba-2 layers and the
    Megatron shared block; rank 0 prints one device's losses within
    LAUNCH_LOSS_RTOL (no capacity here: only the order of sums
    differs)."""
    args = ["--arch", "zamba2-1.2b"]
    one = _losses(_launcher(tmp_path / "one", args, 1)[0])
    mesh = _launcher(tmp_path / "mesh", args + ["--mesh", "2x2", "--backend",
                                                "gloo"], 4)
    got = _losses(mesh[0])
    assert len(one) == 2 and len(got) == 2, (one, mesh[0])
    for a, b in zip(got, one):
        assert abs(a - b) <= LAUNCH_LOSS_RTOL * abs(b), (got, one)
    assert all(not _losses(o) for o in mesh[1:])     # rank 0 prints


def test_gated_norm_all_reduce_pair_gives_the_one_device_gradient(ranks,
                                                                   single):
    """The Mamba-2 gated norm over a d_inner split over ``model``: with
    the all-reduce pair (``C.all_reduce``, an all-reduce backward) each
    rank's gradients of its y and z slices are the one-device gradients';
    with ``reduce_from`` in its place (an identity backward) each rank
    sees only its own sum's term, and they are not, while the output is
    the same."""
    for r in ranks:
        for name, ok in (("all_reduce", True), ("reduce_from", False)):
            got = r[f"norm/{name}"]
            cols = got["cols"]
            for k in ("y", "z"):
                want = single[f"norm/grad_{k}"][..., cols]
                close = np.abs(_np(got[k]) - _np(want)).max() \
                    <= GRAD_TOL * np.abs(_np(want)).max()
                assert close == ok, (name, k, r["coords"])


def _rule_case(ranks, case):
    return [r[f"rule/{case}"] for r in ranks]


def _one_device(single, case, what):
    prefix = DC.RULE_CASES[case][2]
    return single[f"{prefix}/{what}"]


@pytest.mark.parametrize("case", list(DC.RULE_CASES))
def test_rule_set_step_loss_matches_one_device_and_jax(ranks, single, oracle,
                                                       case):
    """loss and grad norm of the train step under each rule set
    (``seqparallel``: llama, phi3.5-moe; ``fsdp``: qwen2-vl, mamba2;
    ``fsdp_seqparallel``: llama; ``default``: mamba2, zamba2) on every
    rank, against one device and JAX's sharded step under the same
    rules."""
    jax_out = oracle.result()
    loss, gn = (_one_device(single, case, w) for w in ("loss", "grad_norm"))
    for r in _rule_case(ranks, case):
        for got, want, jw in ((r["loss"], loss, f"rule/{case}/loss"),
                              (r["grad_norm"], gn,
                               f"rule/{case}/grad_norm")):
            assert abs(got - want) <= LOSS_RTOL * abs(want), (case, got, want)
            assert abs(got - float(jax_out[jw])) <= LOSS_RTOL * abs(want), (
                case, got, float(jax_out[jw]))


@pytest.mark.parametrize("case", list(DC.RULE_CASES))
def test_rule_set_step_gradients_match_one_device_and_jax(ranks, single,
                                                          oracle, case):
    jax_out = oracle.result()
    want = dict(leaves_with_paths(_one_device(single, case, "grads")))
    got = dict(leaves_with_paths(_rule_case(ranks, case)[0]["grads"]))
    assert set(got) == set(want)
    for path, g in got.items():
        name = "/".join(path)
        _close(g, want[path], GRAD_TOL, f"{case} grad {name} vs one device")
        _close(g, jax_out[f"rule/{case}/grads/{name}"], GRAD_TOL,
               f"{case} grad {name} vs JAX")


def _params_close(got_tree, want_tree, jax_out, key, lr):
    """Parameters after one AdamW step within PARAM_TOL_LR lr of one
    device's and JAX's, and all but 1e-3 of the entries within 1e-3 lr."""
    want = dict(leaves_with_paths(want_tree))
    flipped, total = 0, 0
    for path, p in leaves_with_paths(got_tree):
        name = "/".join(path)
        refs = [(want[path], "one device")]
        if jax_out is not None:
            refs.append((jax_out[f"{key}/new_params/{name}"], "JAX"))
        for ref, what in refs:
            diff = np.abs(_np(p) - _np(ref))
            assert diff.max() <= PARAM_TOL_LR * lr * 1.001, (key, name, what)
            flipped += int((diff > 1e-3 * lr).sum())
        total += p.numel()
    assert flipped <= 1e-3 * total, f"{key}: {flipped} of {total} moved"


@pytest.mark.parametrize("case", list(DC.RULE_CASES))
def test_rule_set_step_parameters_match_one_device_and_jax(ranks, single,
                                                           oracle, case):
    lr = DC.rule_cfg(case)[1].learning_rate
    _params_close(_rule_case(ranks, case)[0]["new_params"],
                  _one_device(single, case, "new_params"), oracle.result(),
                  f"rule/{case}", lr)


def test_seqparallel_decode_matches_unsharded_and_jax(ranks, single, oracle):
    """llama's decode step under its serve rules (``seqparallel``): every
    head on every rank over the sequence-sharded cache, equal to the
    unsharded steps and to JAX's under the same rules."""
    jax_out = oracle.result()
    for r in ranks:
        n = single["decode/llama/logits_0"].shape[0] // 2
        d = r["coords"]["data"]
        rows = slice(d * n, (d + 1) * n)
        for i in range(2):
            got = r[f"seqdecode/logits_{i}"]
            _close(got, single[f"decode/llama/logits_{i}"][rows], OUT_TOL,
                   f"seqparallel step {i} vs unsharded")
            _close(got, jax_out[f"seqdecode/logits1_{i}"][rows], OUT_TOL,
                   f"seqparallel step {i} vs JAX")


def test_gather_sum_gives_the_one_device_gradient(ranks, inputs):
    """Rows of x split over ``model`` and gathered; rank r's loss is
    sum(y * w_r).  Summed over the data ranks (as ``train_step`` sums),
    ``gather_sum``'s gradient of each rank's rows is the one-device
    gradient sum_r w_r; ``gather_from``'s (the rank's own cotangent,
    sliced) is not."""
    w = inputs[1]["pair/w"]
    want = w.sum(0)
    for name, ok in (("gather_sum", True), ("gather_from", False)):
        for m in range(2):
            got = sum(_np(r[f"pair/{name}"]) for r in ranks
                      if r["coords"]["model"] == m)
            close = np.allclose(got, want[4 * m:4 * m + 4], atol=1e-5)
            assert close == ok, (name, m)


def test_wide_mesh_seqparallel_lifts_the_whole_heads_limit(ranks, single):
    """On (1, 4) reduced llama's 2 kv heads are cut in storage: the
    Megatron program (``default``) refuses the cut, and ``seqparallel``
    gathers the projections whole and equals one device."""
    for r in ranks:
        assert "whole heads" in r["wide/default"], r["wide/default"]
        got = r["wide/seq_llama"]
        for what in ("loss", "grad_norm"):
            want = single[f"train/{what}"]
            assert abs(got[what] - want) <= LOSS_RTOL * abs(want), what
    got = ranks[0]["wide/seq_llama"]
    want = dict(leaves_with_paths(single["train/grads"]))
    for path, g in leaves_with_paths(got["grads"]):
        _close(g, want[path], GRAD_TOL, f"(1, 4) grad {'/'.join(path)}")
    _params_close(got["new_params"], single["train/new_params"], None,
                  "wide", DC.train_cfg()[1].learning_rate)
