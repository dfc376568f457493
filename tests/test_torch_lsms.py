"""The port's LSMS (``repro_torch.models.lsms``) on the CPU against the JAX
package's (``repro.models.lsms``), on the same numpy inputs: the energy
contour and the neighbours bit for bit, A, tau and the densities within
stated tolerances, the task split composing to the whole bit for bit,
the task mixes field for field, the measured mix reproducing its
seconds, the examples' lines against the JAX examples', and (marked
``cuda``, skipped without a card) the card against the CPU.

The reference's build, LU and SCF outputs are computed once per test
process in a subprocess whose XLA runs on one thread
(``jax_refs``): XLA's batched LU on the CPU spreads over every core, and
among other test processes that took ~15 s a call against ~0.02 s alone.

Tolerances: both sides compute in complex64 from the same inputs and
differ in the order of their sums (XLA's dot and LAPACK's LU against
PyTorch's) and in their complex division: A within 1e-5 of max|A|
(t is diagonal, so a block product has one term: ~1e-7 expected); tau
and the densities within 1e-4 of their largest entry (an LU of order up
to 128, ~1e-6 expected)."""

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.hw.tpu import DEFAULT_CHIP as JCHIP  # noqa: E402
from repro.models import lsms as jl  # noqa: E402
from repro_torch.core import (TaskTable, measure_sweep,  # noqa: E402
                              simulate_task)
from repro_torch.hw.h100 import H100_CHIP, H100_SUPERCHIP  # noqa: E402
from repro_torch.hw.tpu import DEFAULT_CHIP, DEFAULT_SUPERCHIP  # noqa: E402
from repro_torch.models import lsms as tl  # noqa: E402
from repro_torch.power import metered as metered_mod  # noqa: E402
from repro_torch.power.metered import (MeteredPowerManager,  # noqa: E402
                                       metered_windows)

REPO = Path(__file__).resolve().parent.parent
A_TOL, TAU_TOL, DENSITY_TOL = 1e-5, 1e-4, 1e-4
#: (n_atoms, liz, e_points): the reference's default, the card's parity
#: config, the JAX example's --atoms 4 and a wider LIZ
CONFIGS = [(8, 4, 4), (16, 8, 4), (4, 4, 4), (24, 12, 3)]
#: ``run_scf``'s cases: the reference's default and the JAX example's
RUN_CONFIGS = CONFIGS[:3]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The CPU side's products and LUs are small: one intra-op thread runs
    them as fast and leaves the cores to other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the reference's case runs on one thread (set before JAX starts)
_ONE_THREAD_ENV = {
    "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false "
                 "intra_op_parallelism_threads=1",
    "OPENBLAS_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def _reference_outputs(path):
    """Every output of ``repro.models.lsms`` the tests below compare with,
    on their inputs, saved to ``path`` (npz): A, t's blocks and tau at
    each case of ``test_kkr_matrix_and_tau``, the density of each
    ``test_scf_step`` case, and ``run_scf``'s density and positions of
    each ``test_run_scf_on_the_references_positions`` case."""
    out = {}
    for cfg in CONFIGS:
        jc, tc = _cfgs(*cfg)
        for general_t in (False, True):
            pos = _positions(jc.n_atoms, seed=1)
            t = _t_diag(jc, np.random.default_rng(2) if general_t else None)
            for i, e in enumerate(tl.contour(tc)):
                A, tb = jl.build_kkr_matrix(jc, jnp.asarray(pos),
                                            jnp.asarray(t), jnp.float32(e))
                key = f"{cfg}-{general_t}-{i}"
                out["A" + key], out["tb" + key] = np.asarray(A), np.asarray(tb)
                if i == 0:
                    out["tau" + key] = np.asarray(jl.solve_tau(A, tb))
        pos = _positions(jc.n_atoms, seed=3)
        out[f"scf{cfg}"] = np.asarray(jl.scf_step(
            jc, jnp.asarray(pos), jnp.asarray(_t_diag(jc))))
    for cfg in RUN_CONFIGS:
        jc, _ = _cfgs(*cfg)
        key = jax.random.PRNGKey(0)
        out[f"run{cfg}"] = np.asarray(jl.run_scf(jc, key))
        out[f"pos{cfg}"] = np.asarray(jl.make_positions(jc, key))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    path = tmp_path_factory.mktemp("lsms") / "refs.npz"
    code = (f"import sys; sys.path[:0] = [{str(REPO / 'src')!r}, "
            f"{str(Path(__file__).parent)!r}]; import test_torch_lsms as t; "
            f"t._reference_outputs({str(path)!r})")
    res = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, **_ONE_THREAD_ENV),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    with np.load(path) as refs:
        return dict(refs)


def _cfgs(n, liz, e):
    kw = dict(n_atoms=n, liz=liz, e_points=e)
    return jl.LsmsConfig(**kw), tl.LsmsConfig(**kw)


def _positions(n, seed=0):
    return np.random.default_rng(seed).uniform(0.0, 10.0, (n, 3)).astype(
        np.float32)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t_diag(cfg, rng=None):
    """The reference's t (0.1i I), or a seeded general complex one."""
    t = np.broadcast_to(0.1j * np.eye(cfg.nb, dtype=np.complex64),
                        (cfg.n_atoms, cfg.nb, cfg.nb)).copy()
    if rng is not None:
        t = t + 0.02 * (rng.standard_normal(t.shape)
                        + 1j * rng.standard_normal(t.shape))
    return t.astype(np.complex64)


def test_contour_bit_equal():
    """The energies equal ``jnp.linspace(0.5, 2.0, n)`` bit for bit."""
    for n in range(1, 65):
        want = np.asarray(jnp.linspace(0.5, 2.0, n))
        got = tl.contour(tl.LsmsConfig(e_points=n))
        assert got.dtype == np.float32 and got.shape == (n,)
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), n


@pytest.mark.parametrize("n,liz", [(8, 4), (16, 8), (128, 113), (40, 40)])
def test_neighbours_equal(n, liz):
    """The LIZ members and their order equal the reference's stable
    argsort; each atom is its own member 0."""
    pos = _positions(n, seed=n)
    d2 = jnp.sum((pos[:, None] - pos[None, :]) ** 2, -1)
    want = np.asarray(jnp.argsort(d2, axis=1)[:, :liz])
    got = tl.liz_neighbours(torch.from_numpy(pos), liz).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got[:, 0], np.arange(n))


@pytest.mark.parametrize("general_t", [False, True], ids=["t=0.1i", "t"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=str)
def test_kkr_matrix_and_tau(cfg, general_t, jax_refs):
    """A at every energy point within A_TOL of max|A| and t's blocks
    equal; tau at the first from the reference's A within TAU_TOL."""
    jc, tc = _cfgs(*cfg)
    pos = _positions(jc.n_atoms, seed=1)
    t = _t_diag(jc, np.random.default_rng(2) if general_t else None)
    for i, e in enumerate(tl.contour(tc)):
        key = f"{cfg}-{general_t}-{i}"
        A_j, tb_j = jax_refs["A" + key], jax_refs["tb" + key]
        A_t, tb_t = tl.build_kkr_matrix(tc, torch.from_numpy(pos),
                                        torch.from_numpy(t),
                                        torch.tensor(e))
        assert A_t.dtype == torch.complex64 and A_t.shape == A_j.shape
        assert np.array_equal(tb_t.numpy(), tb_j)
        assert _rel(A_t.numpy(), A_j) <= A_TOL
        if i == 0:
            tau_t, info = tl.solve_tau(torch.from_numpy(A_j), tb_t)
            assert tau_t.dtype == torch.complex64
            assert int(info.abs().sum()) == 0
            assert _rel(tau_t.numpy(), jax_refs["tau" + key]) <= TAU_TOL


@pytest.mark.parametrize("cfg", CONFIGS, ids=str)
def test_scf_step(cfg, jax_refs):
    """One SCF iteration's density within DENSITY_TOL, none singular."""
    jc, tc = _cfgs(*cfg)
    pos = _positions(jc.n_atoms, seed=3)
    t = _t_diag(jc)
    want = jax_refs[f"scf{cfg}"]
    got, singular = tl.scf_step(tc, torch.from_numpy(pos),
                                torch.from_numpy(t))
    assert got.dtype == torch.float32 and int(singular) == 0
    assert _rel(got.numpy(), want) <= DENSITY_TOL


@pytest.mark.parametrize("cfg", RUN_CONFIGS, ids=str)
def test_run_scf_on_the_references_positions(cfg, jax_refs):
    """``run_scf`` on JAX's ``make_positions`` (numpy) within
    DENSITY_TOL of the reference's ``run_scf``."""
    jc, tc = _cfgs(*cfg)
    want, pos = jax_refs[f"run{cfg}"], jax_refs[f"pos{cfg}"]
    got = tl.run_scf(tc, positions=pos, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (jc.n_atoms,)
    assert _rel(got.numpy(), want) <= DENSITY_TOL


def test_task_split_composes_bit_for_bit():
    """``build_kkr_matrix`` is ``kkr_zgemm`` of ``kkr_structure``,
    ``solve_tau`` is ``trsm`` of ``getrf``, and ``scf_step`` (which
    calls the tasks) equals the loop over the two, bit for bit; each of
    ``task_calls`` returns what the loop's first energy point computes."""
    _, tc = _cfgs(16, 8, 4)
    pos = torch.from_numpy(_positions(16, seed=4))
    t = tl.initial_t(tc, "cpu")
    density = torch.zeros(16)
    for e in torch.from_numpy(tl.contour(tc)):
        A, tb = tl.build_kkr_matrix(tc, pos, t, e)
        g0, tb2 = tl.kkr_structure(tc, pos, t, e)
        assert torch.equal(tb, tb2)
        assert torch.equal(tl.kkr_zgemm(tb2, g0), A)
        tau, _ = tl.solve_tau(A, tb)
        lu, piv, _ = tl.getrf(A)
        alone = tl.trsm(lu, piv, tl.tau_rhs(tb, A.shape[-1]))[:, :tc.nb]
        assert torch.equal(alone, tau)
        density = density - torch.diagonal(tau, dim1=1, dim2=2).sum(
            -1).imag / np.pi
    got, _ = tl.scf_step(tc, pos, t)
    assert torch.equal(got, density / tc.e_points)

    calls = tl.task_calls(tc, pos)
    assert list(calls) == list(tl.TASKS)
    e0 = torch.from_numpy(tl.contour(tc))[0]
    A, tb = tl.build_kkr_matrix(tc, pos, t, e0)
    assert torch.equal(calls["buildKKRMatrix"]()[0],
                       tl.kkr_structure(tc, pos, t, e0)[0])
    assert torch.equal(calls["zgemm"](), A)
    lu, piv, _ = calls["getrf"]()
    assert torch.equal(lu, tl.getrf(A)[0])
    assert torch.equal(calls["trsm"](),
                       tl.trsm(lu, piv, tl.tau_rhs(tb, A.shape[-1])))
    assert torch.equal(calls["gpu_compute_idle"](), torch.full((16,), 0.3))


def test_host_mix_matches_and_checks_singular():
    """The mix is the reference's numpy expression, bit for bit; a
    singular count raises."""
    rng = np.random.default_rng(5)
    d, nd = (rng.standard_normal(9).astype(np.float32) for _ in range(2))
    want = np.asarray(jl.host_mix(jnp.asarray(d), jnp.asarray(nd)))
    got = tl.host_mix(torch.from_numpy(d), torch.from_numpy(nd),
                      singular=torch.tensor(0))
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(RuntimeError, match="zero pivot"):
        tl.host_mix(torch.from_numpy(d), torch.from_numpy(nd),
                    singular=torch.tensor(2))


def test_getrf_reports_a_zero_pivot_without_raising():
    """``getrf`` leaves a zero pivot in ``info`` (1-based, per matrix)
    for ``scf_step`` to count, and does not raise (no sync)."""
    A = torch.eye(32, dtype=torch.complex64)[None].repeat(2, 1, 1)
    A[1, 5] = 0
    _, _, info = tl.getrf(A)
    assert info.tolist() == [0, 6]


def _fields(tasks):
    return [dataclasses.astuple(t) for t in tasks]


@pytest.mark.parametrize("chip", ["tpu", "h100"])
def test_paper_mix_and_phase_sequence_equal(chip):
    """``paper_calibrated_tasks`` and ``scf_phase_sequence`` equal the
    reference's field for field (on the reference's TPU spec, and on the
    H100's, given to both as the same numbers)."""
    if chip == "tpu":
        pchip, jchip = DEFAULT_CHIP, JCHIP
    else:
        pchip = H100_CHIP
        jchip = type(JCHIP)(**dataclasses.asdict(H100_CHIP))
    assert _fields(tl.paper_calibrated_tasks(pchip)) \
        == _fields(jl.paper_calibrated_tasks(jchip))
    assert _fields(tl.scf_phase_sequence(pchip)) \
        == _fields(jl.scf_phase_sequence(jchip))
    assert _fields(tl.paper_calibrated_tasks()) \
        == _fields(jl.paper_calibrated_tasks())


def test_task_counts_at_card_size():
    """The derived work of LSMS_CARD: G0 / A of 3.35 GB, getrf's 2.02
    TFLOP an energy point (>= 30 ms at 67 TFLOP/s), the bound kinds."""
    c = tl.lsms_task_counts(tl.LSMS_CARD)
    m = 113 * 16
    assert m == 1808
    entries = 128 * m * m
    assert c["buildKKRMatrix"]["bytes"] >= entries * 8
    assert c["zgemm"]["bytes"] >= 2 * entries * 8
    assert c["getrf"]["flops"] == pytest.approx(8 / 3 * m ** 3 * 128)
    assert 2.0e12 < c["getrf"]["flops"] < 2.05e12
    assert c["getrf"]["bound_s"] == pytest.approx(c["getrf"]["flops"] / 67e12)
    assert c["getrf"]["bound_by"] == "operations"
    for t in ("buildKKRMatrix", "zgemm", "trsm"):
        assert c[t]["bound_by"] == "bytes"
        assert c[t]["bound_s"] == pytest.approx(c[t]["bytes"] / 3.35e12)
    assert c["gpu_compute_idle"] == {"flops": 0.0, "bytes": 0.0, "calls": 2,
                                     "bound_s": 0.0, "bound_by": "none"}
    assert {t: c[t]["calls"] for t in tl.TASKS} == {
        "buildKKRMatrix": 16, "zgemm": 16, "getrf": 16, "trsm": 16,
        "gpu_compute_idle": 2}


@pytest.mark.parametrize("spec", [H100_SUPERCHIP, DEFAULT_SUPERCHIP],
                         ids=["h100", "tpu"])
def test_measured_mix_reproduces_its_seconds(spec):
    """Fed seconds per call, ``measured_lsms_tasks`` gives tasks whose
    ``simulate_task`` at the default cap takes those seconds over the
    run's calls, with each task's boundedness that of its counts."""
    cfg = tl.LSMS_CARD
    counts = tl.lsms_task_counts(cfg)
    per = {"buildKKRMatrix": 1.3e-3, "zgemm": 8.6e-3, "getrf": 0.212,
           "trsm": 6.4e-3, "gpu_compute_idle": 5e-5}
    calls = {t: counts[t]["calls"] for t in per}
    tasks = tl.measured_lsms_tasks(per, calls, cfg, spec)
    assert [t.name for t in tasks] == list(tl.TASKS)
    for t in tasks:
        m = simulate_task(t, spec.p_default, spec)
        assert m.runtime == pytest.approx(per[t.name] * calls[t.name],
                                          rel=1e-9)
        assert t.calls == calls[t.name]
        want = {"operations": "compute", "bytes": "memory",
                "none": "idle"}[counts[t.name]["bound_by"]]
        assert t.boundedness(spec.chip) == want


class _Meter:
    """An energy counter drawing 150 W on the host's clock."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def energy_mj(self):
        return int((time.perf_counter() - self.t0) * 150_000)


def test_metered_windows_fill_the_window():
    """Each call is repeated until one window of at least ``window_s``
    holds it; per-call seconds and joules are the window's over its
    calls."""
    syncs = []
    out = metered_windows({"short": lambda: time.sleep(0.002),
                           "long": lambda: time.sleep(0.06)}, _Meter(),
                          window_s=0.1, sync=lambda: syncs.append(1))
    for name, w in out.items():
        assert w["seconds"] >= 0.1
        assert w["s_per_call"] == pytest.approx(w["seconds"] / w["reps"])
        assert w["j_per_call"] == pytest.approx(w["joules"] / w["reps"])
        assert w["mean_w"] == pytest.approx(150, rel=0.1)
    assert out["short"]["reps"] > out["long"]["reps"] >= 2
    assert len(syncs) >= 4 * len(out)


class _Card:
    """A ``CardPower`` over ``_Meter``: a 700 W limit, the H100 spec's
    sweep, limit writes taken (each logged) or refused."""

    def __init__(self, writable):
        self.writable, self.spec = writable, H100_SUPERCHIP
        self.nvml, self.applied, self.limit = self, [], 700.0
        self.meter = _Meter()

    def energy_mj(self):
        return self.meter.energy_mj()

    def limit_w(self):
        return self.limit

    def apply(self, cap):
        self.applied.append(cap)
        self.limit = cap


@pytest.fixture
def _fake_card_clock(monkeypatch):
    """Short windows, no settling, and a no-op device synchronise."""
    monkeypatch.setattr(metered_mod, "WINDOW_S", 0.01)
    monkeypatch.setattr(metered_mod, "SETTLE_S", 0.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


@pytest.mark.parametrize("writable", [False, True],
                         ids=["refused", "granted"])
def test_measure_table1_on_a_fake_card(writable, _fake_card_clock):
    """``measure_table1``, the one builder of the measured Table 1: every
    task timed over windows of at least ``WINDOW_S`` at the limit in
    force, and where writes are granted at every other cap of the sweep,
    the limit put back after; its rows, task mix and measurements are
    the windows scaled by the run's calls."""
    _, tc = _cfgs(8, 4, 4)
    pos = torch.from_numpy(_positions(8, seed=9))
    card = _Card(writable)
    out = tl.measure_table1(card, tc, pos)
    sweep = sorted(H100_SUPERCHIP.cap_sweep(), reverse=True)
    want_caps = [700.0] + [c for c in sweep if c != 700.0] if writable \
        else [700.0]
    assert out["caps"] == want_caps
    assert card.applied == (want_caps[1:] + [700.0] if writable else [])
    assert card.limit == 700.0
    counts = tl.lsms_task_counts(tc)
    assert list(out["rows"]) == list(tl.TASKS)
    for t, r in out["rows"].items():
        w = out["windows"][700.0][t]
        assert r["seconds"] >= 0.01 and r["s_per_call"] == w["s_per_call"]
        assert r["calls"] == counts[t]["calls"]
        assert r["bound_s"] == counts[t]["bound_s"]
        assert r["run_s"] == w["s_per_call"] * r["calls"]
        assert r["run_j"] == w["j_per_call"] * r["calls"]
    assert out["tasks"] == tl.measured_lsms_tasks(
        {t: r["s_per_call"] for t, r in out["rows"].items()},
        {t: r["calls"] for t, r in out["rows"].items()}, tc, H100_SUPERCHIP)
    assert [(m.task, m.cap) for m in out["measurements"]] == [
        (t, c) for c in want_caps for t in tl.TASKS]
    for m in out["measurements"]:
        w = out["windows"][m.cap][m.task]
        assert m.runtime == w["s_per_call"] * counts[m.task]["calls"]


def test_metered_scf_is_run_scf(_fake_card_clock):
    """``metered_scf`` gives ``run_scf``'s density bit for bit and one
    (seconds, joules) reading per iteration."""
    _, tc = _cfgs(8, 4, 3)
    pos = torch.from_numpy(_positions(8, seed=4))
    want = tl.run_scf(tc, positions=pos, device="cpu")
    got, iters = tl.metered_scf(_Meter(), tc, pos)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert len(iters) == tc.scf_iters
    for it in iters:
        assert it["seconds"] > 0
        assert it["joules"] == pytest.approx(150 * it["seconds"], rel=0.2,
                                             abs=1e-3)


@pytest.mark.parametrize("kernel,backend", [
    ("void gemm_template_batched_nn_kernel<float2, 16, 16, 48, 32, 16,",
     "MAGMA"),
    ("void trsm_template_batched_lNL_kernel<float2, 16, 32>(magma_diag_t,",
     "MAGMA"),
    ("claswp_rowparallel_kernel_batched(int, int, int, float2**, int,",
     "MAGMA"),
    ("zcomputecolumn_kernel_shared_batched(int, int, int, float2**, int",
     "MAGMA"),
    ("zdisplace_pointers_kernel(float2**, float2**, int, int, int)",
     "MAGMA"),
    ("void cusolver::getrf_kernel<float2>(int, float2*)", "cuSOLVER"),
    ("void getrf_batched_kernel<float2, 32>(int, float2**, int*)",
     "cuBLAS batched"),
    ("void getrs_batch_kernel<float2>(int, float2**)", "cuBLAS batched"),
    ("void laswp_kernel<float2>(int, float2*, int*)", "unknown"),
    ("sm80_xmma_gemm_cf32cf32_f32f32_cf32_nn_n_tilesize32x64x8", None),
    ("void at::native::elementwise_kernel<128, 2>", None),
])
def test_lu_backend_by_kernel_name(kernel, backend):
    """``chip_smoke.py`` names the LU backend of ``[profile:lsms]`` from
    kernel names: MAGMA's own (the names read on the card), cuSOLVER's,
    a batched getrf/getrs (cuBLAS), an LU-like name of none of them
    unknown, and any other kernel none."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    assert chip_smoke._lu_backend(kernel) == backend


def test_metered_run_is_bit_equal_and_phased():
    """``run_scf`` under a ``MeteredPowerManager`` (fake meter and sync)
    gives the unmetered density bit for bit, with one phase per task per
    energy point and one host mix per iteration, each entered once."""
    _, tc = _cfgs(16, 8, 3)
    pos = _positions(16, seed=6)
    want = tl.run_scf(tc, positions=pos, device="cpu")
    counts = tl.lsms_task_counts(tc)
    calls = {t: counts[t]["calls"] for t in tl.TASKS}
    tasks = tl.measured_lsms_tasks({t: 1e-3 for t in tl.TASKS}, calls, tc)
    syncs = []
    pm = MeteredPowerManager(
        TaskTable(measure_sweep(tasks, spec=H100_SUPERCHIP).rows),
        tasks=tasks, meter=_Meter(), sync=lambda: syncs.append(1),
        spec=H100_SUPERCHIP)
    got = tl.run_scf(tc, positions=pos, device="cpu", power=pm)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert pm.entries == calls and pm.calls == calls
    assert pm.syncs == len(syncs) == 2 * sum(calls.values())


def test_entry_points_need_the_card_or_cpu_asked():
    """Without CUDA an entry point not asked for the CPU raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = tl.LsmsConfig()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tl.run_scf(cfg, positions=_positions(8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tl.make_positions(cfg, torch.Generator())
    with pytest.raises(ValueError, match="generator or positions"):
        tl.run_scf(cfg, device="cpu")


def _run(args, timeout=300):
    """An example in a subprocess, on one thread (torch's and XLA's)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1", **_ONE_THREAD_ENV)
    return subprocess.run([sys.executable, *args], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def _tables(text):
    return text[text.index("== Table 1"):].splitlines()


def test_lsms_example_lines_equal_the_jax_examples():
    """``torch_lsms_scf.py --device cpu --atoms 4`` prints the JAX
    example's Table 1, Table 2, aggregates, weighted impact and session
    lines, character for character."""
    got = _run(["examples/torch_lsms_scf.py", "--device", "cpu",
                "--atoms", "4"])
    want = _run(["examples/lsms_scf.py", "--atoms", "4"])
    assert got.returncode == 0, got.stderr
    assert want.returncode == 0, want.stderr
    assert got.stdout.startswith("[scf] 4 atoms, 2 iterations")
    assert _tables(got.stdout) == _tables(want.stdout)
    assert len(_tables(got.stdout)) > 20


@pytest.mark.parametrize("args", [
    ["examples/torch_quickstart.py", "--steps", "2"],
    ["examples/torch_serve_decode.py", "--requests", "3", "--new", "3"],
    ["examples/torch_train_energy_aware.py", "--steps", "3", "--seq", "32",
     "--batch", "2", "--ckpt-every", "2"],
], ids=["quickstart", "serve_decode", "train_energy_aware"])
def test_examples_run_on_the_cpu(args, tmp_path):
    """The other three examples at reduced size with ``--device cpu``;
    without it, on a host with no card, each raises."""
    if "train_energy_aware" in args[0]:
        args = args + ["--ckpt-dir", str(tmp_path)]
    res = _run(args + ["--device", "cpu"])
    assert res.returncode == 0, res.stdout + res.stderr
    last = res.stdout.strip().splitlines()[-1]
    assert last in ("done.", "serving demo done.") \
        or last.startswith("[done] 3 steps")
    if not torch.cuda.is_available():
        res = _run(args)
        assert res.returncode != 0
        assert "CUDA is not available" in res.stderr


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_matches_cpu(card):
    """The card (TF32 off) against the CPU on the same numpy positions:
    A, tau and the density within the tolerances above."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tc = _cfgs(16, 8, 4)
    pos = _positions(16, seed=7)
    got = {}
    for dev in (card, torch.device("cpu")):
        p = torch.from_numpy(pos).to(dev)
        e = torch.from_numpy(tl.contour(tc)).to(dev)[0]
        A, tb = tl.build_kkr_matrix(tc, p, tl.initial_t(tc, dev), e)
        tau, _ = tl.solve_tau(A, tb)
        got[dev.type] = (A.cpu(), tau.cpu(),
                         tl.run_scf(tc, positions=pos, device=dev).cpu())
    for i, tol in enumerate((A_TOL, TAU_TOL, DENSITY_TOL)):
        assert _rel(got["cuda"][i].numpy(), got["cpu"][i].numpy()) <= tol
