"""LSMS, the paper's application, in PyTorch: the port's counterpart of
``repro/models/lsms.py``.

LSMS (Locally Self-consistent Multiple Scattering) computes Green's
functions by the KKR method: for every atom, build the multiple-scattering
matrix A = I - t*G0 over its local interaction zone (LIZ), then solve
A tau = t (LU factorisation and triangular solves).  The SCF loop
alternates this accelerator-heavy solve with host-side density mixing
(the paper's 'gpu compute idle' phase).

Three layers:

  * the real math, in complex64 (``build_kkr_matrix``, ``solve_tau``,
    ``scf_step``, ``host_mix``, ``run_scf``), split into the paper's
    Table-1 tasks that the miniature performs, one function each:

      buildKKRMatrix    ``kkr_structure``: neighbours, structure constants
      zgemm             ``kkr_zgemm``: the block product t*G0, A = I - tG0
      getrf             ``getrf``: ``torch.linalg.lu_factor_ex``
      trsm              ``trsm``: ``torch.linalg.lu_solve``
      gpu_compute_idle  ``host_mix``: the density's round trip to the host

    ``build_kkr_matrix`` is ``kkr_zgemm`` of ``kkr_structure`` and
    ``solve_tau`` is ``trsm`` of ``getrf``, so a task timed alone does
    exactly the work it does in the loop.  Every function runs where its
    inputs lie; the entry points (``make_positions``, ``run_scf``) take a
    ``device``, the card by default (``device="cpu"`` must be asked for);
  * ``paper_calibrated_tasks`` and ``scf_phase_sequence``: copies of the
    reference's task mix (the paper's GH200 seconds rescaled to a
    modelled chip), unchanged;
  * ``lsms_task_counts`` and ``measured_lsms_tasks``: each task's flops
    and HBM bytes from the shapes (its bound on the H100), and the task
    mix built the reference's way from seconds measured on the card;
    ``metered_scf`` and ``measure_table1`` measure the loop and each
    task on the card's energy counter (one builder of the measured
    Table 1 for the example and the smoke run).

The JAX reference reaches no Pallas kernel (its block product is
``jnp.einsum``, its LU ``jax.scipy.linalg``), so neither does this
module: the product and the factorisation are PyTorch's own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.power_model import simulate_task
from repro_torch.core.tasks import Task, TaskMeasurement
from repro_torch.hw.h100 import H100_CHIP, H100_SUPERCHIP, PEAK_FLOPS_F32
from repro_torch.hw.tpu import DEFAULT_CHIP, ChipSpec, SuperchipSpec
from repro_torch.models.params import resolve_device
from repro_torch.power import metered


# ===========================================================================
# runnable miniature (real math)
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class LsmsConfig:
    n_atoms: int = 8
    liz: int = 4          # atoms in the local interaction zone
    nb: int = 16          # angular-momentum block size ((lmax+1)^2)
    scf_iters: int = 2
    e_points: int = 4     # energy-contour points


#: the card's configuration: lmax = 3 (nb = 16) and a LIZ of 113 atoms,
#: so each atom inverts a matrix of order m = 113 * 16 = 1808.  113 is
#: the count of a bcc LIZ through eight neighbour shells (1 + 8 + 6 + 12
#: + 24 + 8 + 6 + 24 + 24), taken as a size only: the geometry is the
#: reference's, positions uniform in a 10^3 box, so with 113 of 128 atoms
#: each LIZ holds almost the whole system.  The size is a choice; no
#: published run is cited for it.  Neighbours are found among the atoms
#: given, so n_atoms >= liz
LSMS_CARD = LsmsConfig(n_atoms=128, liz=113, nb=16, scf_iters=2, e_points=8)

#: the paper's Table-1 tasks the miniature performs, in the loop's order
TASKS = ("buildKKRMatrix", "zgemm", "getrf", "trsm", "gpu_compute_idle")


def contour(cfg: LsmsConfig) -> np.ndarray:
    """The energy points, float32, equal bit for bit to the reference's
    ``jnp.linspace(0.5, 2.0, e_points)``.  XLA compiles that linspace to
    ``fma(i, 2.0 * (1 / div), 0.5 * (1 - i * (1 / div)))`` with each
    constant rounded to float32; the product of two float32 values is
    exact in float64, so the sum there is rounded once to float32, as the
    fused multiply-add rounds it."""
    n = cfg.e_points
    if n == 1:
        return np.array([0.5], np.float32)
    f32 = np.float32
    i = np.arange(n - 1, dtype=f32)
    rec = f32(1) / f32(n - 1)
    head = f32(0.5) * (f32(1) - i * rec)
    out = (i.astype(np.float64) * np.float64(f32(2.0) * rec)
           + head.astype(np.float64)).astype(f32)
    return np.concatenate([out, np.array([2.0], f32)])


def make_positions(cfg: LsmsConfig, generator: torch.Generator,
                   device="cuda") -> torch.Tensor:
    """(n_atoms, 3) float32 positions, uniform in [0, 10), drawn from
    ``generator`` (a ``torch.Generator`` on ``device``)."""
    dev = resolve_device(device)
    return torch.rand((cfg.n_atoms, 3), generator=generator, device=dev,
                      dtype=torch.float32) * 10.0


def initial_t(cfg: LsmsConfig, device) -> torch.Tensor:
    """The single-site t matrices, 0.1i * I for every atom (complex64)."""
    eye = torch.eye(cfg.nb, dtype=torch.complex64, device=device)
    return (0.1j * eye)[None].repeat(cfg.n_atoms, 1, 1)


def liz_neighbours(positions, liz: int):
    """(n, liz) indices of each atom's LIZ, nearest first: the atom itself
    (distance 0) is member 0, and ties keep the lower index (a stable
    sort, as ``jnp.argsort``)."""
    d = positions[:, None] - positions[None, :]
    # the three squares summed in one fixed order on every device, so the
    # neighbour order is the same on the card and the CPU
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]
    return torch.argsort(d2, dim=1, stable=True)[:, :liz]


def kkr_structure(cfg: LsmsConfig, positions, t_diag, energy):
    """The buildKKRMatrix task: each atom's LIZ (itself first, then its
    nearest atoms) and the structure constants G0 between its members,
    (n, liz, liz, nb, nb) complex64 with no self blocks; also the
    members' t blocks.  ``energy`` is a 0-d float32 tensor.

    G0 blocks decay with distance and oscillate with sqrt(energy):
    structurally faithful free-space structure constants (not the true
    Gaunt-coefficient expansion), as in the reference."""
    liz, nb = cfg.liz, cfg.nb
    neigh = liz_neighbours(positions, liz)                   # (n, liz)
    pos_l = positions[neigh]                                 # (n, liz, 3)
    rij = torch.linalg.vector_norm(
        pos_l[:, :, None] - pos_l[:, None, :] + 1e-3, dim=-1)  # (n,liz,liz)
    kappa = torch.sqrt(torch.abs(energy)) + 0.1
    phase = torch.exp(1j * kappa * rij) / rij.to(torch.complex64)
    # the reference masks the self blocks of the full G0; masking the
    # (n, liz, liz) phase first gives the same values at 1/nb^2 the work
    not_self = 1.0 - torch.eye(liz, dtype=torch.complex64,
                               device=positions.device)
    phase = phase * not_self
    lm = (torch.arange(nb, device=positions.device)[:, None]
          - torch.arange(nb, device=positions.device)[None, :]).float()
    ang = torch.exp(-0.1 * torch.abs(lm)).to(torch.complex64)  # (nb, nb)
    g0 = phase[..., None, None] * ang                    # (n,liz,liz,nb,nb)
    return g0, t_diag[neigh]                                 # t: (n,liz,nb,nb)


def kkr_zgemm(t_blocks, g0):
    """The zgemm task: tG0 = t * G0 block by block (t is block-diagonal
    per atom), laid out as the (m, m) matrix of each atom (m = liz * nb),
    and A = I - tG0, written over tG0."""
    n, liz, _, nb, _ = g0.shape
    m = liz * nb
    tg = torch.einsum("napq,nasqr->napsr", t_blocks, g0)    # (n,liz,nb,liz,nb)
    A = tg.reshape(n, m, m).neg_()
    A.diagonal(dim1=1, dim2=2).add_(1.0)
    return A


def build_kkr_matrix(cfg: LsmsConfig, positions, t_diag, energy):
    """Assemble A = I - t*G0 per atom: the buildKKRMatrix task, then the
    zgemm task.  Returns (A, t_blocks)."""
    g0, t_blocks = kkr_structure(cfg, positions, t_diag, energy)
    return kkr_zgemm(t_blocks, g0), t_blocks


def getrf(A):
    """The getrf task: A = P L U.  No sync: ``info`` (nonzero where a
    pivot is exactly zero) stays on the device, for ``host_mix`` to check
    where it syncs anyway."""
    return torch.linalg.lu_factor_ex(A, check_errors=False)


def tau_rhs(t_blocks, m: int):
    """The right-hand side of A tau = t for the central atom's block: t of
    member 0 (the atom itself) in the first nb rows, zeros below."""
    n, _, nb, _ = t_blocks.shape
    rhs = torch.zeros((n, m, nb), dtype=torch.complex64,
                      device=t_blocks.device)
    rhs[:, :nb] = t_blocks[:, 0]
    return rhs


def trsm(lu, pivots, rhs):
    """The trsm task: the two triangular solves with the factors."""
    return torch.linalg.lu_solve(lu, pivots, rhs)


def solve_tau(A, t_blocks):
    """A tau = t: the getrf task, then the trsm task.  Returns the
    central atom's (n, nb, nb) tau block and the factorisation's
    ``info``."""
    nb = t_blocks.shape[-1]
    lu, pivots, info = getrf(A)
    tau = trsm(lu, pivots, tau_rhs(t_blocks, A.shape[-1]))
    return tau[:, :nb, :], info


def _phase(power, name: str):
    """``power.phase(name, 1)`` (one call of the task), or nothing."""
    return contextlib.nullcontext() if power is None \
        else power.phase(name, 1)


def scf_step(cfg: LsmsConfig, positions, t_diag, *, power=None):
    """One SCF iteration over the energy contour: returns the new density
    (n,) float32 and the number of singular factorisations (a 0-d device
    tensor).  ``power``: a ``PowerManager`` whose phase brackets each
    task (the block runs under the task's cap; a ``MeteredPowerManager``
    also measures it)."""
    device = positions.device
    energies = torch.from_numpy(contour(cfg)).to(device)
    density = torch.zeros((cfg.n_atoms,), dtype=torch.float32,
                          device=device)
    singular = torch.zeros((), dtype=torch.int64, device=device)
    nb, m = cfg.nb, cfg.liz * cfg.nb
    for energy in energies:
        with _phase(power, "buildKKRMatrix"):
            g0, t_blocks = kkr_structure(cfg, positions, t_diag, energy)
        with _phase(power, "zgemm"):
            A = kkr_zgemm(t_blocks, g0)
        del g0
        with _phase(power, "getrf"):
            lu, pivots, info = getrf(A)
        del A
        with _phase(power, "trsm"):
            tau = trsm(lu, pivots, tau_rhs(t_blocks, m))[:, :nb, :]
        del lu
        singular = singular + (info != 0).sum()
        dos = -torch.diagonal(tau, dim1=1, dim2=2).sum(-1).imag / math.pi
        density = density + dos
    return density / cfg.e_points, singular


def host_mix(density, new_density, alpha=0.3, *, singular=None):
    """Host-side density mixing (the 'gpu compute idle' phase): both
    densities go to the host, are mixed in numpy and come back.  The copy
    to the host waits for the card, so ``singular`` (``scf_step``'s count)
    is checked here at no extra wait: a zero pivot raises."""
    d = density.cpu().numpy()
    nd = new_density.cpu().numpy()
    if singular is not None and int(singular):
        raise RuntimeError(f"LSMS: {int(singular)} KKR matrices had a zero "
                           "pivot in getrf")
    return torch.from_numpy((1 - alpha) * d + alpha * nd).to(
        new_density.device)


def _positions(cfg, generator, positions, device):
    dev = resolve_device(device)
    if positions is not None:
        if not isinstance(positions, torch.Tensor):
            positions = torch.from_numpy(np.array(positions, np.float32))
        return positions.to(dev, torch.float32)
    if generator is None:
        raise ValueError("run_scf needs a generator or positions")
    return make_positions(cfg, generator, dev)


def scf_iterations(cfg: LsmsConfig, generator=None, *, positions=None,
                   device="cuda", power=None):
    """``run_scf``'s loop, yielding the mixed density after each
    iteration, when the card has finished it and idles (``host_mix``
    waited for it)."""
    positions = _positions(cfg, generator, positions, device)
    t_diag = initial_t(cfg, positions.device)
    density = torch.zeros((cfg.n_atoms,), dtype=torch.float32,
                          device=positions.device)
    for _ in range(cfg.scf_iters):
        new_density, singular = scf_step(cfg, positions, t_diag,
                                         power=power)
        with _phase(power, "gpu_compute_idle"):
            density = host_mix(density, new_density, singular=singular)
        yield density
        scale = (1.0 + 0.05 * torch.tanh(density)).to(torch.complex64)
        t_diag = t_diag * scale[:, None, None]


def run_scf(cfg: LsmsConfig, generator=None, *, positions=None,
            device="cuda", power=None):
    """The SCF loop on ``device``: positions from ``generator`` (a
    ``torch.Generator`` on that device) or given (a tensor or a numpy
    array, e.g. the reference's ``make_positions``).  Returns the
    density, (n_atoms,) float32."""
    for density in scf_iterations(cfg, generator, positions=positions,
                                  device=device, power=power):
        pass
    return density


def task_calls(cfg: LsmsConfig, positions) -> dict[str, Callable]:
    """One call of each task at the shapes of one energy point (the first
    of the contour) of the first SCF iteration, on inputs made once on
    ``positions``' device: name -> a function of no arguments, for
    timing a task alone.  Each call does exactly what the loop's call
    does; its result is dropped."""
    t_diag = initial_t(cfg, positions.device)
    energy = torch.from_numpy(contour(cfg)).to(positions.device)[0]
    g0, t_blocks = kkr_structure(cfg, positions, t_diag, energy)
    A = kkr_zgemm(t_blocks, g0)
    lu, pivots, _ = getrf(A)
    density = torch.zeros((cfg.n_atoms,), dtype=torch.float32,
                          device=positions.device)
    new_density = torch.ones_like(density)
    return {
        "buildKKRMatrix": lambda: kkr_structure(cfg, positions, t_diag,
                                                energy),
        # kkr_zgemm writes A over its own product: g0 is only read
        "zgemm": lambda: kkr_zgemm(t_blocks, g0),
        "getrf": lambda: getrf(A),
        "trsm": lambda: trsm(lu, pivots, tau_rhs(t_blocks, A.shape[-1])),
        "gpu_compute_idle": lambda: host_mix(density, new_density),
    }


# ===========================================================================
# the tasks' work and the measured task mix
# ===========================================================================

def lsms_task_counts(cfg: LsmsConfig) -> dict:
    """Per call of each task: real flops and HBM bytes from the shapes
    (a complex multiply-add is 8 real flops, a complex multiply 6; each
    input read once, each output written once), the calls in one
    ``run_scf``, and the least time an H100 could take, the larger of
    bytes over its HBM rate (3.35 TB/s) and flops over its float32 rate
    (67 TFLOP/s: complex64 runs outside the tensor cores, TF32 off).

      buildKKRMatrix  G0 written (one complex multiply an entry)
      zgemm           G0 read, tG0 (A) written; nb multiply-adds an entry
      getrf           A read, LU written; (1/3) m^3 multiply-adds an atom
      trsm            LU, rhs read, tau written; m^2 multiply-adds a
                      column of the nb right-hand sides
      gpu_compute_idle  no device work (two n-float copies over PCIe)
    """
    n, liz, nb = cfg.n_atoms, cfg.liz, cfg.nb
    m = liz * nb
    c8 = 8                                    # bytes of a complex64
    entries = n * m * m                       # of G0, tG0, A and LU
    t_bytes = n * liz * nb * nb * c8          # the members' t blocks
    rhs = n * m * nb * c8
    pivots = n * m * 4
    counts = {
        "buildKKRMatrix": (6.0 * entries, entries * c8 + t_bytes + n * 12),
        "zgemm": (8.0 * nb * entries, 2 * entries * c8 + t_bytes),
        "getrf": (8.0 / 3.0 * m ** 3 * n, 2 * entries * c8 + pivots),
        "trsm": (8.0 * m * m * nb * n, entries * c8 + pivots + 2 * rhs),
        "gpu_compute_idle": (0.0, 0.0),
    }
    calls = cfg.e_points * cfg.scf_iters
    out = {}
    for name, (flops, nbytes) in counts.items():
        t_ops = flops / PEAK_FLOPS_F32
        t_bytes_s = nbytes / H100_CHIP.hbm_bandwidth
        out[name] = {
            "flops": flops, "bytes": float(nbytes),
            "calls": cfg.scf_iters if name == "gpu_compute_idle" else calls,
            "bound_s": max(t_ops, t_bytes_s),
            "bound_by": ("operations" if t_ops > t_bytes_s else "bytes")
            if flops or nbytes else "none"}
    return out


def measured_lsms_tasks(seconds_per_call: dict[str, float],
                        calls: dict[str, int], cfg: LsmsConfig,
                        spec: SuperchipSpec = H100_SUPERCHIP) -> list[Task]:
    """The card's counterpart of ``paper_calibrated_tasks``: the task mix
    from seconds per call measured on the card, by the reference's own
    recipe (``compute_task``/``memory_task``), with each task's
    memory/compute time ratio taken from ``lsms_task_counts`` on the
    card's roofline in place of the paper's guesses.

    The ratio is the H100's whatever ``spec`` is; the recipe converts
    it with ``spec.chip``'s rates.  It takes the measured seconds as the
    time at full clock; on
    a spec whose default cap throttles a busy task (the H100's 700 W is
    below its modelled peak draw) each task's work is then scaled by the
    measured over the modelled seconds at ``spec.p_default``, so that
    ``simulate_task`` at the default cap gives the measured seconds (the
    clock the model picks depends on the ratio only, not the scale)."""
    peak, bw = spec.chip.peak_flops_bf16, spec.chip.hbm_bandwidth
    counts = lsms_task_counts(cfg)
    tasks = []
    for name in TASKS:
        if name not in seconds_per_call:
            continue
        k, per = calls[name], seconds_per_call[name]
        c = counts[name]
        if name == "gpu_compute_idle":
            task = Task(name, flops=0.0, hbm_bytes=0.0, calls=k,
                        host_seconds=per)
        else:
            t_ops = c["flops"] / PEAK_FLOPS_F32
            t_mem = c["bytes"] / H100_CHIP.hbm_bandwidth
            if t_ops >= t_mem:          # compute_task(name, s, k, t_mem/t_ops)
                task = Task(name, flops=peak * per,
                            hbm_bytes=t_mem / t_ops * bw * per, calls=k)
            else:                       # memory_task(name, s, k, t_ops/t_mem)
                task = Task(name, flops=t_ops / t_mem * peak * per,
                            hbm_bytes=bw * per, calls=k)
        modelled = simulate_task(task, spec.p_default, spec).runtime
        scale = per * k / modelled
        tasks.append(dataclasses.replace(
            task, flops=task.flops * scale,
            hbm_bytes=task.hbm_bytes * scale,
            host_seconds=task.host_seconds * scale))
    return tasks


# ===========================================================================
# measured on the card
# ===========================================================================

def metered_scf(meter, cfg: LsmsConfig, positions, *, power=None):
    """``scf_iterations`` on ``positions``' device (the card) from an idle
    card, each iteration's wall seconds and joules read on ``meter``'s
    energy counter (``NvmlBackend``) where ``host_mix`` has waited for
    the card.  Returns the density and one ``{"seconds", "joules"}`` per
    iteration."""
    torch.cuda.synchronize()
    e0, t0 = meter.energy_mj(), time.perf_counter()
    iters = []
    for density in scf_iterations(cfg, positions=positions,
                                  device=positions.device, power=power):
        e1, t1 = meter.energy_mj(), time.perf_counter()
        iters.append({"seconds": t1 - t0, "joules": (e1 - e0) / 1e3})
        e0, t0 = e1, t1
    return density, iters


def measure_table1(card, cfg: LsmsConfig, positions) -> dict:
    """The paper's Table 1 measured on the card: each task of
    ``task_calls`` timed alone on the energy counter of ``card`` (a
    ``power.nvml.CardPower``) over windows of at least
    ``metered.WINDOW_S`` (``metered_windows``), at the limit in force
    and, where the card takes limit writes, at every other cap of its
    spec's sweep, each after ``metered.SETTLE_S`` (the limit put back
    after).  Returns

      ``caps``          the caps measured, the limit in force first;
      ``windows``       cap -> task -> the ``metered_windows`` window;
      ``rows``          task -> the window at the limit in force with the
                        task's ``lsms_task_counts`` and its seconds and
                        joules over one ``run_scf`` (``run_s``, ``run_j``);
      ``tasks``         ``measured_lsms_tasks`` of those seconds on
                        ``card.spec``: the measured task mix;
      ``measurements``  one ``TaskMeasurement`` per task and cap, over
                        one run.
    """
    nvml = card.nvml
    limit = nvml.limit_w()
    caps = [limit]
    if card.writable:
        caps += [c for c in sorted(card.spec.cap_sweep(), reverse=True)
                 if c != limit]
    counts = lsms_task_counts(cfg)
    calls = task_calls(cfg, positions)
    windows = {}
    try:
        for cap in caps:
            if cap != limit:
                nvml.apply(cap)
                time.sleep(metered.SETTLE_S)
            windows[cap] = metered.metered_windows(calls, nvml)
    finally:
        if card.writable:
            nvml.apply(limit)
    del calls
    rows = {t: dict(w, **counts[t],
                    run_s=w["s_per_call"] * counts[t]["calls"],
                    run_j=w["j_per_call"] * counts[t]["calls"])
            for t, w in windows[limit].items()}
    tasks = measured_lsms_tasks(
        {t: r["s_per_call"] for t, r in rows.items()},
        {t: r["calls"] for t, r in rows.items()}, cfg, card.spec)
    measurements = [
        TaskMeasurement(t, cap, w["s_per_call"] * counts[t]["calls"],
                        w["j_per_call"] * counts[t]["calls"])
        for cap, ws in windows.items() for t, w in ws.items()]
    return {"caps": caps, "windows": windows, "rows": rows, "tasks": tasks,
            "measurements": measurements}


# ===========================================================================
# paper-calibrated task mix (a copy of the reference's)
# ===========================================================================

def paper_calibrated_tasks(chip: ChipSpec = DEFAULT_CHIP) -> list[Task]:
    """The paper's Table-1 task mix, re-scaled to the modeled chip.

    For each task we choose (flops, hbm_bytes) so that at the DEFAULT cap the
    runtime matches the paper's measured seconds and the roofline
    boundedness matches the paper's characterization.  Invocation counts are
    the paper's.  The memory/compute TIME RATIO encodes how deep the clock
    can drop before runtime suffers (the paper's compute-vs-memory capping
    asymmetry):
      zgemm64   strongly compute-bound (mem ratio 0.25) -> optimum near max
      zgemm32   compute-bound, smaller tiles (0.55)
      getrf     pivoting is access-limited (0.80)       -> mid-range optimum
      trsm      memory-bound (compute ratio 0.70)
      buildKKR  memory-bound (compute ratio 0.30)       -> low optimum
      idle      host-only density mixing between SCF iterations -> floor
    """
    peak, bw = chip.peak_flops_bf16, chip.hbm_bandwidth

    def compute_task(name, seconds, calls, mem_ratio):
        return Task(name, flops=peak * seconds / calls,
                    hbm_bytes=mem_ratio * bw * seconds / calls, calls=calls)

    def memory_task(name, seconds, calls, comp_ratio):
        return Task(name, flops=comp_ratio * peak * seconds / calls,
                    hbm_bytes=bw * seconds / calls, calls=calls)

    return [
        compute_task("zgemm_ts64", 77.89, 21632, 0.25),
        memory_task("buildKKRMatrix", 34.90, 128, 0.30),
        memory_task("zgemm_ts32", 8.03, 94208, 0.90),
        memory_task("getrf_pivot_1", 4.07, 16384, 0.80),
        memory_task("getrf_pivot_2", 4.07, 30720, 0.85),
        memory_task("trsm_left", 3.57, 150272, 0.70),
        memory_task("getrf_pivot_3", 1.82, 8192, 0.85),
        Task("gpu_compute_idle", flops=0.0, hbm_bytes=0.0, calls=601345,
             host_seconds=8.83 / 601345),
    ]


def scf_phase_sequence(chip: ChipSpec = DEFAULT_CHIP) -> list[Task]:
    """Fig-1-style phase sequence: two SCF iterations, idle gaps between."""
    tasks = {t.name: t for t in paper_calibrated_tasks(chip)}

    def half(name, frac=0.5):
        t = tasks[name]
        return dataclasses.replace(t, calls=max(int(t.calls * frac), 1))

    iteration = [half("buildKKRMatrix"), half("zgemm_ts64"),
                 half("zgemm_ts32"), half("getrf_pivot_1"),
                 half("getrf_pivot_2"), half("getrf_pivot_3"),
                 half("trsm_left")]
    idle = half("gpu_compute_idle")
    return iteration + [idle] + iteration + [idle]
