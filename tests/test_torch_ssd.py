"""The bf16 ``ssd`` kernel's numerics on the CPU, against the JAX package.

``ref.ssd_tc_emulated`` is the tensor-core kernel's arithmetic: the scores
C B^T from the bf16 inputs, and the three f32 operands the kernel hands to
the tensor cores -- the masked M, the carried state and x o wd -- as bf16
parts.  At mamba2's and zamba2's heads, at a 256-row prefill chunk and at
the tails a prompt's chunk plan produces, two parts meet the per-entry
rule ``chip_smoke.py`` holds the kernel to (y: one bf16 ulp, the final
state: the float32 rule) against the port's ``ref.ssd_chunked``, the JAX
``ssd_chunked`` and the Pallas ``ssd`` in interpret mode; one part (the
shortcut) breaks it.  The CUDA kernel itself is checked on the card by
``chip_smoke.py``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd import ssd as jssd  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402

# chip_smoke.py's per-entry rule: |got - want| <= RTOL |want| + ATOL
# max|want|, y in bf16 (one bf16 ulp), the final state in float32
RTOL = {"y": 2 ** -7, "state": 1e-5}
ATOL = 1e-5

#: (H, P, N) of each Mamba-2 model's heads (G = 1)
HEADS = {"mamba2": (32, 64, 128), "zamba2": (64, 64, 64)}
#: (S, chunk): a 256-row prefill chunk (two kernel chunks, the state
#: carried), a 64-row and the smallest tails of ``chunk_plan``, and a
#: whole-prompt chunk that is no power of two (S = 4 x 37)
SIZES = [(256, 128), (64, 64), (8, 8), (2, 2), (148, 37)]
REFS = ["torch", "jax", "pallas"]


@functools.lru_cache(maxsize=None)
def _inputs(model, S):
    """x, dt, B, C in bf16 and A, D, h0 in float32, from a seeded numpy
    draw.  dt = softplus(N(-3, 1)) (~0.05, a decay of ~5 % a row), so the
    carried state reaches every row of a chunk."""
    H, P, N = HEADS[model]
    rng = np.random.default_rng(S + H + N)
    return {
        "x": rng.standard_normal((1, S, H, P)).astype(np.float32),
        "dt": np.log1p(np.exp(rng.standard_normal((1, S, H)) - 3.0))
        .astype(np.float32),
        "A": (-np.exp(0.5 * rng.standard_normal(H))).astype(np.float32),
        "B": rng.standard_normal((1, S, 1, N)).astype(np.float32),
        "C": rng.standard_normal((1, S, 1, N)).astype(np.float32),
        "D": rng.standard_normal(H).astype(np.float32),
        "h0": rng.standard_normal((1, H, P, N)).astype(np.float32)}


def _torch_args(model, S, with_D):
    a = _inputs(model, S)
    bf = {k: torch.from_numpy(a[k]).bfloat16() for k in ("x", "dt", "B", "C")}
    return (bf["x"], bf["dt"], torch.from_numpy(a["A"]), bf["B"], bf["C"],
            torch.from_numpy(a["D"]) if with_D else None,
            torch.from_numpy(a["h0"]))


@functools.lru_cache(maxsize=None)
def _want(reference, model, S, Q):
    """(y, final state) of ``reference`` on the seeded inputs.  The Pallas
    wrapper rounds y, adds D and rounds again, so its case runs without D
    (the kernel's own result, rounded once); the others fuse D and round
    once, as the CUDA kernel does.  The port's plain version sums in
    float64 from the same bf16 inputs, y then rounded once to bf16: a
    float32 reference moves with the host's BLAS, and its own error would
    count against the emulation."""
    if reference == "torch":
        y, st = ref.ssd_chunked(*(a if a is None else a.double()
                                  for a in _torch_args(model, S, True)),
                                chunk=Q)
        return y.bfloat16(), st
    a = _inputs(model, S)
    bf = {k: jnp.asarray(a[k], jnp.bfloat16) for k in ("x", "dt", "B", "C")}
    args = (bf["x"], bf["dt"], jnp.asarray(a["A"]), bf["B"], bf["C"])
    if reference == "jax":
        y, st = jref.ssd_chunked(*args, jnp.asarray(a["D"]),
                                 jnp.asarray(a["h0"]), chunk=Q)
    else:
        y, st = jssd(*args, None, jnp.asarray(a["h0"]), chunk=Q,
                     interpret=True)
    return (torch.from_numpy(np.array(y.astype(jnp.float32))),
            torch.from_numpy(np.array(st)))


def _worst_over_rule(reference, model, S, Q, parts):
    """The emulation's worst y and state entry, each over its limit."""
    got = ref.ssd_tc_emulated(
        *_torch_args(model, S, reference != "pallas"), chunk=Q, parts=parts)
    worst = {}
    for name, g, w in zip(("y", "state"), got, _want(reference, model, S, Q)):
        g, w = g.float(), w.float()
        limit = RTOL[name] * w.abs() + ATOL * w.abs().max()
        worst[name] = ((g - w).abs() / limit).max().item()
    return worst


@pytest.mark.parametrize("S,Q", SIZES, ids=[f"S{s}-Q{q}" for s, q in SIZES])
@pytest.mark.parametrize("model", list(HEADS))
@pytest.mark.parametrize("reference", REFS)
def test_ssd_split_hi_lo_meets_the_rule(reference, model, S, Q):
    """M, the state and x o wd as hi = bf16(v) and lo = bf16(v - hi), one
    f32 product each (the kernel's design): every y entry within one bf16
    ulp and every state entry within the float32 rule."""
    worst = _worst_over_rule(reference, model, S, Q, parts=2)
    assert worst["y"] <= 1 and worst["state"] <= 1, worst


@pytest.mark.parametrize("S,Q", SIZES, ids=[f"S{s}-Q{q}" for s, q in SIZES])
@pytest.mark.parametrize("model", list(HEADS))
@pytest.mark.parametrize("reference", REFS)
def test_ssd_operands_rounded_to_bf16_break_the_rule(reference, model, S, Q):
    """The same three operands rounded to bf16 once put y entries beyond
    one bf16 ulp and state entries far beyond the float32 rule: the
    per-entry rule rejects the shortcut."""
    worst = _worst_over_rule(reference, model, S, Q, parts=1)
    assert worst["y"] > 2 and worst["state"] > 2, worst


def test_the_emulation_with_exact_operands_is_the_plain_version():
    """With three parts each operand is carried to ~2^-24 of itself, and
    the emulation is the plain ``ssd_chunked`` up to f32 summation order:
    the chunk walk, the masking and the state carried between chunks are
    the same function."""
    args = _torch_args("zamba2", 256, True)
    y32 = [a.float() if a is not None and a.dtype == torch.bfloat16 else a
           for a in args]
    got_y, got_s = ref.ssd_tc_emulated(*y32, chunk=128, parts=3)
    want_y, want_s = ref.ssd_chunked(*y32, chunk=128)
    for g, w in ((got_y, want_y), (got_s, want_s)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * w.abs().max().item())


def test_ptxas_report_reads_registers_and_spills(monkeypatch):
    """``build.kernel_resources`` (the registers ``chip_smoke.py`` prints
    for each kernel) reads ``ptxas -v``'s report of a build: each entry
    function's registers and spilled bytes, under the name ``demangle``
    gives its symbol (``cu++filt``, which ships with nvcc only)."""
    tc = ("_ZN33_GLOBAL__N__025e8cd1_6_ssd_cu_ssd13ssd_tc_kernelILi128ELi64EE"
          "Ev14CUtensorMap_stS1_S1_PK13__nv_bfloat16PKfS6_S6_PS2_Pfiiiiii")
    cc = ("_ZN33_GLOBAL__N__025e8cd1_6_ssd_cu_ssd10ssd_kernelEPKfS1_S1_S1_"
          "S1_S1_S1_PfS2_iiiiii")
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{tc}' for 'sm_90a'",
        f"ptxas info    : Function properties for {tc}",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 199 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{cc}' for 'sm_90a'",
        f"ptxas info    : Function properties for {cc}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 115 registers, used 1 barriers"])
    names = {tc: "<unnamed>::ssd_tc_kernel<(int)128, (int)64>",
             cc: "<unnamed>::ssd_kernel"}
    monkeypatch.setattr(build, "_logs", {"ssd": log})
    monkeypatch.setattr(build, "demangle",
                        lambda syms: [names[s] for s in syms])
    assert build.kernel_resources() == {
        "<unnamed>::ssd_tc_kernel<(int)128, (int)64>": {
            "registers": 199, "spill_stores": 8, "spill_loads": 4},
        "<unnamed>::ssd_kernel": {"registers": 115, "spill_stores": 0,
                                  "spill_loads": 0}}
