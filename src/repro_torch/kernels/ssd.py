"""Wrappers of the hand-written CUDA kernels of the Mamba-2 path: the
chunked scan that replaces the Pallas TPU kernel of ``repro/kernels/ssd.py``,
and its gradient.

  ssd                 csrc/ssd.cu
                      (TPU: ssd, _ssd_kernel)
  ssd_bwd             csrc/ssd_bwd.cu
                      (TPU: none; the JAX package differentiates
                      ssd_chunked with XLA)

Given CPU tensors each runs its plain PyTorch version (``ref.ssd_chunked``,
``ref.ssd_chunked_bwd``); given CUDA tensors it checks device, dtype,
shape, contiguity and alignment, allocates the outputs, launches the
kernel on the current stream and raises if the launch returns a CUDA
error.  There is no other path.  Each counts its calls in
``<wrapper>.launches`` (the rule at ``flash_attention.KERNELS``): an
``ssd`` call is one kernel; an ``ssd_bwd`` call is three in bf16 (each
chunk's state products, the scans across chunks, the chunk pass:
``ssd_bwd_states_tc_kernel``, ``ssd_bwd_scan_kernel``,
``ssd_bwd_chunk_tc_kernel``, every product on ``wgmma``, which
``ref.ssd_bwd_tc_emulated`` repeats on the CPU) and two in float32 (the
states, then the chunk pass, on the CUDA cores).

bf16 runs on the tensor cores (``ssd_tc_kernel``: the scores C B^T, the
masked product M x, C state^T and the state update on ``wgmma``, with M,
the carried state and x o wd handed over as two bf16 parts each, which
``ref.ssd_tc_emulated`` repeats on the CPU); float32, the parity path,
runs on the CUDA cores (``ssd_kernel``).  Every chunk from 1 to 128 rows
takes the same kernel of its dtype.

The kernel adds the ``D`` skip in float32 and rounds y once, as
``ssd_chunked`` does (the Pallas wrapper rounded y, added ``D`` and
rounded again).  The final state may be written over ``h0`` itself
(``state_out=h0``): the serving cache keeps each slot's state as one
contiguous (H, P, N) float32 lane, updated in place.

A call that autograd will differentiate goes through ``SSD``: its
forward is ``ssd``'s launch (no per-chunk state is kept: the serving path
pays nothing for training) and its backward one ``ssd_bwd`` launch, which
recomputes the states entering the chunks and gives dx, ddt, dA, dB, dC,
dD and dh0 from dy and the final state's gradient.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref


def _check(x, dt, A, B, C, D, h0, state_out, chunk):
    Bb, S, H, P = x.shape
    if x.dtype not in build.DTYPE_CODE or any(
            t.dtype != x.dtype for t in (dt, B, C)):
        raise TypeError(f"ssd: x, dt, B, C dtypes {x.dtype}, {dt.dtype}, "
                        f"{B.dtype}, {C.dtype}; the kernel takes float32 or "
                        "bfloat16, all alike")
    if any(t is not None and t.dtype != torch.float32
           for t in (A, D, h0, state_out)):
        raise TypeError("ssd: A, D, h0 and state_out must be float32")
    if B.ndim != 4 or C.shape != B.shape or tuple(B.shape[:2]) != (Bb, S) \
            or tuple(dt.shape) != (Bb, S, H) or tuple(A.shape) != (H,) \
            or (D is not None and tuple(D.shape) != (H,)) \
            or H % B.shape[2]:
        raise ValueError(f"ssd: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    N = B.shape[3]
    for name, t in (("h0", h0), ("state_out", state_out)):
        if t is not None and tuple(t.shape) != (Bb, H, P, N):
            raise ValueError(f"ssd: {name} shape {tuple(t.shape)}, expected "
                             f"{(Bb, H, P, N)}")
    if chunk < 1 or chunk > 128 or S % chunk:
        raise ValueError(f"ssd: chunk {chunk} for S={S}; the kernel takes a "
                         "chunk from 1 to 128 that divides S")
    if P % 16 or N % 32 or N > 128 or H > 65535:
        raise ValueError(f"ssd: H={H}, P={P}, N={N}; the kernel takes P a "
                         "multiple of 16 and N a multiple of 32 up to 128")


def _launch(x, dt, A, B, C, D, h0, chunk, state_out):
    if not x.is_cuda:
        y, state = ref.ssd_chunked(x, dt, A, B, C, D=D, h0=h0, chunk=chunk)
        if state_out is None:
            return y, state
        state_out.copy_(state)
        return y, state_out
    _check(x, dt, A, B, C, D, h0, state_out, chunk)
    opt = {k: t for k, t in (("D", D), ("h0", h0)) if t is not None}
    build.check_cuda("ssd", x.device, x=x, dt=dt, A=A, B=B, C=C, **opt)
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    y = torch.empty_like(x)
    if state_out is None:
        state_out = torch.empty((Bb, H, P, N), dtype=torch.float32,
                                device=x.device)
    build.check_cuda("ssd", x.device, state_out=state_out)
    err = build.library("ssd").ssd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr() if D is not None else None,
        h0.data_ptr() if h0 is not None else None, y.data_ptr(),
        state_out.data_ptr(), Bb, S, H, P, G, N, chunk,
        build.DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.raise_on("ssd", err)
    ssd.launches += 1
    return y, state_out


def ssd(x, dt, A, B, C, D=None, h0=None, *, chunk=128, state_out=None):
    """x: (Bb,S,H,P); dt: (Bb,S,H); A: (H,) float32 (negative); B/C:
    (Bb,S,G,N); D: optional (H,) float32 skip; h0: optional (Bb,H,P,N)
    float32 initial state.  Returns (y (Bb,S,H,P) in x's dtype, the final
    state (Bb,H,P,N) float32); with ``state_out`` the final state is
    written there (it may be ``h0``) and ``state_out`` is returned.
    Differentiable (``SSD``); with ``state_out`` the write into it is an
    autograd-tracked copy of the state, refused if ``state_out`` shares
    storage with an input (``state_out=h0``, the serving cache's in-place
    write, is a no-grad path: the backward reads h0)."""
    inputs = (x, dt, A, B, C, D, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        if state_out is not None and any(
                t is not None and t.untyped_storage().data_ptr()
                == state_out.untyped_storage().data_ptr() for t in inputs):
            raise ValueError(
                "ssd: under autograd state_out must not share storage with "
                "an input (state_out=h0 is the serving path's in-place "
                "write, which runs without grad): the backward reads the "
                "inputs; pass a separate state_out or none")
        y, state = SSD.apply(x, dt, A, B, C, D, h0, chunk)
        if state_out is None:
            return y, state
        state_out.copy_(state)
        return y, state_out
    return _launch(x, dt, A, B, C, D, h0, chunk, state_out)


ssd.launches = 0


def _work_floats(lib, *sizes) -> int:
    """The floats of ``ssd_bwd``'s work buffer, as the library lays it out
    (``ssd_bwd_work_floats``: the bf16 path's dB/dC partials are sized by
    the head slice it picks for the card)."""
    fn = lib.ssd_bwd_work_floats
    fn.argtypes, fn.restype = [ctypes.c_int] * 8, ctypes.c_longlong
    n = fn(*sizes)
    if n < 0:
        raise RuntimeError(f"ssd_bwd: no work size for {sizes}")
    return n


def ssd_bwd(x, dt, A, B, C, D, h0, dy, dstate=None, *, chunk=128):
    """The gradient of ``ssd`` (the one of ``ref.ssd_chunked``) given dy
    (Bb,S,H,P) in x's dtype and the final state's gradient ``dstate``
    (Bb,H,P,N) float32 or None (zero): (dx, ddt, dA, dB, dC, dD, dh0) in
    the dtypes of x, dt, A, B, C, D and h0, dD None without D and dh0
    None without h0.  On CUDA one call runs the ``ssd_bwd`` kernels
    (three in bf16, two in float32; ``ssd_bwd.launches`` counts the
    call), under ``ssd``'s contract with P at most 128."""
    if not x.is_cuda:
        return ref.ssd_chunked_bwd(x, dt, A, B, C, D, h0, dy, dstate,
                                   chunk=chunk)
    _check(x, dt, A, B, C, D, h0, None, chunk)
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if P > 128:
        raise ValueError(f"ssd_bwd: P={P}; the kernel takes P up to 128")
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"ssd_bwd: dy {tuple(dy.shape)} {dy.dtype}, "
                         f"expected {tuple(x.shape)} {x.dtype}")
    if dstate is not None and (dstate.dtype != torch.float32
                               or tuple(dstate.shape) != (Bb, H, P, N)):
        raise ValueError(f"ssd_bwd: dstate {tuple(dstate.shape)} "
                         f"{dstate.dtype}, expected {(Bb, H, P, N)} float32")
    opt = {k: t for k, t in (("D", D), ("h0", h0), ("dstate", dstate))
           if t is not None}
    build.check_cuda("ssd_bwd", x.device, x=x, dt=dt, A=A, B=B, C=C, dy=dy,
                     **opt)
    nc = S // chunk
    dev = x.device
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA = torch.empty((H,), dtype=torch.float32, device=dev)
    dD = torch.empty_like(D) if D is not None else None
    dh0 = torch.empty_like(h0) if h0 is not None else None
    lib = build.library("ssd_bwd")
    floats = _work_floats(lib, Bb, S, H, P, G, N, chunk,
                          build.DTYPE_CODE[x.dtype])
    work = torch.empty((floats,), dtype=torch.float32, device=dev)
    counters = torch.zeros((Bb * nc * G + H,), dtype=torch.int32, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    err = lib.ssd_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), ptr(D), ptr(h0), dy.data_ptr(), ptr(dstate),
        dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
        dC.data_ptr(), ptr(dD), ptr(dh0), work.data_ptr(),
        counters.data_ptr(), Bb, S, H, P, G, N, chunk,
        build.DTYPE_CODE[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on("ssd_bwd", err)
    ssd_bwd.launches += 1
    return dx, ddt, dA, dB, dC, dD, dh0


ssd_bwd.launches = 0


class SSD(torch.autograd.Function):
    """``ssd`` with its gradient: the forward launches ``ssd`` and saves
    its inputs; the backward is one ``ssd_bwd`` launch on them, given dy
    and the final state's gradient (either may be absent).  Under
    ``torch.utils.checkpoint`` the forward runs again in the backward
    pass."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, D, h0)
        ctx.chunk = chunk
        return _launch(x, dt, A, B, C, D, h0, chunk, None)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C, D, h0 = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = ssd_bwd(x, dt, A, B, C, D, h0, dy, dstate, chunk=ctx.chunk)
        return (*grads, None)
