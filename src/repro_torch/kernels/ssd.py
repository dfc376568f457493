"""Wrapper of the hand-written CUDA kernel that replaces the Pallas TPU
kernel of ``repro/kernels/ssd.py`` on the Mamba-2 path.

  ssd                 csrc/ssd.cu
                      (TPU: ssd, _ssd_kernel)

Given CPU tensors it runs the plain PyTorch version (``ref.ssd_chunked``);
given CUDA tensors it checks device, dtype, shape, contiguity and
alignment, allocates the outputs, launches the kernel on the current
stream and raises if the launch returns a CUDA error.  There is no other
path.  It counts its launches in ``ssd.launches``.

The kernel adds the ``D`` skip in float32 and rounds y once, as
``ssd_chunked`` does (the Pallas wrapper rounded y, added ``D`` and
rounded again).  The final state may be written over ``h0`` itself
(``state_out=h0``): the serving cache keeps each slot's state as one
contiguous (H, P, N) float32 lane, updated in place.

The kernel has no backward yet (nor has the Pallas kernel a VJP; JAX
training differentiates ``ssd_chunked``): on CUDA a call that autograd
would have to differentiate raises ``NotImplementedError`` naming ROADMAP
queue 1 item 17 (SSM training on the card).
"""

from __future__ import annotations

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


def ssd(x, dt, A, B, C, D=None, h0=None, *, chunk=128, state_out=None):
    """x: (Bb,S,H,P); dt: (Bb,S,H); A: (H,) float32 (negative); B/C:
    (Bb,S,G,N); D: optional (H,) float32 skip; h0: optional (Bb,H,P,N)
    float32 initial state.  Returns (y (Bb,S,H,P) in x's dtype, the final
    state (Bb,H,P,N) float32); with ``state_out`` the final state is
    written there (it may be ``h0``) and ``state_out`` is returned."""
    if not x.is_cuda:
        y, state = ref.ssd_chunked(x, dt, A, B, C, D=D, h0=h0, chunk=chunk)
        if state_out is None:
            return y, state
        state_out.copy_(state)
        return y, state_out
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, B, C, D, h0)):
        raise NotImplementedError(
            "ssd has no backward kernel yet: SSM training on the card is "
            "ROADMAP queue 1 item 17")
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


ssd.launches = 0
