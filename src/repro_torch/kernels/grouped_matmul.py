"""Wrappers of the hand-written CUDA kernels of the MoE path: the grouped
matmul that replaces the Pallas TPU kernel of
``repro/kernels/grouped_matmul.py``, and its gradient.

  grouped_matmul      csrc/grouped_matmul.cu
                      (TPU: grouped_matmul, _gmm_kernel)
  grouped_matmul_bwd  csrc/grouped_matmul_bwd.cu
                      (TPU: none; the JAX package differentiates
                      grouped_matmul_ref with XLA)

Given CPU tensors each runs its plain PyTorch version
(``ref.grouped_matmul``, ``ref.grouped_matmul_bwd``); given CUDA tensors it
checks device, dtype, shape, contiguity and alignment, allocates the
outputs, launches the kernel on the current stream and raises if the
launch returns a CUDA error.  There is no other path.  Each counts its
calls in ``<wrapper>.launches`` (the rule at ``flash_attention.KERNELS``).

A call that autograd will differentiate goes through ``GroupedMatmul``:
its forward is ``grouped_matmul``'s launch and its backward one
``grouped_matmul_bwd`` launch (dlhs = dout rhs^T and drhs = lhs^T dout,
each only where its input needs a gradient).  A call of either wrapper
runs one device kernel, so its count is of kernel launches: a
``grouped_matmul_bwd`` call's grid covers the tiles of both products
(bf16: the wgmma/TMA kernel ``gmm_bwd_tc_kernel``; float32:
``gmm_bwd_f32_kernel``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref


def _check(name, lhs, rhs):
    """The shapes and dtypes the kernels take; returns (G, M, K, N)."""
    if lhs.dtype not in build.DTYPE_CODE or rhs.dtype != lhs.dtype:
        raise TypeError(f"{name}: dtypes {lhs.dtype} x {rhs.dtype} "
                        "not supported (float32 or bfloat16, both alike)")
    if lhs.ndim != 3 or rhs.ndim != 3 or rhs.shape[0] != lhs.shape[0] \
            or rhs.shape[1] != lhs.shape[2]:
        raise ValueError(f"{name}: shapes lhs {tuple(lhs.shape)}, "
                         f"rhs {tuple(rhs.shape)}")
    G, M, K = lhs.shape
    N = rhs.shape[2]
    if G < 1 or M < 1 or K % 8 or N % 8 or K < 8 or N < 8:
        raise ValueError(f"{name}: G={G}, M={M}, K={K}, N={N}; the "
                         "kernel takes G, M >= 1 and K, N multiples of 8")
    return G, M, K, N


def _launch(lhs, rhs):
    if not lhs.is_cuda:
        return ref.grouped_matmul(lhs, rhs)
    G, M, K, N = _check("grouped_matmul", lhs, rhs)
    build.check_cuda("grouped_matmul", lhs.device, lhs=lhs, rhs=rhs)
    out = torch.empty((G, M, N), dtype=lhs.dtype, device=lhs.device)
    err = build.library("grouped_matmul").grouped_matmul(
        lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(), G, M, K, N,
        build.DTYPE_CODE[lhs.dtype],
        torch.cuda.current_stream(lhs.device).cuda_stream)
    build.raise_on("grouped_matmul", err)
    grouped_matmul.launches += 1
    return out


def grouped_matmul(lhs, rhs):
    """lhs: (G, M, K), rhs: (G, K, N) -> (G, M, N) in lhs's dtype, the
    products summed in float32 and rounded once.  On CUDA: float32 or
    bfloat16 (lhs and rhs alike), M >= 1, K and N multiples of 8,
    contiguous and 16-byte aligned.  Differentiable (``GroupedMatmul``)."""
    if torch.is_grad_enabled() and (lhs.requires_grad or rhs.requires_grad):
        return GroupedMatmul.apply(lhs, rhs)
    return _launch(lhs, rhs)


grouped_matmul.launches = 0


def grouped_matmul_bwd(lhs, rhs, dout, *, need_lhs=True, need_rhs=True):
    """The gradient of ``grouped_matmul`` given its cotangent dout (G, M,
    N) in lhs's dtype: (dlhs (G, M, K), drhs (G, K, N)), each product
    summed in float32 and rounded once, None where not wanted.  On CUDA
    one kernel launch computes the wanted ones, under ``grouped_matmul``'s
    contract."""
    if not lhs.is_cuda:
        dlhs, drhs = ref.grouped_matmul_bwd(lhs, rhs, dout)
        return dlhs if need_lhs else None, drhs if need_rhs else None
    G, M, K, N = _check("grouped_matmul_bwd", lhs, rhs)
    if dout.dtype != lhs.dtype or tuple(dout.shape) != (G, M, N):
        raise ValueError(f"grouped_matmul_bwd: dout {tuple(dout.shape)} "
                         f"{dout.dtype}, expected {(G, M, N)} {lhs.dtype}")
    build.check_cuda("grouped_matmul_bwd", lhs.device, lhs=lhs, rhs=rhs,
                     dout=dout)
    dlhs = torch.empty_like(lhs) if need_lhs else None
    drhs = torch.empty_like(rhs) if need_rhs else None
    if dlhs is None and drhs is None:
        return None, None
    err = build.library("grouped_matmul_bwd").grouped_matmul_bwd(
        lhs.data_ptr(), rhs.data_ptr(), dout.data_ptr(),
        dlhs.data_ptr() if dlhs is not None else None,
        drhs.data_ptr() if drhs is not None else None, G, M, K, N,
        build.DTYPE_CODE[lhs.dtype],
        torch.cuda.current_stream(lhs.device).cuda_stream)
    build.raise_on("grouped_matmul_bwd", err)
    grouped_matmul_bwd.launches += 1
    return dlhs, drhs


grouped_matmul_bwd.launches = 0


class GroupedMatmul(torch.autograd.Function):
    """``grouped_matmul`` with its gradient: the forward saves lhs and rhs
    and launches ``grouped_matmul``; the backward is one
    ``grouped_matmul_bwd`` launch on them.  Under ``torch.utils.checkpoint``
    the forward runs again in the backward pass."""

    @staticmethod
    def forward(ctx, lhs, rhs):
        ctx.save_for_backward(lhs, rhs)
        return _launch(lhs, rhs)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs = ctx.saved_tensors
        return grouped_matmul_bwd(lhs, rhs, dout.contiguous(),
                                  need_lhs=ctx.needs_input_grad[0],
                                  need_rhs=ctx.needs_input_grad[1])
