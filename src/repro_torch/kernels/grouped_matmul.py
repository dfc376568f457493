"""Wrapper of the hand-written CUDA kernel that replaces the Pallas TPU
kernel of ``repro/kernels/grouped_matmul.py`` on the MoE path.

  grouped_matmul      csrc/grouped_matmul.cu
                      (TPU: grouped_matmul, _gmm_kernel)

Given CPU tensors it runs the plain PyTorch version
(``ref.grouped_matmul``); given CUDA tensors it checks device, dtype,
shape, contiguity and alignment, allocates the output, launches the
kernel on the current stream and raises if the launch returns a CUDA
error.  There is no other path.  It counts its launches in
``grouped_matmul.launches``.

The kernel has no backward yet (nor has the Pallas kernel a VJP): on CUDA
a call that autograd would have to differentiate raises
``NotImplementedError`` naming ROADMAP queue 1 item 16 (MoE training on
the card).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref


def grouped_matmul(lhs, rhs):
    """lhs: (G, M, K), rhs: (G, K, N) -> (G, M, N) in lhs's dtype, the
    products summed in float32 and rounded once.  On CUDA: float32 or
    bfloat16 (lhs and rhs alike), M >= 1, K and N multiples of 8,
    contiguous and 16-byte aligned."""
    if not lhs.is_cuda:
        return ref.grouped_matmul(lhs, rhs)
    if torch.is_grad_enabled() and (lhs.requires_grad or rhs.requires_grad):
        raise NotImplementedError(
            "grouped_matmul has no backward kernel yet (dlhs = dout rhs^T, "
            "drhs = lhs^T dout): MoE training on the card is ROADMAP queue "
            "1 item 16")
    if lhs.dtype not in build.DTYPE_CODE or rhs.dtype != lhs.dtype:
        raise TypeError(f"grouped_matmul: dtypes {lhs.dtype} x {rhs.dtype} "
                        "not supported (float32 or bfloat16, both alike)")
    if lhs.ndim != 3 or rhs.ndim != 3 or rhs.shape[0] != lhs.shape[0] \
            or rhs.shape[1] != lhs.shape[2]:
        raise ValueError(f"grouped_matmul: shapes lhs {tuple(lhs.shape)}, "
                         f"rhs {tuple(rhs.shape)}")
    G, M, K = lhs.shape
    N = rhs.shape[2]
    if G < 1 or M < 1 or K % 8 or N % 8 or K < 8 or N < 8:
        raise ValueError(f"grouped_matmul: G={G}, M={M}, K={K}, N={N}; the "
                         "kernel takes G, M >= 1 and K, N multiples of 8")
    build.check_cuda("grouped_matmul", lhs.device, lhs=lhs, rhs=rhs)
    out = torch.empty((G, M, N), dtype=lhs.dtype, device=lhs.device)
    err = build.library("grouped_matmul").grouped_matmul(
        lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(), G, M, K, N,
        build.DTYPE_CODE[lhs.dtype],
        torch.cuda.current_stream(lhs.device).cuda_stream)
    build.raise_on("grouped_matmul", err)
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
