"""PyTorch/CUDA port of the ``repro`` package for an NVIDIA H100.

Module names mirror ``repro`` so each counterpart is easy to find.  The
port imports ``torch`` and never ``jax``, and nothing of ``repro``: what
it needs from framework-free modules there is copied here.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; on the CPU the
kernel wrappers take their plain PyTorch versions, on a CUDA tensor they
launch the hand-written kernels in ``kernels/csrc``.
"""
