#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one card: ``python3 chip_smoke.py``.

Phases (any failure raises and exits non-zero; no phase's failure is
caught):

  0. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (timed);
  1. the card: ``torch.cuda.get_device_name`` and nvidia-smi's name and
     power limit;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (B=8, S=2048, H=24, K=8, D=128; Sq 1, 5 and 256;
     ragged kv_len with one done lane; also the reduced configs' D=32),
     bf16 and f32 (TF32 off), with stated tolerances; the paged kernels
     over a (1025, 16, 8, 128) pool whose tables are scattered by a seeded
     permutation (free tail entries on the parking block), the paged
     attention also against the dense kernel over the gathered cache (must
     be equal, bit for bit); then kernel (device time, from a CUDA graph),
     plain-version and library times beside the card's least possible time
     (the bound), at decode and at a 256-row prefill chunk; the
     cache-free attention forward and backward against
     ``attention_naive`` (with its lse) and ``attention_bwd_ref`` entry by
     entry (the training shape B=2, S=2048, and D=32; causal, window +
     softcap, bidirectional, odd lengths, Sq != Sk; bf16 and f32), the
     same checks shown to reject kernels that drop one tile of the bf16
     kernels' sizes and the plain version with P and dS rounded to bf16
     once (the shortcut the hi/lo split avoids), then timed at the
     training shape beside SDPA and its autograd backward;
     the four decode and cache kernels also at olmoe's H = K = 16 (one
     query head per kv head), checked and timed; ``grouped_matmul``
     against ``ref.grouped_matmul`` entry by entry at the olmoe path's
     shapes (G=64; capacity 2 at decode, 40 at a 256-row chunk; odd
     capacities 1, 3, 5, 100) and the reduced configs', bf16 and f32,
     the check shown to reject a kernel that drops the last 64-wide
     K-slice or the last group, then timed beside ``torch.bmm``; the
     four decode and cache kernels at zamba2's H = K = 32, D = 64,
     checked (paged == dense bit for bit) and timed; ``ssd`` against
     ``ref.ssd_chunked`` entry by entry at mamba2's (H=32, P=64, N=128)
     and zamba2's (H=64, P=64, N=64) heads, S 256 (two chunks), 128, 64,
     16 and 2, with and without h0, G=2 once, the state written over h0
     once, chunks 37 (S=148) and 1 (S=131) at mamba2's heads, bf16 and
     f32, the check shown to reject a kernel that drops
     h0 or the state carried between chunks, then timed at S=256 beside
     its byte bound (no library call computes SSD);
  3. the main path: full-width llama3.2-3b (28 layers, seeded random
     weights) served by ``ServeEngine`` (batch 8, max_seq 2048, prefill
     chunk 256, decode chunk 8) on 16 seeded requests, three times:
       a. dense: every request must get exactly its tokens and both dense
          kernels must have launched (the paged ones not);
       b. paged (``paged=True, block_size=16``) on the same 16 requests:
          every stream must equal the dense arm's, the paged kernels must
          have launched 28 times per decode step and prefill chunk (the
          dense ones not), and the pool must drain; then paged and dense
          once more (the order dense, paged, paged, dense), held to the
          same checks;
       c. prefix sharing: 16 requests opening with one 600-token system
          prefix (``prefix_len=600``), served dense and with
          ``paged=True, prefix_sharing=True``: every request must get its
          tokens, 15 x 600 prefill rows must be skipped with 15
          copy-on-write copies, and only the registry's prefix blocks may
          stay in the pool (stream equality with the dense engine is
          counted, not required: the suffix prefill's GEMMs have other row
          counts, so bf16 bits may differ);
       d. after llama's weights are released: full-width, full-depth
          olmoe-1b-7b (16 layers, 64 experts top-8, seeded random
          weights, bf16 compute, the f32 router) on the same engine
          settings and 16 seeded requests, dense and then paged: every
          request gets exactly its tokens and the launches are exact (3 x
          16 ``grouped_matmul`` and 16 attention launches per decode step
          and prefill chunk); the paged streams equal to the dense arm's
          are counted, not required (done lanes take part in routing and
          read stale rows, which differ between the two caches, as in the
          reference); then an untimed replay that must give the dense
          arm's streams again, files every synchronising call by phase
          (one fetch per decode chunk and no other sync) and counts
          the capacity drops of live and done lanes; then, untimed, the
          same requests at capacity factor 8.0, where nothing is dropped
          and done lanes cannot reach live ones: dense and paged, 16/16
          streams equal bit for bit;
       e. full-width, full-depth mamba2-370m (48 Mamba-2 layers), dense
          (the reference refuses paged, and so must the engine): exact
          launches (48 ``ssd`` per prefill chunk of two rows or more, no
          attention kernel), then an untimed replay: the same streams,
          one host sync per decode chunk and no other;
       f. full-width, full-depth zamba2-1.2b (38 Mamba-2 layers, the
          shared attention block every 6 with per-invocation LoRA),
          dense and paged: exact launches (38 ``ssd`` per chunk of two
          rows or more, 6 attention and 6 cache launches per step and,
          paged, per chunk), 16/16 paged streams equal the dense ones
          bit for bit, and prefix sharing refused;
     then torch.profiler windows of steady decode, olmoe dense, mamba2
     dense, zamba2 dense and paged, llama dense and paged (last:
     launches slow down once the profiler has run);
  4. logits parity at full width and 2 layers: the card (bf16, kernels)
     against a float32 CPU forward of the same weights (plain path); for
     olmoe the same prefill chunks and decode step on both sides, the
     card in f32 routing exactly as the CPU in f32 with logits within
     MOE_PARITY_TOL, and the card in bf16 printed beside them; mamba2 at
     2 layers and zamba2 at 7 (one shared invocation and one trailing
     layer), the same prefill chunks (256 + 64 rows: the state carried
     between SSD chunks and from one chunk into the next; 1-row chunks)
     and 3 decode steps, the card in f32 within SSM_PARITY_TOL of the
     CPU in f32, the card in bf16 printed beside it;
  5. training, the second main path, after the serving arms have
     released their weights: full-width, full-depth llama3.2-3b (seeded
     f32 masters, bf16 compute, AdamW, remat="full", batch 2 x 2048)
     trained TRAIN_STEPS steps on one repeated batch through
     ``make_train_step``: finite losses, the last below the first, and
     exactly 2 x 28 ``flash_attention`` and 28 ``flash_attention_bwd``
     launches per step; seconds per step, tokens/s, peak memory and the
     share of the bf16 peak;
  6. training parity: one f32 step at full width and 2 layers on the card
     (kernels) against the CPU (plain versions) from the same weights and
     batch: loss, grad norm and the parameter update.

It prints one ``{"kernels": [...]}`` line (eight kernels), the
nvidia-smi line, and as its last line ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository's ``src/`` beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_OPS_PER_S = 989e12         # dense bf16 tensor-core peak
# kernel vs plain version on the card: bf16 outputs are rounded from f32
# sums that differ only in order, so they differ by at most ~2 bf16 ulps
# at |x| < 2 (2 * 2^-7); f32 outputs differ by summation order alone
DECODE_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
PARITY_TOL = 0.15   # bf16 card vs f32 CPU logits: the reference's bf16
#                     bound (tests/test_serving.py:63)
# cache-free attention kernels (out, dq, dk, dv) vs their plain versions
# on the card, entry by entry:
#   |got - want| <= ATTN_RTOL[dtype] * |want| + ATTN_ATOL * max|want|.
# Both sides compute in f32 from the same inputs and differ only in the
# order of their sums.  A bf16 output is then rounded; two f32 values less
# than one bf16 ulp apart round to the same or adjacent bf16 values, at
# most 2^-7 |want| apart (8-bit significand).  ATTN_ATOL covers the f32
# order error of entries that cancel to near zero (measured ~1e-6 at
# max|want| 1-10 in f32 on an H100).  A limit per entry, not per tensor:
# at S=2048 causal the largest gradients (the first keys') are ~200 times
# a typical one, so a whole-tensor limit would pass a wrong typical entry.
ATTN_RTOL = {"bfloat16": 2 ** -7, "float32": 1e-5}
ATTN_ATOL = 1e-5
# lse is f32 in both, from the same inputs, so only the order differs
LSE_TOL = 1e-4
_ATTN_TOL_TEXT = (f"per entry {ATTN_RTOL['bfloat16']} |want| + "
                  f"{ATTN_ATOL} max|want| (bf16)")
# grouped_matmul vs its plain version is held to the same rule per entry:
# both sides sum the same f32 products (K = 1024 or 2048 of them) in
# another order, and a bf16 output is then rounded once, so the two are
# equal or one bf16 ulp apart (ratio <= 1 / (1 + 2^-7) at worst); ATTN_ATOL
# covers the f32 order error of sums that cancel to near zero, which grows
# as sqrt(K) (~1e-4 at K = 2048, entries of size ~45, the largest ~200).
# A wrong K-slice or group changes an entry by far more than one ulp.
GMM_SHAPES = [(64, 2, 2048, 1024), (64, 2, 1024, 2048),      # decode
              (64, 40, 2048, 1024), (64, 40, 1024, 2048),    # 256-row chunk
              (64, 1, 2048, 1024), (64, 3, 2048, 1024),      # odd capacity
              (64, 5, 1024, 2048), (64, 100, 2048, 1024),
              (8, 2, 128, 256), (8, 5, 256, 128),            # reduced configs
              (8, 17, 128, 256)]
TRAIN_STEPS = 6
#: the bf16 attention kernels' tiles: the forward's key tile, the dK/dV
#: pass's query step and the dQ pass's query tile (flash_attention*.cu)
FA_KEY_TILE, FA_KV_STEP, FA_DQ_TILE = 128, 64, 128
#: kernel-name fragments of the train step's device time by kind (bf16:
#: the tensor-core kernels)
TRAIN_PROFILE_GROUPS = {
    "flash_attention": ("attn_fwd_tc_kernel",),
    "flash_attention_bwd": ("attn_bwd_dkdv_tc_kernel",
                            "attn_bwd_dq_tc_kernel", "attn_delta_kernel"),
    "GEMM (cuBLAS)": ("nvjet", "gemm", "Gemm", "cutlass", "xmma"),
}
# [train:parity], f32 card (kernels, TF32 off) vs f32 CPU (plain), one
# step: loss and grad norm differ by summation order only; the AdamW
# update g / (|g| + eps) flips for a gradient within rounding of zero
# (2 lr for that entry), so the updates are compared as a relative norm
TRAIN_PARITY_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "update": 1e-2}
ARCH = "llama3.2-3b"
MOE_ARCH = "olmoe-1b-7b"
SSM_ARCH = "mamba2-370m"
HYBRID_ARCH = "zamba2-1.2b"
#: the ssd kernel's serving shapes, (H, P, N) of each Mamba-2 model
SSD_HEADS = {"mamba2": (32, 64, 128), "zamba2": (64, 64, 64)}
#: kernel-name fragments of a Mamba model's decode step by kind
SSM_PROFILE_GROUPS = {
    "ssd": ("ssd_kernel",),
    "flash_decode": ("decode_attention_kernel",),
    "cache_update": ("cache_update_kernel", "cache_update_paged_kernel"),
    "GEMM (cuBLAS)": ("nvjet", "gemm", "Gemm", "cutlass", "xmma"),
}
# [parity:mamba2] / [parity:zamba2], the f32 gate: the card (kernels, TF32
# off) and the CPU (plain versions) differ by summation order only, through
# 2 (mamba2) or 7 (zamba2) layers, 1024- to 8192-term sums, the SSD's
# cumulative decays and a 32000- or 50280-wide unembedding (logits ~N(0,
# 1) here): ~1e-5 expected, 1e-3 allowed
SSM_PARITY_TOL = 1e-3
#: kernel-name fragments of an olmoe decode step's device time by kind
MOE_PROFILE_GROUPS = {
    "grouped_matmul": ("grouped_matmul_kernel",),
    "flash_decode": ("decode_attention_kernel",),
    "cache_update": ("cache_update_kernel",),
    "GEMM (cuBLAS)": ("nvjet", "gemm", "Gemm", "cutlass", "xmma"),
}


def _smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _time_eager_ms(calls, rounds: int) -> float:
    """Time per call run eagerly: the host's work per call included (the
    card idles when the host cannot keep up)."""
    import torch
    for c in calls:
        c()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        for c in calls:
            c()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (rounds * len(calls))


def _time_graph_ms(calls, min_calls: int = 64, replays: int = 10,
                   stream=None) -> float:
    """Device time per call: the calls are captured once into a CUDA graph
    and replayed, so the host's per-call work is left out.  ``stream``:
    warm up and capture on it (autograd runs each backward op on the
    stream its forward op ran on, so a backward is captured on that one)."""
    import torch
    calls = calls * max(1, math.ceil(min_calls / len(calls)))
    side = torch.cuda.Stream() if stream is None else stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm up off the capture
        for c in calls[:4]:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for c in calls:
            c()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * len(calls))


def _bound(nbytes: float, ops: float, ops_rate: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _decode_case(B, S, H, K, D, Sq, dtype, kv_len, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, S, K, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, K, D), generator=g, device="cuda").to(dtype)
    return q, k, v, torch.tensor(kv_len, dtype=torch.int32, device="cuda")


def check_flash_decode(tfa, ref):
    """Kernel vs plain version over dtypes, chunk sizes (Sq 5: a partial
    block of query rows), softcap/window, the reduced configs' head_dim
    32, olmoe's H = K = 16 (one query head per kv head) and zamba2's
    shared attention (H = K = 32, head_dim 64)."""
    import torch
    rng = np.random.default_rng(0)
    checks = []
    shapes = [((8, 2048, 24, 8, 128), Sq) for Sq in (1, 5, 256)] \
        + [((3, 64, 4, 2, 32), Sq) for Sq in (1, 4)] \
        + [((8, 2048, 16, 16, 128), Sq) for Sq in (1, 5, 256)] \
        + [((8, 2048, 32, 32, 64), Sq) for Sq in (1, 5, 256)]    # zamba2
    for dtype in (torch.bfloat16, torch.float32):
        for (B, S, H, K, D), Sq in shapes:
            kv_len = rng.integers(Sq, S + 1, B)
            kv_len[-1] = S + 1                        # a done lane
            window_on = 512 if S > 512 else 16
            for softcap, window in ((None, None), (30.0, window_on)):
                q, k, v, kl = _decode_case(B, S, H, K, D, Sq, dtype,
                                           kv_len.tolist(), len(checks))
                got = tfa.flash_decode(q, k, v, kl, softcap=softcap,
                                       local_window=window)
                want = ref.decode_attention_ref(q, k, v, kl, softcap=softcap,
                                                local_window=window)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    raise AssertionError("flash_decode: non-finite output")
                err = (got.float() - want.float()).abs().max().item()
                name = str(dtype).split(".")[1]
                tol = DECODE_TOL[name]
                checks.append({"dtype": name, "B": B, "S": S, "H": H,
                               "K": K, "D": D, "Sq": Sq, "softcap": softcap,
                               "window": window, "max_abs_err": err,
                               "tol": tol})
                print(f"[check] flash_decode {name} B={B} S={S} H={H} K={K} "
                      f"D={D} Sq={Sq} "
                      f"softcap={softcap} window={window}: max|err| {err:.3e}"
                      f" (tol {tol})", flush=True)
                if not err <= tol:
                    raise AssertionError(f"flash_decode disagrees: {err}")
    return checks


def check_cache_update(tfa, ref):
    """Kernel vs plain version, bit-exact, including dropped slots, at
    llama's K = 8 and olmoe's K = 16 kv heads of 128, and zamba2's 32 of
    64."""
    import torch
    B, S = 8, 2048
    checks = []
    for (new_dt, cache_dt), (K, D) in itertools.product(
            ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
             (torch.float32, torch.bfloat16)), ((8, 128), (16, 128),
                                                (32, 64))):
        for Sn in (1, 4):
            index = [0, 5, 700, 1333, S - Sn, S, -1, S - Sn + 1]
            g = torch.Generator(device="cuda").manual_seed(len(checks))
            kc = torch.randn((B, S, K, D), generator=g,
                             device="cuda").to(cache_dt)
            vc = torch.randn((B, S, K, D), generator=g,
                             device="cuda").to(cache_dt)
            kn = torch.randn((B, Sn, K, D), generator=g,
                             device="cuda").to(new_dt)
            vn = torch.randn((B, Sn, K, D), generator=g,
                             device="cuda").to(new_dt)
            idx = torch.tensor(index, dtype=torch.int32, device="cuda")
            got = tfa.cache_update(kc.clone(), vc.clone(), kn, vn, idx)
            want = ref.kv_cache_update_ref(kc.clone(), vc.clone(), kn, vn,
                                           idx)
            torch.cuda.synchronize()
            exact = all(torch.equal(a, b) for a, b in zip(got, want))
            checks.append({"new": str(new_dt).split(".")[1],
                           "cache": str(cache_dt).split(".")[1], "K": K,
                           "D": D, "Sn": Sn, "bit_exact": exact})
            print(f"[check] cache_update {checks[-1]}", flush=True)
            if not exact:
                raise AssertionError("cache_update is not bit-exact")
    return checks


def _paged_case(B, S, H, K, D, Sq, bs, dtype, kv_len, seed):
    """q, k/v pools of B * S / bs + 1 blocks (the last one the parking
    block), kv_len and tables: each slot's blocks scattered through the
    pool by a seeded permutation, the entries past its kv_len parked."""
    import torch
    mb = S // bs
    n_pool = B * mb + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=g, device="cuda").to(dtype)
    kp = torch.randn((n_pool, bs, K, D), generator=g, device="cuda").to(dtype)
    vp = torch.randn((n_pool, bs, K, D), generator=g, device="cuda").to(dtype)
    perm = np.random.default_rng(seed).permutation(B * mb).reshape(B, mb)
    for b, n in enumerate(kv_len):
        perm[b, -(-min(int(n), S) // bs):] = n_pool - 1
    table = torch.tensor(perm, dtype=torch.int32, device="cuda")
    return q, kp, vp, torch.tensor(kv_len, dtype=torch.int32,
                                   device="cuda"), table


def check_flash_decode_paged(tfa, ref):
    """Paged kernel vs its plain version, and vs the DENSE kernel over the
    gathered cache (must be equal: the reduction order is shared); llama's
    and olmoe's head counts, zamba2's D=64 and the reduced D=32."""
    import torch
    rng = np.random.default_rng(10)
    checks = []
    shapes = [((8, 2048, 24, 8, 128), 16, Sq) for Sq in (1, 5, 256)] \
        + [((3, 64, 4, 2, 32), 8, Sq) for Sq in (1, 4)] \
        + [((8, 2048, 16, 16, 128), 16, Sq) for Sq in (1, 5, 256)] \
        + [((8, 2048, 32, 32, 64), 16, Sq) for Sq in (1, 5, 256)]
    for dtype in (torch.bfloat16, torch.float32):
        for (B, S, H, K, D), bs, Sq in shapes:
            kv_len = rng.integers(Sq, S + 1, B)
            kv_len[-1] = S + 1                        # a done lane
            window_on = 512 if S > 512 else 16
            for softcap, window in ((None, None), (30.0, window_on)):
                q, kp, vp, kl, tab = _paged_case(
                    B, S, H, K, D, Sq, bs, dtype, kv_len.tolist(),
                    1000 + len(checks))
                got = tfa.flash_decode_paged(q, kp, vp, kl, tab,
                                             softcap=softcap,
                                             local_window=window)
                want = ref.decode_attention_paged_ref(
                    q, kp, vp, kl, tab, softcap=softcap, local_window=window)
                dense = tfa.flash_decode(q, ref.paged_gather_ref(kp, tab),
                                         ref.paged_gather_ref(vp, tab), kl,
                                         softcap=softcap, local_window=window)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    raise AssertionError("flash_decode_paged: non-finite")
                err = (got.float() - want.float()).abs().max().item()
                vs_dense = (got.float() - dense.float()).abs().max().item()
                name = str(dtype).split(".")[1]
                tol = DECODE_TOL[name]
                checks.append({"dtype": name, "B": B, "S": S, "H": H,
                               "K": K, "D": D, "bs": bs, "Sq": Sq,
                               "softcap": softcap, "window": window,
                               "max_abs_err": err, "tol": tol,
                               "vs_dense_max_abs_diff": vs_dense})
                print(f"[check] flash_decode_paged {name} B={B} S={S} H={H} "
                      f"K={K} D={D} bs={bs} Sq={Sq} softcap={softcap} "
                      f"window={window}: max|err| {err:.3e} (tol {tol}); "
                      f"vs dense kernel over the gathered cache "
                      f"max|diff| {vs_dense}", flush=True)
                if not err <= tol:
                    raise AssertionError(f"flash_decode_paged disagrees: "
                                         f"{err}")
                if not torch.equal(got, dense):
                    raise AssertionError(f"flash_decode_paged differs from "
                                         f"flash_decode: {vs_dense}")
    return checks


def check_cache_update_paged(tfa, ref):
    """Kernel vs plain version, bit-exact, at Sn 1, 4 and 256 across block
    boundaries, with done, negative and overrunning slots; blocks no table
    maps must stay untouched.  llama's K = 8 and olmoe's K = 16 kv heads of
    128, zamba2's 32 of 64."""
    import torch
    B, S, bs = 8, 2048, 16
    mb, mapped = S // bs, 100                 # 100 of 128 blocks mapped
    n_pool = B * mb + 1
    checks = []
    for (new_dt, pool_dt), (K, D) in itertools.product(
            ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
             (torch.float32, torch.bfloat16)), ((8, 128), (16, 128),
                                                (32, 64))):
        for Sn in (1, 4, 256):
            # 14 + Sn crosses a block; 1600 - Sn ends on the last mapped
            # row; S is done, -1 negative, S - Sn + 1 overruns
            index = [0, 14, 700, 1333, mapped * bs - Sn, S, -1, S - Sn + 1]
            seed = 2000 + len(checks)
            g = torch.Generator(device="cuda").manual_seed(seed)
            kp = torch.randn((n_pool, bs, K, D), generator=g,
                             device="cuda").to(pool_dt)
            vp = torch.randn((n_pool, bs, K, D), generator=g,
                             device="cuda").to(pool_dt)
            kn = torch.randn((B, Sn, K, D), generator=g,
                             device="cuda").to(new_dt)
            vn = torch.randn((B, Sn, K, D), generator=g,
                             device="cuda").to(new_dt)
            perm = np.random.default_rng(seed).permutation(B * mb)
            table = perm.reshape(B, mb).copy()
            table[:, mapped:] = n_pool - 1
            unmapped = sorted(set(range(n_pool)) - set(table.ravel().tolist()))
            tab = torch.tensor(table, dtype=torch.int32, device="cuda")
            idx = torch.tensor(index, dtype=torch.int32, device="cuda")
            got = tfa.cache_update_paged(kp.clone(), vp.clone(), kn, vn, idx,
                                         tab)
            want = ref.kv_cache_update_paged_ref(kp.clone(), vp.clone(), kn,
                                                 vn, idx, tab)
            torch.cuda.synchronize()
            exact = all(torch.equal(a, b) for a, b in zip(got, want))
            um = torch.tensor(unmapped, device="cuda")
            untouched = all(torch.equal(a[um], b[um])
                            for a, b in zip(got, (kp, vp)))
            checks.append({"new": str(new_dt).split(".")[1],
                           "pool": str(pool_dt).split(".")[1], "K": K,
                           "D": D, "Sn": Sn,
                           "bit_exact": exact,
                           "unmapped_blocks_untouched": untouched,
                           "unmapped_blocks": len(unmapped)})
            print(f"[check] cache_update_paged {checks[-1]}", flush=True)
            if not (exact and untouched):
                raise AssertionError("cache_update_paged is not bit-exact "
                                     "or wrote an unmapped block")
    return checks


def time_flash_decode(tfa, ref, B, Sq, kv_len, H=24, K=8, D=128):
    """Kernel, plain and library times at one main-path shape (bf16),
    rotating over enough cache copies that reads come from HBM, not L2."""
    import torch
    import torch.nn.functional as F
    S = 2048
    esz = 2
    rows = [min(int(n), S) for n in kv_len]
    kv_bytes = sum(rows) * K * D * 2 * esz
    n_copies = max(2, min(8, math.ceil(100e6 / max(kv_bytes, 1))))
    cases = [_decode_case(B, S, H, K, D, Sq, torch.bfloat16,
                          [int(n) for n in kv_len], 100 + i)
             for i in range(n_copies)]
    # the library call: SDPA over the whole cache with a length mask
    k_pos = torch.arange(S, device="cuda")
    q_pos = (torch.tensor(kv_len, device="cuda")[:, None] - Sq
             + torch.arange(Sq, device="cuda")[None])
    mask = (k_pos[None, None] <= q_pos[:, :, None])[:, None]   # (B,1,Sq,S)
    lib_cases = [(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                  v.transpose(1, 2).contiguous()) for q, k, v, _ in cases]
    kernel = [functools.partial(tfa.flash_decode, *c) for c in cases]
    plain = [functools.partial(ref.decode_attention_ref, *c) for c in cases]
    library = [functools.partial(F.scaled_dot_product_attention, *c,
                                 attn_mask=mask, enable_gqa=True)
               for c in lib_cases]
    ms = _time_graph_ms(kernel)
    host_ms = _time_eager_ms(kernel, 10)
    plain_ms = _time_eager_ms(plain, 2)
    library_ms = _time_graph_ms(library)
    pairs = sum(min(S, int(n) - Sq + t + 1) for n in kv_len
                for t in range(Sq)) * H
    nbytes = kv_bytes + 2 * B * Sq * H * D * esz + 4 * B
    bound_ms, bound_by = _bound(nbytes, 4.0 * D * pairs, BF16_OPS_PER_S)
    return {"shape": f"B={B} Sq={Sq} S={S} H={H} K={K} D={D} bf16, "
                     f"kv_len {min(rows)}..{max(rows)}",
            "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": "F.scaled_dot_product_attention(enable_gqa=True) "
                       "over the whole cache with a length mask",
            "bound_ms": bound_ms, "bound_by": bound_by}


def time_cache_update(tfa, ref, K=8, D=128):
    """Decode-step write (Sn=1, bf16) of 8 slots, one of them done."""
    import torch
    B, S, Sn = 8, 2048, 1
    index = [96, 140, 333, 512, 700, 911, 1100, S]
    g = torch.Generator(device="cuda").manual_seed(7)
    kc = torch.zeros((B, S, K, D), dtype=torch.bfloat16, device="cuda")
    vc = torch.zeros_like(kc)
    kn = torch.randn((B, Sn, K, D), generator=g, device="cuda").bfloat16()
    vn = torch.randn((B, Sn, K, D), generator=g, device="cuda").bfloat16()
    idx = torch.tensor(index, dtype=torch.int32, device="cuda")
    valid = [b for b, i in enumerate(index) if 0 <= i and i + Sn <= S]
    flat = torch.tensor([b * S + index[b] + j for b in valid
                         for j in range(Sn)], device="cuda")
    kv_rows, vv_rows = (x[valid].reshape(-1, K * D) for x in (kn, vn))
    kflat, vflat = kc.view(B * S, K * D), vc.view(B * S, K * D)

    def run_library():
        kflat.index_copy_(0, flat, kv_rows)
        vflat.index_copy_(0, flat, vv_rows)

    kernel = [functools.partial(tfa.cache_update, kc, vc, kn, vn, idx)]
    ms = _time_graph_ms(kernel)
    host_ms = _time_eager_ms(kernel, 200)
    # the plain version syncs with the host (nonzero): eager only
    plain_ms = _time_eager_ms(
        [functools.partial(ref.kv_cache_update_ref, kc, vc, kn, vn, idx)], 50)
    library_ms = _time_graph_ms([run_library])
    nbytes = 2 * (2 * len(valid) * Sn * K * D * 2) + 4 * B
    bound_ms, bound_by = _bound(nbytes, 0.0, BF16_OPS_PER_S)
    return {"shape": f"B={B} Sn={Sn} S={S} K={K} D={D} bf16, one done slot",
            "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": "Tensor.index_copy_ on the k and v caches",
            "bound_ms": bound_ms, "bound_by": bound_by}


def time_flash_decode_paged(tfa, ref, B, Sq, kv_len, H=24, K=8, D=128):
    """Paged kernel, plain and library times at one main-path shape (bf16,
    pool of B * 128 + 1 blocks of 16), rotating over enough pools that
    reads come from HBM, not L2."""
    import torch
    import torch.nn.functional as F
    S, bs = 2048, 16
    esz = 2
    rows = [min(int(n), S) for n in kv_len]
    kv_bytes = sum(rows) * K * D * 2 * esz
    n_copies = max(2, min(8, math.ceil(100e6 / max(kv_bytes, 1))))
    cases = [_paged_case(B, S, H, K, D, Sq, bs, torch.bfloat16,
                         [int(n) for n in kv_len], 300 + i)
             for i in range(n_copies)]
    k_pos = torch.arange(S, device="cuda")
    q_pos = (torch.tensor(kv_len, device="cuda")[:, None] - Sq
             + torch.arange(Sq, device="cuda")[None])
    mask = (k_pos[None, None] <= q_pos[:, :, None])[:, None]   # (B,1,Sq,S)

    def run_library(q, kp, vp, kl, tab):
        # one gather of each slot's whole table, then SDPA over it
        ids = tab.reshape(-1)
        kd = kp.index_select(0, ids).view(B, S, K, D).transpose(1, 2)
        vd = vp.index_select(0, ids).view(B, S, K, D).transpose(1, 2)
        return F.scaled_dot_product_attention(q.transpose(1, 2), kd, vd,
                                              attn_mask=mask, enable_gqa=True)

    kernel = [functools.partial(tfa.flash_decode_paged, *c) for c in cases]
    plain = [functools.partial(ref.decode_attention_paged_ref, *c)
             for c in cases]
    library = [functools.partial(run_library, *c) for c in cases]
    ms = _time_graph_ms(kernel)
    host_ms = _time_eager_ms(kernel, 10)
    plain_ms = _time_eager_ms(plain, 2)
    library_ms = _time_graph_ms(library)
    pairs = sum(min(S, int(n) - Sq + t + 1) for n in kv_len
                for t in range(Sq)) * H
    table_bytes = 4 * sum(-(-r // bs) for r in rows)
    nbytes = kv_bytes + 2 * B * Sq * H * D * esz + 4 * B + table_bytes
    bound_ms, bound_by = _bound(nbytes, 4.0 * D * pairs, BF16_OPS_PER_S)
    return {"shape": f"B={B} Sq={Sq} H={H} pool ({B * S // bs + 1},{bs},{K},"
                     f"{D}) bf16, kv_len {min(rows)}..{max(rows)}",
            "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": "Tensor.index_select gather of each slot's whole "
                       "table + F.scaled_dot_product_attention(enable_gqa="
                       "True) with a length mask, timed together",
            "bound_ms": bound_ms, "bound_by": bound_by}


def time_cache_update_paged(tfa, ref, B, Sn, index, K=8, D=128):
    """Paged write (bf16) of Sn rows per slot into a (B * 128 + 1, 16, K,
    D) pool through scattered tables."""
    import torch
    S, bs = 2048, 16
    mb = S // bs
    n_pool = B * mb + 1
    g = torch.Generator(device="cuda").manual_seed(9)
    kp = torch.zeros((n_pool, bs, K, D), dtype=torch.bfloat16, device="cuda")
    vp = torch.zeros_like(kp)
    kn = torch.randn((B, Sn, K, D), generator=g, device="cuda").bfloat16()
    vn = torch.randn((B, Sn, K, D), generator=g, device="cuda").bfloat16()
    table = np.random.default_rng(9).permutation(B * mb).reshape(B, mb)
    tab = torch.tensor(table, dtype=torch.int32, device="cuda")
    idx = torch.tensor(index, dtype=torch.int32, device="cuda")
    valid = [b for b, i in enumerate(index) if 0 <= i and i + Sn <= S]
    flat = torch.tensor([int(table[b, (index[b] + j) // bs]) * bs
                         + (index[b] + j) % bs
                         for b in valid for j in range(Sn)], device="cuda")
    kv_rows, vv_rows = (x[valid].reshape(-1, K * D) for x in (kn, vn))
    kflat, vflat = kp.view(n_pool * bs, K * D), vp.view(n_pool * bs, K * D)

    def run_library():
        kflat.index_copy_(0, flat, kv_rows)
        vflat.index_copy_(0, flat, vv_rows)

    kernel = [functools.partial(tfa.cache_update_paged, kp, vp, kn, vn, idx,
                                tab)]
    ms = _time_graph_ms(kernel)
    host_ms = _time_eager_ms(kernel, 200)
    # the plain version syncs with the host (nonzero): eager only
    plain_ms = _time_eager_ms(
        [functools.partial(ref.kv_cache_update_paged_ref, kp, vp, kn, vn,
                           idx, tab)], 20)
    library_ms = _time_graph_ms([run_library])
    n_rows = len(valid) * Sn
    nbytes = (2 * (2 * n_rows * K * D * 2) + 4 * B
              + 4 * len({(b, (index[b] + j) // bs) for b in valid
                         for j in range(Sn)}))
    bound_ms, bound_by = _bound(nbytes, 0.0, BF16_OPS_PER_S)
    done = len(index) - len(valid)
    return {"shape": f"B={B} Sn={Sn} pool ({n_pool},{bs},{K},{D}) bf16"
                     + (f", {done} done slot" if done else ""),
            "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": "Tensor.index_copy_ on the k and v pools viewed as "
                       "rows",
            "bound_ms": bound_ms, "bound_by": bound_by}


def _attention_case(B, Sq, Sk, H, K, D, dtype, seed):
    """q, k, v and an output cotangent, seeded on the card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D),
                          (B, Sq, H, D))]


def _entry_ratio(name, got, want):
    """|got - want| over its limit (ATTN_RTOL, ATTN_ATOL), entry by entry:
    an entry passes at <= 1.  The rule of the attention and
    grouped_matmul checks."""
    got, want = got.float(), want.float()
    limit = ATTN_RTOL[name] * want.abs() + ATTN_ATOL * want.abs().max()
    return (got - want).abs() / limit.clamp(min=1e-30)


def check_flash_attention(tfa, ref):
    """Forward (out and lse) and backward (dq, dk, dv) kernels against
    ``attention_naive`` (with its lse) and ``attention_bwd_ref`` on the
    same inputs, entry by entry; the backward on the plain forward's out
    and lse.  The
    training shape and the reduced configs' D=32; causal, window +
    softcap, bidirectional (+ softcap), an odd length, Sq != Sk both ways;
    bf16 and f32.  Every row sees at least one key (the reference's two
    plain versions disagree on rows that see none)."""
    import torch
    checks = []
    train = (2, 24, 8, 128)
    small = (2, 4, 2, 32)
    cases = [(train, 2048, 2048, True, None, None),
             (train, 2048, 2048, True, 512, 30.0),
             (train, 1000, 1000, False, None, 30.0),
             (train, 1000, 1000, True, None, None),
             (train, 300, 1000, True, None, None),
             (train, 1000, 300, True, None, None),
             (small, 256, 256, True, None, None),
             (small, 130, 77, False, 100, 20.0)]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for (B, H, K, D), Sq, Sk, causal, window, cap in cases:
            q, k, v, do = _attention_case(B, Sq, Sk, H, K, D, dtype,
                                          500 + len(checks))
            kw = dict(causal=causal, local_window=window, softcap=cap)
            out, lse = tfa.flash_attention(q, k, v, **kw)
            want_out, want_lse = ref.attention_naive(q, k, v,
                                                     return_lse=True, **kw)
            grads = tfa.flash_attention_bwd(q, k, v, want_out, want_lse, do,
                                            **kw)
            want = ref.attention_bwd_ref(q, k, v, want_out, want_lse, do,
                                         **kw)
            torch.cuda.synchronize()
            for t in (out, lse, *grads):
                if not torch.isfinite(t).all():
                    raise AssertionError("flash_attention: non-finite output")
            err = {"lse": (lse - want_lse).abs().max().item()}
            # the worst entry's error over its limit (lse: over LSE_TOL)
            ratio = {"lse": err["lse"] / LSE_TOL}
            for n, got, w in (("out", out, want_out),
                              *zip(("dq", "dk", "dv"), grads, want)):
                err[n] = (got.float() - w.float()).abs().max().item()
                ratio[n] = _entry_ratio(name, got, w).max().item()
            checks.append({"dtype": name, "B": B, "Sq": Sq, "Sk": Sk, "H": H,
                           "K": K, "D": D, "causal": causal,
                           "window": window, "softcap": cap,
                           "max_abs_err": err, "worst_over_limit": ratio})
            print(f"[check] flash_attention {name} B={B} Sq={Sq} Sk={Sk} "
                  f"H={H} K={K} D={D} causal={causal} window={window} "
                  f"softcap={cap}: max|err| (worst entry / its limit) "
                  + ", ".join(f"{n} {err[n]:.3e} ({ratio[n]:.3f})"
                              for n in err), flush=True)
            bad = [n for n in ratio if not ratio[n] <= 1.0]
            if bad:
                raise AssertionError(f"flash_attention disagrees on {bad}: "
                                     f"{ratio}")
    return checks


def check_planted_faults(tfa, ref):
    """The attention checks must reject kernels that drop one tile of the
    size the bf16 kernels use.  At the training shape (bf16, causal),
    against the plain version of the intact inputs: the forward with the
    last FA_KEY_TILE rows of v zeroed (its last key tile's contribution to
    the last query rows dropped); the backward with the last FA_KV_STEP
    rows of dout zeroed (the dK/dV pass's last query step: its
    contribution to every dk and dv dropped), checked on dk and dv; and
    with the last FA_DQ_TILE rows of dout zeroed (the dQ pass's last query
    tile: those dq rows zero), checked on dq.  Raises if a check passes a
    fault.  Reports, per tensor, the share of entries beyond their limit
    and max|err| / max|want| (what a limit on the whole tensor would see);
    for dv both also over the keys before the last step, whose dv the
    fault only shortens."""
    import torch
    B, S, H, K, D = 2, 2048, 24, 8, 128
    q, k, v, do = _attention_case(B, S, S, H, K, D, torch.bfloat16, 700)
    want_out, want_lse = ref.attention_naive(q, k, v, return_lse=True)
    want = ref.attention_bwd_ref(q, k, v, want_out, want_lse, do)
    v_cut, do_step, do_tile = v.clone(), do.clone(), do.clone()
    v_cut[:, -FA_KEY_TILE:] = 0
    do_step[:, -FA_KV_STEP:] = 0
    do_tile[:, -FA_DQ_TILE:] = 0
    out, _ = tfa.flash_attention(q, k, v_cut)
    _, dk, dv = tfa.flash_attention_bwd(q, k, v, want_out, want_lse, do_step)
    dq, _, _ = tfa.flash_attention_bwd(q, k, v, want_out, want_lse, do_tile)
    faults = {}
    for n, got, w in (("out", out, want_out), ("dq", dq, want[0]),
                      ("dk", dk, want[1]), ("dv", dv, want[2])):
        ratio = _entry_ratio("bfloat16", got, w)
        faults[n] = {
            "flagged_share": (ratio > 1).float().mean().item(),
            "max_err_over_max_want": ((got.float() - w.float()).abs().max()
                                      / w.float().abs().max()).item()}
        if n == "dv":
            keep = slice(None, -FA_KV_STEP)
            faults[n]["flagged_share_before_last_tile"] = (
                ratio[:, keep] > 1).float().mean().item()
            faults[n]["max_err_over_max_want_before_last_tile"] = (
                (got[:, keep].float() - w[:, keep].float()).abs().max()
                / w.float().abs().max()).item()
        if not (ratio > 1).any():
            raise AssertionError(f"flash_attention: the {n} check passes a "
                                 "kernel that drops a tile")
    print(f"[check] flash_attention planted faults B={B} S={S} H={H} K={K} "
          f"D={D} causal bf16 (out: last {FA_KEY_TILE}-row key tile's v "
          f"zeroed; dk/dv: last {FA_KV_STEP}-row query step's dout zeroed; "
          f"dq: last {FA_DQ_TILE}-row query tile's dout zeroed): share of "
          "entries beyond their limit, max|err|/max|want|: " + ", ".join(
              f"{n} {f['flagged_share']:.4f}, {f['max_err_over_max_want']:.3e}"
              for n, f in faults.items())
          + "; dv before the last step {:.4f}, {:.3e}".format(
              faults["dv"]["flagged_share_before_last_tile"],
              faults["dv"]["max_err_over_max_want_before_last_tile"]),
          flush=True)
    return faults


def check_bf16_shortcut(ref):
    """The per-entry rule must reject the shortcut a bf16 tensor-core
    product invites: P (for out) and dS (for dq) rounded to bf16 once
    (``ref.attention_tc_emulated(parts=1)``, the plain version with that
    one change), at the training shape (bf16, causal) on the card.  The
    kernels' split, hi = bf16(x) and lo = bf16(x - hi) (``parts=2``), is
    shown beside it, within the rule.  Raises if the rule passes the
    shortcut or rejects the split."""
    import torch
    B, S, H, K, D = 2, 2048, 24, 8, 128
    q, k, v, do = _attention_case(B, S, S, H, K, D, torch.bfloat16, 700)
    want_out, want_lse = ref.attention_naive(q, k, v, return_lse=True)
    want_dq = ref.attention_bwd_ref(q, k, v, want_out, want_lse, do)[0]
    res = {}
    for parts in (1, 2):
        out, dq = ref.attention_tc_emulated(q, k, v, want_out, want_lse, do,
                                            parts=parts)
        for n, got, w in (("out", out, want_out), ("dq", dq, want_dq)):
            ratio = _entry_ratio("bfloat16", got, w)
            res[f"{n}_parts{parts}"] = {
                "worst_over_limit": ratio.max().item(),
                "flagged_share": (ratio > 1).float().mean().item()}
        del out, dq
    print(f"[check] flash_attention bf16 shortcut B={B} S={S} H={H} K={K} "
          f"D={D} causal (plain version, worst entry / its limit, share "
          "beyond): P and dS rounded to bf16 once: " + ", ".join(
              f"{n} {res[n + '_parts1']['worst_over_limit']:.3f} "
              f"({res[n + '_parts1']['flagged_share']:.4f})"
              for n in ("out", "dq"))
          + "; split hi + lo: " + ", ".join(
              f"{n} {res[n + '_parts2']['worst_over_limit']:.3f}"
              for n in ("out", "dq")), flush=True)
    if any(res[f"{n}_parts1"]["worst_over_limit"] <= 1 for n in ("out", "dq")):
        raise AssertionError(f"the attention rule passes bf16 P / dS: {res}")
    if any(res[f"{n}_parts2"]["worst_over_limit"] > 1 for n in ("out", "dq")):
        raise AssertionError(f"the attention rule rejects the split: {res}")
    return res


def time_flash_attention(tfa, ref):
    """Forward and backward kernel, plain and library times at the
    training shape (bf16, causal), two input sets in turn (~67 MB each,
    beyond the 50 MB L2).  Library yardsticks, never called by the port:
    ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)`` and
    its autograd backward."""
    import torch
    import torch.nn.functional as F
    B, S, H, K, D = 2, 2048, 24, 8, 128
    esz = 2
    cases = [_attention_case(B, S, S, H, K, D, torch.bfloat16, 900 + i)
             for i in range(2)]
    saved = [tfa.flash_attention(q, k, v) for q, k, v, _ in cases]
    fwd = [functools.partial(tfa.flash_attention, *c[:3]) for c in cases]
    bwd = [functools.partial(tfa.flash_attention_bwd, *c[:3], o, l, c[3])
           for c, (o, l) in zip(cases, saved)]

    def plain_fwd(q, k, v):
        return ref.attention_naive(q, k, v, return_lse=True)

    lib_in = [[t.transpose(1, 2).contiguous().requires_grad_()
               for t in c[:3]] for c in cases]
    lib_do = [c[3].transpose(1, 2).contiguous() for c in cases]

    def lib_fwd(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    with torch.no_grad():
        lib_f = [functools.partial(lib_fwd, *[t.detach() for t in c])
                 for c in lib_in]
        t_fwd = {"ms": _time_graph_ms(fwd, min_calls=16),
                 "host_ms": _time_eager_ms(fwd, 4),
                 "plain_ms": _time_eager_ms(
                     [functools.partial(plain_fwd, *c[:3]) for c in cases], 1),
                 "library_ms": _time_graph_ms(lib_f, min_calls=16)}
    # SDPA's forward runs on the stream its backward is captured on
    lib_stream = torch.cuda.Stream()
    lib_stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(lib_stream):
        lib_out = [lib_fwd(*c) for c in lib_in]
    lib_b = [functools.partial(torch.autograd.grad, o, c, g,
                               retain_graph=True)
             for o, c, g in zip(lib_out, lib_in, lib_do)]
    t_bwd = {"ms": _time_graph_ms(bwd, min_calls=16),
             "host_ms": _time_eager_ms(bwd, 4),
             "plain_ms": _time_eager_ms(
                 [functools.partial(ref.attention_bwd_ref, *c[:3], o, l, c[3])
                  for c, (o, l) in zip(cases, saved)], 1),
             "library_ms": _time_graph_ms(lib_b, min_calls=16,
                                          stream=lib_stream)}
    pairs = B * H * S * (S + 1) // 2                  # causal (q, k) pairs
    q_bytes, kv_bytes = B * S * H * D * esz, B * S * K * D * esz
    lse_bytes = 4 * B * H * S
    # forward: reads q, k, v; writes out, lse
    t_fwd["bound_ms"], t_fwd["bound_by"] = _bound(
        2 * q_bytes + 2 * kv_bytes + lse_bytes, 4.0 * D * pairs,
        BF16_OPS_PER_S)
    # backward: reads q, k, v, out, dout, lse; writes dq, dk, dv
    t_bwd["bound_ms"], t_bwd["bound_by"] = _bound(
        4 * q_bytes + 4 * kv_bytes + lse_bytes, 10.0 * D * pairs,
        BF16_OPS_PER_S)
    shape = f"B={B} S={S} H={H} K={K} D={D} causal bf16"
    t_fwd.update(shape=shape, ops=4.0 * D * pairs,
                 library="F.scaled_dot_product_attention(is_causal=True, "
                         "enable_gqa=True) on (B,H,S,D) copies",
                 plain="ref.attention_naive(return_lse=True)")
    t_bwd.update(shape=shape, ops=10.0 * D * pairs,
                 library="torch.autograd.grad through the same SDPA call "
                         "(CUDA graph, as the kernel)",
                 plain="ref.attention_bwd_ref")
    return {"fwd": t_fwd, "bwd": t_bwd}


def _gmm_case(G, M, K, N, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn((G, M, K), generator=g, device="cuda").to(dtype),
            torch.randn((G, K, N), generator=g, device="cuda").to(dtype))


def check_grouped_matmul(gmm, ref):
    """The kernel against ``ref.grouped_matmul`` on the same inputs, entry
    by entry (``_entry_ratio``), at the olmoe path's shapes (capacity 2 at
    a decode step, 40 at a 256-row chunk; gate/up and down), at odd
    capacities and at the reduced configs' shapes, bf16 and f32."""
    import torch
    checks = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for G, M, K, N in GMM_SHAPES:
            lhs, rhs = _gmm_case(G, M, K, N, dtype, 3000 + len(checks))
            got = gmm.grouped_matmul(lhs, rhs)
            want = ref.grouped_matmul(lhs, rhs)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError("grouped_matmul: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            ratio = _entry_ratio(name, got, want).max().item()
            checks.append({"dtype": name, "G": G, "M": M, "K": K, "N": N,
                           "max_abs_err": err, "worst_over_limit": ratio})
            print(f"[check] grouped_matmul {name} G={G} M={M} K={K} N={N}: "
                  f"max|err| {err:.3e}, worst entry / its limit "
                  f"{ratio:.3f}", flush=True)
            if not ratio <= 1.0:
                raise AssertionError(f"grouped_matmul disagrees: {ratio}")
    return checks


def check_grouped_matmul_faults(gmm, ref):
    """The check must reject a kernel that drops one 64-wide K-slice or
    one group: at the 256-row chunk's gate shape (bf16), the kernel run on
    lhs with its last 64 K-columns zeroed, and separately with its last
    group zeroed, against the plain version of the intact inputs.  Raises
    unless most of the affected entries are flagged (every entry for the
    K-slice, the last group's for the group) and no other entry is."""
    import torch
    G, M, K, N = 64, 40, 2048, 1024
    lhs, rhs = _gmm_case(G, M, K, N, torch.bfloat16, 3100)
    want = ref.grouped_matmul(lhs, rhs)
    cut_k, cut_g = lhs.clone(), lhs.clone()
    cut_k[..., -64:] = 0
    cut_g[-1] = 0
    faults = {}
    for fault, cut, affected in (("last 64-wide K-slice", cut_k, slice(None)),
                                 ("last group", cut_g, slice(G - 1, G))):
        flagged = _entry_ratio("bfloat16", gmm.grouped_matmul(cut, rhs),
                               want) > 1
        others = flagged.clone()
        others[affected] = False
        faults[fault] = {
            "flagged_share_of_affected": flagged[affected].float().mean()
            .item(),
            "flagged_outside": int(others.sum().item())}
        if not (faults[fault]["flagged_share_of_affected"] > 0.5
                and faults[fault]["flagged_outside"] == 0):
            raise AssertionError(f"grouped_matmul check vs a dropped "
                                 f"{fault}: {faults[fault]}")
    print(f"[check] grouped_matmul planted faults G={G} M={M} K={K} N={N} "
          "bf16, lhs zeroed on the kernel's side only: share of the "
          "affected entries beyond their limit: " + ", ".join(
              f"{n} {f['flagged_share_of_affected']:.4f} "
              f"({f['flagged_outside']} flagged elsewhere)"
              for n, f in faults.items()), flush=True)
    return faults


def time_grouped_matmul(gmm, ref, G, M, K, N):
    """Kernel, plain and library times at one olmoe shape (bf16), two input
    sets in turn (each set's 268 MB of rhs is beyond the 50 MB L2).  The
    library yardstick, never called by the port: ``torch.bmm``."""
    import torch
    cases = [_gmm_case(G, M, K, N, torch.bfloat16, 3200 + i)
             for i in range(2)]
    kernel = [functools.partial(gmm.grouped_matmul, *c) for c in cases]
    library = [functools.partial(torch.bmm, *c) for c in cases]
    plain = [functools.partial(ref.grouped_matmul, *c) for c in cases]
    esz = 2
    nbytes = esz * (G * M * K + G * K * N + G * M * N)
    ops = 2.0 * G * M * K * N
    bound_ms, bound_by = _bound(nbytes, ops, BF16_OPS_PER_S)
    return {"shape": f"G={G} M={M} K={K} N={N} bf16", "ms":
            _time_graph_ms(kernel, min_calls=32),
            "host_ms": _time_eager_ms(kernel, 10),
            "plain_ms": _time_eager_ms(plain, 2),
            "library_ms": _time_graph_ms(library, min_calls=32),
            "library": "torch.bmm (CUDA graph, as the kernel)",
            "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops,
            "bytes": nbytes}


def _ssd_case(Bb, S, H, P, G, N, dtype, seed, dt_shift=-3.0):
    """Seeded SSD inputs on the card in the model's layouts: x, B, C
    ~N(0, 1), A = -exp(N(0, 0.25)), D ~N(0, 1), h0 ~N(0, 1) and dt =
    softplus(N(dt_shift, 1)).  At dt_shift -3 (dt ~0.05, a decay of ~5 %
    a row) the carried state reaches every row of a 128-row chunk, so a
    kernel that drops it fails; at 0 (the models' scale, dt ~0.8) it fades
    within ~10 rows."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((Bb, S, H, P), generator=g, device="cuda").to(dtype)
    dt = F.softplus(torch.randn((Bb, S, H), generator=g, device="cuda")
                    + dt_shift).to(dtype)
    A = -torch.exp(0.5 * torch.randn((H,), generator=g, device="cuda"))
    B = torch.randn((Bb, S, G, N), generator=g, device="cuda").to(dtype)
    C = torch.randn((Bb, S, G, N), generator=g, device="cuda").to(dtype)
    D = torch.randn((H,), generator=g, device="cuda")
    h0 = torch.randn((Bb, H, P, N), generator=g, device="cuda")
    return x, dt, A, B, C, D, h0


def check_ssd(tssd, ref):
    """The kernel against ``ref.ssd_chunked`` on the same card inputs,
    entry by entry (``_entry_ratio``: y in its dtype, the final state by
    the float32 rule), at mamba2's and zamba2's heads, S = 256 (two
    chunks: the state carried), 128, 64, 16 and 2 (one chunk of S rows,
    as serving cuts prompt tails), with and without h0, with D; the
    models' dt scale once per shape; G = 2 once; the final state written
    over h0 (the cache lane, in place) once; at mamba2's heads the chunks
    a whole-prompt prefill picks that are no power of two: 37 (S = 4 x
    37) and 1 (S = 131, a prime); bf16 and f32."""
    import torch
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for model, (H, P, N) in SSD_HEADS.items():
            cases += [(dtype, model, H, P, N, S, 1, h0, -3.0, False,
                       min(128, S))
                      for S in (256, 128, 64, 16, 2) for h0 in (True, False)]
            cases.append((dtype, model, H, P, N, 256, 1, True, 0.0, False,
                          128))
        H, P, N = SSD_HEADS["mamba2"]
        cases.append((dtype, "mamba2", H, P, N, 256, 2, True, -3.0, False,
                      128))
        cases.append((dtype, "mamba2", H, P, N, 256, 1, True, -3.0, True,
                      128))
        cases += [(dtype, "mamba2", H, P, N, S, 1, True, -3.0, False, Q)
                  for S, Q in ((4 * 37, 37), (131, 1))]
    checks = []
    for dtype, model, H, P, N, S, G, use_h0, shift, inplace, Q in cases:
        x, dt, A, B, C, D, h0 = _ssd_case(1, S, H, P, G, N, dtype,
                                          5000 + len(checks), shift)
        h0 = h0 if use_h0 else None
        want_y, want_s = ref.ssd_chunked(x, dt, A, B, C, D, h0, chunk=Q)
        if inplace:
            got_y, got_s = tssd.ssd(x, dt, A, B, C, D, h0, chunk=Q,
                                    state_out=h0)
        else:
            got_y, got_s = tssd.ssd(x, dt, A, B, C, D, h0, chunk=Q)
        torch.cuda.synchronize()
        if not (torch.isfinite(got_y).all() and torch.isfinite(got_s).all()):
            raise AssertionError("ssd: non-finite output")
        name = str(dtype).split(".")[1]
        ratio_y = _entry_ratio(name, got_y, want_y).max().item()
        ratio_s = _entry_ratio("float32", got_s, want_s).max().item()
        err = (got_y.float() - want_y.float()).abs().max().item()
        checks.append({"dtype": name, "model": model, "H": H, "P": P, "N": N,
                       "S": S, "G": G, "chunk": Q, "h0": use_h0,
                       "dt_shift": shift, "state_out_is_h0": inplace,
                       "max_abs_err": err, "worst_over_limit": ratio_y,
                       "state_worst_over_limit": ratio_s})
        print(f"[check] ssd {name} {model} H={H} P={P} N={N} S={S} G={G} "
              f"chunk={Q} h0={use_h0} dt_shift={shift}"
              f"{' state_out=h0' if inplace else ''}: max|err| {err:.3e}, "
              f"worst entry / its limit: y {ratio_y:.3f}, state "
              f"{ratio_s:.3f}", flush=True)
        if not (ratio_y <= 1.0 and ratio_s <= 1.0):
            raise AssertionError(f"ssd disagrees: {checks[-1]}")
    return checks


def check_ssd_faults(tssd, ref):
    """The check must reject a kernel that drops the carried state: at
    mamba2's heads, S = 256, bf16, the plain version's y from the real h0
    against the kernel (a) given h0 zeroed, (b) run on the two 128-row
    halves with no state carried from the first into the second.  Raises
    unless more than a tenth of the affected entries (all rows for (a),
    the second half for (b)) are flagged, and none of the first half for
    (b), which is the same computation."""
    import torch
    H, P, N = SSD_HEADS["mamba2"]
    x, dt, A, B, C, D, h0 = _ssd_case(1, 256, H, P, 1, N, torch.bfloat16,
                                      5100)
    want, _ = ref.ssd_chunked(x, dt, A, B, C, D, h0, chunk=128)
    zeroed, _ = tssd.ssd(x, dt, A, B, C, D, torch.zeros_like(h0), chunk=128)
    first, _ = tssd.ssd(x[:, :128], dt[:, :128], A, B[:, :128], C[:, :128],
                        D, h0, chunk=128)
    second, _ = tssd.ssd(x[:, 128:], dt[:, 128:], A, B[:, 128:],
                         C[:, 128:], D, None, chunk=128)
    faults = {}
    for fault, got, affected in (
            ("h0 zeroed", zeroed, slice(None)),
            ("no state carried between halves",
             torch.cat([first, second], dim=1), slice(128, None))):
        flagged = _entry_ratio("bfloat16", got, want) > 1
        others = flagged.clone()
        others[:, affected] = False
        faults[fault] = {
            "flagged_share_of_affected": flagged[:, affected].float().mean()
            .item(),
            "flagged_outside": int(others.sum().item())}
        if not (faults[fault]["flagged_share_of_affected"] > 0.1
                and faults[fault]["flagged_outside"] == 0):
            raise AssertionError(f"ssd check vs a kernel with {fault}: "
                                 f"{faults[fault]}")
    print(f"[check] ssd planted faults mamba2 heads S=256 bf16, against the "
          "plain version from the real h0: share of the affected entries "
          "beyond their limit: " + ", ".join(
              f"{n} {f['flagged_share_of_affected']:.4f} "
              f"({f['flagged_outside']} flagged elsewhere)"
              for n, f in faults.items()), flush=True)
    return faults


def time_ssd(tssd, ref, model):
    """Kernel and plain times of one 256-row prefill chunk at batch 1 (the
    serving shape: bf16, h0 from the slot's lane and the final state
    written back over it), at the models' dt scale.  The inputs (4-6 MB)
    stay in the 50 MB L2, as in serving, where the chunk's projections
    have just written them.  No single PyTorch call computes SSD: the
    library column is none."""
    import torch
    H, P, N = SSD_HEADS[model]
    S, G, Q = 256, 1, 128
    x, dt, A, B, C, D, h0 = _ssd_case(1, S, H, P, G, N, torch.bfloat16,
                                      5200, 0.0)
    kernel = [functools.partial(tssd.ssd, x, dt, A, B, C, D, h0, chunk=Q,
                                state_out=h0)]
    plain = [functools.partial(ref.ssd_chunked, x, dt, A, B, C, D, h0,
                               chunk=Q)]
    esz = 2
    nbytes = (esz * (2 * S * H * P + S * H + 2 * S * G * N)
              + 4 * (2 * H + 2 * H * P * N))
    # per head and chunk: C B^T and M x over the j <= i triangle, C state^T
    # and the state update over all rows
    tri = Q * (Q + 1) / 2
    ops = H * (S // Q) * (2 * tri * N + 2 * tri * P + 4 * Q * N * P)
    bound_ms, bound_by = _bound(nbytes, ops, BF16_OPS_PER_S)
    return {"shape": f"Bb=1 S={S} H={H} P={P} G={G} N={N} chunk={Q} bf16, "
                     "h0 in place",
            "ms": _time_graph_ms(kernel), "host_ms": _time_eager_ms(kernel,
                                                                    20),
            "plain_ms": _time_eager_ms(plain, 5), "library_ms": None,
            "library": "none: no single PyTorch call computes SSD",
            "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops,
            "bytes": nbytes}


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

class PhaseClock:
    """The engine's ``power=`` hook, used here as a stopwatch: each phase
    is bracketed by device synchronisation, so its seconds are the card's
    time for that phase (it adds syncs beyond the engine's own count)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.seconds = {"prefill": 0.0, "decode": 0.0}
        self.entries = {"prefill": 0, "decode": 0}
        self.calls = {"prefill": 0, "decode": 0}

    @contextlib.contextmanager
    def phase(self, name, calls=None):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield None
        torch.cuda.synchronize()
        self.seconds[name] += time.perf_counter() - t0
        self.entries[name] += 1
        self.calls[name] += calls or 1


def _engine(cfg, run, params, clock, **kw):
    from repro_torch.models.layers import Ctx
    from repro_torch.serving.engine import ServeEngine
    return ServeEngine(cfg, run, Ctx(run, "cuda"), params, batch_size=8,
                       max_seq=2048, prefill_chunk=256, decode_chunk=8,
                       power=clock, **kw)


def _serve(tfa, engine, clock, cfg, specs):
    """Serve fresh requests made from ``specs`` [(prompt, max_new_tokens,
    prefix_len)] with every count set to 0 just before and read just
    after; every request must get exactly its tokens."""
    import torch
    from repro_torch.serving.engine import Request
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=n, prefix_len=pl)
            for i, (p, n, pl) in enumerate(specs)]
    clock.reset()
    engine.sync_count = 0
    tfa.reset_launch_counts()
    t0 = time.perf_counter()
    done = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in tfa.KERNELS}
    if sorted(r.uid for r in done) != list(range(len(specs))):
        raise AssertionError("not every request finished")
    for r in done:
        if len(r.generated) != r.max_new_tokens:
            raise AssertionError(f"request {r.uid}: {len(r.generated)} "
                                 f"tokens, wanted {r.max_new_tokens}")
        if not all(0 <= t < cfg.vocab for t in r.generated):
            raise AssertionError(f"request {r.uid}: token outside vocab")
    return done, wall, launches


def _serving_launches(cfg, steps, specs, paged):
    """The exact launches of a serving arm of ``steps`` decode steps on
    the requests ``specs``, prefilled in 256-row chunks: per attention
    layer (every layer of a decoder, zamba2's shared block once per
    invocation, none in mamba2) and per step or chunk one attention
    launch and, for an MoE model, three expert products (gate, up, down);
    one cache write per decode step (dense: prefill chunks write by a
    slice copy) or per step and chunk (paged); one ``ssd`` per Mamba layer
    and prefill chunk of two rows or more (a 1-row chunk takes the decode
    step's recurrence, as in the reference).  No training kernel runs."""
    from repro_torch.models.lm import zamba_structure
    from repro_torch.serving.scheduler import chunk_plan
    plans = [chunk_plan(len(p), 256) for p, _, _ in specs]
    chunks = sum(len(plan) for plan in plans)
    attn = {"ssm": 0, "hybrid": zamba_structure(cfg)[0]}.get(
        cfg.family, cfg.n_layers)
    mamba = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    n = attn * (steps + chunks)
    return {"flash_decode": 0 if paged else n,
            "flash_decode_paged": n if paged else 0,
            "cache_update": 0 if paged else attn * steps,
            "cache_update_paged": n if paged else 0,
            "flash_attention": 0, "flash_attention_bwd": 0,
            "grouped_matmul": 3 * n if cfg.n_experts else 0,
            "ssd": mamba * sum(size >= 2 for plan in plans for size in plan)}


def _check_launches(arm, launches, want):
    """The arm's kernels launched exactly ``want`` times (each > 0), the
    other arm's kernels not at all."""
    ran = [k for k, n in want.items() if n]
    if launches != want or not ran \
            or min(launches[k] for k in ran) <= 0:
        raise AssertionError(f"{arm} arm: kernel launches {launches}, "
                             f"expected {want}")


def _arm_stats(engine, clock, done, wall, specs):
    """The arm's numbers; ``prefill_chunks`` counts the chunk programs the
    engine reported to its phase hook (a shared prefix skips its own)."""
    import torch
    n_tok = sum(len(r.generated) for r in done)
    return {"requests": len(done), "wall_s": wall, "tok_per_s": n_tok / wall,
            "new_tokens": n_tok,
            "prompt_tokens": sum(len(p) for p, _, _ in specs),
            "prefill_s": clock.seconds["prefill"],
            "decode_s": clock.seconds["decode"],
            "host_syncs": engine.sync_count,
            "decode_steps": engine.sync_count * engine.decode_chunk,
            "prefill_chunks": clock.calls["prefill"],
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2**30}


def _print_arm(name, st, launches):
    print(f"[serve:{name}] {st['requests']} requests, "
          f"{st['prompt_tokens']} prompt tokens, "
          f"{st['new_tokens']} new tokens in {st['wall_s']:.2f}s: "
          f"{st['tok_per_s']:.1f} tok/s; prefill {st['prefill_s']:.2f}s, "
          f"decode {st['decode_s']:.2f}s "
          f"({st['decode_s'] / st['decode_steps'] * 1e3:.1f} ms per decode "
          f"step); {st['host_syncs']} host syncs "
          f"({st['decode_steps']} decode steps, {st['prefill_chunks']} "
          f"prefill chunks); launches {launches}; max_memory_allocated "
          f"{st['max_memory_allocated_gib']:.2f} GiB", flush=True)


def _card_weights(cfg, run):
    """Seeded random f32 masters of ``cfg`` made on the card (seed 0) and
    cast once to the compute dtype (``lm.prepare_params``, as the engine
    does); the masters are freed before this returns."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import init_params
    masters = init_params(lm.model_decls(cfg),
                          torch.Generator(device="cuda").manual_seed(0),
                          "cuda")
    params = lm.prepare_params(Ctx(run, "cuda"), masters)
    del masters
    torch.cuda.empty_cache()
    return params


def serve_full_width(tfa, arch=ARCH, tag=""):
    """Phase 3a (llama) and the first arm of 3d (``arch=MOE_ARCH``, arms
    named ``olmoe-*``): the dense arm.  Returns its launches and stats, and
    what the later arms reuse: (cfg, run, card params, request specs,
    streams)."""
    import torch
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.models import lm
    from repro_torch.models.params import param_count
    from repro_torch.serving.engine import Request

    cfg = get_model_config(arch)
    run = get_run_config(arch, remat="none")          # bf16 compute
    decls = lm.model_decls(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _card_weights(cfg, run)
    clock = PhaseClock()
    engine = _engine(cfg, run, params, clock)
    del params
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers d{cfg.d_model} "
          f"vocab {cfg.vocab}, {param_count(decls) / 1e9:.3f} B params, "
          f"weights ready in {time.perf_counter() - t0:.1f}s (peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB with the f32 "
          f"masters; {torch.cuda.memory_allocated() / 1e9:.2f} GB held)",
          flush=True)

    rng = np.random.default_rng(0)
    warm = Request(uid=-1, prompt=rng.integers(0, cfg.vocab, 64).tolist(),
                   max_new_tokens=8)
    engine.generate([warm])                   # first-call costs, not counted
    specs = []
    for _ in range(16):
        plen = int(rng.integers(64, 1025))
        specs.append((rng.integers(0, cfg.vocab, plen).tolist(),
                      int(rng.integers(32, 129)), 0))
    torch.cuda.reset_peak_memory_stats()
    done, wall, launches = _serve(tfa, engine, clock, cfg, specs)
    stats = _arm_stats(engine, clock, done, wall, specs)
    _check_launches(tag + "dense", launches, _serving_launches(
        cfg, stats["decode_steps"], specs, paged=False))
    _print_arm(tag + "dense", stats, launches)
    shared = (cfg, run, engine.params, specs,
              {r.uid: r.generated for r in done})
    del engine
    torch.cuda.empty_cache()
    return launches, stats, shared


def serve_arm(tfa, cfg, run, params, specs, dense_streams, name, paged,
              gate_equal=True):
    """Phase 3b (and 3d): the dense arm's 16 requests once more, through
    ``paged=True`` or dense; every stream must equal the dense arm's
    (with ``gate_equal``; else the count is printed) and only that
    engine's kernels may launch."""
    import torch
    from repro_torch.serving.engine import Request
    clock = PhaseClock()
    engine = _engine(cfg, run, params, clock,
                     **(dict(paged=True, block_size=16) if paged else {}))
    warm = Request(uid=-1, max_new_tokens=8, prompt=np.random.default_rng(5)
                   .integers(0, cfg.vocab, 64).tolist())
    engine.generate([warm])                   # first-call costs, not counted
    torch.cuda.reset_peak_memory_stats()
    done, wall, launches = _serve(tfa, engine, clock, cfg, specs)
    stats = _arm_stats(engine, clock, done, wall, specs)
    same = sum(r.generated == dense_streams[r.uid] for r in done)
    stats["streams_equal_dense"] = same
    _print_arm(name, stats, launches)
    msg = f"[serve:{name}] {same}/16 streams equal the dense arm's"
    if not gate_equal:
        msg += (" (not gated: a done lane reads stale rows of its own "
                "slot, which differ between the dense cache and the "
                "pool, and under capacity its routing can drop a live "
                "lane's assignment -- the reference engine does the same)")
    if paged:
        stats.update(n_blocks=engine.n_blocks,
                     peak_used_blocks=engine.peak_used_blocks,
                     used_blocks_at_end=engine._alloc.used_blocks)
        msg += (f"; pool {engine.n_blocks} + 1 blocks of 16, peak "
                f"{engine.peak_used_blocks} used, "
                f"{engine._alloc.used_blocks} used at the end")
    print(msg, flush=True)
    if gate_equal and same != len(specs):
        raise AssertionError(f"{name} arm: {same}/16 streams equal dense")
    _check_launches(name, launches, _serving_launches(
        cfg, stats["decode_steps"], specs, paged))
    if paged and engine._alloc.used_blocks:
        raise AssertionError(f"{name} arm: the pool did not drain")
    del engine
    torch.cuda.empty_cache()
    return launches, stats


PREFIX_LEN = 600     # 37 full blocks of 16 + 8 rows: every sharer copies


def serve_prefix_sharing(tfa, cfg, run, params):
    """Phase 3c: 16 requests opening with one 600-token system prefix,
    served dense and with paged prefix sharing."""
    import torch
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, cfg.vocab, PREFIX_LEN).tolist()
    specs = [(prefix + rng.integers(0, cfg.vocab,
                                    int(rng.integers(16, 401))).tolist(),
              int(rng.integers(32, 65)), PREFIX_LEN) for _ in range(16)]
    warm = Request(uid=-1, max_new_tokens=8, prompt=np.random.default_rng(6)
                   .integers(0, cfg.vocab, 64).tolist())
    out = {}
    for name, kw in (("dense", {}),
                     ("shared", dict(paged=True, block_size=16,
                                     prefix_sharing=True))):
        clock = PhaseClock()
        engine = _engine(cfg, run, params, clock, **kw)
        engine.generate([warm])
        torch.cuda.reset_peak_memory_stats()
        done, wall, launches = _serve(tfa, engine, clock, cfg, specs)
        st = _arm_stats(engine, clock, done, wall, specs)
        st["launches"] = launches
        st["streams"] = {r.uid: r.generated for r in done}
        if name == "shared":
            st.update(prefill_tokens_skipped=engine.prefill_tokens_skipped,
                      cow_copies=engine.cow_copies,
                      peak_used_blocks=engine.peak_used_blocks,
                      used_blocks_at_end=engine._alloc.used_blocks,
                      registry_blocks=engine._alloc.blocks_for(PREFIX_LEN),
                      registry_entries=len(engine._registry))
        out[name] = st
        _print_arm(f"prefix-{name}", st, launches)
        del engine
        torch.cuda.empty_cache()
    sh = out["shared"]
    L, K, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    block_bytes = L * 2 * 16 * K * D * 2
    dense_bytes = L * 2 * 8 * 2048 * K * D * 2
    same = sum(sh["streams"][u] == out["dense"]["streams"][u]
               for u in range(16))
    sh.update(resident_kv_bytes_peak=sh["peak_used_blocks"] * block_bytes,
              dense_kv_bytes=dense_bytes, streams_equal_dense=same)
    print(f"[serve:prefix] {PREFIX_LEN}-token shared prefix on 16 requests: "
          f"dense {out['dense']['tok_per_s']:.1f} tok/s, prefill "
          f"{out['dense']['prefill_s']:.2f}s; shared "
          f"{sh['tok_per_s']:.1f} tok/s, prefill {sh['prefill_s']:.2f}s; "
          f"skipped {sh['prefill_tokens_skipped']} prefill rows, "
          f"{sh['cow_copies']} CoW copies; peak {sh['peak_used_blocks']} "
          f"blocks = {sh['resident_kv_bytes_peak'] / 1e9:.3f} GB of KV "
          f"resident vs the dense cache's {dense_bytes / 1e9:.3f} GB; "
          f"{sh['used_blocks_at_end']} blocks held at the end (registry "
          f"{sh['registry_blocks']}); {same}/16 streams equal the dense "
          f"engine's", flush=True)
    if sh["prefill_tokens_skipped"] != 15 * PREFIX_LEN \
            or sh["cow_copies"] != 15:
        raise AssertionError(f"prefix arm: skipped "
                             f"{sh['prefill_tokens_skipped']}, CoW "
                             f"{sh['cow_copies']}")
    if sh["used_blocks_at_end"] != sh["registry_blocks"] \
            or sh["registry_entries"] != 1:
        raise AssertionError("prefix arm: the pool holds more than the "
                             "registry's prefix")
    for st in out.values():
        del st["streams"]
    return out


def _profile_window(name, label, steps, run, groups=None, top_n=8):
    """Run ``run()`` (``steps`` steps, ending in a synchronise) under
    torch.profiler and print where the device time went: device busy
    share = the kernels' summed device time over the window's wall time,
    the top kernels, and the summed time of each of ``groups`` ({label:
    name fragments}) per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    dev = [(e.key, e.device_time_total, e.count)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy_s = sum(t for _, t, _ in dev) / 1e6
    dev.sort(key=lambda r: -r[1])
    top = [{"kernel": k[:80], "ms_per_step": t / 1e3 / steps,
            "launches_per_step": n / steps} for k, t, n in dev[:top_n]]
    by_group = {g: sum(t for k, t, _ in dev
                       if any(f in k for f in frags)) / 1e3 / steps
                for g, frags in (groups or {}).items()}
    if dev:
        print(f"[profile:{name}] {label}: {wall / steps * 1e3:.2f} ms per "
              f"step, device busy {busy_s / steps * 1e3:.2f} ms per step "
              f"({100 * busy_s / wall:.1f}% busy, "
              f"{100 * (1 - busy_s / wall):.1f}% idle)", flush=True)
        for row in top:
            print(f"[profile:{name}]   {row['ms_per_step']:.3f} ms/step "
                  f"x{row['launches_per_step']:.0f}  {row['kernel']}",
                  flush=True)
        for g, ms in by_group.items():
            print(f"[profile:{name}]   group {g}: {ms:.3f} ms/step "
                  f"({100 * ms / (busy_s / steps * 1e3):.1f}% of the device "
                  "busy time)", flush=True)
    else:
        print(f"[profile:{name}] the profiler saw no device events: device "
              "busy share not measured", flush=True)
    return {"profile_ms_per_step": wall / steps * 1e3,
            "profile_device_busy_ms_per_step":
                busy_s / steps * 1e3 if dev else None,
            "profile_top_kernels": top,
            "profile_group_ms_per_step": by_group if dev else None}


def profile_decode(cfg, run, params, name, groups=None, **kw):
    """Where a steady decode step's time goes: two decode chunks of 8
    full lanes of a fresh engine under torch.profiler.  It runs after
    every serving arm, as the launches slow down once the profiler has
    run."""
    import torch
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(7)
    engine = _engine(cfg, run, params, None, **kw)
    engine.start([Request(uid=100 + i,
                          prompt=rng.integers(0, cfg.vocab, 128).tolist(),
                          max_new_tokens=24) for i in range(8)])
    engine.step()                             # admission + first chunk
    torch.cuda.synchronize()

    def run_window():
        engine.step()
        engine.step()
        torch.cuda.synchronize()

    return _profile_window(name, "steady decode, 8 lanes",
                           2 * engine.decode_chunk, run_window,
                           groups=groups)


def serve_moe_no_drop(tfa, cfg, run, params, specs):
    """Phase 3d: the paged MoE path against the dense one, bit for bit,
    where done lanes cannot reach live ones.  At capacity factor E/top_k
    (8.0 for olmoe) the capacity is the call's token count, so no
    assignment is ever dropped, and every row's expert products, and so
    every live lane's output, depend on that lane alone.  The dense arm's
    16 requests, untimed, dense and then paged: exact launches, and 16/16
    paged streams equal the dense ones."""
    import torch
    cfg = dataclasses.replace(cfg,
                              capacity_factor=cfg.n_experts / cfg.top_k)
    streams = {}
    for paged in (False, True):
        name = "olmoe-nodrop-" + ("paged" if paged else "dense")
        clock = PhaseClock()
        engine = _engine(cfg, run, params, clock,
                         **(dict(paged=True, block_size=16) if paged else {}))
        done, _, launches = _serve(tfa, engine, clock, cfg, specs)
        steps = engine.sync_count * engine.decode_chunk
        _check_launches(name, launches, _serving_launches(
            cfg, steps, specs, paged))
        streams[paged] = {r.uid: r.generated for r in done}
        del engine
        torch.cuda.empty_cache()
    same = sum(streams[True][u] == streams[False][u] for u in streams[False])
    print(f"[serve:olmoe-nodrop] capacity factor {cfg.capacity_factor} "
          f"(capacity = the call's token count: nothing dropped): "
          f"{same}/16 paged streams equal the dense ones; launches exact "
          f"in both", flush=True)
    if same != len(specs):
        raise AssertionError(f"olmoe no-drop arms: {same}/16 paged streams "
                             "equal the dense ones")
    return {"capacity_factor": cfg.capacity_factor,
            "paged_streams_equal_dense": same}


class SyncTally:
    """The engine's ``power=`` hook in the replay arm: it notes which
    caught warnings each phase raised, so that every synchronising call
    can be filed under the phase it came in.  It synchronises nothing."""

    def __init__(self):
        self.caught, self.spans = [], []

    @contextlib.contextmanager
    def phase(self, name, calls=None):
        i0 = len(self.caught)
        yield None
        self.spans.append((name, i0, len(self.caught)))

    def where(self, i):
        for name, i0, i1 in self.spans:
            if i0 <= i < i1:
                return name
        return "outside"


def _count_syncs(engine, tally, specs):
    """Serve fresh requests from ``specs`` under
    ``torch.cuda.set_sync_debug_mode("warn")``, where every synchronising
    CUDA call warns, and file each warning under the phase ``tally`` (the
    engine's ``power=`` hook) saw it in: prefill, decode, or outside both,
    where the engine admits requests and fetches each decode chunk's
    tokens.  Returns (finished requests, syncs by place, their sites)."""
    import warnings
    import torch
    from repro_torch.serving.engine import Request
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=n, prefix_len=pl)
            for i, (p, n, pl) in enumerate(specs)]
    engine.sync_count = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tally.caught = caught
        torch.cuda.set_sync_debug_mode("warn")
        try:
            done = engine.generate(reqs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = {"prefill": 0, "decode": 0, "outside": 0}
    sites = {k: {} for k in syncs}
    for i, w in enumerate(caught):
        if "called a synchronizing CUDA operation" not in str(w.message):
            continue
        where = tally.where(i)
        syncs[where] += 1
        site = f"{Path(w.filename).name}:{w.lineno}"
        sites[where][site] = sites[where].get(site, 0) + 1
    return done, syncs, sites


def serve_moe_replay(tfa, cfg, run, params, specs, dense_streams):
    """Phase 3d, the last arm: the dense arm's requests served once more,
    untimed, to read what the timed arms must not pay for.
      * Host syncs, by where they happen: under
        ``torch.cuda.set_sync_debug_mode("warn")`` every synchronising
        CUDA call warns, and ``SyncTally`` files each warning under the
        phase it came in (prefill, decode) or outside both, where the
        engine admits requests and fetches each decode chunk's tokens.
        The only syncs allowed are those fetches, one per chunk.
      * Capacity drops at the decode steps: the (token, expert)
        assignments that capacity keeps and drops, for live lanes and for
        done lanes (fed token 0 at index max_seq), counted on the card
        over every decode step and layer.
    Every stream must equal the dense arm's."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.serving.engine import Request

    tally = SyncTally()
    engine = _engine(cfg, run, params, tally)
    engine.generate([Request(uid=-1, max_new_tokens=8, prompt=list(range(
        1, 65)))])                            # first-call costs, not counted
    tally.spans = []
    counts = torch.zeros(4, dtype=torch.int64, device="cuda")
    lanes = {}
    real_forward, real_dispatch = lm.forward, L._moe_dispatch_local

    def forward(ctx, cfg_, params_, batch, *, cache=None, cache_index=None):
        step = torch.is_tensor(cache_index) and cache_index.ndim == 1
        lanes["done"] = cache_index >= engine.max_seq if step else None
        return real_forward(ctx, cfg_, params_, batch, cache=cache,
                            cache_index=cache_index)

    def dispatch(cfg_, xf, top_e, capacity):
        out = real_dispatch(cfg_, xf, top_e, capacity)
        if lanes["done"] is not None:
            # [live kept, live dropped, done kept, done dropped]
            keep = out[3].view(lanes["done"].shape[0], -1)
            idx = (2 * lanes["done"].long()[:, None]
                   + (~keep).long()).reshape(-1)
            counts.index_add_(0, idx, torch.ones_like(idx))
        return out

    lm.forward, L._moe_dispatch_local = forward, dispatch
    try:
        done, syncs, sites = _count_syncs(engine, tally, specs)
    finally:
        lm.forward, L._moe_dispatch_local = real_forward, real_dispatch
    same = sum(r.generated == dense_streams[r.uid] for r in done)
    lk, ld, dk, dd = counts.tolist()
    drops = {"live_assignments": lk + ld, "live_dropped": ld,
             "live_dropped_share": ld / max(lk + ld, 1),
             "done_assignments": dk + dd, "done_dropped": dd,
             "done_dropped_share": dd / max(dk + dd, 1),
             "decode_steps": engine.sync_count * engine.decode_chunk,
             "layers": cfg.n_layers}
    print(f"[serve:olmoe-syncs] {same}/16 streams equal the dense arm's; "
          f"synchronising calls under torch.cuda.set_sync_debug_mode: "
          f"decode phases {syncs['decode']}, outside the phases "
          f"{syncs['outside']} ({engine.sync_count} decode chunks: the "
          f"engine's fetch) at {sites['outside']}, prefill phases "
          f"{syncs['prefill']} at {sites['prefill']}", flush=True)
    print(f"[serve:olmoe-drops] capacity 2 per expert at a batch-8 decode "
          f"step ({drops['decode_steps']} steps x {cfg.n_layers} layers): "
          f"live lanes {ld} of {lk + ld} (token, expert) assignments "
          f"dropped ({100 * drops['live_dropped_share']:.2f}%), done lanes "
          f"{dd} of {dk + dd} ({100 * drops['done_dropped_share']:.2f}%)",
          flush=True)
    if same != len(specs):
        raise AssertionError(f"olmoe replay: {same}/16 streams equal dense")
    if syncs != {"prefill": 0, "decode": 0, "outside": engine.sync_count}:
        raise AssertionError(f"olmoe replay: host syncs {syncs} {sites}, "
                             f"expected one per decode chunk and no other")
    del engine
    torch.cuda.empty_cache()
    return {"syncs": syncs, "sync_sites": sites, "drops": drops,
            "replay_streams_equal_dense": same}


def serve_ssm_replay(tfa, cfg, run, params, specs, dense_streams, tag):
    """Phase 3e: a Mamba model's dense arm replayed, untimed: every stream
    equals the dense arm's, and the only host syncs are the engine's
    fetches, one per decode chunk (the Mamba lanes' reset at admission,
    the in-place state and conv updates and the ``ssd`` wrapper sync
    nothing)."""
    import torch
    from repro_torch.serving.engine import Request
    tally = SyncTally()
    engine = _engine(cfg, run, params, tally)
    engine.generate([Request(uid=-1, max_new_tokens=8, prompt=list(range(
        1, 65)))])                            # first-call costs, not counted
    tally.spans = []
    done, syncs, sites = _count_syncs(engine, tally, specs)
    same = sum(r.generated == dense_streams[r.uid] for r in done)
    print(f"[serve:{tag}syncs] {same}/16 streams equal the dense arm's; "
          f"synchronising calls under torch.cuda.set_sync_debug_mode: "
          f"decode phases {syncs['decode']}, outside the phases "
          f"{syncs['outside']} ({engine.sync_count} decode chunks: the "
          f"engine's fetch) at {sites['outside']}, prefill phases "
          f"{syncs['prefill']} at {sites['prefill']}", flush=True)
    if same != len(specs):
        raise AssertionError(f"{tag}replay: {same}/16 streams equal dense")
    if syncs != {"prefill": 0, "decode": 0, "outside": engine.sync_count}:
        raise AssertionError(f"{tag}replay: host syncs {syncs} {sites}, "
                             f"expected one per decode chunk and no other")
    del engine
    torch.cuda.empty_cache()
    return {"syncs": syncs, "sync_sites": sites,
            "replay_streams_equal_dense": same}


def _refused(what, make, expect):
    """``make()`` must raise ValueError with ``expect`` in its message."""
    try:
        make()
    except ValueError as e:
        if expect not in str(e):
            raise
        print(f"[serve:refused] {what}: ValueError({str(e)!r})", flush=True)
        return str(e)
    raise AssertionError(f"{what} did not raise")


def serve_ssm(tfa):
    """Phase 3e: full-width, full-depth mamba2-370m (48 Mamba-2 layers,
    seeded random weights, bf16 compute with A_log, D, dt_bias and the
    gated norm kept f32) on the engine settings of the other arms and 16
    seeded requests: the dense arm (exact launches: 48 ``ssd`` per prefill
    chunk of two rows or more, no attention kernel), its untimed replay
    (same streams, one host sync per decode chunk and no other), and the
    paged constructor, which must refuse.  Returns (launches, stats,
    shared)."""
    launches, stats, shared = serve_full_width(tfa, SSM_ARCH, "mamba2-")
    stats.update(serve_ssm_replay(tfa, *shared, "mamba2-"))
    cfg, run, params = shared[:3]
    stats["paged_refused"] = _refused(
        "mamba2 paged", lambda: _engine(cfg, run, params, None, paged=True,
                                        block_size=16),
        "no sequence rows to page")
    return launches, stats, shared


def serve_hybrid(tfa):
    """Phase 3f: full-width, full-depth zamba2-1.2b (38 Mamba-2 layers and
    the shared attention block, head_dim 64, after every 6 of them, with
    per-invocation LoRA on q): the dense arm, then paged
    (``block_size=16``), whose 16 streams must equal the dense arm's bit
    for bit (nothing couples lanes: no capacity, and a done lane's stale
    rows reach only itself); exact launches in both (38 ``ssd`` per chunk
    of two rows or more, 6 attention and 6 cache launches per decode step
    and, paged, per chunk); and prefix sharing, which must refuse.
    Returns (dense launches, paged launches, stats, shared)."""
    launches, stats, shared = serve_full_width(tfa, HYBRID_ARCH, "zamba2-")
    paged_launches, paged = serve_arm(tfa, *shared, "zamba2-paged", True)
    cfg, run, params = shared[:3]
    stats["paged"] = paged
    stats["prefix_sharing_refused"] = _refused(
        "zamba2 prefix sharing", lambda: _engine(
            cfg, run, params, None, paged=True, block_size=16,
            prefix_sharing=True), "recurrent state cannot be row-shared")
    return launches, paged_launches, stats, shared


# ---------------------------------------------------------------------------
# phase 4: logits parity at full width, reduced depth
# ---------------------------------------------------------------------------

def logits_parity():
    import torch
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import (make_decode_step,
                                            make_prefill_chunk_step)
    from repro_torch.serving.scheduler import chunk_plan

    cfg = dataclasses.replace(get_model_config(ARCH), n_layers=2)
    run = get_run_config(ARCH, remat="none")
    ctx = Ctx(run, "cuda")
    cpu_ctx = Ctx(run.replace(compute_dtype="float32"), "cpu")
    params = init_params(lm.model_decls(cfg), torch.Generator().manual_seed(1),
                         "cpu")
    card = lm.prepare_params(ctx, params)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in (37, 100, 256, 300)]
    cache = lm.init_cache(ctx, cfg, len(prompts), 512)
    step = make_prefill_chunk_step(cfg, run, ctx)
    first = []
    for sid, prompt in enumerate(prompts):
        idx = 0
        for size in chunk_plan(len(prompt), 256):
            toks = torch.tensor([prompt[idx:idx + size]], dtype=torch.int32,
                                device="cuda")
            cache, logits = step(card, cache, toks, sid, idx)
            idx += size
        first.append(logits[0].float().cpu())
    nxt = torch.stack([lg.argmax() for lg in first]).int()
    index = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                         device="cuda")
    _, dec = make_decode_step(cfg, run, ctx)(
        card, cache, nxt[:, None].cuda(), index)
    dec = dec.float().cpu()
    worst = 0.0
    for i, prompt in enumerate(prompts):
        toks = torch.tensor([prompt + [int(nxt[i])]])
        h, _, _ = lm.forward(cpu_ctx, cfg, params, {"tokens": toks})
        want = lm.logits_for(cpu_ctx, cfg, params, h[:, -2:])[0]
        worst = max(worst, (first[i] - want[0]).abs().max().item(),
                    (dec[i] - want[1]).abs().max().item())
    print(f"[parity] {cfg.name} d{cfg.d_model} vocab {cfg.vocab}, 2 layers: "
          f"card bf16 (kernels) vs CPU f32 (plain) last-prompt-token and "
          f"first-decode logits over 4 prompts: max|diff| {worst:.4f} "
          f"(tol {PARITY_TOL})", flush=True)
    if not worst <= PARITY_TOL:
        raise AssertionError(f"logits parity {worst} > {PARITY_TOL}")
    return worst


# [parity:olmoe], the f32 gate: the card (kernels, TF32 off) and the CPU
# (plain versions) route identically and then differ by summation order
# only, through 2 layers, 2048- and 1024-term sums and a 50304-wide
# unembedding (logits ~N(0, 1) here): ~1e-5 expected, 1e-3 allowed
MOE_PARITY_TOL = 1e-3


def _moe_steps(ctx, cfg, params, prompts, nxt=None):
    """Each prompt prefilled into its own slot of a 4-slot cache in
    256-row chunks (batch 1), then one decode step of the 4 slots.
    Returns (last-prompt-token logits (4, V), decode logits (4, V), the
    decode step's input tokens, every router call's top_e), on the CPU in
    float32.  ``nxt``: the decode step's tokens (default: the argmax of
    the prefill logits)."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.serving.engine import (make_decode_step,
                                            make_prefill_chunk_step)
    from repro_torch.serving.scheduler import chunk_plan

    p = lm.prepare_params(ctx, params)
    routes = []
    real = L._moe_router

    def tap(cfg_, p_, xf):
        out = real(cfg_, p_, xf)
        routes.append(out[1])
        return out

    L._moe_router = tap
    try:
        cache = lm.init_cache(ctx, cfg, len(prompts), 512)
        step = make_prefill_chunk_step(cfg, ctx.run, ctx)
        first = []
        for sid, prompt in enumerate(prompts):
            idx = 0
            for size in chunk_plan(len(prompt), 256):
                toks = torch.tensor([prompt[idx:idx + size]],
                                    dtype=torch.int32, device=ctx.device)
                cache, logits = step(p, cache, toks, sid, idx)
                idx += size
            first.append(logits[0].float().cpu())
        first = torch.stack(first)
        nxt = first.argmax(-1).int() if nxt is None else nxt
        index = torch.tensor([len(q) for q in prompts], dtype=torch.int32,
                             device=ctx.device)
        _, dec = make_decode_step(cfg, ctx.run, ctx)(
            p, cache, nxt[:, None].to(ctx.device), index)
    finally:
        L._moe_router = real
    return first, dec.float().cpu(), nxt, [r.cpu() for r in routes]


def _routed_apart(a, b, E):
    """The share of (token, expert) assignments in ``a`` missing from
    ``b`` (top_e lists of the same calls)."""
    import torch
    missing = total = 0
    for x, y in zip(a, b):
        ox = torch.zeros((x.shape[0], E)).scatter_(1, x, 1.0)
        oy = torch.zeros((y.shape[0], E)).scatter_(1, y, 1.0)
        missing += int((ox * (1 - oy)).sum())
        total += x.numel()
    return missing / total


def olmoe_parity():
    """Phase 4, MoE: olmoe at full width and 2 layers from one set of
    seeded weights, the same prefill chunks and decode step on the card
    and on the CPU.  The gate: the card in f32 (kernels, TF32 off) routes
    every router call exactly as the CPU in f32 (plain path), and its
    logits agree within MOE_PARITY_TOL.  Printed, not gated: the card in
    bf16 against the CPU in f32 (max |logit diff| and the share of
    assignments routed differently; routing is discontinuous, so a bf16
    flip is no kernel fault)."""
    import torch
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_model_config(MOE_ARCH), n_layers=2)
    run32 = get_run_config(MOE_ARCH, remat="none", compute_dtype="float32")
    run16 = get_run_config(MOE_ARCH, remat="none")
    params = init_params(lm.model_decls(cfg), torch.Generator().manual_seed(1),
                         "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in (37, 100, 256, 300)]
    cpu_first, cpu_dec, nxt, cpu_routes = _moe_steps(Ctx(run32, "cpu"), cfg,
                                                     params, prompts)
    out = {}
    for name, run in (("f32", run32), ("bf16", run16)):
        gmm.grouped_matmul.launches = 0
        first, dec, _, routes = _moe_steps(Ctx(run, "cuda"), cfg, params,
                                           prompts, nxt)
        diff = max((first - cpu_first).abs().max().item(),
                   (dec - cpu_dec).abs().max().item())
        same = (len(routes) == len(cpu_routes)
                and all(torch.equal(a, b) for a, b in zip(routes, cpu_routes)))
        out[name] = {"max_abs_logit_diff": diff,
                     "router_calls": len(routes),
                     "routing_identical": same,
                     "routed_apart_share": _routed_apart(cpu_routes, routes,
                                                         cfg.n_experts),
                     "grouped_matmul_launches": gmm.grouped_matmul.launches}
        torch.cuda.empty_cache()
    f32, b16 = out["f32"], out["bf16"]
    print(f"[parity:olmoe] {cfg.name} d{cfg.d_model} {cfg.n_experts} experts "
          f"top-{cfg.top_k}, 2 layers, prefill chunks + one decode step of "
          f"4 prompts ({len(cpu_routes)} router calls): card f32 (kernels, "
          f"{f32['grouped_matmul_launches']} grouped_matmul launches) vs "
          f"CPU f32: routing identical {f32['routing_identical']}, "
          f"max|logit diff| {f32['max_abs_logit_diff']:.3e} (tol "
          f"{MOE_PARITY_TOL}); card bf16 vs CPU f32 (not gated): max|logit "
          f"diff| {b16['max_abs_logit_diff']:.4f}, "
          f"{100 * b16['routed_apart_share']:.2f}% of assignments routed "
          f"differently", flush=True)
    if not f32["routing_identical"]:
        raise AssertionError(f"[parity:olmoe] f32 routing differs: "
                             f"{f32['routed_apart_share']}")
    if not f32["max_abs_logit_diff"] <= MOE_PARITY_TOL:
        raise AssertionError(f"[parity:olmoe] f32 logits differ by "
                             f"{f32['max_abs_logit_diff']}")
    _release_card()
    return out


def _ssm_steps(ctx, cfg, params, prompts, feed=None, steps=3):
    """Each prompt prefilled into its own slot of a cache in 256-row
    chunks (batch 1), then ``steps`` decode steps of all the slots.
    Returns (each prompt's last-token logits (n, V), each decode step's
    logits [(n, V)], the decode steps' input tokens [(n,)]), on the CPU in
    float32.  ``feed``: the decode steps' tokens (default: each step's
    argmax of the logits before it)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.serving.engine import (make_decode_step,
                                            make_prefill_chunk_step)
    from repro_torch.serving.scheduler import chunk_plan

    p = lm.prepare_params(ctx, params)
    cache = lm.init_cache(ctx, cfg, len(prompts), 512)
    step = make_prefill_chunk_step(cfg, ctx.run, ctx)
    first = []
    for sid, prompt in enumerate(prompts):
        idx = 0
        for size in chunk_plan(len(prompt), 256):
            toks = torch.tensor([prompt[idx:idx + size]], dtype=torch.int32,
                                device=ctx.device)
            cache, logits = step(p, cache, toks, sid, idx)
            idx += size
        first.append(logits[0].float().cpu())
    first = torch.stack(first)
    decode = make_decode_step(cfg, ctx.run, ctx)
    index = torch.tensor([len(q) for q in prompts], dtype=torch.int32,
                         device=ctx.device)
    outs, fed, prev = [], [], first
    for t in range(steps):
        nxt = prev.argmax(-1).int() if feed is None else feed[t]
        cache, logits = decode(p, cache, nxt[:, None].to(ctx.device),
                               index + t)
        prev = logits.float().cpu()
        outs.append(prev)
        fed.append(nxt)
    return first, outs, fed


def ssm_parity(arch, n_layers):
    """Phase 4, Mamba: ``arch`` at full width and ``n_layers`` layers from
    one set of seeded weights, the same per-slot prefill chunks and 3
    decode steps on the card and on the CPU.  Prompts of 320, 37 and 100
    tokens: 320 = 256 + 64 (a 256-row chunk is two SSD chunks that carry
    the state; the 64-row chunk continues from h0 and the conv window), 37
    = 32 + 4 + 1 (the 1-row chunk takes the decode branch), 100 = 64 + 32
    + 4.  The gate: the card in f32 (kernels, TF32 off) within
    SSM_PARITY_TOL of the CPU in f32 (plain path), on every prompt's last
    logits and every decode step's; the card in bf16 printed beside it."""
    import torch
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.kernels import ssd as tssd
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_model_config(arch), n_layers=n_layers)
    run32 = get_run_config(arch, remat="none", compute_dtype="float32")
    run16 = get_run_config(arch, remat="none")
    params = init_params(lm.model_decls(cfg), torch.Generator().manual_seed(1),
                         "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (320, 37, 100)]
    cpu_first, cpu_dec, fed = _ssm_steps(Ctx(run32, "cpu"), cfg, params,
                                         prompts)
    out = {}
    for name, run in (("f32", run32), ("bf16", run16)):
        tssd.ssd.launches = 0
        first, dec, _ = _ssm_steps(Ctx(run, "cuda"), cfg, params, prompts,
                                   fed)
        out[name] = {"max_abs_logit_diff": max(
            [(first - cpu_first).abs().max().item()]
            + [(a - b).abs().max().item() for a, b in zip(dec, cpu_dec)]),
            "ssd_launches": tssd.ssd.launches}
        torch.cuda.empty_cache()
    f32, b16 = out["f32"], out["bf16"]
    tag = arch.split("-")[0]
    print(f"[parity:{tag}] {cfg.name} d{cfg.d_model} vocab {cfg.vocab}, "
          f"{n_layers} layers, prefill chunks of prompts 320 / 37 / 100 + 3 "
          f"decode steps: card f32 (kernels, {f32['ssd_launches']} ssd "
          f"launches) vs CPU f32: max|logit diff| "
          f"{f32['max_abs_logit_diff']:.3e} (tol {SSM_PARITY_TOL}); card "
          f"bf16 vs CPU f32 (not gated): max|logit diff| "
          f"{b16['max_abs_logit_diff']:.4f}", flush=True)
    if not f32["max_abs_logit_diff"] <= SSM_PARITY_TOL:
        raise AssertionError(f"[parity:{tag}] f32 logits differ by "
                             f"{f32['max_abs_logit_diff']}")
    _release_card()
    return out


# ---------------------------------------------------------------------------
# phase 5: training at full width
# ---------------------------------------------------------------------------

def _release_card():
    """Free what earlier phases left cached and start a new peak."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def train_full_width(tfa):
    """Phase 5, the training main path: full-width, full-depth
    llama3.2-3b (seeded f32 masters on the card, bf16 compute, AdamW,
    remat="full", batch 2 x 2048, logits_chunk 1024, 2 warmup steps)
    through ``make_train_step``, TRAIN_STEPS steps on one repeated
    TokenSource batch.  Every loss finite, the last below the first, and
    exactly 2 forward launches (the forward and its recompute) and one
    backward launch per layer and step."""
    import torch
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import param_count
    from repro_torch.train.step import init_state, make_train_step

    B, S = 2, 2048
    cfg = get_model_config(ARCH)
    run = get_run_config(ARCH, remat="full", logits_chunk=1024,
                         warmup_steps=2, total_steps=TRAIN_STEPS)
    _release_card()
    t0 = time.perf_counter()
    state = init_state(cfg, run, torch.Generator(device="cuda").manual_seed(0),
                       "cuda").tree()
    torch.cuda.synchronize()
    n_params = param_count(lm.model_decls(cfg))
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
          f"params; f32 masters + AdamW state ready in "
          f"{time.perf_counter() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
          flush=True)
    data = TokenSource(DataConfig(vocab=cfg.vocab, global_batch=B, seq_len=S))
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch(0).items()}
    step_fn = make_train_step(cfg, run, Ctx(run, "cuda"))
    tfa.reset_launch_counts()
    losses, gnorms, secs = [], [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        print(f"[train] step {i} loss={losses[-1]:.4f} "
              f"grad_norm={gnorms[-1]:.4f} {secs[-1]:.3f}s", flush=True)
    launches = {fn.__name__: fn.launches for fn in tfa.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_decode": 0, "flash_decode_paged": 0, "cache_update": 0,
            "cache_update_paged": 0, "grouped_matmul": 0, "ssd": 0,
            "flash_attention": 2 * cfg.n_layers * TRAIN_STEPS,
            "flash_attention_bwd": cfg.n_layers * TRAIN_STEPS}
    step_s = float(np.median(secs[1:]))
    tokens = B * S
    attn_fwd_ops = 4.0 * cfg.head_dim * B * cfg.n_heads * S * (S + 1) / 2
    # 6 N per token (forward 2, backward 4) plus the attention's forward
    # and its 2.5x backward, per layer; the remat recompute is not counted
    model_ops = 6.0 * n_params * tokens + 3.5 * attn_fwd_ops * cfg.n_layers
    stats = {"steps": TRAIN_STEPS, "batch": B, "seq": S, "losses": losses,
             "grad_norms": gnorms, "step_s": secs,
             "median_step_s_after_first": step_s,
             "tokens_per_s": tokens / step_s,
             "peak_allocated_gb": peak / 1e9, "launches": launches,
             "model_ops_per_step": model_ops,
             "bf16_peak_share": model_ops / (step_s * BF16_OPS_PER_S)}
    print(f"[train] {TRAIN_STEPS} steps of {B} x {S} tokens: "
          f"{step_s:.3f} s per step (median after the first; first "
          f"{secs[0]:.3f} s), {stats['tokens_per_s']:.0f} tokens/s, peak "
          f"allocated {peak / 1e9:.2f} GB, {100 * stats['bf16_peak_share']:.1f}"
          f"% of the bf16 peak ({model_ops:.3e} model operations per step); "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches {launches}",
          flush=True)
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"[train] non-finite loss or grad norm: "
                             f"{losses} {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[train] loss did not fall: {losses}")
    if launches != want:
        raise AssertionError(f"[train] launches {launches}, expected {want}")

    def one_step():
        step_fn(state, batch)
        torch.cuda.synchronize()

    # one more step after the counted ones (and after the serving
    # profiles: the profiler slows later launches)
    stats["profile"] = _profile_window(
        "train", "one train step", 1, one_step, top_n=12,
        groups=TRAIN_PROFILE_GROUPS)
    del state, batch
    _release_card()
    return launches, stats


def train_parity(tfa):
    """Phase 6: one train step at full width and 2 layers in f32 from the
    same seeded weights and batch, on the card (kernels) and on the CPU
    (plain versions): loss, grad norm and the parameter update agree."""
    import torch
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.models.layers import Ctx
    from repro_torch.train.step import init_state, make_train_step
    from repro_torch.tree import leaves, tree_map

    cfg = dataclasses.replace(get_model_config(ARCH), n_layers=2)
    run = get_run_config(ARCH, remat="full", compute_dtype="float32",
                         logits_chunk=256, warmup_steps=0, total_steps=1)
    cpu = init_state(cfg, run, torch.Generator().manual_seed(2), "cpu").tree()
    p0 = [p.clone() for p in leaves(cpu["params"])]
    card = {"params": tree_map(lambda t: t.cuda(), cpu["params"]),
            "opt_state": tree_map(lambda t: t.cuda(), cpu["opt_state"]),
            "step": cpu["step"].clone()}
    host = TokenSource(DataConfig(vocab=cfg.vocab, global_batch=1,
                                  seq_len=256, seed=3)).batch(0)
    tfa.reset_launch_counts()
    card, m_card = make_train_step(cfg, run, Ctx(run, "cuda"))(
        card, {k: torch.from_numpy(v).cuda() for k, v in host.items()})
    torch.cuda.synchronize()
    launches = {"flash_attention": tfa.flash_attention.launches,
                "flash_attention_bwd": tfa.flash_attention_bwd.launches}
    cpu, m_cpu = make_train_step(cfg, run, Ctx(run, "cpu"))(
        cpu, {k: torch.from_numpy(v) for k, v in host.items()})
    err = {k: abs(float(m_card[k]) - float(m_cpu[k])) / abs(float(m_cpu[k]))
           for k in ("loss", "grad_norm")}
    du2 = u2 = 0.0
    for a, b, p in zip(leaves(card["params"]), leaves(cpu["params"]), p0):
        u_cpu = b.detach() - p
        du2 += float(((a.detach().cpu() - p) - u_cpu).double().square().sum())
        u2 += float(u_cpu.double().square().sum())
    err["update"] = math.sqrt(du2 / u2)
    print(f"[train:parity] {cfg.name} d{cfg.d_model} vocab {cfg.vocab}, 2 "
          f"layers, f32, one AdamW step on 1 x 256 tokens: card (kernels, "
          f"launches {launches}) vs CPU (plain): loss "
          f"{float(m_card['loss']):.6f} vs {float(m_cpu['loss']):.6f}, "
          f"grad_norm {float(m_card['grad_norm']):.6f} vs "
          f"{float(m_cpu['grad_norm']):.6f}; relative errors "
          + ", ".join(f"{k} {v:.2e} (tol {TRAIN_PARITY_TOL[k]})"
                      for k, v in err.items()), flush=True)
    if launches != {"flash_attention": 4, "flash_attention_bwd": 2}:
        raise AssertionError(f"[train:parity] launches {launches}")
    bad = [k for k, v in err.items() if not v <= TRAIN_PARITY_TOL[k]]
    if bad:
        raise AssertionError(f"[train:parity] disagrees on {bad}: {err}")
    del card
    _release_card()
    return err


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as tssd

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {[p.name for p in libs]} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    kind = torch.cuda.get_device_name(0)
    smi = _smi_line()
    print(f"[device] {kind} | nvidia-smi: {smi}", flush=True)

    fd_checks = check_flash_decode(tfa, ref)
    cu_checks = check_cache_update(tfa, ref)
    fdp_checks = check_flash_decode_paged(tfa, ref)
    cup_checks = check_cache_update_paged(tfa, ref)
    rng = np.random.default_rng(3)
    decode_lens = rng.integers(96, 1153, 8).tolist()
    decode_index = [96, 140, 333, 512, 700, 911, 1100, 2048]   # one done
    times = {
        "flash_decode decode": time_flash_decode(tfa, ref, 8, 1, decode_lens),
        "flash_decode prefill": time_flash_decode(tfa, ref, 1, 256, [768]),
        "cache_update decode": time_cache_update(tfa, ref),
        "flash_decode_paged decode": time_flash_decode_paged(
            tfa, ref, 8, 1, decode_lens),
        "flash_decode_paged prefill": time_flash_decode_paged(
            tfa, ref, 1, 256, [768]),
        "cache_update_paged decode": time_cache_update_paged(
            tfa, ref, 8, 1, decode_index),
        "cache_update_paged prefill": time_cache_update_paged(
            tfa, ref, 1, 256, [512]),
        # olmoe's heads: H = K = 16, one query row per kv head
        "flash_decode decode g=1": time_flash_decode(
            tfa, ref, 8, 1, decode_lens, H=16, K=16),
        "flash_decode prefill g=1": time_flash_decode(
            tfa, ref, 1, 256, [768], H=16, K=16),
        "cache_update decode g=1": time_cache_update(tfa, ref, K=16),
        "flash_decode_paged decode g=1": time_flash_decode_paged(
            tfa, ref, 8, 1, decode_lens, H=16, K=16),
        "flash_decode_paged prefill g=1": time_flash_decode_paged(
            tfa, ref, 1, 256, [768], H=16, K=16),
        "cache_update_paged decode g=1": time_cache_update_paged(
            tfa, ref, 8, 1, decode_index, K=16),
        "cache_update_paged prefill g=1": time_cache_update_paged(
            tfa, ref, 1, 256, [512], K=16),
        # zamba2's shared attention: H = K = 32 heads of 64
        "flash_decode decode D=64": time_flash_decode(
            tfa, ref, 8, 1, decode_lens, H=32, K=32, D=64),
        "flash_decode prefill D=64": time_flash_decode(
            tfa, ref, 1, 256, [768], H=32, K=32, D=64),
        "cache_update decode D=64": time_cache_update(tfa, ref, K=32, D=64),
        "flash_decode_paged decode D=64": time_flash_decode_paged(
            tfa, ref, 8, 1, decode_lens, H=32, K=32, D=64),
        "flash_decode_paged prefill D=64": time_flash_decode_paged(
            tfa, ref, 1, 256, [768], H=32, K=32, D=64),
        "cache_update_paged decode D=64": time_cache_update_paged(
            tfa, ref, 8, 1, decode_index, K=32, D=64),
        "cache_update_paged prefill D=64": time_cache_update_paged(
            tfa, ref, 1, 256, [512], K=32, D=64),
    }
    fa_checks = check_flash_attention(tfa, ref)
    fa_faults = check_planted_faults(tfa, ref)
    fa_shortcut = check_bf16_shortcut(ref)
    fa_times = time_flash_attention(tfa, ref)
    times["flash_attention training"] = fa_times["fwd"]
    times["flash_attention_bwd training"] = fa_times["bwd"]
    gmm_checks = check_grouped_matmul(gmm, ref)
    gmm_faults = check_grouped_matmul_faults(gmm, ref)
    for G, M, K, N in GMM_SHAPES[:4]:
        times[f"grouped_matmul {'decode' if M == 2 else 'prefill'} "
              f"{K}x{N}"] = time_grouped_matmul(gmm, ref, G, M, K, N)
    ssd_checks = check_ssd(tssd, ref)
    ssd_faults = check_ssd_faults(tssd, ref)
    for model in SSD_HEADS:
        times[f"ssd prefill {model}"] = time_ssd(tssd, ref, model)
    for name, t in times.items():
        lib = (f"{t['library_ms']:.4f} ms" if t["library_ms"] is not None
               else "none")
        print(f"[time] {name} {t['shape']}: kernel {t['ms']:.4f} ms "
              f"(eager with its host work {t['host_ms']:.4f} ms), plain "
              f"{t['plain_ms']:.4f} ms, library {lib}, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})", flush=True)

    dense_launches, serving, shared = serve_full_width(tfa)
    paged_launches, paged_serving = serve_arm(tfa, *shared, "paged", True)
    # dense, paged, paged, dense: each engine read on both sides of the
    # other, as the host's pace drifts over a run
    _, paged2 = serve_arm(tfa, *shared, "paged-again", True)
    _, dense2 = serve_arm(tfa, *shared, "dense-again", False)
    order = (("dense", serving), ("paged", paged_serving),
             ("paged", paged2), ("dense", dense2))
    print("[serve:abba] dense, paged, paged, dense: " + ", ".join(
        f"{n} {st['tok_per_s']:.1f} tok/s "
        f"({st['decode_s'] / st['decode_steps'] * 1e3:.1f} ms/step)"
        for n, st in order), flush=True)
    paged_serving["again"] = paged2
    serving["again"] = dense2
    prefix_serving = serve_prefix_sharing(tfa, *shared[:3])
    llama = shared[:2]
    del shared                            # llama's weights, before olmoe's
    _release_card()
    # 3d: full-width olmoe, dense, paged, then the untimed replay
    moe_launches, moe_serving, moe_shared = serve_full_width(
        tfa, MOE_ARCH, "olmoe-")
    moe_paged_launches, moe_paged = serve_arm(tfa, *moe_shared,
                                              "olmoe-paged", True,
                                              gate_equal=False)
    moe_serving.update(serve_moe_replay(tfa, *moe_shared))
    moe_serving["no_drop"] = serve_moe_no_drop(tfa, *moe_shared[:4])
    # each model's weights are released before the next model's are made
    olmoe = moe_shared[:2]
    del moe_shared
    _release_card()
    # 3e, 3f: full-width mamba2 (dense) and zamba2 (dense, paged)
    ssm_launches, ssm_serving, ssm_shared = serve_ssm(tfa)
    mamba2 = ssm_shared[:2]
    del ssm_shared
    _release_card()
    hyb_launches, hyb_paged_launches, hyb_serving, hyb_shared = \
        serve_hybrid(tfa)
    zamba2 = hyb_shared[:2]
    del hyb_shared
    _release_card()
    # the profiles come after every serving arm: launches slow down once
    # the profiler has run; each model's seeded weights are made again
    for model, into, name, groups, kw in (
            (olmoe, moe_serving, "olmoe-dense", MOE_PROFILE_GROUPS, {}),
            (mamba2, ssm_serving, "mamba2-dense", SSM_PROFILE_GROUPS, {}),
            (zamba2, hyb_serving, "zamba2-dense", SSM_PROFILE_GROUPS, {}),
            (zamba2, hyb_serving["paged"], "zamba2-paged",
             SSM_PROFILE_GROUPS, dict(paged=True, block_size=16)),
            (llama, serving, "dense", None, {}),
            (llama, paged_serving, "paged", None,
             dict(paged=True, block_size=16))):
        params = _card_weights(*model)
        into.update(profile_decode(*model, params, name, groups=groups,
                                   **kw))
        del params
        _release_card()
    parity = logits_parity()
    moe_parity = olmoe_parity()
    mamba_parity = {SSM_ARCH: ssm_parity(SSM_ARCH, 2),
                    HYBRID_ARCH: ssm_parity(HYBRID_ARCH, 7)}
    train_launches, training = train_full_width(tfa)
    training["parity_rel_err"] = train_parity(tfa)

    def bf16_err(checks):
        return max(c["max_abs_err"] for c in checks
                   if c["dtype"] == "bfloat16")

    def row(name, source, replaces, launches, err, tol, t, prefill, checks,
            arm, **extra):
        # olmoe (H = K = 16) and zamba2 (H = K = 32, D = 64): their times
        # and their arms' launches beside
        moe = moe_paged_launches if "paged" in name else moe_launches
        g1 = {"launches": moe[name], "launches_arm": "olmoe-" + arm}
        g1.update({k.split()[1]: times[k] for k in times
                   if k.startswith(name + " ") and k.endswith("g=1")})
        hyb = hyb_paged_launches if "paged" in name else hyb_launches
        d64 = {"launches": hyb[name], "launches_arm": "zamba2-" + arm}
        d64.update({k.split()[1]: times[k] for k in times
                    if k.startswith(name + " ") and k.endswith("D=64")})
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches, max_abs_err=err,
                    tolerance=tol, ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t["library_ms"], library=t["library"],
                    shape=t["shape"], max_abs_diff=err, kernel_ms=t["ms"],
                    host_ms=t["host_ms"], launches_per_decode_step=28,
                    launches_arm=arm, prefill_chunk=prefill, checks=checks,
                    olmoe_g1=g1, zamba2_d64=d64, **extra)

    csrc = "src/repro_torch/kernels/csrc/"
    fa = "src/repro/kernels/flash_attention.py"
    kernels = [
        row("flash_decode", csrc + "decode_attention.cu", fa + ":212",
            dense_launches["flash_decode"], bf16_err(fd_checks),
            DECODE_TOL["bfloat16"], times["flash_decode decode"],
            times["flash_decode prefill"], fd_checks, "dense"),
        row("cache_update", csrc + "cache_update.cu", fa + ":394",
            dense_launches["cache_update"], 0.0, 0.0,
            times["cache_update decode"], None, cu_checks, "dense"),
        row("flash_decode_paged", csrc + "decode_attention_paged.cu",
            fa + ":318", paged_launches["flash_decode_paged"],
            bf16_err(fdp_checks), DECODE_TOL["bfloat16"],
            times["flash_decode_paged decode"],
            times["flash_decode_paged prefill"], fdp_checks, "paged",
            vs_dense_max_abs_diff=max(c["vs_dense_max_abs_diff"]
                                      for c in fdp_checks)),
        row("cache_update_paged", csrc + "cache_update_paged.cu",
            fa + ":462", paged_launches["cache_update_paged"], 0.0, 0.0,
            times["cache_update_paged decode"],
            times["cache_update_paged prefill"], cup_checks, "paged"),
    ]
    train_src = "src/repro/kernels/ref.py"

    def train_row(name, source, replaces, t, checks, **extra):
        worst = max(max(v for n, v in c["max_abs_err"].items()
                        if n != "lse") for c in checks
                    if c["dtype"] == "bfloat16")
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=train_launches[name],
                    max_abs_err=worst, ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t["library_ms"], library=t["library"],
                    plain=t["plain"], shape=t["shape"], host_ms=t["host_ms"],
                    launches_arm="train", checks=checks, **extra)

    kernels += [
        train_row("flash_attention", csrc + "flash_attention.cu",
                  fa + ":107", fa_times["fwd"],
                  [dict(c, max_abs_err={n: c["max_abs_err"][n]
                                        for n in ("out", "lse")})
                   for c in fa_checks],
                  tolerance=_ATTN_TOL_TEXT, planted_fault=fa_faults["out"],
                  bf16_shortcut=fa_shortcut),
        train_row("flash_attention_bwd", csrc + "flash_attention_bwd.cu",
                  train_src + ":37", fa_times["bwd"],
                  [dict(c, max_abs_err={n: c["max_abs_err"][n]
                                        for n in ("dq", "dk", "dv")})
                   for c in fa_checks],
                  tolerance=_ATTN_TOL_TEXT,
                  planted_fault={n: fa_faults[n] for n in ("dq", "dk", "dv")},
                  replaces_note="XLA autodiff of ref.attention_naive / "
                                "attention_blockwise: the Pallas "
                                "flash_attention has no VJP"),
    ]
    gmm_times = {k: t for k, t in times.items()
                 if k.startswith("grouped_matmul")}
    t = gmm_times["grouped_matmul decode 2048x1024"]
    kernels.append(dict(
        name="grouped_matmul", route="cuda",
        source=csrc + "grouped_matmul.cu",
        replaces="src/repro/kernels/grouped_matmul.py:51",
        launches=moe_launches["grouped_matmul"], launches_arm="olmoe-dense",
        max_abs_err=max(c["max_abs_err"] for c in gmm_checks
                        if c["dtype"] == "bfloat16"),
        worst_over_limit=max(c["worst_over_limit"] for c in gmm_checks),
        tolerance=_ATTN_TOL_TEXT, ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"], library=t["library"], shape=t["shape"],
        host_ms=t["host_ms"], times=gmm_times, checks=gmm_checks,
        planted_fault=gmm_faults))
    t = times["ssd prefill mamba2"]
    kernels.append(dict(
        name="ssd", route="cuda", source=csrc + "ssd.cu",
        replaces="src/repro/kernels/ssd.py:81",
        launches=ssm_launches["ssd"], launches_arm="mamba2-dense",
        launches_zamba2={"dense": hyb_launches["ssd"],
                         "paged": hyb_paged_launches["ssd"]},
        max_abs_err=max(c["max_abs_err"] for c in ssd_checks
                        if c["dtype"] == "bfloat16"),
        worst_over_limit=max(max(c["worst_over_limit"],
                                 c["state_worst_over_limit"])
                             for c in ssd_checks),
        tolerance=_ATTN_TOL_TEXT + "; the f32 state: per entry "
                  f"{ATTN_RTOL['float32']} |want| + {ATTN_ATOL} max|want|",
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=None, library=t["library"],
        shape=t["shape"], host_ms=t["host_ms"],
        times={k: v for k, v in times.items() if k.startswith("ssd")},
        checks=ssd_checks, planted_fault=ssd_faults))
    serving.update(paged=paged_serving, prefix_sharing=prefix_serving)
    moe_serving["paged"] = moe_paged
    print(json.dumps({"kernels": kernels, "serving": serving,
                      "olmoe_serving": moe_serving,
                      "mamba2_serving": ssm_serving,
                      "zamba2_serving": hyb_serving,
                      "training": training,
                      "parity_max_abs_diff": parity,
                      "olmoe_parity": moe_parity,
                      "ssm_parity": mamba_parity,
                      "total_s": time.perf_counter() - t_start}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
