#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one card: ``python3 chip_smoke.py``.

Phases (any failure raises and exits non-zero; no phase's failure is
caught):

  0. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (timed;
     each kernel's registers and spills as ``ptxas -v`` reports them);
  1. the card: ``torch.cuda.get_device_name`` and nvidia-smi's name and
     power limit;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (B=8, S=2048, H=24, K=8, D=128; Sq 1, 5 and 256;
     ragged kv_len with one done lane; also the reduced configs' D=32),
     bf16 and f32 (TF32 off), with stated tolerances; the paged kernels
     over a (1025, 16, 8, 128) pool whose tables are scattered by a seeded
     permutation (free tail entries on the parking block), the paged
     attention also against the dense kernel over the gathered cache (must
     be equal, bit for bit), the attention also entry by entry, and shown
     to reject a kernel that drops one 128-row K/V tile or one split-KV
     span and the plain version with P rounded to bf16 once (the shortcut
     the chunk kernel's hi/lo split avoids); then kernel (device time,
     from a CUDA graph), plain-version and library times beside the
     card's least possible time
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
     shapes (G=64; capacity 2 at decode, 1 to 40 at the prefill chunks of
     1 to 256 rows; 100) and the reduced configs', bf16 and f32,
     the check shown to reject a kernel that drops the last 64-wide
     K-slice or the last group, then timed beside ``torch.bmm`` at every
     capacity olmoe's path produces; the
     four decode and cache kernels at zamba2's H = K = 32, D = 64,
     checked (paged == dense bit for bit) and timed; the two cache
     writes with the serving step's RoPE folded in (given q, cos and sin)
     against the plain composition (``apply_rope`` on q and k, then the
     plain scatter), bit for bit in k cache, v cache and rotated q, at
     llama's, olmoe's and zamba2's heads, a decode step and a 256-row
     chunk with done, negative and overrunning slots, every dtype pair and
     half-rotary heads, the check shown to reject k left unrotated and
     RoPE's halves swapped, then timed at a decode step and a 256-row
     chunk beside the plain composition and the byte bound (no single
     PyTorch call does both); ``ssd`` against
     ``ref.ssd_chunked`` entry by entry at mamba2's (H=32, P=64, N=128)
     and zamba2's (H=64, P=64, N=64) heads, S 256 (two chunks), 128, 64,
     16 and 2, with and without h0, G=2 once, the state written over h0
     once, chunks 37 (S=148) and 1 (S=131) at mamba2's heads, the
     contract's edges (P=48, N=96, G=2; P=16, N=32), bf16 and f32, the
     check shown to reject a kernel that drops h0, the state carried
     between chunks or one 64-row tile of x, and the plain version with
     M, the state and x o wd rounded to bf16 once (the shortcut the bf16
     kernel's hi/lo split avoids), then timed at S=256 and at every tail
     a prompt's chunk plan cuts (S = 128 ... 2) beside its byte bound (no
     library call computes SSD), and summed per Mamba layer over a
     serving arm's chunks;
  2b. the power backend (``power/nvml.py``, ``power/metered.py``), the
     card's power session opened once by ``open_card`` for the whole
     script, which puts the limit back at its end (without
     ``libnvidia-ml.so.1`` the run fails): ``[power:nvml]``, the
     card's limits, the energy counter's update period and the session's
     one probe limit write (refused or not: both are results, decided
     once);
     ``[power:calibrate]``, the mean draw of an idle, a compute-bound and
     a memory-bound window and the envelope fitted from them beside
     ``hw/h100.py``'s; after llama's dense arm (3a), ``[power:table]``,
     prefill and decode windows of that arm's work at every cap of the
     sweep (at the default limit only where writes are refused) and the
     SED and ED picks from them beside the modelled H100 table's, and
     ``[power:serve]``, the dense arm under a ``MeteredPowerManager`` on
     that measured table (default, SED, SED, default where writes are
     allowed): J per generated token and prompt row, each phase's
     joules, cap writes, apply failures, the manager's syncs, and its
     streams equal to the dense arm's.  Every serving arm line carries
     its joules and J per generated token, and ``[train]`` its joules a
     step, read from the counter where the card already waits; every
     window's mean draw must lie between 10 W and 1.05 x the limit, the
     counter must never go backwards, and the limit nvidia-smi reads at
     the end must be the one it read at the start;
  3. the main path: full-width llama3.2-3b (28 layers, seeded random
     weights) served by ``ServeEngine`` (batch 8, max_seq 2048, prefill
     chunk 256, decode chunk 8) on 16 seeded requests, three times.  Every
     engine runs its decode chunk as one CUDA graph (its first chunk
     eager, then captured; every later chunk one replay, whose launches
     the kernel wrappers' counts include) and each prefill chunk as the
     replay of one graph per chunk size, in the engine's prefill lane
     (captured at the size's first use: each arm's engine first serves a
     WARM_LEN-token request, cut into every size once, so every chunk of
     the arm must be a replay, and each arm line counts them), and the
     split-KV counters must be back at zero after every arm.  Each family
     also runs an ``eager=True`` dense arm (every prefill and decode chunk
     run directly), whose 16 streams must equal the graphed dense arm's
     bit for bit, ``[serve:graph-ab]``: AB_PAIRS alternating pairs
     (eager, graphed) of a steady 2-chunk window of 8 live lanes, ms per
     decode step (host clock, and CUDA events around each decode chunk),
     host syncs per chunk (must be 1), the capture's seconds and memory,
     and the two engines' streams equal bit for bit, and
     ``[serve:prefill-ab]``: PREFILL_AB_PAIRS alternating pairs (eager,
     graphed) of the dense arm's 16 prompts (85 chunks) prefilled into one
     slot, the host's wall ms over the chunks, CUDA events around each
     chunk (summed, and per 256-row chunk), each prefill graph's capture
     seconds, their shared pool and the lane's bytes, and every prompt's
     last-token logits equal bit for bit; llama's ``[serve:capture-refused]``
     shows that a prefill capture that fails raises and keeps no graph:
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
       g. slot migration (``drain``/``restore``/``checkpoint``, int8
          snapshots), each arm with the counts set to 0 just before it
          and every kernel of its engines' path required to launch, the
          split-KV counters back at zero and no graph captured again on
          a source engine: on llama's weights and dense-arm requests,
          ``[migrate:dense]`` (the 16 requests served until 8 are
          mid-decode, all drained: the payload's MB, the drain's ms
          through its two host syncs and the restore's ms over every
          install, each bracketed by synchronisation, and the GB/s they
          imply; half the snapshots restored into a second engine of
          MIGRATE_TARGET's geometry, half into the source: 16/16 streams
          equal the dense arm's), ``[migrate:partial]``
          (``select_victims(2)``, ``drain(slots=...)``,
          ``set_slot_limit(6)``: 14 survivors and the two restored
          victims equal the arm's), ``[migrate:int8]`` (a raw checkpoint,
          then an int8 drain: bytes within 1 % of ``int8_payload_ratio``,
          every leaf within row absmax / 254 + bf16 rounding of the raw
          one; equal streams counted, not gated) and ``[migrate:paged]``
          (the prefix arm's requests, sharing PREFIX_LEN rows, drained
          from a paged prefix-sharing engine into the dense source and a
          fresh paged one: 16/16 equal the prefix arm's dense streams,
          the prefix-trimmed payload under the untrimmed bytes, the
          prefix rows taken from the registry, with the partial tail
          block copied on write, and re-prefilled); then
          ``[migrate:olmoe]`` (at the no-drop capacity factor),
          ``[migrate:mamba2]`` and ``[migrate:zamba2]``: one whole drain
          mid-decode restored into the same engine, 16/16 equal the
          family's dense arm; a ``{"migrate": ...}`` line;
     then torch.profiler windows (every device launch per step counted;
     graph replays, and where the profiler does not see a graph's
     kernels the line says so) of steady decode, olmoe dense, mamba2
     dense, zamba2 dense and paged, llama dense and paged, and of the
     graphed prefill of one 1024-row prompt (four 256-row chunks, each a
     replay) on mamba2, zamba2 and llama (last: launches slow down once
     the profiler has run);
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
     batch: loss, grad norm and the parameter update;
  7. LSMS, the paper's own workload (``models/lsms.py``, no kernel of
     the repo's: PyTorch's complex64 products and LU), on a card that no
     model holds any more: ``[lsms:parity]``, a reduced configuration
     (LSMS_PARITY) on the card against the CPU, A, tau and the density
     within LSMS_TOL; ``[lsms:scf]``, ``LSMS_CARD`` (128 atoms, a LIZ of
     113, nb 16: 1808 x 1808 complex64 per atom and energy point, 8
     points, 2 iterations): wall s, J and mean W per iteration, the peak
     memory and the density's finite sum; ``[lsms:table1]``, each task
     timed alone at one energy point's shapes over a window of at least
     WINDOW_S on the energy counter: ms per call against its bound,
     J and W, and the tasks' summed seconds over the SCF wall;
     ``[lsms:table2]``, the modelled H100 sweep of the measured mix (SED
     and ED caps per task) beside the paper-calibrated mix's;
     ``[lsms:power]``, ``LSMS_CARD`` again under a ``MeteredPowerManager``
     with those SED caps (written, or logged where writes are refused):
     the density bit-equal to ``[lsms:scf]``'s and 0 failed writes; and
     ``[profile:lsms]``, one energy point under torch.profiler: the top
     kernels, the busy share and the LU backend (MAGMA, cuSOLVER or
     cuBLAS batched, by kernel name).

It prints one ``{"migrate": ...}`` line, one ``{"lsms": ...}`` line, one
``{"kernels": [...]}`` line
(eight kernels), the nvidia-smi line, and as its last line
``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository's ``src/`` beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import json
import math
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

# the data sheet's roofline
from repro_torch.hw.h100 import H100_CHIP, PEAK_FLOPS_F32  # noqa: E402
# [power:table]'s and [lsms:table1]'s least window on the energy counter,
# and the seconds a new limit is given to take effect before one
from repro_torch.power.metered import SETTLE_S, WINDOW_S  # noqa: E402
from repro_torch.power.nvml import PROBE_BELOW_MAX_W  # noqa: E402

HBM_BYTES_PER_S = H100_CHIP.hbm_bandwidth      # 3.35e12
BF16_OPS_PER_S = H100_CHIP.peak_flops_bf16     # dense bf16, 989e12
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
              (64, 20, 1024, 2048), (64, 10, 2048, 1024),    # 128, 64 rows
              (64, 1, 2048, 1024), (64, 3, 2048, 1024),      # odd capacity
              (64, 5, 1024, 2048), (64, 100, 2048, 1024),
              (8, 2, 128, 256), (8, 5, 256, 128),            # reduced configs
              (8, 17, 128, 256)]
#: olmoe's capacities, ceil(S * 8 * 1.25 / 64), at the prefill chunks of
#: 256, 128, ..., 1 rows (40 .. 1) and a batch-8 decode step (2): timed at
#: the gate/up shape, and at 2 and 40 at the down shape
GMM_TIME_M = (1, 2, 3, 5, 10, 20, 40)
GMM_TIME_SHAPES = ([(64, M, 2048, 1024) for M in GMM_TIME_M]
                   + [(64, 2, 1024, 2048), (64, 40, 1024, 2048)])
#: (H, K, D) of the attention the fused RoPE + cache write serves:
#: llama3.2-3b, olmoe-1b-7b and zamba2-1.2b's shared block
ROPE_HEADS = {"llama": (24, 8, 128), "olmoe": (16, 16, 128),
              "zamba2": (32, 32, 64)}
F32_OPS_PER_S = PEAK_FLOPS_F32  # float32 outside the tensor cores, 67e12
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
#: the prefill chunks timed: a 256-row chunk and every tail ``chunk_plan``
#: cuts that takes the kernel (two rows or more)
SSD_TIME_S = (256, 128, 64, 32, 16, 8, 4, 2)
#: the bf16 ssd kernel's row tile (csrc/ssd.cu)
SSD_TILE = 64
#: the prompt of the [profile:*prefill] windows: four 256-row chunks
PREFILL_PROFILE_LEN = 1024
#: the warm-up prompt before a timed arm: 511 = 256 + 128 + ... + 1 is cut
#: into every chunk size once, so a graphed engine captures every prefill
#: graph (and its decode graph) before the arm, whose chunks are replays
WARM_LEN = 511
#: kernel-name fragments of a Mamba model's decode step by kind
SSM_PROFILE_GROUPS = {
    "ssd": ("ssd_kernel", "ssd_tc_kernel"),
    "flash_decode": ("decode_attention",),
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
    "grouped_matmul": ("grouped_matmul",),
    "flash_decode": ("decode_attention",),
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
    shared attention (H = K = 32, head_dim 64): max|err| within
    DECODE_TOL and every entry within the per-entry rule
    (``_entry_ratio``)."""
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
                ratio = _entry_ratio(name, got, want).max().item()
                checks.append({"dtype": name, "B": B, "S": S, "H": H,
                               "K": K, "D": D, "Sq": Sq, "softcap": softcap,
                               "window": window, "max_abs_err": err,
                               "tol": tol, "worst_over_limit": ratio})
                print(f"[check] flash_decode {name} B={B} S={S} H={H} K={K} "
                      f"D={D} Sq={Sq} "
                      f"softcap={softcap} window={window}: max|err| {err:.3e}"
                      f" (tol {tol}), worst entry / its limit {ratio:.3f}",
                      flush=True)
                if not (err <= tol and ratio <= 1.0):
                    raise AssertionError(f"flash_decode disagrees: {err}, "
                                         f"{ratio}")
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
    """Paged kernel vs its plain version (DECODE_TOL and the per-entry
    rule), and vs the DENSE kernel over the gathered cache (must be equal:
    the reduction order is shared); llama's and olmoe's head counts,
    zamba2's D=64 and the reduced D=32."""
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
                ratio = _entry_ratio(name, got, want).max().item()
                checks.append({"dtype": name, "B": B, "S": S, "H": H,
                               "K": K, "D": D, "bs": bs, "Sq": Sq,
                               "softcap": softcap, "window": window,
                               "max_abs_err": err, "tol": tol,
                               "worst_over_limit": ratio,
                               "vs_dense_max_abs_diff": vs_dense})
                print(f"[check] flash_decode_paged {name} B={B} S={S} H={H} "
                      f"K={K} D={D} bs={bs} Sq={Sq} softcap={softcap} "
                      f"window={window}: max|err| {err:.3e} (tol {tol}), "
                      f"worst entry / its limit {ratio:.3f}; vs dense "
                      f"kernel over the gathered cache max|diff| {vs_dense}",
                      flush=True)
                if not (err <= tol and ratio <= 1.0):
                    raise AssertionError(f"flash_decode_paged disagrees: "
                                         f"{err}, {ratio}")
                if not torch.equal(got, dense):
                    raise AssertionError(f"flash_decode_paged differs from "
                                         f"flash_decode: {vs_dense}")
    return checks


def check_decode_faults(tfa, ref):
    """The decode checks must reject kernels that drop one 128-row K/V
    tile or one split-KV span (``tfa.DECODE_SPAN`` rows).  At llama's heads
    (H=24, K=8, D=128, bf16, S=2048), each fault zeroes those rows of one
    slot's K and V on the kernel's side only, against the plain version of
    the intact caches: at Sq=256 (the tensor-core chunk path; B=2, kv_len
    768 and 1024) and at Sq=1 (the split-KV decode path; B=8, ragged).  An
    entry is affected if its slot is the one cut and its query position
    is at or past the first row cut (it sees a cut row).  Raises unless
    more than half the affected entries are flagged by the per-entry rule
    and no other entry is."""
    import torch
    B1, S, H, K, D = 8, 2048, 24, 8, 128
    span = tfa.DECODE_SPAN
    lens1 = [96, 700, 333, 1100, 512, 911, 140, 2048]
    cases = [  # (fault, Sq, kv_len, slot, first cut row, rows cut)
        ("128-row tile", 256, [768, 1024], 0, 640, 128),
        ("split-KV span", 256, [768, 1024], 1, 512, span),
        ("128-row tile", 1, lens1, 3, 384, 128),
        ("split-KV span", 1, lens1, 3, 256, span)]
    faults = []
    for fault, Sq, lens, slot, lo, n in cases:
        B = len(lens)
        q, k, v, kl = _decode_case(B, S, H, K, D, Sq, torch.bfloat16, lens,
                                   1500 + len(faults))
        want = ref.decode_attention_ref(q, k, v, kl)
        k_cut, v_cut = k.clone(), v.clone()
        k_cut[slot, lo:lo + n] = 0
        v_cut[slot, lo:lo + n] = 0
        got = tfa.flash_decode(q, k_cut, v_cut, kl)
        flagged = _entry_ratio("bfloat16", got, want) > 1
        qpos = kl.long()[:, None] - Sq + torch.arange(Sq, device="cuda")
        affected = torch.zeros_like(qpos, dtype=torch.bool)
        affected[slot] = qpos[slot] >= lo
        affected = affected[:, :, None, None].expand_as(flagged)
        res = {"fault": fault, "Sq": Sq, "slot": slot, "rows": [lo, lo + n],
               "flagged_share_of_affected": flagged[affected].float().mean()
               .item(),
               "flagged_outside": int((flagged & ~affected).sum().item())}
        faults.append(res)
        if not (res["flagged_share_of_affected"] > 0.5
                and res["flagged_outside"] == 0):
            raise AssertionError(f"flash_decode check vs a dropped {fault}: "
                                 f"{res}")
    print(f"[check] flash_decode planted faults B=2|8 S={S} H={H} K={K} "
          f"D={D} bf16, K and V rows of one slot zeroed on the kernel's side "
          "only: share of the affected entries beyond their limit: "
          + ", ".join(f"{f['fault']} rows {f['rows'][0]}..{f['rows'][1]} "
                      f"Sq={f['Sq']} {f['flagged_share_of_affected']:.4f} "
                      f"({f['flagged_outside']} flagged elsewhere)"
                      for f in faults), flush=True)
    return faults


def check_decode_shortcut(ref):
    """The per-entry rule must reject the shortcut a bf16 tensor-core P V
    product invites in the prefill-chunk kernel: P rounded to bf16 once
    (``ref.decode_attention_tc_emulated(parts=1)``, the plain version with
    that one change), at llama's heads and a 256-row chunk (B=2, kv_len 768
    and 1024, bf16) on the card.  The kernel's split, hi = bf16(P) and lo =
    bf16(P - hi) (``parts=2``), is shown beside it, within the rule.
    Raises if the rule passes the shortcut or rejects the split."""
    import torch
    B, S, H, K, D, Sq = 2, 2048, 24, 8, 128, 256
    q, k, v, kl = _decode_case(B, S, H, K, D, Sq, torch.bfloat16,
                               [768, 1024], 1600)
    want = ref.decode_attention_ref(q, k, v, kl)
    res = {}
    for parts in (1, 2):
        ratio = _entry_ratio("bfloat16", ref.decode_attention_tc_emulated(
            q, k, v, kl, parts=parts), want)
        res[f"parts{parts}"] = {
            "worst_over_limit": ratio.max().item(),
            "flagged_share": (ratio > 1).float().mean().item()}
    print(f"[check] flash_decode bf16 shortcut B={B} Sq={Sq} H={H} K={K} "
          f"D={D} kv_len 768, 1024 (plain version, worst entry / its limit, "
          "share beyond): P rounded to bf16 once: "
          f"{res['parts1']['worst_over_limit']:.3f} "
          f"({res['parts1']['flagged_share']:.4f}); split hi + lo: "
          f"{res['parts2']['worst_over_limit']:.3f}", flush=True)
    if res["parts1"]["worst_over_limit"] <= 1:
        raise AssertionError(f"the decode rule passes bf16 P: {res}")
    if res["parts2"]["worst_over_limit"] > 1:
        raise AssertionError(f"the decode rule rejects the split: {res}")
    return res


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


def _rope_case(B, Sn, H, K, D, new_dt, rotary_pct, index, seed):
    """q, k_new, v_new (new_dt) and the f32 cos/sin of positions index[b]
    + j (``rope_cos_sin``'s formula, theta 500000), seeded on the card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Sn, H, D), generator=g, device="cuda").to(new_dt)
    kn = torch.randn((B, Sn, K, D), generator=g, device="cuda").to(new_dt)
    vn = torch.randn((B, Sn, K, D), generator=g, device="cuda").to(new_dt)
    half = int(D * rotary_pct) // 2
    pos = (torch.tensor(index, device="cuda").clamp(min=0)[:, None]
           + torch.arange(Sn, device="cuda")[None])
    inv = 500000.0 ** (-torch.arange(half, dtype=torch.float32,
                                     device="cuda") / half)
    ang = pos.float()[..., None] * inv
    return q, kn, vn, torch.cos(ang), torch.sin(ang)


def _rope_cache(paged, B, S, K, D, cache_dt, Sn, seed, bs=16, mapped=100):
    """Seeded caches (dense (B, S, K, D), or pools of B * S / bs + 1 blocks
    of bs whose tables map ``mapped`` scattered blocks a slot and park the
    rest), the per-slot index with a done, a negative and an overrunning
    slot, the table (None dense) and the blocks no table maps."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    if not paged:
        shape, table, unmapped = (B, S, K, D), None, []
        index = [0, 5, 700, 1333, S - Sn, S, -1, S - Sn + 1][:B]
    else:
        mb = S // bs
        n_pool = B * mb + 1
        shape = (n_pool, bs, K, D)
        perm = np.random.default_rng(seed).permutation(B * mb)
        table = perm.reshape(B, mb).copy()
        table[:, mapped:] = n_pool - 1
        unmapped = sorted(set(range(n_pool)) - set(table.ravel().tolist()))
        table = torch.tensor(table, dtype=torch.int32, device="cuda")
        index = [0, 14, 700, 1333, mapped * bs - Sn, S, -1, S - Sn + 1][:B]
    kc = torch.randn(shape, generator=g, device="cuda").to(cache_dt)
    vc = torch.randn(shape, generator=g, device="cuda").to(cache_dt)
    return kc, vc, index, table, unmapped


def _rope_both(tfa, ref, paged, kc, vc, idx, table, q, kn, vn, c, s, rp,
               plain=None):
    """(kernel outputs, plain outputs) of one fused call, each (k cache, v
    cache, rotated q), on clones of the caches; ``plain`` replaces the
    plain composition (a planted fault)."""
    import torch
    rope = dict(q=q, cos=c, sin=s, rotary_pct=rp)
    if paged:
        got = tfa.cache_update_paged(kc.clone(), vc.clone(), kn, vn, idx,
                                     table, **rope)
    else:
        got = tfa.cache_update(kc.clone(), vc.clone(), kn, vn, idx, **rope)
    want = (plain or ref.rope_kv_cache_update_ref)(
        kc.clone(), vc.clone(), kn, vn, idx, q, c, s, rp,
        block_tables=table)
    torch.cuda.synchronize()
    return got, want


def _max_diff(got, want):
    return max((a.float() - b.float()).abs().max().item()
               for a, b in zip(got, want))


def check_rope_cache_update(tfa, ref, paged):
    """The fused RoPE + cache write against the plain composition
    (``ref.rope_kv_cache_update_ref``: apply_rope on q and k, then the
    plain scatter), bit for bit in k cache, v cache and rotated q: at
    llama's, olmoe's and zamba2's heads, a decode step (B = 8, Sn = 1) and
    a 256-row chunk (B = 8, Sn = 256), both with a done, a negative and an
    overrunning slot, every dtype pair (new f32/bf16 x cache f32/bf16),
    and partial rotary (half of each head) at llama's decode; paged, the
    blocks no table maps must stay untouched."""
    import torch
    name = "cache_update_paged" if paged else "cache_update"
    B, S = 8, 2048
    dts = (torch.float32, torch.bfloat16)
    cases = [(m, Sn, nd, cd, 1.0) for m in ROPE_HEADS for Sn in (1, 256)
             for nd in dts for cd in dts]
    cases += [("llama", 1, nd, torch.bfloat16, 0.5) for nd in dts]
    checks = []
    for model, Sn, new_dt, cache_dt, rp in cases:
        H, K, D = ROPE_HEADS[model]
        seed = 4000 + 100 * paged + len(checks)
        kc, vc, index, table, unmapped = _rope_cache(paged, B, S, K, D,
                                                     cache_dt, Sn, seed)
        q, kn, vn, c, s = _rope_case(B, Sn, H, K, D, new_dt, rp, index, seed)
        idx = torch.tensor(index, dtype=torch.int32, device="cuda")
        got, want = _rope_both(tfa, ref, paged, kc, vc, idx, table, q, kn,
                               vn, c, s, rp)
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        check = {"model": model, "Sn": Sn, "rotary_pct": rp,
                 "new": str(new_dt).split(".")[1],
                 "cache": str(cache_dt).split(".")[1], "index": index,
                 "max_abs_diff": _max_diff(got, want), "bit_exact": exact}
        if paged:
            um = torch.tensor(unmapped, device="cuda")
            check["unmapped_blocks_untouched"] = all(
                torch.equal(a[um], b[um]) for a, b in zip(got, (kc, vc)))
        checks.append(check)
        print(f"[check] {name} rope {check}", flush=True)
        if not exact or not check.get("unmapped_blocks_untouched", True):
            raise AssertionError(f"{name} with RoPE is not bit for bit the "
                                 "plain composition")
    return checks


def _rope_halves_swapped(x, cos, sin, rotary_pct=1.0):
    """apply_rope with the two rotated halves written in each other's
    place: the planted fault of ``check_rope_faults``."""
    import torch
    D = x.shape[-1]
    half = int(D * rotary_pct) // 2
    x1, x2 = x[..., :half].float(), x[..., half:2 * half].float()
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    rotated = torch.cat([x2 * c + x1 * s, x1 * c - x2 * s], -1)
    return torch.cat([rotated.to(x.dtype), x[..., 2 * half:]], -1)


def check_rope_faults(tfa, ref):
    """The bit-for-bit check shown to reject two wrong plain compositions
    at llama's decode step (bf16, dense and paged): k written unrotated
    (only the written k rows may differ), and RoPE's two halves swapped (q
    and the written k rows differ).  Each must be flagged; the v cache
    must stay equal in both."""
    import torch
    H, K, D = ROPE_HEADS["llama"]
    B, S, Sn = 8, 2048, 1

    def k_unrotated(kc, vc, kn, vn, idx, q, c, s, rp, block_tables=None):
        q = ref.apply_rope(q, c, s, rp)
        if block_tables is None:
            ref.kv_cache_update_ref(kc, vc, kn, vn, idx)
        else:
            ref.kv_cache_update_paged_ref(kc, vc, kn, vn, idx, block_tables)
        return kc, vc, q

    def halves_swapped(kc, vc, kn, vn, idx, q, c, s, rp, block_tables=None):
        q = _rope_halves_swapped(q, c, s, rp)
        k = _rope_halves_swapped(kn, c, s, rp)
        if block_tables is None:
            ref.kv_cache_update_ref(kc, vc, k, vn, idx)
        else:
            ref.kv_cache_update_paged_ref(kc, vc, k, vn, idx, block_tables)
        return kc, vc, q

    out = {}
    for paged in (False, True):
        kc, vc, index, table, _ = _rope_cache(paged, B, S, K, D,
                                              torch.bfloat16, Sn, 4500)
        q, kn, vn, c, s = _rope_case(B, Sn, H, K, D, torch.bfloat16, 1.0,
                                     index, 4500)
        idx = torch.tensor(index, dtype=torch.int32, device="cuda")
        for fault, plain in (("k_unrotated", k_unrotated),
                             ("halves_swapped", halves_swapped)):
            got, want = _rope_both(tfa, ref, paged, kc, vc, idx, table, q,
                                   kn, vn, c, s, 1.0, plain=plain)
            differs = [int((a != b).sum()) for a, b in zip(got, want)]
            key = ("paged " if paged else "dense ") + fault
            out[key] = {"flagged": differs != [0, 0, 0],
                        "entries_differing": dict(zip(("k_cache", "v_cache",
                                                       "q"), differs)),
                        "k_entries_written": Sn * K * D * sum(
                            0 <= i <= S - Sn for i in index)}
            expect_q = fault == "halves_swapped"
            if not (out[key]["flagged"] and differs[0] > 0
                    and differs[1] == 0 and (differs[2] > 0) == expect_q):
                raise AssertionError(f"planted fault {key} not flagged as "
                                     f"expected: {out[key]}")
    print(f"[check] cache_update rope planted faults {out}", flush=True)
    return out


def time_rope_cache_update(tfa, ref, paged, model, B, Sn, index):
    """The fused RoPE + cache write (bf16) at one serving shape, beside the
    plain composition run eagerly (two apply_rope passes and the scatter)
    and its byte bound; no single PyTorch call does both, so there is no
    library time."""
    import torch
    H, K, D = ROPE_HEADS[model]
    S, bs, esz = 2048, 16, 2
    kc, vc, _, table, _ = _rope_cache(paged, B, S, K, D, torch.bfloat16, Sn,
                                      4700)
    if paged:                    # every slot's table maps all its blocks
        mb = S // bs
        table = torch.tensor(np.random.default_rng(9).permutation(B * mb)
                             .reshape(B, mb), dtype=torch.int32,
                             device="cuda")
    q, kn, vn, c, s = _rope_case(B, Sn, H, K, D, torch.bfloat16, 1.0, index,
                                 4700)
    idx = torch.tensor(index, dtype=torch.int32, device="cuda")
    rope = dict(q=q, cos=c, sin=s)
    if paged:
        call = functools.partial(tfa.cache_update_paged, kc, vc, kn, vn, idx,
                                 table, **rope)
    else:
        call = functools.partial(tfa.cache_update, kc, vc, kn, vn, idx,
                                 **rope)
    ms = _time_graph_ms([call])
    host_ms = _time_eager_ms([call], 200)
    # the plain version syncs with the host (nonzero): eager only
    plain_ms = _time_eager_ms([functools.partial(
        ref.rope_kv_cache_update_ref, kc, vc, kn, vn, idx, q, c, s,
        block_tables=table)], 50)
    valid = [b for b, i in enumerate(index) if 0 <= i and i + Sn <= S]
    half = D // 2
    nbytes = (2 * B * Sn * H * D * esz            # q in, rotated q out
              + 2 * 2 * len(valid) * Sn * K * D * esz   # k, v in and out
              + 2 * B * Sn * half * 4 + 4 * B)    # cos, sin, index
    if paged:
        nbytes += 4 * len({(b, (index[b] + j) // bs) for b in valid
                           for j in range(Sn)})
    ops = 6.0 * Sn * half * (B * H + len(valid) * K)
    bound_ms, bound_by = _bound(nbytes, ops, F32_OPS_PER_S)
    done = len(index) - len(valid)
    where = f"pool ({B * S // bs + 1},{bs},{K},{D})" if paged else \
        f"S={S}"
    return {"shape": f"B={B} Sn={Sn} H={H} K={K} D={D} {where} bf16, RoPE "
                     f"of q and k" + (f", {done} done slot" if done else ""),
            "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "library_ms": None,
            "library": "none: no single PyTorch call does RoPE and the "
                       "scatter",
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
    37) and 1 (S = 131, a prime); the edges of the kernel's contract (P =
    48, N = 96, G = 2; P = 16, N = 32, chunk 48); bf16 and f32."""
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
        # the edges of the contract: P a multiple of 16 and N of 32 that
        # fill no whole tile of the bf16 kernel, two groups
        cases += [(dtype, "edges", 8, 48, 96, 256, 2, True, -3.0, False, 128),
                  (dtype, "edges", 4, 16, 32, 96, 1, True, -3.0, False, 48)]
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
    """The check must reject a kernel that drops the carried state or one
    of the bf16 kernel's 64-row tiles: at mamba2's heads, S = 256, bf16,
    the plain version's y from the real inputs against the kernel (a)
    given h0 zeroed, (b) run on the two 128-row halves with no state
    carried from the first into the second, (c) given x with rows 64..127
    zeroed (the first chunk's second 64-row tile of M x, of the state
    update's reduction and of D x dropped).  Raises unless more than a
    tenth of the affected entries (all rows for (a); the second half for
    (b); rows 64 on for (c), which see the tile directly or through the
    state) are flagged, and none of the rows the fault cannot reach (the
    first half for (b), rows 0..63 for (c): the same computation)."""
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
    x_cut = x.clone()
    x_cut[:, SSD_TILE:2 * SSD_TILE] = 0
    tile, _ = tssd.ssd(x_cut, dt, A, B, C, D, h0, chunk=128)
    faults = {}
    for fault, got, affected in (
            ("h0 zeroed", zeroed, slice(None)),
            ("no state carried between halves",
             torch.cat([first, second], dim=1), slice(128, None)),
            (f"x rows {SSD_TILE}..{2 * SSD_TILE - 1} zeroed", tile,
             slice(SSD_TILE, None))):
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
          "plain version from the real inputs: share of the affected "
          "entries beyond their limit: " + ", ".join(
              f"{n} {f['flagged_share_of_affected']:.4f} "
              f"({f['flagged_outside']} flagged elsewhere)"
              for n, f in faults.items()), flush=True)
    return faults


def check_ssd_shortcut(ref):
    """The per-entry rules must reject the shortcut a bf16 tensor-core
    SSD invites: M, the carried state and x o wd rounded to bf16 once
    (``ref.ssd_tc_emulated(parts=1)``, the plain version with that one
    change), at mamba2's and zamba2's heads, S = 256, bf16, on the card.
    The kernel's split, hi = bf16(v) and lo = bf16(v - hi) (``parts=2``),
    is shown beside it, within the rules (y: one bf16 ulp; the state: the
    float32 rule).  Raises if the rules pass the shortcut or reject the
    split."""
    import torch
    res = {}
    for model, (H, P, N) in SSD_HEADS.items():
        x, dt, A, B, C, D, h0 = _ssd_case(1, 256, H, P, 1, N, torch.bfloat16,
                                          5300)
        want_y, want_s = ref.ssd_chunked(x, dt, A, B, C, D, h0, chunk=128)
        for parts in (1, 2):
            y, st = ref.ssd_tc_emulated(x, dt, A, B, C, D, h0, chunk=128,
                                        parts=parts)
            for n, got, w, rule in (("y", y, want_y, "bfloat16"),
                                    ("state", st, want_s, "float32")):
                ratio = _entry_ratio(rule, got, w)
                res[f"{model}_{n}_parts{parts}"] = {
                    "worst_over_limit": ratio.max().item(),
                    "flagged_share": (ratio > 1).float().mean().item()}
    print("[check] ssd bf16 shortcut S=256 chunk=128 (plain version, worst "
          "entry / its limit, share beyond): M, the state and x o wd "
          "rounded to bf16 once: " + ", ".join(
              f"{m} {n} {res[f'{m}_{n}_parts1']['worst_over_limit']:.3f} "
              f"({res[f'{m}_{n}_parts1']['flagged_share']:.4f})"
              for m in SSD_HEADS for n in ("y", "state"))
          + "; split hi + lo: " + ", ".join(
              f"{m} {n} {res[f'{m}_{n}_parts2']['worst_over_limit']:.3f}"
              for m in SSD_HEADS for n in ("y", "state")), flush=True)
    if any(v["worst_over_limit"] <= 1 for k, v in res.items()
           if k.endswith("parts1")):
        raise AssertionError(f"the ssd rules pass bf16 operands: {res}")
    if any(v["worst_over_limit"] > 1 for k, v in res.items()
           if k.endswith("parts2")):
        raise AssertionError(f"the ssd rules reject the split: {res}")
    return res


def time_ssd(tssd, ref, model, S=256):
    """Kernel and plain times of one prefill chunk of S rows at batch 1
    (the serving shape: bf16, h0 from the slot's lane and the final state
    written back over it), at the models' dt scale: S = 256 (two 128-row
    kernel chunks) or a tail of ``chunk_plan`` (S = Q = 2 ... 128).  The
    inputs (at most 4-6 MB) stay in the 50 MB L2, as in serving, where the
    chunk's projections have just written them.  No single PyTorch call
    computes SSD: the library column is none."""
    import torch
    H, P, N = SSD_HEADS[model]
    G, Q = 1, min(S, 128)
    x, dt, A, B, C, D, h0 = _ssd_case(1, S, H, P, G, N, torch.bfloat16,
                                      5200, 0.0)
    kernel = [functools.partial(tssd.ssd, x, dt, A, B, C, D, h0, chunk=Q,
                                state_out=h0)]
    plain = [functools.partial(ref.ssd_chunked, x, dt, A, B, C, D, h0,
                               chunk=Q)]
    esz = 2
    nbytes = (esz * (2 * S * H * P + S * H + 2 * S * G * N)
              + 4 * (2 * H + 2 * H * P * N))
    # per chunk: C B^T once per group over the j <= i triangle; per head
    # M x over the triangle, C state^T and the state update over all rows
    tri = Q * (Q + 1) / 2
    ops = (S // Q) * (G * 2 * tri * N + H * (2 * tri * P + 4 * Q * N * P))
    bound_ms, bound_by = _bound(nbytes, ops, BF16_OPS_PER_S)
    return {"shape": f"Bb=1 S={S} H={H} P={P} G={G} N={N} chunk={Q} bf16, "
                     "h0 in place",
            "ms": _time_graph_ms(kernel), "host_ms": _time_eager_ms(kernel,
                                                                    20),
            "plain_ms": _time_eager_ms(plain, 5), "library_ms": None,
            "library": "none: no single PyTorch call computes SSD",
            "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops,
            "bytes": nbytes}


def ssd_layer_ms(times, model, specs):
    """Print the ``ssd`` device time of one Mamba layer over a serving
    arm's requests, derived, not measured: the prefill chunks of two rows
    or more that ``chunk_plan`` cuts from the prompts, replayed here, each
    at its timed size (``SSD_TIME_S``), summed."""
    from repro_torch.serving.scheduler import chunk_plan
    calls = collections.Counter(size for p, _, _ in specs
                                for size in chunk_plan(len(p), 256)
                                if size >= 2)
    per = {S: n * times[_ssd_time_key(model, S)]["ms"]
           for S, n in sorted(calls.items(), reverse=True)}
    print(f"[time] ssd per {model} layer over the arm's 16 requests, "
          f"derived: {sum(calls.values())} calls replayed from chunk_plan, "
          + ", ".join(f"{calls[S]} x S={S}" for S in per)
          + f", times their [time] ssd kernel ms: {sum(per.values()):.4f} ms",
          flush=True)


def _ssd_time_key(model, S):
    return f"ssd prefill {model}" if S == 256 else f"ssd tail {model} S={S}"


# ---------------------------------------------------------------------------
# phase 2b: the power backend (NVML), the envelope and the cap table
# ---------------------------------------------------------------------------

#: the card's ``NvmlBackend`` once ``main`` has opened it: every serving
#: arm and the training loop read its energy counter where the card is
#: already idle (None: no energy is read, as in ``tools/serve_probe.py``)
METER = None
#: [power:nvml]: seconds spent reading the counter back to back
COUNTER_SPIN_S = 1.0
#: [power:calibrate]: seconds of each window (after a warm-up of
#: CALIBRATE_WARM_S), and the drift from hw/h100.py's constants printed
CALIBRATE_S, CALIBRATE_WARM_S, ENVELOPE_DRIFT = 2.0, 1.0, 0.15
#: a window's mean draw must lie between these (W, and times the limit)
DRAW_MIN_W, DRAW_MAX_OF_LIMIT = 10.0, 1.05
#: the energy counter's update period, s, as [power:nvml] measured it
COUNTER_PERIOD_S = 0.0


def _check_draw(what, joules, seconds, limit_w=None):
    """A window's mean draw on the counter is physical: at least
    DRAW_MIN_W, at most DRAW_MAX_OF_LIMIT times the limit in force.  The
    counter holds the energy up to its last update, so a window's joules
    cover an interval within one update period of the window: the bounds
    are taken over the window's seconds less and plus that period."""
    limit = limit_w if limit_w is not None else METER.limit_w()
    lo = DRAW_MIN_W * max(seconds - COUNTER_PERIOD_S, 0.0)
    hi = DRAW_MAX_OF_LIMIT * limit * (seconds + COUNTER_PERIOD_S)
    if not lo <= joules <= hi:
        raise AssertionError(f"{what}: {joules:.1f} J over {seconds:.3f} s "
                             f"(mean {joules / seconds:.1f} W) is outside "
                             f"[{DRAW_MIN_W}, {DRAW_MAX_OF_LIMIT} x "
                             f"{limit:.2f}] W over the window -/+ "
                             f"{COUNTER_PERIOD_S * 1e3:.1f} ms")
    return joules / seconds


def _metered(fn, nvml):
    """(seconds, joules) of ``fn()`` from an idle card to a synchronise."""
    import torch
    torch.cuda.synchronize()
    e0, t0 = nvml.energy_mj(), time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, (nvml.energy_mj() - e0) / 1e3


def power_nvml(card):
    """``[power:nvml]``: the card as NVML sees it; the energy counter's
    update period (the counter read back to back for COUNTER_SPIN_S on
    an idle card: the median time and energy between two readings that
    differ); ``open_card``'s probe write of the maximum limit less
    PROBE_BELOW_MAX_W, read back and put back.  A refused write is a
    result, decided there once for the run."""
    nvml, probe = card.nvml, card.probe
    lo, hi = nvml.limit_range_w()
    info = {"name": nvml.name(), "bus_id": nvml.bus_id,
            "default_w": nvml.default_limit_w(), "min_w": lo, "max_w": hi,
            "limit_w": nvml.limit_w(), "power_w": nvml.power_mw() / 1e3}
    reads, last = 0, nvml.energy_mj()
    t_last = t0 = time.perf_counter()
    steps_s, steps_mj, first = [], [], True
    while time.perf_counter() - t0 < COUNTER_SPIN_S:
        v, t = nvml.energy_mj(), time.perf_counter()
        reads += 1
        if v != last:
            if not first:            # the first change ends a partial step
                steps_s.append(t - t_last)
                steps_mj.append(v - last)
            first, last, t_last = False, v, t
    if len(steps_s) < 2:
        raise AssertionError(f"[power:nvml] the energy counter changed "
                             f"{len(steps_s)} times in {COUNTER_SPIN_S} s")
    global COUNTER_PERIOD_S
    COUNTER_PERIOD_S = float(np.median(steps_s))
    info.update(counter_period_ms=COUNTER_PERIOD_S * 1e3,
                counter_step_mj=float(np.median(steps_mj)),
                counter_changes=len(steps_s) + 1,
                read_us=COUNTER_SPIN_S / reads * 1e6)
    info.update(writable=probe.writable, code=probe.code,
                probe_cap_w=hi - PROBE_BELOW_MAX_W,
                probe_read_back_w=probe.read_back_w,
                probe_call_ms=probe.seconds * 1e3,
                limit_before_probe_w=card.limit_w,
                limit_after_probe_w=nvml.limit_w())
    print(f"[power:nvml] {info['name']} (bus {info['bus_id']}): limit "
          f"{info['limit_w']:.2f} W in force, default {info['default_w']:.2f}"
          f" W, range {lo:.2f}-{hi:.2f} W, drawing {info['power_w']:.1f} W; "
          f"energy counter: median step {info['counter_period_ms']:.2f} ms "
          f"and {info['counter_step_mj']:.0f} mJ ({info['counter_changes']} "
          f"changes in {COUNTER_SPIN_S:.0f} s, a read {info['read_us']:.1f} "
          f"us); probe write {info['probe_cap_w']:.2f} W: writable: "
          f"{'true' if probe.writable else 'false'} ({probe.code}), read "
          f"back {probe.read_back_w:.2f} W, call {probe.seconds * 1e3:.3f} "
          f"ms; limit before the probe {card.limit_w:.2f} W, after it "
          f"{info['limit_after_probe_w']:.2f} W", flush=True)
    if info["limit_after_probe_w"] != card.limit_w:
        raise AssertionError("[power:nvml] the probe did not put the limit "
                             "back")
    return info


def power_calibrate(nvml):
    """``[power:calibrate]``: three windows of CALIBRATE_S at the limit in
    force, each after a warm-up of CALIBRATE_WARM_S of the same work: the
    idle card, a bf16 MATMUL_N^3 ``torch.matmul`` loop (compute-bound)
    and a COPY_BYTES device-to-device copy loop (memory-bound); the mean
    draw of each on the energy counter, the envelope fitted from them
    (``hw.h100.fit_envelope``) beside hw/h100.py's constants, and any
    drift over ENVELOPE_DRIFT (printed, not gated: draw varies by
    card)."""
    import torch
    from repro_torch.hw import h100
    n = h100.MATMUL_N

    def loop(fn, batch, seconds):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if fn is None:
                time.sleep(0.05)
                continue
            for _ in range(batch):
                fn()
            torch.cuda.synchronize()
        return 0

    def window(name, fn=None, batch=0):
        loop(fn, batch, CALIBRATE_WARM_S)
        s, j = _metered(lambda: loop(fn, batch, CALIBRATE_S), nvml)
        out[name] = {"seconds": s, "joules": j,
                     "mean_w": _check_draw(f"[power:calibrate] {name}", j, s)}

    out = {}
    window("idle")            # first, before the buffers' kernels wake it
    a = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
    c = torch.empty(n, n, device="cuda", dtype=torch.bfloat16)
    window("compute", lambda: torch.matmul(a, b, out=c), 50)
    del a, b, c
    src = torch.empty(h100.COPY_BYTES, device="cuda", dtype=torch.uint8)
    dst = torch.empty_like(src)
    window("memory", lambda: dst.copy_(src), 200)
    del src, dst
    torch.cuda.empty_cache()
    fit = h100.fit_envelope(out["idle"]["mean_w"], out["compute"]["mean_w"],
                            out["memory"]["mean_w"])
    const = {"p_static": h100.H100_CHIP.p_static,
             "p_compute_max": h100.H100_CHIP.p_compute_max,
             "p_mem_max": h100.H100_CHIP.p_mem_max}
    drift = {k: (fit[k] - const[k]) / const[k] for k in fit}
    out.update(fit=fit, constants=const, drift=drift)
    far = [f"{k} {100 * v:+.1f}%" for k, v in drift.items()
           if abs(v) > ENVELOPE_DRIFT]
    print(f"[power:calibrate] at {nvml.limit_w():.2f} W, {CALIBRATE_S:.0f} s "
          f"windows after {CALIBRATE_WARM_S:.0f} s warm-ups, mean W: idle "
          f"{out['idle']['mean_w']:.1f}, bf16 {n}^3 matmul "
          f"{out['compute']['mean_w']:.1f}, {h100.COPY_BYTES >> 20} MiB copy "
          f"{out['memory']['mean_w']:.1f}; fitted envelope p_static "
          f"{fit['p_static']:.1f}, p_compute_max {fit['p_compute_max']:.1f}, "
          f"p_mem_max {fit['p_mem_max']:.1f} W against hw/h100.py's "
          f"{const['p_static']:.1f}, {const['p_compute_max']:.1f}, "
          f"{const['p_mem_max']:.1f} W (measured on {h100.MEASURED_ON})"
          + (f"; drift over {100 * ENVELOPE_DRIFT:.0f}%: {', '.join(far)}"
             if far else ""), flush=True)
    return out


def _arm_tasks(cfg, specs):
    """The arm's serving phases on the model: its mean prompt and its
    mean new tokens at batch 8 (``serve_phase_tasks``)."""
    from repro_torch.serving.engine import serve_phase_tasks
    return serve_phase_tasks(
        cfg, batch=8, prompt=round(np.mean([len(p) for p, _, _ in specs])),
        new_tokens=round(np.mean([n for _, n, _ in specs])))


def power_table(tfa, card, cfg, run, params, specs):
    """``[power:table]``, the paper's experiment on the card: two
    phase-homogeneous windows at each cap of the sweep (the default only
    where writes are refused), measured one phase at a time on the
    energy counter after SETTLE_S at the new limit and one warm-up of
    the same work: prefill, the arm's 16 prompts (85 chunks) into one
    slot of the graphed engine, as [serve:prefill-ab]; decode, graphed
    chunks at 8 live lanes, as [serve:graph-ab].  The default cap runs
    first, and the number of turns and chunks that fill WINDOW_S
    there is kept for every cap, so each cap does the same work.  Each
    window gives seconds and joules per call (a prefill chunk, a decode
    step), which the measured TaskTable holds at the arm's task scale
    (``_arm_tasks``).  The SED and ED picks per phase from it are printed
    beside the picks of the modelled H100 table of the same tasks.  A
    write that fails here fails the run."""
    import math
    import torch
    from repro_torch.core.power_model import measure_sweep
    from repro_torch.core.tasks import TaskMeasurement, TaskTable
    from repro_torch.power import optimal_cap
    from repro_torch.serving.engine import Request
    nvml, spec, writable = card.nvml, card.spec, card.writable
    default = nvml.limit_w()
    sweep = spec.cap_sweep() if writable else (default,)
    tasks = {t.name: t for t in _arm_tasks(cfg, specs)}
    engine = _engine(cfg, run, params, None)
    engine.generate([Request(uid=-1, max_new_tokens=8, prompt=np.random
                             .default_rng(10).integers(
                                 0, cfg.vocab, WARM_LEN).tolist())])
    prompts = [list(p) for p, _, _ in specs]
    rng = np.random.default_rng(11)
    lanes = [rng.integers(0, cfg.vocab, 128).tolist() for _ in range(8)]
    max_chunks = (2048 - 128) // engine.decode_chunk - 3

    def decode_start():
        engine.start([Request(uid=i, prompt=p, max_new_tokens=(
            max_chunks + 2) * engine.decode_chunk)
            for i, p in enumerate(lanes)])
        for _ in range(2):                  # admission, then a warm chunk
            engine.step()

    turns = chunks = None
    rows, windows = [], []
    for cap in sorted(sweep, reverse=True):
        if writable:
            nvml.apply(cap)
            if nvml.current_cap != cap:
                raise AssertionError(f"[power:table] wrote {cap} W, read "
                                     f"back {nvml.current_cap} W")
        time.sleep(SETTLE_S)
        n_chunks = len(_prefill_turn(engine, prompts)[1])     # warm-up
        if turns is None:
            s, _ = _metered(lambda: _prefill_turn(engine, prompts), nvml)
            turns = max(1, math.ceil(WINDOW_S / s))
        s_pre, j_pre = _metered(lambda: [_prefill_turn(engine, prompts)
                                         for _ in range(turns)], nvml)
        decode_start()
        if chunks is None:
            torch.cuda.synchronize()
            t0, chunks = time.perf_counter(), 0
            while time.perf_counter() - t0 < WINDOW_S \
                    and chunks < max_chunks:
                engine.step()
                chunks += 1
            decode_start()
        s_dec, j_dec = _metered(lambda: [engine.step()
                                         for _ in range(chunks)], nvml)
        limit = nvml.limit_w()
        calls = {"prefill": n_chunks * turns,
                 "decode": chunks * engine.decode_chunk}
        for name, s, j in (("prefill", s_pre, j_pre),
                           ("decode", s_dec, j_dec)):
            w = _check_draw(f"[power:table] {name} at {cap} W", j, s, limit)
            per = tasks[name].calls / calls[name]
            rows.append(TaskMeasurement(name, cap, s * per, j * per))
            windows.append({"phase": name, "cap_w": cap, "seconds": s,
                            "joules": j, "calls": calls[name],
                            "ms_per_call": s / calls[name] * 1e3,
                            "j_per_call": j / calls[name], "mean_w": w})
    _check_counters(tfa)
    if writable:
        nvml.apply(default)
        time.sleep(SETTLE_S)
    step_chunk = engine.decode_chunk
    del engine
    torch.cuda.empty_cache()
    table = TaskTable(rows)
    model = measure_sweep(list(tasks.values()), tuple(sorted(sweep)), spec)
    picks = {m: {ph: {"measured": optimal_cap(m, table, ph),
                      "modelled": optimal_cap(m, model, ph)}
                 for ph in tasks} for m in ("sed", "ed")}
    print(f"[power:table] {cfg.name} dense, graphed, batch 8: "
          + ("every cap of the sweep " if writable else
             "the default limit only (limit writes refused: no sweep "
             "possible) ")
          + f"{', '.join(f'{c:.0f}' for c in sorted(sweep))} W, settle "
          f"{SETTLE_S:.1f} s and one warm-up each; prefill windows {turns} "
          f"x the arm's {n_chunks} chunks, decode windows {chunks} chunks "
          f"of {step_chunk} steps at 8 lanes; per call (ms, J, "
          "mean W): " + "; ".join(
              f"{w['phase']} {w['cap_w']:.0f} W {w['ms_per_call']:.3f} ms "
              f"{w['j_per_call']:.4f} J {w['mean_w']:.1f} W"
              for w in windows)
          + "; picks measured / modelled (hw/h100.py): " + "; ".join(
              f"{m} {ph} {v['measured']:.0f} / {v['modelled']:.0f} W"
              for m, by in picks.items() for ph, v in by.items()),
          flush=True)
    return table, {"caps": sorted(sweep), "windows": windows,
                   "picks": picks, "prefill_turns": turns,
                   "decode_chunks": chunks,
                   "modelled": [dataclasses.astuple(r) for r in model.rows]}


def power_serve(tfa, card, table, info, cfg, run, params, specs,
                dense_streams):
    """``[power:serve]``: the dense llama arm (the same 16 requests) under a
    ``MeteredPowerManager`` whose table is the measured one of
    [power:table], so its per-phase caps are the measured SED picks;
    where writes are allowed, in the order default, SED, SED, default
    against the same arm at the default limit (the same manager with
    every phase at the default cap), else once with its caps logged and
    not applied.  Per arm: tok/s, J per generated token and per prompt
    row, each phase's measured J and s, cap writes, ``apply_failures``
    (0 when writable) and the manager's own syncs.  Every stream must
    equal the graphed dense arm's, the launches must be exact, and the
    phases' joules must sum to the arm's within one counter period times
    the limit per phase boundary, plus the time between phases at the
    limit."""
    import torch
    from repro_torch.core.tasks import TaskTable
    from repro_torch.power import CapSchedule
    from repro_torch.power.metered import MeteredPowerManager
    from repro_torch.serving.engine import Request
    nvml, spec, writable = card.nvml, card.spec, card.writable
    default = nvml.limit_w()
    tasks = _arm_tasks(cfg, specs)

    def manager(name):
        return MeteredPowerManager(
            TaskTable(list(table.rows)), tasks=tasks, metric="sed",
            backend=card.backend, meter=nvml, spec=spec,
            schedule=(CapSchedule({}, default_cap=default)
                      if name == "default" else None))

    order = ("default", "sed", "sed", "default") if writable else ("sed",)
    engine = _engine(cfg, run, params, None)
    engine.generate([Request(uid=-1, max_new_tokens=8, prompt=np.random
                             .default_rng(12).integers(
                                 0, cfg.vocab, WARM_LEN).tolist())])
    period_s = info["counter_period_ms"] / 1e3
    out = []
    for name in order:
        # each arm from the default limit, through a manager of its own
        # (which knows no cap in force, so its first phase writes)
        if writable:
            nvml.apply(default)
            time.sleep(SETTLE_S)
        pm = manager(name)
        engine.power = pm
        done, wall, launches, joules = _serve(tfa, engine, pm, cfg, specs)
        engine.power = None
        st = _arm_stats(engine, pm, done, wall, specs, joules)
        _check_launches(f"power-{name}", launches, _serving_launches(
            cfg, st["decode_steps"], specs, paged=False))
        same = sum(r.generated == dense_streams[r.uid] for r in done)
        phase_j = pm.total_joules()
        boundaries = 2 * sum(pm.entries.values())
        # the counter's quantisation at each boundary, and the host's time
        # between phases (the fetch, admission), at most at the limit
        gap_s = max(wall - sum(pm.seconds.values()), 0.0)
        slack = (period_s * boundaries + gap_s) * DRAW_MAX_OF_LIMIT * default
        st.update(arm=name, caps=dict(pm.schedule.caps),
                  prefill_j=pm.joules["prefill"],
                  decode_j=pm.joules["decode"], phase_j=phase_j,
                  j_per_prompt_row=pm.joules["prefill"]
                  / st["prompt_tokens"],
                  cap_writes=pm.transitions,
                  apply_failures=pm.apply_failures,
                  manager_syncs=pm.syncs, streams_equal=same,
                  boundaries=boundaries, gap_s=gap_s, sum_slack_j=slack,
                  limit_after_w=nvml.limit_w())
        caps = {ph: round(pm.cap_for(ph)) for ph in ("prefill", "decode")}
        print(f"[power:serve] {cfg.name} dense, {name} caps {caps} W"
              + ("" if writable else " (logged, not applied)")
              + f": {st['tok_per_s']:.1f} tok/s, {joules:.1f} J, "
              f"{st['j_per_token']:.4f} J per generated token, "
              f"{st['j_per_prompt_row']:.5f} J per prompt row; prefill "
              f"{st['prefill_j']:.1f} J in {st['prefill_s']:.3f} s, decode "
              f"{st['decode_j']:.1f} J in {st['decode_s']:.3f} s (phases "
              f"{phase_j:.1f} of the arm's {joules:.1f} J, {boundaries} "
              f"boundaries, {gap_s * 1e3:.1f} ms between phases, slack "
              f"{slack:.1f} J); {st['cap_writes']} cap "
              f"writes, {st['apply_failures']} apply failures, "
              f"{st['manager_syncs']} syncs of the manager beside the "
              f"engine's {st['host_syncs']}; {same}/16 streams equal the "
              "graphed dense arm's", flush=True)
        if same != len(specs):
            raise AssertionError(f"[power:serve] {name}: {same}/16 streams")
        if writable and st["apply_failures"]:
            raise AssertionError(f"[power:serve] {name}: "
                                 f"{st['apply_failures']} failed cap writes")
        if abs(joules - phase_j) > slack:
            raise AssertionError(f"[power:serve] {name}: phases {phase_j:.1f}"
                                 f" J against the arm's {joules:.1f} J")
        out.append(st)
    if writable:
        nvml.apply(default)
    del engine
    torch.cuda.empty_cache()
    if writable:
        print("[power:serve] ABBA: " + ", ".join(
            f"{st['arm']} {st['tok_per_s']:.1f} tok/s "
            f"{st['j_per_token']:.4f} J/token" for st in out), flush=True)
    return out


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
    """An engine on the card at the main path's geometry (batch 8,
    max_seq 2048, prefill chunk 256, decode chunk 8), which ``kw`` may
    override."""
    from repro_torch.models.layers import Ctx
    from repro_torch.serving.engine import ServeEngine
    geometry = dict(batch_size=8, max_seq=2048, prefill_chunk=256,
                    decode_chunk=8)
    return ServeEngine(cfg, run, Ctx(run, "cuda"), params, power=clock,
                       **{**geometry, **kw})


def _serve(tfa, engine, clock, cfg, specs):
    """Serve fresh requests made from ``specs`` [(prompt, max_new_tokens,
    prefix_len)] with every count set to 0 just before and read just
    after; every request must get exactly its tokens.  Returns the
    finished requests, the wall seconds, the launches and the arm's
    joules on the card's energy counter (None without ``METER``), read
    where the card is idle: after the engine's last fetch and after the
    arm's closing synchronise, so no sync is added."""
    import torch
    from repro_torch.serving.engine import Request
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=n, prefix_len=pl)
            for i, (p, n, pl) in enumerate(specs)]
    clock.reset()
    engine.sync_count = 0
    sizes0 = set(engine.prefill_graphs)
    for graph in engine.prefill_graphs.values():
        graph.replays = 0
    tfa.reset_launch_counts()
    e0 = METER.energy_mj() if METER is not None else None
    t0 = time.perf_counter()
    done = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    joules = (METER.energy_mj() - e0) / 1e3 if METER is not None else None
    launches = {fn.__name__: fn.launches for fn in tfa.KERNELS}
    _check_counters(tfa)
    # a graphed engine replays every prefill chunk but a size's first
    new_sizes = set(engine.prefill_graphs) - sizes0
    if not engine.eager and _prefill_replays(engine) \
            != clock.calls["prefill"] - len(new_sizes):
        raise AssertionError(
            f"{_prefill_replays(engine)} prefill graph replays of "
            f"{clock.calls['prefill']} chunks, {len(new_sizes)} sizes "
            "captured in the arm")
    if sorted(r.uid for r in done) != list(range(len(specs))):
        raise AssertionError("not every request finished")
    for r in done:
        if len(r.generated) != r.max_new_tokens:
            raise AssertionError(f"request {r.uid}: {len(r.generated)} "
                                 f"tokens, wanted {r.max_new_tokens}")
        if not all(0 <= t < cfg.vocab for t in r.generated):
            raise AssertionError(f"request {r.uid}: token outside vocab")
    if joules is not None:
        _check_draw("arm", joules, wall)
    return done, wall, launches, joules


def _prefill_replays(engine):
    return sum(g.replays for g in engine.prefill_graphs.values())


def _check_counters(tfa):
    """The split-KV decode path's span counters are back at zero: every
    launch, and so every replay of a graph that holds them, must leave
    them as it found them."""
    for dev, counters in tfa._counters.items():
        if counters.any():
            raise AssertionError(f"split-KV counters on {dev} not zero: "
                                 f"{counters.nonzero().flatten().tolist()}")


def _serving_launches(cfg, steps, specs, paged):
    """The exact launches of a serving arm of ``steps`` decode steps on
    the requests ``specs``, prefilled in 256-row chunks: per attention
    layer (every layer of a decoder, zamba2's shared block once per
    invocation, none in mamba2) and per step or chunk one attention
    launch and, for an MoE model, three expert products (gate, up, down);
    one cache write (RoPE of q and k folded in) per step and chunk, dense
    and paged alike, so ``cache_update`` launches attn * (steps + chunks)
    times on a dense arm; one ``ssd`` per Mamba layer
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
            "cache_update": 0 if paged else n,
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


def _arm_stats(engine, clock, done, wall, specs, joules=None):
    """The arm's numbers; ``prefill_chunks`` counts the chunk programs the
    engine reported to its phase hook (a shared prefix skips its own);
    ``joules`` is the arm's energy (None where not measured)."""
    import torch
    n_tok = sum(len(r.generated) for r in done)
    return {"requests": len(done), "wall_s": wall, "tok_per_s": n_tok / wall,
            "new_tokens": n_tok, "energy_j": joules,
            "j_per_token": joules / n_tok if joules is not None else None,
            "prompt_tokens": sum(len(p) for p, _, _ in specs),
            "prefill_s": clock.seconds["prefill"],
            "decode_s": clock.seconds["decode"],
            "host_syncs": engine.sync_count,
            "decode_steps": engine.sync_count * engine.decode_chunk,
            "prefill_chunks": clock.calls["prefill"],
            "prefill_graph_replays": _prefill_replays(engine),
            "prefill_graphs": len(engine.prefill_graphs),
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2**30}


def _print_arm(name, st, launches):
    print(f"[serve:{name}] {st['requests']} requests, "
          f"{st['prompt_tokens']} prompt tokens, "
          f"{st['new_tokens']} new tokens in {st['wall_s']:.2f}s: "
          f"{st['tok_per_s']:.1f} tok/s"
          + (f", {st['energy_j']:.1f} J, {st['j_per_token']:.4f} J per "
             f"generated token" if st["energy_j"] is not None else "")
          + f"; prefill {st['prefill_s']:.2f}s, "
          f"decode {st['decode_s']:.2f}s "
          f"({st['decode_s'] / st['decode_steps'] * 1e3:.1f} ms per decode "
          f"step); {st['host_syncs']} host syncs "
          f"({st['decode_steps']} decode steps, {st['prefill_chunks']} "
          f"prefill chunks, {st['prefill_graph_replays']} of them prefill "
          f"graph replays of {st['prefill_graphs']} graphs); launches "
          f"{launches}; max_memory_allocated "
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
    # 64 seeded tokens repeated: the requests below follow those 64 draws
    warm = Request(uid=-1, prompt=(rng.integers(0, cfg.vocab, 64).tolist()
                                   * 8)[:WARM_LEN], max_new_tokens=8)
    engine.generate([warm])                   # first-call costs, not counted
    specs = []
    for _ in range(16):
        plen = int(rng.integers(64, 1025))
        specs.append((rng.integers(0, cfg.vocab, plen).tolist(),
                      int(rng.integers(32, 129)), 0))
    torch.cuda.reset_peak_memory_stats()
    done, wall, launches, joules = _serve(tfa, engine, clock, cfg, specs)
    stats = _arm_stats(engine, clock, done, wall, specs, joules)
    _check_launches(tag + "dense", launches, _serving_launches(
        cfg, stats["decode_steps"], specs, paged=False))
    _print_arm(tag + "dense", stats, launches)
    shared = (cfg, run, engine.params, specs,
              {r.uid: r.generated for r in done})
    del engine
    torch.cuda.empty_cache()
    return launches, stats, shared


def serve_arm(tfa, cfg, run, params, specs, dense_streams, name, paged,
              gate_equal=True, eager=False):
    """Phase 3b (and 3d-3f): the dense arm's 16 requests once more,
    through ``paged=True`` or dense, graphed or (``eager=True``) with
    every decode chunk run directly; every stream must equal the dense
    arm's (with ``gate_equal``; else the count is printed) and only that
    engine's kernels may launch."""
    import torch
    from repro_torch.serving.engine import Request
    clock = PhaseClock()
    engine = _engine(cfg, run, params, clock, eager=eager,
                     **(dict(paged=True, block_size=16) if paged else {}))
    warm = Request(uid=-1, max_new_tokens=8, prompt=np.random.default_rng(5)
                   .integers(0, cfg.vocab, WARM_LEN).tolist())
    engine.generate([warm])                   # first-call costs, not counted
    torch.cuda.reset_peak_memory_stats()
    done, wall, launches, joules = _serve(tfa, engine, clock, cfg, specs)
    stats = _arm_stats(engine, clock, done, wall, specs, joules)
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


AB_PAIRS, AB_CHUNKS = 10, 2     # [serve:graph-ab]: pairs, chunks a turn


def _steps_ms(engine, chunks):
    """Wall and chunk-stream ms per decode step over ``chunks`` engine
    steps: the host clock around them (from an idle card to a
    synchronise), and CUDA events around each step's decode chunk,
    summed.  The events bracket the engine's ``_decode_chunk`` (an older
    engine's ``_decode_fn``): a graph replay's time on the card, or the
    time an eager chunk takes to be issued, as the card waits on the
    host."""
    import torch
    name = ("_decode_chunk" if hasattr(engine, "_decode_chunk")
            else "_decode_fn")
    real, ev = getattr(engine, name), []
    own = name in vars(engine)      # an instance attribute, not a method

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args)
        end.record()
        ev.append((start, end))
        return out

    setattr(engine, name, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(chunks):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        # a method is restored by deleting the patch: setting the bound
        # method back would tie the engine into a reference cycle, which
        # the cyclic collector could free, graphs and all, mid-capture
        if own:
            setattr(engine, name, real)
        else:
            delattr(engine, name)
    steps = chunks * engine.decode_chunk
    return (wall * 1e3 / steps,
            sum(a.elapsed_time(b) for a, b in ev) / steps)


def _graph_pool_gib(pool):
    """GiB the caching allocator holds in the private pool ``pool`` (a
    CUDA graph's, or graphs' that share it), from its segment snapshot;
    None where the snapshot does not say."""
    import torch
    segs = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in seg for seg in segs):
        return None
    return sum(seg["total_size"] for seg in segs
               if tuple(seg["segment_pool_id"]) == tuple(pool)) / 2**30


def graph_ab(tfa, cfg, run, params):
    """``[serve:graph-ab]``: the eager (``eager=True``) and the graphed
    dense engine, batch 8, 128-token prompts, every lane live to the end,
    each after its first step (admission and the first chunk, which the
    graphed engine captures); then AB_PAIRS alternating pairs (eager,
    graphed) of AB_CHUNKS decode chunks each, in one process on one card:
    wall and chunk-stream ms per decode step (``_steps_ms``) of each turn
    and their medians, the graphed chunk's share of the wall time,
    host syncs per chunk (must be 1), the capture's seconds, each first
    step's peak allocation and the graph's private pool.  The two
    engines' streams must be equal bit for bit at the end."""
    import statistics
    import torch
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, 128).tolist() for _ in range(8)]
    engines, memory = {}, {}
    for eager in (True, False):
        engine = _engine(cfg, run, params, None, eager=eager)
        new = engine.decode_chunk * (1 + AB_PAIRS * AB_CHUNKS) + 1
        engine.start([Request(uid=i, prompt=p, max_new_tokens=new)
                      for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        engine.step()
        torch.cuda.synchronize()
        memory[eager] = (torch.cuda.max_memory_allocated() - base) / 2**30
        engines[eager] = engine
    pool = _graph_pool_gib(engines[False].graph.graph.pool())
    syncs0 = {e: engines[e].sync_count for e in engines}
    turns = {True: [], False: []}
    for _ in range(AB_PAIRS):
        for eager in (True, False):
            turns[eager].append(_steps_ms(engines[eager], AB_CHUNKS))
    per_chunk = {("eager" if e else "graphed"): (engines[e].sync_count
                                                 - syncs0[e])
                 / (AB_PAIRS * AB_CHUNKS) for e in engines}
    graph = engines[False].graph
    streams = {e: [s.request.generated for s in engines[e]._sched.active()]
               for e in engines}
    _check_counters(tfa)
    med = {e: (statistics.median(w for w, _ in turns[e]),
               statistics.median(d for _, d in turns[e])) for e in turns}
    out = {"pairs": AB_PAIRS, "chunks_per_turn": AB_CHUNKS,
           "eager_wall_ms_per_step": [w for w, _ in turns[True]],
           "graphed_wall_ms_per_step": [w for w, _ in turns[False]],
           "eager_chunk_stream_ms_per_step": [d for _, d in turns[True]],
           "graphed_chunk_stream_ms_per_step": [d for _, d in turns[False]],
           "median_eager_wall_ms": med[True][0],
           "median_graphed_wall_ms": med[False][0],
           "median_eager_chunk_stream_ms": med[True][1],
           "median_graphed_chunk_stream_ms": med[False][1],
           "host_syncs_per_chunk": per_chunk,
           "capture_s": graph.capture_s,
           "graph_launches_per_replay": {
               fn.__name__: n for fn, n in graph.launches.items()},
           "first_step_peak_gib": {"eager": memory[True],
                                   "graphed": memory[False]},
           "graph_pool_gib": pool}
    print(f"[serve:graph-ab] {cfg.name} dense, batch 8, {AB_PAIRS} pairs "
          f"(eager, graphed) of {AB_CHUNKS} chunks of {engine.decode_chunk} steps: "
          "wall ms per step " + ", ".join(
              f"({a[0]:.2f}, {b[0]:.2f})" for a, b in zip(turns[True],
                                                          turns[False]))
          + "; chunk-stream ms per step " + ", ".join(
              f"({a[1]:.3f}, {b[1]:.3f})" for a, b in zip(turns[True],
                                                          turns[False]))
          + f"; medians: wall {med[True][0]:.2f} eager, {med[False][0]:.2f} "
          f"graphed ({med[True][0] / med[False][0]:.2f}x), chunk-stream "
          f"{med[True][1]:.3f} eager, {med[False][1]:.3f} graphed (the "
          f"graph {100 * med[False][1] / med[False][0]:.1f}% of the "
          "graphed wall); host "
          f"syncs per chunk {per_chunk['eager']:.2f} eager, "
          f"{per_chunk['graphed']:.2f} graphed; capture {graph.capture_s:.3f} s "
          f"(instantiation included), {graph.replays} replays; first "
          f"step's peak allocation {memory[True]:.3f} GiB eager, "
          f"{memory[False]:.3f} GiB graphed; the graph's private pool "
          + (f"{pool:.3f} GiB" if pool is not None else "not measured")
          + f"; streams equal: {streams[True] == streams[False]}",
          flush=True)
    if per_chunk != {"eager": 1.0, "graphed": 1.0}:
        raise AssertionError(f"{cfg.name} graph-ab: host syncs per chunk "
                             f"{per_chunk}, expected 1")
    if graph.replays != engines[False].sync_count - 1:
        raise AssertionError(f"{cfg.name} graph-ab: {graph.replays} "
                             f"replays of {engines[False].sync_count} "
                             "chunks")
    if streams[True] != streams[False]:
        raise AssertionError(f"{cfg.name} graph-ab: the graphed streams "
                             "differ from the eager ones")
    del engines, engine
    torch.cuda.empty_cache()
    return out


PREFILL_AB_PAIRS = 10     # [serve:prefill-ab]: alternating pairs


def _prefill_turn(engine, prompts):
    """Prefill every prompt into slot 0 through the engine's own chunk loop
    (``_prefill_rows``: state reset, chunks, the graphed engine's lane
    commit), from an idle card to a synchronise: the host's wall ms over
    the turn, each chunk's (rows, CUDA-event ms) -- the events bracket the
    engine's ``_prefill_chunk``: a graph replay's time on the card, or
    the time an eager chunk takes to be issued, as the card waits on the
    host -- and each prompt's last-token logits."""
    import torch
    real, ev, logits = engine._prefill_chunk, [], []

    def timed(toks, sid, idx):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(toks, sid, idx)
        end.record()
        ev.append((len(toks), start, end))
        return out

    engine._prefill_chunk = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for prompt in prompts:
            logits.append(engine._prefill_rows(prompt, 0, 0).clone())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del engine._prefill_chunk
    return wall * 1e3, [(n, a.elapsed_time(b)) for n, a, b in ev], logits


def _lane_bytes(engine):
    """Bytes of the graphed engine's prefill lane: its own rows and state
    leaves (a paged engine's pools are the cache's), the staging table
    row, the offset, the token buffers and the logits."""
    import torch
    total = sum(a.nbytes for a in (engine._offset, engine._logits,
                                   *engine._lane_tokens.values()))
    for key, leaves in engine._lane.items():
        if torch.is_tensor(leaves):
            total += leaves.nbytes
        elif leaves is not engine._cache[key]:
            total += sum(a.nbytes for a in leaves.values())
    return total


def prefill_ab(tfa, cfg, run, params, specs):
    """``[serve:prefill-ab]``: the eager (``eager=True``) and the graphed
    engine prefill the arm's prompts (``specs``: 16 prompts, 85 chunks)
    into slot 0, each engine after a warm-up request that cuts every chunk
    size once (the graphed engine's captures); then PREFILL_AB_PAIRS
    alternating pairs (eager, graphed) of turns, in one process on one
    card: the host's wall ms over the arm's chunks, the chunks' CUDA-event
    ms summed and per 256-row chunk, their medians, the graphed engine's
    capture seconds per chunk size, its prefill graphs' shared pool and
    its lane's bytes.  Every prompt's last-token logits must be equal bit
    for bit between the two engines, every graphed chunk must be a
    replay, and the split-KV counters must be back at zero."""
    import statistics
    import torch
    from repro_torch.serving.engine import Request
    prompts = [list(p) for p, _, _ in specs]
    engines = {}
    for eager in (True, False):
        engine = _engine(cfg, run, params, None, eager=eager)
        engine.generate([Request(uid=-1, max_new_tokens=8, prompt=np.random
                                 .default_rng(9).integers(
                                     0, cfg.vocab, WARM_LEN).tolist())])
        engines[eager] = engine
    graphed = engines[False]
    replays0 = _prefill_replays(graphed)
    turns = {True: [], False: []}
    logits = {}
    for _ in range(PREFILL_AB_PAIRS):
        for eager in (True, False):
            wall, chunks, logits[eager] = _prefill_turn(engines[eager],
                                                        prompts)
            turns[eager].append((wall, sum(ms for _, ms in chunks),
                                 statistics.mean(ms for n, ms in chunks
                                                 if n == 256)))
    _check_counters(tfa)
    n_chunks, n_256 = len(chunks), sum(n == 256 for n, _ in chunks)
    replays = _prefill_replays(graphed) - replays0
    same = sum(torch.equal(a, b) for a, b in zip(logits[True],
                                                 logits[False]))
    med = {e: [statistics.median(t[i] for t in turns[e]) for i in range(3)]
           for e in turns}
    capture = {n: g.capture_s for n, g in sorted(graphed.prefill_graphs
                                                 .items(), reverse=True)}
    pool = _graph_pool_gib(graphed._share[1])
    lane = _lane_bytes(graphed)
    out = {"pairs": PREFILL_AB_PAIRS, "prompts": len(prompts),
           "rows": sum(map(len, prompts)), "chunks": n_chunks,
           "chunks_of_256": n_256,
           "eager_wall_ms": [t[0] for t in turns[True]],
           "graphed_wall_ms": [t[0] for t in turns[False]],
           "eager_chunk_stream_ms": [t[1] for t in turns[True]],
           "graphed_chunk_stream_ms": [t[1] for t in turns[False]],
           "eager_chunk_stream_ms_per_256": [t[2] for t in turns[True]],
           "graphed_chunk_stream_ms_per_256": [t[2] for t in turns[False]],
           "median_eager": dict(zip(("wall_ms", "chunk_stream_ms",
                                     "chunk_stream_ms_per_256"), med[True])),
           "median_graphed": dict(zip(("wall_ms", "chunk_stream_ms",
                                       "chunk_stream_ms_per_256"),
                                      med[False])),
           "graph_replays": replays, "capture_s": capture,
           "prefill_pool_gib": pool, "lane_bytes": lane,
           "logits_equal": same}
    print(f"[serve:prefill-ab] {cfg.name} dense, {len(prompts)} prompts "
          f"({out['rows']} rows: {n_chunks} chunks, {n_256} of 256 rows), "
          f"{PREFILL_AB_PAIRS} pairs (eager, graphed): wall ms over the "
          f"{n_chunks} chunks " + ", ".join(
              f"({a[0]:.1f}, {b[0]:.1f})" for a, b in zip(turns[True],
                                                          turns[False]))
          + "; chunk-stream ms per 256-row chunk " + ", ".join(
              f"({a[2]:.3f}, {b[2]:.3f})" for a, b in zip(turns[True],
                                                          turns[False]))
          + f"; medians: wall {med[True][0]:.1f} eager, {med[False][0]:.1f} "
          f"graphed ({med[True][0] / med[False][0]:.2f}x), i.e. "
          f"{med[True][0] / n_chunks:.3f} and {med[False][0] / n_chunks:.3f} "
          f"ms a chunk; chunk-stream over the {n_chunks} chunks "
          f"{med[True][1]:.1f} eager, {med[False][1]:.1f} graphed (the "
          f"graphs {100 * med[False][1] / med[False][0]:.1f}% of the "
          f"graphed wall); per 256-row chunk {med[True][2]:.3f} eager, "
          f"{med[False][2]:.3f} graphed ({med[True][2] / med[False][2]:.2f}x)"
          f"; {replays} graph replays of {PREFILL_AB_PAIRS * n_chunks} "
          "graphed chunks; capture s by chunk size " + ", ".join(
              f"{n}: {t:.3f}" for n, t in capture.items())
          + f" ({sum(capture.values()):.2f} s in all); the prefill graphs' "
          "shared pool " + (f"{pool:.3f} GiB" if pool is not None
                            else "not measured")
          + f"; the lane {lane / 1e6:.1f} MB; last-token logits equal bit "
          f"for bit: {same}/{len(prompts)}", flush=True)
    if same != len(prompts):
        raise AssertionError(f"{cfg.name} prefill-ab: {same}/{len(prompts)} "
                             "prompts' logits equal eager's")
    if replays != PREFILL_AB_PAIRS * n_chunks:
        raise AssertionError(f"{cfg.name} prefill-ab: {replays} replays of "
                             f"{PREFILL_AB_PAIRS * n_chunks} chunks")
    del engines, engine, graphed
    torch.cuda.empty_cache()
    return out


def capture_refused(cfg, run, params):
    """``[serve:capture-refused]``: a graphed engine whose prefill chunk
    ends in a host sync (``.item()``, which a capture may not do) runs its
    first chunk's warm-up, and the capture that follows must fail: the
    error comes out of ``generate``, no graph is kept, and a fresh engine
    serves after it."""
    import torch
    from repro_torch.serving.engine import Request
    engine = _engine(cfg, run, params, None)
    real = engine._prefill_lane_fn

    def syncing(*args):
        out = real(*args)
        out.sum().item()
        return out

    engine._prefill_lane_fn = syncing
    try:
        engine.generate([Request(uid=0, prompt=[3] * 40, max_new_tokens=2)])
    except RuntimeError as e:
        err = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    else:
        raise AssertionError("a capture with a host sync did not raise")
    kept = list(engine.prefill_graphs)
    del engine
    fresh = _engine(cfg, run, params, None).generate(
        [Request(uid=0, prompt=[3] * 40, max_new_tokens=2)])
    torch.cuda.synchronize()
    print(f"[serve:capture-refused] {cfg.name}: a prefill capture with a "
          f"host sync raised {err!r}; graphs kept {kept}; a fresh engine "
          f"then served {len(fresh[0].generated)} tokens", flush=True)
    if kept or len(fresh[0].generated) != 2:
        raise AssertionError(f"capture refused: graphs kept {kept}")
    return err


PREFIX_LEN = 600     # 37 full blocks of 16 + 8 rows: every sharer copies


def serve_prefix_sharing(tfa, cfg, run, params):
    """Phase 3c: 16 requests opening with one 600-token system prefix,
    served dense and with paged prefix sharing.  Returns the arms' stats,
    the request specs and the dense arm's streams."""
    import torch
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, cfg.vocab, PREFIX_LEN).tolist()
    specs = [(prefix + rng.integers(0, cfg.vocab,
                                    int(rng.integers(16, 401))).tolist(),
              int(rng.integers(32, 65)), PREFIX_LEN) for _ in range(16)]
    warm = Request(uid=-1, max_new_tokens=8, prompt=np.random.default_rng(6)
                   .integers(0, cfg.vocab, WARM_LEN).tolist())
    out = {}
    for name, kw in (("dense", {}),
                     ("shared", dict(paged=True, block_size=16,
                                     prefix_sharing=True))):
        clock = PhaseClock()
        engine = _engine(cfg, run, params, clock, **kw)
        engine.generate([warm])
        torch.cuda.reset_peak_memory_stats()
        done, wall, launches, joules = _serve(tfa, engine, clock, cfg,
                                              specs)
        st = _arm_stats(engine, clock, done, wall, specs, joules)
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
    dense_streams = out["dense"]["streams"]
    for st in out.values():
        del st["streams"]
    return out, specs, dense_streams


def _profile_window(name, label, steps, run, groups=None, top_n=8,
                    cpu=True):
    """Run ``run()`` (``steps`` steps, ending in a synchronise) under
    torch.profiler (``cpu``: the host's ops too, else the CUDA activity
    alone: kernels, copies and the runtime's calls, such as
    ``cudaGraphLaunch``) and print where the device time went: device busy
    share = the kernels' summed device time over the window's wall time,
    every device launch per step counted (kernels, copies, memsets), the
    CUDA graph launches the host made, the top kernels, and the summed
    time of each of ``groups`` ({label: name fragments}) per step.
    ``run()`` may return the launches the kernel wrappers counted in it:
    fewer device events than that mean the profiler did not see a graph's
    kernels, and the busy share is then not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        counted = run()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev = [(e.key, e.device_time_total, e.count) for e in events
           if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    graph_launches = sum(e.count for e in events
                         if e.key == "cudaGraphLaunch") / steps
    seen = sum(n for _, _, n in dev)
    missed = counted is not None and seen < counted
    if missed:
        print(f"[profile:{name}] {label}: {wall / steps * 1e3:.2f} ms per "
              f"step; the profiler saw {graph_launches:.1f} CUDA graph "
              f"launches per step but not the graph's kernels ({seen} "
              f"device events against the {counted} launches the "
              "kernel wrappers counted): device busy share and device "
              "launches not measured", flush=True)
        dev = []
    busy_s = sum(t for _, t, _ in dev) / 1e6
    launches = seen / steps
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
              f"{100 * (1 - busy_s / wall):.1f}% idle), {launches:.1f} "
              "device launches per step (kernels, copies and memsets, "
              f"all of them), {graph_launches:.2f} CUDA graph launches per "
              "step", flush=True)
        for row in top:
            print(f"[profile:{name}]   {row['ms_per_step']:.3f} ms/step "
                  f"x{row['launches_per_step']:.0f}  {row['kernel']}",
                  flush=True)
        for g, ms in by_group.items():
            print(f"[profile:{name}]   group {g}: {ms:.3f} ms/step "
                  f"({100 * ms / (busy_s / steps * 1e3):.1f}% of the device "
                  "busy time)", flush=True)
    elif not missed:
        print(f"[profile:{name}] the profiler saw no device events: device "
              "busy share not measured", flush=True)
    return {"profile_ms_per_step": wall / steps * 1e3,
            "profile_device_busy_ms_per_step":
                busy_s / steps * 1e3 if dev else None,
            "profile_device_launches_per_step": launches if dev else None,
            "profile_graph_launches_per_step": graph_launches,
            "profile_top_kernels": top,
            "profile_group_ms_per_step": by_group if dev else None}


def _wrapper_launches(tfa):
    return sum(fn.launches for fn in tfa.KERNELS)


def profile_decode(cfg, run, params, name, groups=None, **kw):
    """Where a steady decode step's time goes: two decode chunks of 8
    full lanes of a fresh engine under torch.profiler, after its first
    step (admission and the first chunk, which the graphed engine
    captures), so the window's chunks are graph replays.  It runs after
    every serving arm, as the launches slow down once the profiler has
    run."""
    import torch
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(7)
    engine = _engine(cfg, run, params, None, **kw)
    engine.start([Request(uid=100 + i,
                          prompt=rng.integers(0, cfg.vocab, 128).tolist(),
                          max_new_tokens=24) for i in range(8)])
    engine.step()                             # admission + first chunk
    torch.cuda.synchronize()

    def run_window():
        before = _wrapper_launches(tfa)
        engine.step()
        engine.step()
        torch.cuda.synchronize()
        return _wrapper_launches(tfa) - before

    label = "steady decode, 8 lanes" + (", graphed" if engine.graph else "")
    return _profile_window(name, label, 2 * engine.decode_chunk, run_window,
                           groups=groups)


def profile_prefill(cfg, run, params, name, groups=None):
    """Where a prefill chunk's time goes: one request of PREFILL_PROFILE_LEN
    prompt tokens (four 256-row chunks) prefilled into slot 0 of a fresh
    engine under torch.profiler, through the engine's own chunk loop,
    after a warm-up request (which captures the 256-row chunk's graph, so
    the window's chunks are replays).  It runs after every serving arm,
    as ``profile_decode`` does."""
    import torch
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(11)
    engine = _engine(cfg, run, params, None)
    engine.generate([Request(uid=-1, max_new_tokens=8, prompt=rng.integers(
        0, cfg.vocab, 300).tolist())])        # first-call costs, not counted
    prompt = rng.integers(0, cfg.vocab, PREFILL_PROFILE_LEN).tolist()
    torch.cuda.synchronize()

    def run_window():
        before = _wrapper_launches(tfa)
        engine._prefill_rows(prompt, 0, 0)
        torch.cuda.synchronize()
        return _wrapper_launches(tfa) - before

    out = _profile_window(name, f"prefill of {PREFILL_PROFILE_LEN} rows, "
                          "per 256-row chunk"
                          + ("" if engine.eager else ", graphed"),
                          PREFILL_PROFILE_LEN // engine.prefill_chunk,
                          run_window, groups=groups)
    del engine
    torch.cuda.empty_cache()
    return {"prefill_" + k: v for k, v in out.items()}


def serve_moe_no_drop(tfa, cfg, run, params, specs):
    """Phase 3d: the paged MoE path against the dense one, bit for bit,
    where done lanes cannot reach live ones.  At capacity factor E/top_k
    (8.0 for olmoe) the capacity is the call's token count, so no
    assignment is ever dropped, and every row's expert products, and so
    every live lane's output, depend on that lane alone.  The dense arm's
    16 requests, untimed, dense and then paged: exact launches, and 16/16
    paged streams equal the dense ones.  Returns the stats, the no-drop
    config and the dense streams."""
    import torch
    cfg = dataclasses.replace(cfg,
                              capacity_factor=cfg.n_experts / cfg.top_k)
    streams = {}
    for paged in (False, True):
        name = "olmoe-nodrop-" + ("paged" if paged else "dense")
        clock = PhaseClock()
        engine = _engine(cfg, run, params, clock,
                         **(dict(paged=True, block_size=16) if paged else {}))
        done, _, launches, _ = _serve(tfa, engine, clock, cfg, specs)
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
    return ({"capacity_factor": cfg.capacity_factor,
             "paged_streams_equal_dense": same}, cfg, streams[False])


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
        over every decode step and layer (by ops patched in before the
        engine captures its decode chunk, so every replay counts).
    Every stream must equal the dense arm's."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.serving.engine import Request

    tally = SyncTally()
    counts = torch.zeros(4, dtype=torch.int64, device="cuda")
    lanes = {}
    real_forward, real_dispatch = lm.forward, L._moe_dispatch_local

    def forward(ctx, cfg_, params_, batch, *, cache=None, cache_index=None):
        # a decode step runs the whole batch; a prefill chunk, eager or in
        # the graphed engine's lane (whose offset is a (1,) tensor), one slot
        step = batch["tokens"].shape[0] > 1
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

    # patched before the engine's first chunk, so the graph it captures
    # counts the drops at every replay
    lm.forward, L._moe_dispatch_local = forward, dispatch
    try:
        engine = _engine(cfg, run, params, tally)
        engine.generate([Request(uid=-1, max_new_tokens=8, prompt=list(
            range(1, WARM_LEN + 1)))])        # first-call costs, not counted
        tally.spans = []
        counts.zero_()
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
        1, WARM_LEN + 1)))])                  # first-call costs, not counted
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
    _, stats["eager"] = serve_arm(tfa, *shared, "mamba2-eager", False,
                                  eager=True)
    stats["graph_ab"] = graph_ab(tfa, *shared[:3])
    stats["prefill_ab"] = prefill_ab(tfa, *shared[:4])
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
    and per chunk); and prefix sharing, which must refuse.
    Returns (dense launches, paged launches, stats, shared)."""
    launches, stats, shared = serve_full_width(tfa, HYBRID_ARCH, "zamba2-")
    paged_launches, paged = serve_arm(tfa, *shared, "zamba2-paged", True)
    _, stats["eager"] = serve_arm(tfa, *shared, "zamba2-eager", False,
                                  eager=True)
    stats["graph_ab"] = graph_ab(tfa, *shared[:3])
    stats["prefill_ab"] = prefill_ab(tfa, *shared[:4])
    cfg, run, params = shared[:3]
    stats["paged"] = paged
    stats["prefix_sharing_refused"] = _refused(
        "zamba2 prefix sharing", lambda: _engine(
            cfg, run, params, None, paged=True, block_size=16,
            prefix_sharing=True), "recurrent state cannot be row-shared")
    return launches, paged_launches, stats, shared


# ---------------------------------------------------------------------------
# phase 3g: slot migration (drain, restore, checkpoint, int8 snapshots)
# ---------------------------------------------------------------------------

# the restore target of [migrate:dense]/[migrate:partial]: another geometry,
# whose rows hold the largest need of the arm (a 1024-token prompt + 128)
MIGRATE_TARGET = dict(batch_size=4, max_seq=1280)
# rounds of each copy `_copy_ms` times (their median is kept)
COPY_ROUNDS = 3


def _migrate_engine(cfg, run, params, **kw):
    """An engine at ``_engine``'s geometry (graphed, no power hook), warmed
    by a WARM_LEN-token request that captures the decode chunk and every
    prefill chunk size, so a later capture would be the migration's."""
    from repro_torch.serving.engine import Request
    engine = _engine(cfg, run, params, None, **kw)
    engine.generate([Request(
        uid=-1, max_new_tokens=8, prompt=np.random.default_rng(7)
        .integers(0, cfg.vocab, WARM_LEN).tolist())])
    return engine


def _requests(specs):
    from repro_torch.serving.engine import Request
    return [Request(uid=i, prompt=list(p), max_new_tokens=n, prefix_len=pl)
            for i, (p, n, pl) in enumerate(specs)]


def _synced(fn):
    """``fn()`` bracketed by ``torch.cuda.synchronize``: (its value, s)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _time_installs(engines):
    """Time every snapshot install of ``engines`` (each bracketed by a
    synchronise) into the returned dict's ``s``, count it in ``n``, and
    count in ``skipped`` the prefix rows the installs took from a prefix
    registry and in ``cow`` the tail blocks they copied on write."""
    total = {"s": 0.0, "n": 0, "skipped": 0, "cow": 0}

    def timed(engine):
        real = engine._install_snapshot

        def install(snap, sid):
            k0, c0 = engine.prefill_tokens_skipped, engine.cow_copies
            _, s = _synced(lambda: real(snap, sid))
            total["s"] += s
            total["n"] += 1
            total["skipped"] += engine.prefill_tokens_skipped - k0
            total["cow"] += engine.cow_copies - c0
        return install

    for engine in engines:
        engine._install_snapshot = timed(engine)
    return total


def _run_all(*engines):
    """Step every engine in turn until none is pending."""
    while any(e.pending for e in engines):
        for e in engines:
            if e.pending:
                e.step()


def _measured_drain(engine, which=None):
    """``engine.drain(which)``, bracketed by synchronisation: (snapshots,
    {"s": its seconds through both host syncs, "syncs": the host syncs it
    made, "extra_bytes": the most device memory it held above what was
    allocated before it})."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    s0 = engine.sync_count
    snaps, secs = _synced(lambda: engine.drain(which))
    return snaps, {"s": secs, "syncs": engine.sync_count - s0,
                   "extra_bytes": torch.cuda.max_memory_allocated() - base}


def _drain_mid_decode(engine, reqs, slots=None):
    """Start ``reqs`` (16, every budget >= 32 tokens) and run one step:
    8 requests admitted and 8 tokens into their decode, 8 queued.  Then
    drain (every slot, or ``slots``: a callable of the engine giving the
    slot ids); returns ``_measured_drain``'s pair."""
    engine.start(reqs)
    engine.step()
    if engine.active_slots != engine.batch_size:
        raise AssertionError(f"{engine.active_slots} slots mid-decode")
    return _measured_drain(engine,
                           slots(engine) if slots is not None else None)


def _graphs(engine):
    return engine.graph, dict(engine.prefill_graphs)


def _decode_replays(engine):
    return engine.graph.replays if engine.graph is not None else 0


def _same_graphs(name, engine, before):
    if engine.graph is not before[0] or engine.prefill_graphs != before[1]:
        raise AssertionError(f"[migrate:{name}] a drain/restore cycle "
                             f"captured a graph again")


def _equal_streams(name, done, want):
    """How many of ``done`` equal ``want``'s streams; any that part are
    printed with the uid and the first token where they do."""
    parted = [(r.uid, next((i for i, (a, b) in enumerate(
        zip(r.generated, want[r.uid])) if a != b),
        min(len(r.generated), len(want[r.uid]))))
        for r in done if r.generated != want[r.uid]]
    if parted:
        print(f"[migrate:{name}] streams part from the dense arm's at "
              f"(uid, token) {parted}", flush=True)
    return len(done) - len(parted)


def _migrate_launches(tfa, name, cfg, specs, paged):
    """The arm's kernel launches (counts set to 0 before it): every
    kernel of its engines' path must have launched."""
    launches = {fn.__name__: fn.launches for fn in tfa.KERNELS}
    need = {k for mode in paged
            for k, n in _serving_launches(cfg, 1, specs, mode).items() if n}
    if any(launches[k] <= 0 for k in need):
        raise AssertionError(f"[migrate:{name}] launches {launches}: "
                             f"{sorted(need)} must all run")
    return launches


def _payload_stats(snaps, drain, installs):
    warm = [s for s in snaps if s.warm]
    nbytes = sum(s.payload_bytes for s in warm)
    return {"snapshots": len(snaps), "warm": len(warm),
            "payload_mb": nbytes / 1e6,
            "payload_rows": sum(s.kv_len - s.prefix_len for s in warm),
            "drain_ms": drain["s"] * 1e3, "drain_syncs": drain["syncs"],
            "drain_extra_mb": drain["extra_bytes"] / 1e6,
            "drain_gb_per_s": nbytes / drain["s"] / 1e9,
            "restore_ms": installs["s"] * 1e3, "installs": installs["n"],
            "restore_gb_per_s": (nbytes / installs["s"] / 1e9
                                 if installs["s"] else None)}


def _print_migrate(name, st, extra=""):
    print(f"[migrate:{name}] {st['warm']} warm of {st['snapshots']} "
          f"snapshots, {st['payload_mb']:.1f} MB of payload "
          f"({st['payload_rows']} rows); drain {st['drain_ms']:.2f} ms "
          f"through {st['drain_syncs']} host syncs "
          f"({st['drain_gb_per_s']:.2f} GB/s, holding "
          f"{st['drain_extra_mb']:.1f} MB more on the card at its peak); "
          f"restore "
          f"{st['restore_ms']:.2f} ms over {st['installs']} installs"
          + (f" ({st['restore_gb_per_s']:.2f} GB/s)"
             if st["restore_gb_per_s"] else "")
          + f"; {st['streams_equal']}/16 streams equal the dense arm's; "
          f"launches {st['launches']}" + extra
          + f"; the arm took {st['seconds']:.1f} s", flush=True)


def _split_restore(snaps, src, dst):
    """Half the snapshots (every other one: 4 warm, 4 cold) into ``dst``,
    the rest back into ``src``; both run to the end."""
    dst.start([])
    dst.restore(snaps[0::2])
    src.restore(snaps[1::2])
    _run_all(src, dst)
    return src.finished + dst.finished


def _copy_ms(nbytes):
    """The median ms of copying ``nbytes`` from the card to the host: into
    newly allocated pageable memory, as ``ServeEngine``'s export does,
    and into one pinned buffer kept across the copies; and back to the
    card from that buffer.  A ceiling for the untried pinned staging, not
    the engine's path."""
    import torch
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    times = {"pageable": [], "pinned": [], "pinned_h2d": []}
    for _ in range(COPY_ROUNDS):
        times["pageable"].append(_synced(dev.cpu)[1])
        times["pinned"].append(_synced(lambda: pinned.copy_(dev))[1])
        times["pinned_h2d"].append(_synced(lambda: dev.copy_(pinned))[1])
    return {k: sorted(v)[COPY_ROUNDS // 2] * 1e3 for k, v in times.items()}


def _int8_check(ck, snaps):
    """Every int8 leaf of the drained snapshots against the same slot's raw
    leaf from the checkpoint taken just before, on the card: within the
    reference's budget, row absmax / 254 plus bf16 rounding.  Returns
    (raw bytes, int8 bytes, worst error over its budget)."""
    import torch
    from repro_torch.kernels import ref
    raw = {s.request.uid: s for s in ck if s.warm}
    raw_bytes = q_bytes = 0
    worst = 0.0
    for s in snaps:
        if not s.warm:
            continue
        r = raw[s.request.uid]
        if (r.kv_len, r.cur, r.rem) != (s.kv_len, s.cur, s.rem):
            raise AssertionError("checkpoint and drain cursors differ")
        raw_bytes += r.payload_bytes
        q_bytes += s.payload_bytes
        for key, leaves in s.payload.items():
            for k, leaf in leaves.items():
                a = r.payload[key][k].cuda().float()
                d = ref.int8_dequantize(leaf.q.cuda(), leaf.scale.cuda(),
                                        getattr(torch, leaf.dtype)).float()
                rel = 2.0 ** -8 if r.payload[key][k].element_size() <= 2 \
                    else 2.0 ** -20
                budget = a.abs().amax(-1, keepdim=True) \
                    * (1 / 254 + rel) + 1e-8
                worst = max(worst, ((d - a).abs() / budget).max().item())
    return raw_bytes, q_bytes, worst


def migrate_llama(tfa, cfg, run, params, specs, dense_streams, prefix_specs,
                  prefix_streams):
    """Phase 3g on llama at full width (the dense arm's weights, 16
    requests and streams; ``_engine``'s geometry, graphed):
      * [migrate:dense]: a whole drain mid-decode (8 warm, 8 cold), half
        the snapshots restored into a second engine of MIGRATE_TARGET's
        geometry and half into the source; 16/16 streams equal the dense
        arm's, the source captured nothing more;
      * [migrate:partial]: ``select_victims(2)``, ``drain(slots=...)``,
        ``set_slot_limit(6)``: the 14 others finish on the source and the
        two victims on the second engine, all equal the arm's;
      * [migrate:int8]: a raw ``checkpoint`` then an int8 drain: bytes
        within 1 % of ``int8_payload_ratio``, every leaf within the
        reference's budget; streams counted, not gated (lossy);
      * [migrate:paged]: the prefix arm's requests (PREFIX_LEN shared
        rows: 37 whole blocks and 8 rows), drained mid-decode from a paged
        prefix-sharing engine and restored into the dense source (the
        prefix re-prefilled) and a fresh paged one (re-prefilled once,
        then shared from its registry with the partial tail block copied
        on write): 16/16 equal the prefix arm's dense streams, the
        trimmed payload under the untrimmed rows' bytes.
    The split-KV counters are back at zero after each arm."""
    import torch
    from repro_torch.models import lm
    t_all = time.perf_counter()
    out = {}
    src = _migrate_engine(cfg, run, params)
    dst = _engine(cfg, run, params, None, **MIGRATE_TARGET)
    installs = _time_installs([src, dst])
    before = _graphs(src)
    L, K, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    item = src._cache["kv"]["k"].element_size()
    row_bytes = L * 2 * K * D * item
    for name in ("dense", "int8"):
        t0 = time.perf_counter()
        tfa.reset_launch_counts()
        installs.update(s=0.0, n=0, skipped=0, cow=0)
        reqs = _requests(specs)
        ck = None
        if name == "int8":
            src.start(reqs)
            src.step()
            ck = src.checkpoint()         # raw, non-destructive
            src.snapshot_int8 = True
            snaps, drain = _measured_drain(src)
            src.snapshot_int8 = False
        else:
            snaps, drain = _drain_mid_decode(src, reqs)
        done = _split_restore(snaps, src, dst)
        st = _payload_stats(snaps, drain, installs)
        st["streams_equal"] = _equal_streams(name, done, dense_streams)
        st["launches"] = _migrate_launches(tfa, name, cfg, specs, [False])
        _check_counters(tfa)
        _same_graphs(name, src, before)
        if drain["syncs"] != 2:
            raise AssertionError(f"[migrate:{name}] drain made "
                                 f"{drain['syncs']} host syncs, not 2")
        extra = ""
        if name == "dense":
            st["derived_row_kib"] = row_bytes / 1024
            st["copy_ms"] = _copy_ms(sum(s.payload_bytes for s in snaps))
            extra = (f"; a row {row_bytes / 1024:.0f} KiB (derived: "
                     f"{L} x {K} x {D} x 2 x {item} B); the payload's bytes "
                     f"alone, card to host: into new pageable memory (the "
                     f"engine's way) {st['copy_ms']['pageable']:.2f} ms, "
                     f"into a pinned buffer kept across copies "
                     f"{st['copy_ms']['pinned']:.2f} ms (not the engine's "
                     f"path); host to card from it "
                     f"{st['copy_ms']['pinned_h2d']:.2f} ms")
            if sum(s.payload_bytes for s in snaps) \
                    != st["payload_rows"] * row_bytes:
                raise AssertionError("[migrate:dense] payload bytes are "
                                     "not the rows' bytes")
        else:
            raw_b, q_b, worst = _int8_check(ck, snaps)
            want = lm.int8_payload_ratio(cfg, itemsize=item)
            st.update(raw_mb=raw_b / 1e6, int8_mb=q_b / 1e6,
                      ratio=q_b / raw_b, ratio_modelled=want,
                      worst_over_budget=worst, gated_streams=False)
            extra = (f"; raw {raw_b / 1e6:.1f} MB -> int8 {q_b / 1e6:.1f} "
                     f"MB, ratio {q_b / raw_b:.4f} (modelled {want:.4f}); "
                     f"worst leaf error {worst:.3f} of its budget (row "
                     f"absmax / 254 + bf16 rounding); streams not gated: "
                     f"the payload is lossy")
            if abs(q_b / raw_b / want - 1) > 0.01 or worst > 1:
                raise AssertionError(f"[migrate:int8] ratio "
                                     f"{q_b / raw_b} vs {want}, worst "
                                     f"error {worst} of its budget")
        st["seconds"] = time.perf_counter() - t0
        _print_migrate(name, st, extra)
        if name == "dense" and st["streams_equal"] != len(specs):
            raise AssertionError(f"[migrate:dense] {st['streams_equal']}/16 "
                                 "streams equal the dense arm's")
        out[name] = st

    # partial: two victims shed, the slot limit pinned at 6
    t0 = time.perf_counter()
    tfa.reset_launch_counts()
    installs.update(s=0.0, n=0, skipped=0, cow=0)
    replays0 = _decode_replays(src)
    snaps, drain = _drain_mid_decode(
        src, _requests(specs), slots=lambda e: e.select_victims(2))
    victims = [(s.request.uid, s.request.max_new_tokens
                - len(s.request.generated)) for s in snaps]
    src.set_slot_limit(6)
    peak = 0
    while src.pending:
        src.step()
        peak = max(peak, src.active_slots)
    survivors = list(src.finished)
    src.set_slot_limit(8)
    dst.start([])
    dst.restore(snaps)
    _run_all(dst)
    st = _payload_stats(snaps, drain, installs)
    st.update(victims=victims, peak_active=peak,
              survivors_equal=_equal_streams("partial", survivors,
                                             dense_streams),
              victims_equal=_equal_streams("partial", dst.finished,
                                           dense_streams),
              replays=_decode_replays(src) - replays0)
    st["streams_equal"] = st["survivors_equal"] + st["victims_equal"]
    st["launches"] = _migrate_launches(tfa, "partial", cfg, specs, [False])
    _check_counters(tfa)
    _same_graphs("partial", src, before)
    st["seconds"] = time.perf_counter() - t0
    _print_migrate("partial", st, (
        f"; victims (uid, tokens owed) {victims}, slot limit 6 (peak "
        f"{peak} active); {st['survivors_equal']}/14 survivors and "
        f"{st['victims_equal']}/2 victims equal; the decode graph replayed "
        f"{st['replays']} times, none recaptured"))
    if len(survivors) != 14 or st["streams_equal"] != len(specs) \
            or peak > 6:
        raise AssertionError(f"[migrate:partial] {st['streams_equal']}/16 "
                             f"equal, {len(survivors)} survivors, peak "
                             f"{peak}")
    out["partial"] = st

    # paged: prefix-trimmed snapshots into the dense source and a fresh
    # paged engine
    t0 = time.perf_counter()
    paged_kw = dict(paged=True, block_size=16, prefix_sharing=True)
    psrc = _migrate_engine(cfg, run, params, **paged_kw)
    pbefore = _graphs(psrc)
    pdst = _engine(cfg, run, params, None, **paged_kw)
    installs_p = _time_installs([pdst])
    installs.update(s=0.0, n=0, skipped=0, cow=0)
    tfa.reset_launch_counts()
    snaps, drain = _drain_mid_decode(psrc, _requests(prefix_specs))
    warm = [s for s in snaps if s.warm]
    trimmed = sum(s.payload_bytes for s in warm)
    untrimmed = sum(s.kv_len for s in warm) * row_bytes
    prefix_rows = sum(s.prefix_len for s in warm)
    # the first admission prefilled the prefix itself: its slot ships whole
    if sorted(s.prefix_len for s in warm) \
            != [0] + [PREFIX_LEN] * (len(warm) - 1) \
            or trimmed != untrimmed - prefix_rows * row_bytes:
        raise AssertionError("[migrate:paged] snapshots not trimmed to "
                             "their private rows")
    src.start([])
    src.restore(snaps[0::2])
    pdst.restore(snaps[1::2])
    _run_all(src, pdst)
    for k in installs:
        installs[k] += installs_p[k]
    from_registry = installs["skipped"]
    reprefilled = prefix_rows - from_registry
    registry_blocks = pdst._alloc.blocks_for(PREFIX_LEN)
    st = _payload_stats(snaps, drain, installs)
    st.update(untrimmed_mb=untrimmed / 1e6,
              prefix_rows_from_registry=from_registry,
              prefix_rows_reprefilled=reprefilled,
              streams_equal=_equal_streams(
                  "paged", src.finished + pdst.finished, prefix_streams),
              cow_copies=installs["cow"],
              pool_blocks_at_end=pdst._alloc.used_blocks)
    st["launches"] = _migrate_launches(tfa, "paged", cfg, prefix_specs,
                                       [False, True])
    _check_counters(tfa)
    _same_graphs("paged", psrc, pbefore)
    _same_graphs("paged", src, before)
    st["seconds"] = time.perf_counter() - t0
    _print_migrate("paged", st, (
        f"; {len(warm) - 1} of {len(warm)} warm snapshots "
        f"prefix-trimmed to rows [{PREFIX_LEN}, kv_len): "
        f"{trimmed / 1e6:.1f} MB against {untrimmed / 1e6:.1f} MB "
        f"untrimmed; prefix rows rebuilt from the registry "
        f"{from_registry}, re-prefilled {reprefilled}; the paged target's "
        f"installs copied {installs['cow']} partial tail blocks on write; "
        f"it holds "
        f"{pdst._alloc.used_blocks} blocks at the end (its registry's "
        f"{registry_blocks})"))
    if st["streams_equal"] != len(prefix_specs) or not trimmed < untrimmed \
            or pdst._alloc.used_blocks != registry_blocks \
            or from_registry == 0 \
            or installs["cow"] != from_registry // PREFIX_LEN:
        raise AssertionError(f"[migrate:paged] {st['streams_equal']}/16 "
                             f"equal, {trimmed} vs {untrimmed} bytes")
    out["paged"] = st
    del src, dst, psrc, pdst
    torch.cuda.empty_cache()
    print(f"[migrate] llama: the four arms and their engines took "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)
    return out


def migrate_family(tfa, name, cfg, run, params, specs, dense_streams):
    """[migrate:olmoe|mamba2|zamba2]: one whole drain mid-decode restored
    into the same engine; 16/16 streams equal the family's dense arm
    (olmoe at the no-drop capacity factor, where no done lane reaches a
    live one), no capture added, the counters back at zero."""
    import torch
    t0 = time.perf_counter()
    engine = _migrate_engine(cfg, run, params)
    installs = _time_installs([engine])
    before = _graphs(engine)
    tfa.reset_launch_counts()
    snaps, drain = _drain_mid_decode(engine, _requests(specs))
    engine.restore(snaps)
    _run_all(engine)
    st = _payload_stats(snaps, drain, installs)
    st["streams_equal"] = _equal_streams(name, engine.finished,
                                         dense_streams)
    st["launches"] = _migrate_launches(tfa, name, cfg, specs, [False])
    _check_counters(tfa)
    _same_graphs(name, engine, before)
    st["seconds"] = time.perf_counter() - t0
    _print_migrate(name, st)
    if st["streams_equal"] != len(specs) or drain["syncs"] != 2:
        raise AssertionError(f"[migrate:{name}] {st['streams_equal']}/16 "
                             f"streams equal the dense arm's, "
                             f"{drain['syncs']} syncs")
    del engine
    torch.cuda.empty_cache()
    return st


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
    losses, gnorms, secs, joules = [], [], [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        e0 = METER.energy_mj()           # on the loop's own syncs
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        joules.append((METER.energy_mj() - e0) / 1e3)
        _check_draw(f"[train] step {i}", joules[-1], secs[-1])
        print(f"[train] step {i} loss={losses[-1]:.4f} "
              f"grad_norm={gnorms[-1]:.4f} {secs[-1]:.3f}s "
              f"E={joules[-1]:.1f}J", flush=True)
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
             "bf16_peak_share": model_ops / (step_s * BF16_OPS_PER_S),
             "step_j": joules,
             "median_step_j_after_first": float(np.median(joules[1:])),
             "j_per_step": sum(joules) / TRAIN_STEPS}
    print(f"[train] {TRAIN_STEPS} steps of {B} x {S} tokens: "
          f"{step_s:.3f} s per step (median after the first; first "
          f"{secs[0]:.3f} s), {stats['median_step_j_after_first']:.1f} J per "
          f"step (median after the first; {stats['j_per_step']:.1f} over "
          f"the {TRAIN_STEPS}, "
          f"{stats['median_step_j_after_first'] / tokens * 1e3:.2f} mJ a "
          f"token), {stats['tokens_per_s']:.0f} tokens/s, peak "
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


# ---------------------------------------------------------------------------
# phase 7: LSMS, the paper's own workload (models/lsms.py)
# ---------------------------------------------------------------------------

#: [lsms:parity]: the reduced configuration held card against CPU
LSMS_PARITY = dict(n_atoms=16, liz=8, nb=16, e_points=4)
# card vs CPU, both complex64 with TF32 off: the same products and
# factorisations with their sums in another order (cuBLAS and the card's
# LU against LAPACK), through an LU of order 128 whose pivots are the
# identity's (|A| ~ 1 on the diagonal): ~1e-7 relative expected in A
# (t is diagonal, so each product has one term), ~1e-6 in tau and the
# density; A against max|A|, tau and the density relative to their largest
LSMS_TOL = {"A": 1e-5, "tau": 1e-4, "density": 1e-4}
#: MAGMA's kernel names: its batched LU's panels, pivot swaps and updates
#: and getrs's triangular solves (``magma_*`` types in a signature,
#: ``*_kernel_batched``, ``*_kernel_shared_batched``, ``*_template_batched_*``
#: and ``zdisplace_pointers_kernel``, read on the card with
#: torch 2.11.0+cu128)
MAGMA_KERNELS = ("magma", "_kernel_batched", "_kernel_shared_batched",
                 "template_batched_", "displace_pointers")
#: kernel-name fragments of an energy point's device time by the library
#: that ran it: MAGMA's batched LU, cuSOLVER's, cuBLAS's GEMMs (the block
#: product) and PyTorch's own elementwise kernels (G0, A = I - tG0)
LSMS_PROFILE_GROUPS = {
    "MAGMA": MAGMA_KERNELS,
    "cuSOLVER": ("cusolver",),
    "cuBLAS GEMM": ("xmma", "nvjet", "cutlass", "sm80_", "sm90_"),
    "PyTorch elementwise": ("at::native",),
}


def lsms_parity():
    """``[lsms:parity]``: LSMS_PARITY on the card against the same code on
    the CPU, on the same numpy positions (seeded): A and tau at the first
    energy point of the first iteration, and ``run_scf``'s density, each
    within LSMS_TOL, the worst entry printed."""
    import torch
    from repro_torch.models import lsms
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("[lsms:parity] needs TF32 off")
    cfg = lsms.LsmsConfig(**LSMS_PARITY)
    pos = np.random.default_rng(23).uniform(
        0.0, 10.0, (cfg.n_atoms, 3)).astype(np.float32)
    got = {}
    for dev in ("cuda", "cpu"):
        p = torch.from_numpy(pos).to(dev)
        energy = torch.from_numpy(lsms.contour(cfg)).to(dev)[0]
        A, t_blocks = lsms.build_kkr_matrix(cfg, p, lsms.initial_t(cfg, dev),
                                            energy)
        tau, _ = lsms.solve_tau(A, t_blocks)
        density = lsms.run_scf(cfg, positions=pos, device=dev)
        got[dev] = {"A": A.cpu(), "tau": tau.cpu(), "density": density.cpu()}
    out = {}
    for name, tol in LSMS_TOL.items():
        card, cpu = got["cuda"][name], got["cpu"][name]
        diff = (card - cpu).abs()
        worst = int(diff.argmax())
        rel = float(diff.max() / cpu.abs().max())
        out[name] = {"rel_err": rel, "tol": tol,
                     "worst": [str(card.flatten()[worst].item()),
                               str(cpu.flatten()[worst].item())]}
    print(f"[lsms:parity] {cfg.n_atoms} atoms, LIZ {cfg.liz}, nb {cfg.nb}, "
          f"{cfg.e_points} energy points, card (TF32 off) vs CPU, complex64: "
          + "; ".join(f"{k} {v['rel_err']:.3e} of max|CPU| (limit "
                      f"{v['tol']:.0e}; worst entry card {v['worst'][0]} vs "
                      f"CPU {v['worst'][1]})" for k, v in out.items()),
          flush=True)
    bad = [k for k, v in out.items() if not v["rel_err"] <= v["tol"]]
    if bad:
        raise AssertionError(f"[lsms:parity] card and CPU disagree on {bad}")
    return out


def _lsms_run(nvml, cfg, positions, power=None):
    """``run_scf``'s iterations on the card from an idle card
    (``lsms.metered_scf``, as the example runs them): wall seconds and
    joules of each, read where ``host_mix`` has waited for the card,
    each iteration's draw checked, and the density."""
    from repro_torch.models import lsms
    density, iters = lsms.metered_scf(nvml, cfg, positions, power=power)
    for it in iters:
        it["mean_w"] = _check_draw("[lsms] an SCF iteration", it["joules"],
                                   it["seconds"])
    return density, iters


def lsms_scf(nvml):
    """``[lsms:scf]``: LSMS_CARD through ``scf_iterations`` on the card,
    after one untimed call of each task at its shapes (the libraries'
    first-call costs): wall s and J per iteration, the mean draw, the
    peak memory, and the density: finite, of shape (n_atoms,)."""
    import torch
    from repro_torch.models import lsms
    cfg = lsms.LSMS_CARD
    positions = lsms.make_positions(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    for fn in lsms.task_calls(cfg, positions).values():
        fn()
    _release_card()
    density, iters = _lsms_run(nvml, cfg, positions)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rho = density.cpu().numpy()
    if rho.shape != (cfg.n_atoms,) or not np.isfinite(rho).all():
        raise AssertionError(f"[lsms:scf] density {rho.shape}, finite "
                             f"{np.isfinite(rho).all()}")
    wall = sum(it["seconds"] for it in iters)
    joules = sum(it["joules"] for it in iters)
    print(f"[lsms:scf] {cfg.n_atoms} atoms, LIZ {cfg.liz}, nb {cfg.nb} "
          f"(m = {cfg.liz * cfg.nb}), {cfg.e_points} energy points, "
          f"{cfg.scf_iters} iterations: " + ", ".join(
              f"iteration {i} {it['seconds']:.3f} s {it['joules']:.1f} J "
              f"{it['mean_w']:.1f} W" for i, it in enumerate(iters))
          + f"; {wall:.3f} s and {joules:.1f} J in all ({joules / wall:.1f} "
          f"W); peak {peak:.2f} GiB; density sum {float(rho.sum()):.6f}, "
          f"finite, shape {rho.shape}", flush=True)
    _release_card()
    return positions, density, {"iterations": iters, "wall_s": wall,
                                "joules": joules, "peak_gib": peak,
                                "density_sum": float(rho.sum())}


def lsms_table1(card, positions, scf):
    """``[lsms:table1]``: ``lsms.measure_table1``, the builder the example
    shares: each task timed alone at one energy point's shapes
    (``lsms.task_calls``), repeated to fill a window of at least
    WINDOW_S on the energy counter, at the limit in force (and at every
    cap of the sweep where the card takes writes; each window's draw
    checked at its cap): ms per call against its bound
    (``lsms_task_counts``), J per call and the window's mean W, and the
    task's calls, s and J over the run; then the per-task seconds summed
    over the run against the [lsms:scf] wall (not gated).  Returns the
    summary and the measured task mix."""
    from repro_torch.models import lsms
    measured = lsms.measure_table1(card, lsms.LSMS_CARD, positions)
    _release_card()
    limit = measured["caps"][0]
    for cap, windows in measured["windows"].items():
        for task, w in windows.items():
            _check_draw(f"[lsms:table1] {task} at {cap:.2f} W", w["joules"],
                        w["seconds"], limit_w=cap)
    rows = {t: dict(r, ms=r["s_per_call"] * 1e3, bound_ms=r["bound_s"] * 1e3)
            for t, r in measured["rows"].items()}
    for task, r in rows.items():
        share = (f", {100 * r['bound_ms'] / r['ms']:.1f}% of it"
                 if r["bound_ms"] else "")
        print(f"[lsms:table1] {task}: {r['ms']:.4f} ms a call against its "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}{share}); "
              f"{r['j_per_call']:.4f} J a call at {r['mean_w']:.1f} W "
              f"({r['reps']} calls over {r['seconds']:.2f} s at "
              f"{limit:.2f} W); {r['calls']} calls in the run: "
              f"{r['run_s']:.3f} s, {r['run_j']:.2f} J", flush=True)
    if len(measured["caps"]) > 1:
        print("[lsms:table1] per cap, s and J over the run: " + "; ".join(
            f"{m.task} {m.cap:.0f} W {m.runtime:.3f} s {m.energy:.2f} J"
            for m in measured["measurements"]), flush=True)
    total = sum(r["run_s"] for r in rows.values())
    ratio = total / scf["wall_s"]
    print(f"[lsms:table1] the tasks' seconds over the run sum to "
          f"{total:.3f} s against the [lsms:scf] wall of {scf['wall_s']:.3f}"
          f" s: ratio {ratio:.3f}", flush=True)
    return {"tasks": rows, "caps": measured["caps"], "sum_s": total,
            "ratio_to_scf": ratio, "limit_w": limit,
            "measurements": [dataclasses.asdict(m)
                             for m in measured["measurements"]]}, \
        measured["tasks"]


def lsms_table2(card, tasks):
    """``[lsms:table2]``: the modelled H100 sweep (hw/h100.py, the limits
    NVML reports) of the measured task mix (``measure_table1``'s
    ``measured_lsms_tasks``): the SED and ED caps per task, beside the
    paper-calibrated mix's picks on the same spec."""
    from repro_torch.core import measure_sweep, table2
    from repro_torch.models import lsms
    spec = card.spec
    out = {}
    for name, mix in (("measured", tasks),
                      ("paper", lsms.paper_calibrated_tasks(spec.chip))):
        out[name] = {r.task: dataclasses.asdict(r)
                     for r in table2(measure_sweep(mix, spec=spec))}
    print("[lsms:table2] modelled H100 envelope, sweep "
          f"{', '.join(f'{c:.0f}' for c in spec.cap_sweep())} W; measured "
          "task mix, SED / ED caps (dE%, dt% at SED): " + "; ".join(
              f"{t} {r['sed_cap']:.0f} / {r['ed_cap']:.0f} W "
              f"({-r['sed_energy_reduction_pct']:+.2f}%, "
              f"{r['sed_runtime_increase_pct']:+.2f}%)"
              for t, r in out["measured"].items())
          + "; the paper-calibrated mix on the same spec: " + "; ".join(
              f"{t} {r['sed_cap']:.0f} / {r['ed_cap']:.0f} W"
              for t, r in out["paper"].items()), flush=True)
    return out


def lsms_power(card, positions, density, scf, tasks):
    """``[lsms:power]``: LSMS_CARD again under a ``MeteredPowerManager``
    on the modelled table of the measured mix (its SED caps), one phase
    per task per energy point and one per host mix: the caps written
    through NVML where the card takes writes, else logged.  The density
    must equal [lsms:scf]'s bit for bit (the phases add only syncs and
    counter reads), with 0 failed writes; J per iteration beside the
    unmetered run's, and the manager's syncs."""
    import torch
    from repro_torch.core import TaskTable, measure_sweep
    from repro_torch.models import lsms
    from repro_torch.power.metered import MeteredPowerManager
    cfg, spec, nvml = lsms.LSMS_CARD, card.spec, card.nvml
    writable = card.writable
    default = nvml.limit_w()
    pm = MeteredPowerManager(
        TaskTable(measure_sweep(tasks, spec=spec).rows), tasks=tasks,
        metric="sed", backend=card.backend, meter=nvml, spec=spec)
    got, iters = _lsms_run(nvml, cfg, positions, power=pm)
    if writable:
        nvml.apply(default)
    _release_card()
    equal = torch.equal(got.view(torch.int32), density.view(torch.int32))
    caps = {t: round(pm.cap_for(t)) for t in pm.tasks}
    joules = sum(it["joules"] for it in iters)
    # each phase's wall (its edges' syncs and one counter read included),
    # summed per task and iteration, in the order the loop ran them
    per_iter = len(pm.history) // cfg.scf_iters
    by_iter = [{t: sum(r.wall_s for r in pm.history[i * per_iter:
                                                     (i + 1) * per_iter]
                       if r.name == t) for t in pm.tasks}
               for i in range(cfg.scf_iters)]
    getrf_ms = [r.wall_s * 1e3 for r in pm.history if r.name == "getrf"]
    print(f"[lsms:power] SED caps {caps} W"
          + ("" if writable else " (logged, not applied: writes refused)")
          + ": " + ", ".join(
              f"iteration {i} {it['seconds']:.3f} s {it['joules']:.1f} J"
              for i, it in enumerate(iters))
          + " against the unmetered " + ", ".join(
              f"{it['seconds']:.3f} s {it['joules']:.1f} J"
              for it in scf["iterations"])
          + f"; phases {pm.total_joules():.1f} of {joules:.1f} J, "
          f"{sum(pm.entries.values())} phases, {pm.transitions} cap writes, "
          f"{pm.apply_failures} apply failures, {pm.syncs} syncs of the "
          f"manager; density bit-equal to [lsms:scf]: {equal}; phase s by "
          "iteration: " + ", ".join(
              f"{t} " + " / ".join(f"{it[t]:.3f}" for it in by_iter)
              for t in pm.tasks)
          + f"; getrf phases {min(getrf_ms):.1f}-{max(getrf_ms):.1f} ms "
          f"(median {float(np.median(getrf_ms)):.1f})", flush=True)
    if not equal:
        raise AssertionError("[lsms:power] the metered density differs")
    if pm.apply_failures:
        raise AssertionError(f"[lsms:power] {pm.apply_failures} failed "
                             "cap writes")
    return {"iterations": iters, "caps": caps, "syncs": pm.syncs,
            "phase_s_by_iteration": by_iter, "getrf_phase_ms": getrf_ms,
            "phases": sum(pm.entries.values()),
            "phase_joules": dict(pm.joules), "phase_seconds":
            dict(pm.seconds), "cap_writes": pm.transitions,
            "apply_failures": pm.apply_failures, "bit_equal": equal}


def profile_lsms(positions):
    """``[profile:lsms]``: one energy point of LSMS_CARD (``scf_step`` with
    one contour point, to the density on the host) under torch.profiler,
    after one untimed: the top device ops, the busy share and the
    library each group of kernels came from; and which LU backend torch
    was built with and prefers."""
    import torch
    from repro_torch.models import lsms
    cfg = dataclasses.replace(lsms.LSMS_CARD, e_points=1)
    t_diag = lsms.initial_t(cfg, "cuda")

    def run():
        lsms.scf_step(cfg, positions, t_diag)[0].cpu()
        return None

    run()
    # the CUDA activity alone: with the host's ops too, this phase took
    # 63.3 s over MAGMA's ~6000 launches under one op, without them 1.8 s
    # (NVIDIA H100 80GB HBM3, torch 2.11.0+cu128)
    out = _profile_window("lsms", "one energy point of LSMS_CARD "
                          "(buildKKRMatrix, zgemm, getrf, trsm)", 1, run,
                          groups=LSMS_PROFILE_GROUPS, top_n=12, cpu=False)
    by_backend, unknown = collections.defaultdict(float), []
    for row in out["profile_top_kernels"]:
        backend = _lu_backend(row["kernel"])
        if backend == "unknown":
            unknown.append(row["kernel"])
        if backend is not None:
            by_backend[backend] += row["ms_per_step"]
    out.update(has_magma=bool(torch.cuda.has_magma),
               preferred_linalg=str(
                   torch.backends.cuda.preferred_linalg_library()),
               lu_backend=sorted(b for b in by_backend if b != "unknown"),
               lu_ms_by_backend=dict(by_backend), lu_unknown=unknown)
    print(f"[profile:lsms] LU backend: torch built with MAGMA "
          f"{out['has_magma']}, preferred {out['preferred_linalg']}; by the "
          f"names of the top {len(out['profile_top_kernels'])} kernels: "
          + (", ".join(f"{b} {ms:.3f} ms/step"
                       for b, ms in by_backend.items()) or "no LU kernel"),
          flush=True)
    if unknown or not out["lu_backend"]:
        print("[profile:lsms] LU backend unknown: "
              + ("; ".join(unknown) if unknown else
                 "no top kernel is a known library's LU kernel")
              + " (names of MAGMA, cuSOLVER and cuBLAS batched LU kernels "
              "matched)", flush=True)
    _release_card()
    return out


def _lu_backend(kernel):
    """The library that ran an LU kernel, by its name: ``MAGMA``
    (MAGMA_KERNELS), ``cuSOLVER``, ``cuBLAS batched`` (a batched getrf or
    getrs), ``unknown`` for an LU-like name (getrf, getrs, getf2, laswp,
    batched) of none of them, None for any other kernel."""
    k = kernel.lower()
    if any(f in k for f in MAGMA_KERNELS):
        return "MAGMA"
    if "cusolver" in k:
        return "cuSOLVER"
    if "batch" in k and ("getrf" in k or "getrs" in k):
        return "cuBLAS batched"
    if any(f in k for f in ("getrf", "getrs", "getf2", "laswp", "batch")):
        return "unknown"
    return None


def lsms_phases(card):
    """Phase 7: every [lsms:*] line, the seconds each phase took, and the
    {"lsms": ...} summary."""
    from repro_torch.models import lsms
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    out = {"parity": lsms_parity()}
    lap("parity")
    positions, density, out["scf"] = lsms_scf(card.nvml)
    lap("scf")
    out["table1"], tasks = lsms_table1(card, positions, out["scf"])
    lap("table1")
    out["table2"] = lsms_table2(card, tasks)
    lap("table2")
    out["power"] = lsms_power(card, positions, density, out["scf"], tasks)
    lap("power")
    out["profile"] = profile_lsms(positions)
    lap("profile")
    print("[lsms] seconds per phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()), flush=True)
    out.update(config=dataclasses.asdict(lsms.LSMS_CARD), seconds=seconds)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from repro_torch.power.nvml import open_card
    global METER
    # a terminated run still puts the power limit back (the stack below,
    # and the backend's atexit hook)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    with contextlib.ExitStack() as stack:
        card = open_card(stack, 0)   # no libnvidia-ml.so.1: the run fails
        METER = card.nvml
        try:
            return _smoke(card)
        finally:
            METER = None


def _smoke(card) -> int:
    import torch
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
    ptxas = build.kernel_resources()
    print("[build] ptxas -v, registers and bytes spilled (stores/loads) a "
          "thread: " + "; ".join(
              f"{k} {v.get('registers')}, {v.get('spill_stores')}/"
              f"{v.get('spill_loads')}" for k, v in sorted(ptxas.items())),
          flush=True)

    kind = torch.cuda.get_device_name(0)
    smi = _smi_line()
    print(f"[device] {kind} | nvidia-smi: {smi}", flush=True)

    fd_checks = check_flash_decode(tfa, ref)
    cu_checks = check_cache_update(tfa, ref)
    fdp_checks = check_flash_decode_paged(tfa, ref)
    fd_faults = check_decode_faults(tfa, ref)
    fd_shortcut = check_decode_shortcut(ref)
    cup_checks = check_cache_update_paged(tfa, ref)
    cu_rope_checks = check_rope_cache_update(tfa, ref, paged=False)
    cup_rope_checks = check_rope_cache_update(tfa, ref, paged=True)
    rope_faults = check_rope_faults(tfa, ref)
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
    # the fused RoPE + cache write at each model's heads: a decode step (one
    # done slot) and a 256-row prefill chunk
    for model, suffix in (("llama", ""), ("olmoe", " g=1"),
                          ("zamba2", " D=64")):
        for paged in (False, True):
            name = "cache_update_paged" if paged else "cache_update"
            times[f"{name} rope decode{suffix}"] = time_rope_cache_update(
                tfa, ref, paged, model, 8, 1, decode_index)
            times[f"{name} rope prefill{suffix}"] = time_rope_cache_update(
                tfa, ref, paged, model, 1, 256, [512])
    fa_checks = check_flash_attention(tfa, ref)
    fa_faults = check_planted_faults(tfa, ref)
    fa_shortcut = check_bf16_shortcut(ref)
    fa_times = time_flash_attention(tfa, ref)
    times["flash_attention training"] = fa_times["fwd"]
    times["flash_attention_bwd training"] = fa_times["bwd"]
    gmm_checks = check_grouped_matmul(gmm, ref)
    gmm_faults = check_grouped_matmul_faults(gmm, ref)
    for G, M, K, N in GMM_TIME_SHAPES:
        times[f"grouped_matmul M={M} {K}x{N}"] = time_grouped_matmul(
            gmm, ref, G, M, K, N)
    ssd_checks = check_ssd(tssd, ref)
    ssd_faults = check_ssd_faults(tssd, ref)
    ssd_shortcut = check_ssd_shortcut(ref)
    for model in SSD_HEADS:
        for S in SSD_TIME_S:
            times[_ssd_time_key(model, S)] = time_ssd(tssd, ref, model, S)
    for name, t in times.items():
        lib = (f"{t['library_ms']:.4f} ms" if t["library_ms"] is not None
               else "none")
        print(f"[time] {name} {t['shape']}: kernel {t['ms']:.4f} ms "
              f"(eager with its host work {t['host_ms']:.4f} ms), plain "
              f"{t['plain_ms']:.4f} ms, library {lib}, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})", flush=True)

    # 2b: the power backend, before the serving arms; the cap table and
    # the metered arm need llama's weights and its dense arm's streams
    power = {"nvml": power_nvml(card),
             "calibrate": power_calibrate(card.nvml)}
    dense_launches, serving, shared = serve_full_width(tfa)
    table, power["table"] = power_table(tfa, card, *shared[:4])
    power["serve"] = power_serve(tfa, card, table, power["nvml"],
                                 *shared)
    paged_launches, paged_serving = serve_arm(tfa, *shared, "paged", True)
    # dense, paged, paged, dense: each engine read on both sides of the
    # other, as the host's pace drifts over a run
    _, paged2 = serve_arm(tfa, *shared, "paged-again", True)
    _, dense2 = serve_arm(tfa, *shared, "dense-again", False)
    _, serving["eager"] = serve_arm(tfa, *shared, "eager", False, eager=True)
    serving["graph_ab"] = graph_ab(tfa, *shared[:3])
    serving["prefill_ab"] = prefill_ab(tfa, *shared[:4])
    serving["capture_refused"] = capture_refused(*shared[:3])
    order = (("dense", serving), ("paged", paged_serving),
             ("paged", paged2), ("dense", dense2))
    print("[serve:abba] dense, paged, paged, dense: " + ", ".join(
        f"{n} {st['tok_per_s']:.1f} tok/s "
        f"({st['decode_s'] / st['decode_steps'] * 1e3:.1f} ms/step)"
        for n, st in order), flush=True)
    paged_serving["again"] = paged2
    serving["again"] = dense2
    prefix_serving, prefix_specs, prefix_streams = serve_prefix_sharing(
        tfa, *shared[:3])
    # 3g: slot migration, on llama's weights and arms
    migrate = migrate_llama(tfa, *shared, prefix_specs, prefix_streams)
    llama = shared[:2]
    del shared                            # llama's weights, before olmoe's
    _release_card()
    # 3d: full-width olmoe, dense, paged, then the untimed replay
    moe_launches, moe_serving, moe_shared = serve_full_width(
        tfa, MOE_ARCH, "olmoe-")
    moe_paged_launches, moe_paged = serve_arm(tfa, *moe_shared,
                                              "olmoe-paged", True,
                                              gate_equal=False)
    _, moe_serving["eager"] = serve_arm(tfa, *moe_shared, "olmoe-eager",
                                        False, eager=True)
    moe_serving["graph_ab"] = graph_ab(tfa, *moe_shared[:3])
    moe_serving["prefill_ab"] = prefill_ab(tfa, *moe_shared[:4])
    moe_serving.update(serve_moe_replay(tfa, *moe_shared))
    moe_serving["no_drop"], nodrop_cfg, nodrop_streams = serve_moe_no_drop(
        tfa, *moe_shared[:4])
    migrate["olmoe"] = migrate_family(tfa, "olmoe", nodrop_cfg,
                                      *moe_shared[1:4], nodrop_streams)
    # each model's weights are released before the next model's are made
    olmoe = moe_shared[:2]
    del moe_shared
    _release_card()
    # 3e, 3f: full-width mamba2 (dense) and zamba2 (dense, paged)
    ssm_launches, ssm_serving, ssm_shared = serve_ssm(tfa)
    migrate["mamba2"] = migrate_family(tfa, "mamba2", *ssm_shared)
    ssd_layer_ms(times, "mamba2", ssm_shared[3])
    mamba2 = ssm_shared[:2]
    del ssm_shared
    _release_card()
    hyb_launches, hyb_paged_launches, hyb_serving, hyb_shared = \
        serve_hybrid(tfa)
    migrate["zamba2"] = migrate_family(tfa, "zamba2", *hyb_shared)
    print(json.dumps({"migrate": migrate}), flush=True)
    ssd_layer_ms(times, "zamba2", hyb_shared[3])
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
        if name in ("mamba2-dense", "zamba2-dense", "dense"):
            into.update(profile_prefill(
                *model, params, "prefill" if name == "dense"
                else name.split("-")[0] + "-prefill", groups=groups))
        del params
        _release_card()
    parity = logits_parity()
    moe_parity = olmoe_parity()
    mamba_parity = {SSM_ARCH: ssm_parity(SSM_ARCH, 2),
                    HYBRID_ARCH: ssm_parity(HYBRID_ARCH, 7)}
    train_launches, training = train_full_width(tfa)
    training["parity_rel_err"] = train_parity(tfa)
    # 7: LSMS, the paper's own workload, on a card no model holds
    lsms = lsms_phases(card)
    print(json.dumps({"lsms": lsms}))

    def bf16_err(checks):
        return max(c["max_abs_err"] for c in checks
                   if c["dtype"] == "bfloat16")

    def row(name, source, replaces, launches, err, tol, t, prefill, checks,
            arm, **extra):
        # olmoe (H = K = 16) and zamba2 (H = K = 32, D = 64): their times
        # and their arms' launches beside
        moe = moe_paged_launches if "paged" in name else moe_launches
        g1 = {"launches": moe[name], "launches_arm": "olmoe-" + arm}
        g1.update({" ".join(k.split()[1:-1]): times[k] for k in times
                   if k.startswith(name + " ") and k.endswith("g=1")})
        hyb = hyb_paged_launches if "paged" in name else hyb_launches
        d64 = {"launches": hyb[name], "launches_arm": "zamba2-" + arm}
        d64.update({" ".join(k.split()[1:-1]): times[k] for k in times
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
            times["flash_decode prefill"], fd_checks, "dense",
            worst_over_limit=max(c["worst_over_limit"] for c in fd_checks),
            planted_fault=fd_faults, bf16_shortcut=fd_shortcut),
        row("cache_update", csrc + "cache_update.cu", fa + ":394",
            dense_launches["cache_update"],
            max(c["max_abs_diff"] for c in cu_rope_checks), 0.0,
            times["cache_update rope decode"],
            times["cache_update rope prefill"], cu_rope_checks, "dense",
            scatter_only={"decode": times["cache_update decode"],
                          "checks": cu_checks},
            planted_fault=rope_faults),
        row("flash_decode_paged", csrc + "decode_attention_paged.cu",
            fa + ":318", paged_launches["flash_decode_paged"],
            bf16_err(fdp_checks), DECODE_TOL["bfloat16"],
            times["flash_decode_paged decode"],
            times["flash_decode_paged prefill"], fdp_checks, "paged",
            worst_over_limit=max(c["worst_over_limit"] for c in fdp_checks),
            vs_dense_max_abs_diff=max(c["vs_dense_max_abs_diff"]
                                      for c in fdp_checks)),
        row("cache_update_paged", csrc + "cache_update_paged.cu",
            fa + ":462", paged_launches["cache_update_paged"],
            max(c["max_abs_diff"] for c in cup_rope_checks), 0.0,
            times["cache_update_paged rope decode"],
            times["cache_update_paged rope prefill"], cup_rope_checks,
            "paged",
            scatter_only={"decode": times["cache_update_paged decode"],
                          "prefill": times["cache_update_paged prefill"],
                          "checks": cup_checks},
            planted_fault=rope_faults),
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
    t = gmm_times["grouped_matmul M=2 2048x1024"]
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
        checks=ssd_checks, planted_fault=ssd_faults,
        bf16_shortcut=ssd_shortcut))
    serving.update(paged=paged_serving, prefix_sharing=prefix_serving)
    moe_serving["paged"] = moe_paged
    print(json.dumps({"kernels": kernels, "serving": serving,
                      "olmoe_serving": moe_serving,
                      "mamba2_serving": ssm_serving,
                      "zamba2_serving": hyb_serving,
                      "training": training,
                      "parity_max_abs_diff": parity,
                      "olmoe_parity": moe_parity,
                      "ssm_parity": mamba_parity, "ptxas": ptxas,
                      "power": power,
                      "total_s": time.perf_counter() - t_start}))
    smi_end = _smi_line()
    if smi_end != smi:
        raise AssertionError(f"the card's limit moved: nvidia-smi read "
                             f"{smi!r} at the start, {smi_end!r} at the end")
    print(smi_end)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
