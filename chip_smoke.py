#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one card: ``python3 chip_smoke.py``.

Phases (any failure raises and exits non-zero; no phase's failure is
caught):

  0. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (timed;
     each kernel's registers and spills as ``ptxas -v`` reports them);
  1. the card: ``torch.cuda.get_device_name`` and nvidia-smi's name and
     power limit;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (B=8, S=2048, H=24, K=8, D=128; Sq 1, 5, 256 and
     1024, ``StaticServeEngine``'s whole-prompt prefill;
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
     training shape beside SDPA and its autograd backward; the same
     checks at a query offset (``FA_OFFSET_CASES``: the sequence-parallel
     rank 1's 1024 rows at positions 1024.. over 2048 keys, gemma2's D =
     256 with a window there, offsets no tile divides), shown to reject a
     backward that ignores the offset, and both kernels timed at the two
     ranks' shapes (``SEQPAR_RANKS``) beside SDPA with
     ``causal_lower_right``;
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
     contract's edges (P=48, N=96, G=2; P=16, N=32), the training shape
     (Bb=2, S=2048, chunk 128, both heads), bf16 and f32, the
     check shown to reject a kernel that drops h0, the state carried
     between chunks or one 64-row tile of x, and the plain version with
     M, the state and x o wd rounded to bf16 once (the shortcut the bf16
     kernel's hi/lo split avoids), then timed at S=256 and at every tail
     a prompt's chunk plan cuts (S = 128 ... 2) beside its byte bound (no
     library call computes SSD), and summed per Mamba layer over a
     serving arm's chunks; the two gradient kernels of the training
     paths: ``grouped_matmul_bwd`` against ``ref.grouped_matmul_bwd`` entry
     by entry at olmoe's training capacity (640 rows: 2 x 2048 tokens,
     top-8 of 64, capacity factor 1.25), gate/up and down, with dead rows
     (zero in lhs and dout past a group's live count: their dlhs exactly
     zero), at odd capacities and the reduced shapes, bf16 and f32, each
     twice bit for bit, shown to reject a kernel that leaves one group's
     drhs unwritten or drops the last 64-row M-slice, then timed beside
     the two ``torch.bmm`` calls (and the forward at M = 640); ``ssd_bwd``
     against ``ref.ssd_chunked_bwd`` entry by entry, every gradient (dx,
     ddt, dB, dC by the dtype's rule; the f32 sums dA, dD, dh0 by
     SSD_BWD_F32_RTOL/ATOL, each beside the float64 plain version's
     distance), at the training shape (Bb=2, S=2048, chunk 128) of
     mamba2's and zamba2's heads, with h0, D and the final state's
     gradient, G = 2, chunks 37 and 1, the contract's edges, bf16 and f32,
     each twice bit for bit, shown to reject a kernel that does not carry
     the state's gradient between chunks or does not sum dB over a
     group's heads, and the plain version with the bf16 kernels' f32
     operands rounded to bf16 once (``ref.ssd_bwd_tc_emulated``: the
     shortcut the hi/lo split avoids), then timed with the forward at the
     training shape (and, after the serving arms, by pass: the state
     pass, the chunk pass, torch.profiler's device time by kernel name);
     and the decode and RoPE cache kernels at nemotron-4-15b's heads (H =
     48, K = 8: a GQA group of 6, half rotary), checked and timed; the
     cache-free attention and its gradient at hubert-xlarge's head_dim 80
     (``HUBERT_FA_CASES``: H = K = 16, B 4 x 1024 bidirectional, 1000
     queries over 300 keys, one causal case, a small one; bf16 and f32)
     against the plain versions entry by entry, shown to reject outputs
     whose columns 64-79 are zeroed (what misread 160-byte rows would
     give), then timed beside SDPA and the bound at D = 80; and
     ``flash_decode`` and ``cache_update`` (M-RoPE's cos/sin of a 3-D
     grid) at qwen2-vl-72b's heads (H = 64, K = 8: a group of 8) at a
     decode step, a 256-row chunk and the vision prefill's 2048 rows,
     checked and timed;
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
  2c. the distributed layer, while this process holds little of the
     card (``tools/dist_probe.py`` runs it alone; sizes and gates at
     ``DIST_TRAIN_GATES``): two
     gloo ranks sharing the card, their collectives staged
     through the host; ``[dist:decode]`` (llama's sequence-sharded decode
     over mesh (1, 2), bf16 at 8 of 28 layers and f32 at 2, whose
     streams must equal the unsharded ones), ``[dist:decode-ssm]``
     (mamba2 f32 at 2 layers and zamba2 f32 at 7, prefilled on one
     device, the cache cut to the head-parallel program's layout, 8/8
     streams each), ``[dist:train-mamba2]`` and ``[dist:train-zamba2]``
     (the head-parallel Mamba-2 program at full width, 4 of 48 and 7 of
     38 layers, ``ssd`` and ``ssd_bwd`` on each rank's half of the heads,
     each against the one-device step beside a planted backward fault:
     the gated norm's all-reduce with an identity backward, ``a_in @
     lora_a`` without its ``copy_to``), ``[dist:train]`` (one step of
     llama at 2 of 28 layers
     on (1, 2) and on (2, 1) against the one-device step, each rank's
     gradients and parameters against its shard of that step's, and a
     planted fault per mesh that must fail every gate; the elastic
     restart on (1, 1)), ``[dist:decode-seqpar]`` (llama f32 at 2 layers
     under its serve rules, ``seqparallel``: every head on every rank
     over the cache cut by sequence; 8/8 streams), ``[dist:train-seqpar]``
     (one step on (1, 2) under llama's own ``seqparallel``) and
     ``[dist:train-fsdp]`` (on (2, 1) under ``fsdp``), each against the
     one-device step beside a planted fault of its gradients'
     collectives that must fail every gate a backward fault can reach
     (``DIST_FAULT_GATES``), and ``[dist:train-olmoe]`` (expert parallelism over
     the bf16 and int8 wires at a capacity that drops nothing, with its
     planted fault; one MoE layer's output against the local path; a
     decode step of all 16 layers under the mesh), ``[dist:prefill]``
     (the serving step functions on the mesh: 8 prompts of 1100-1900
     rows, each one chunk across the 1024-row slice edge of a 2048-row
     cache, then per-slot decode steps; llama bf16 at 4 of 28 layers
     under ``seqparallel`` and ``default``, f32 at 2 layers, zamba2 f32 at
     7; last logits, both ranks' cache rows and the steps against one
     device, ``DIST_BF16_DRIFT`` in bf16; two planted faults, the
     whole-slot write and a combine without the other slice) and
     ``[dist:serve-engine]`` (the eager ``ServeEngine`` on both ranks,
     dense and paged, 16/16 streams equal one device's); each rank's
     kernels launched (``launches_dist`` in the kernels line).  After the
     ``cache_update`` checks, ``[check] cache_update clip`` lines (the
     dense write's row-level clip, bit for bit its plain version, and the
     whole-slot rule's planted fault); after the ``ssd`` checks,
     ``[check] ssd f32 vs float64`` lines.  After phase 2's
     ``flash_decode`` checks, ``[check] flash_decode lse`` lines (the
     log-sum-exp output the combine needs, with its planted fault) and
     ``[time] flash_decode lse`` (beside ``flex_attention``'s lse); the
     ``ssd`` and ``ssd_bwd`` checks and ``[time]`` lines also at the
     heads of one of two model ranks (``SSD_RANK_HEADS``), and
     ``flash_attention`` at zamba2's shared block on one rank (16 of 32
     heads, D = 64);
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
       h. the engine's benchmark interface and the fleet layer, on
          llama's weights (every engine shares the arms' weight tensors):
          ``[serve:static]``, ``StaticServeEngine`` (the reference's
          throughput baseline: equal-length buckets at batch 8, each
          prompt prefilled whole, one host sync a token step, eager) on
          the dense arm's 16 requests beside the graphed dense arm: tok/s,
          p50/p99 of ``completion_s`` and J per generated token; every
          request gets its tokens, ``completion_s`` holds every uid, the
          dense kernels launch exactly 28 times a prefill batch and a
          decode step, and equal streams are counted, not gated; and
          ``[fleet:engine]``, ``fleet_scenario``: a ``SimulatedCluster``
          on the modelled H100 (``policy="sensitivity"``) of two
          open-loop ``ServeJob``s over graphed engines (one paged, one
          dense) fed a diurnal trace through admission and the
          autoscaler, its budget dipping below the nodes' floors: every
          arrival counted once, at least one stream moved between the
          engines with its tokens, every completed stream equal to its
          request served alone by the engine that finished it, the four
          attention and cache kernels launched, wall s and tok/s, the
          card's joules beside the fleet's modelled ones;
       i. full-width minitron-4b (4.19 B params) and nemotron-4-15b
          (15.63 B; each f32 leaf cast to bf16 as it is drawn), dense and
          graphed, at the arms' traffic: exact launches, tok/s and J per
          generated token;
       j. full-width gemma2-2b at max_seq 8192, dense and paged;
       k. qwen2-vl-72b at full width and QWEN2VL_LAYERS of its 80 layers
          (20.04 B params, 40.1 GB in bf16): ``[serve:qwen2vl-dense]``
          (the arms' 16 requests, graphed; exact launches, tok/s, J per
          generated token, ms per decode step and per 256 prompt rows),
          then ``[prefill:qwen2vl-vision]``: ``make_prefill_step`` at
          batch 1 over 2048 rows, the first 1024 seeded vision embeddings
          on a 32 x 32 grid of M-RoPE positions, timed, with exact
          launches, and M-RoPE shown to act (1-D positions move the
          logits by more than MROPE_ACTS);
       l. ``[encode:hubert]``: hubert-xlarge at full width and depth (48
          layers) encoding 8 x 1024 seeded frames through
          ``make_prefill_step``: 48 ``flash_attention`` launches an
          encode, ms and J per encode over at least 2 s;
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
     CPU in f32, the card in bf16 printed beside it; gemma2-2b, qwen2-vl
     (a prefill with 64 vision rows at grid positions and a decode step)
     and hubert (every frame's logits) at 2 layers within PARITY_TOL;
  5. training, the second main path, after the serving arms have
     released their weights: full-width, full-depth llama3.2-3b (seeded
     f32 masters, bf16 compute, AdamW, remat="full", batch 2 x 2048)
     trained TRAIN_STEPS steps on one repeated batch through
     ``make_train_step``: finite losses, the last below the first, and
     exactly 2 x 28 ``flash_attention`` and 28 ``flash_attention_bwd``
     launches per step; seconds per step, tokens/s, peak memory and the
     share of the bf16 peak; then the same loop as ``[train:olmoe]``
     (olmoe-1b-7b at full width, depth cut to 8 of 16 layers: its full
     depth's f32 state does not fit the card), ``[train:mamba2]`` and
     ``[train:zamba2]`` (full depth), ``[train:gemma2]`` and
     ``[train:hubert]`` (48 layers, 4 x 1024 seeded frames, labels over
     its vocab of 504), each with exact launches of every
     kernel, ``grouped_matmul_bwd`` and ``ssd_bwd`` among them; after
     each arm's steps, on a fresh batch its cross-entropy stays near
     ln(vocab) (the repeated batch is learnt by heart, nothing leaks),
     and, but for olmoe, the hidden states up to a position stay
     bit-equal when the tokens after it change;
  6. training parity: one f32 step at full width and 2 layers on the card
     (kernels) against the CPU (plain versions) from the same weights and
     batch: loss, grad norm and the parameter update, for llama3.2-3b,
     olmoe-1b-7b, mamba2-370m, gemma2-2b and hubert-xlarge (frames), and
     for reduced qwen2-vl with vision rows at grid positions;
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
(ten kernels; the attention rows carry ``gemma2_d256`` and, for the
training rows, ``hubert_d80`` and ``zamba2_rank`` objects,
flash_decode's and cache_update's a ``qwen2vl_g8`` one, flash_decode's an
``lse`` object, the rows of the kernels a ``[dist:*]`` phase ran (``ssd``
and ``ssd_bwd`` among them) a ``launches_dist`` one; the JSON also has
``power``, ``fleet`` and ``dist`` objects), the
nvidia-smi line, and as its last line
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
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

# the caching allocator grows segments in place instead of keeping freed
# blocks of earlier shapes apart: without it [train:olmoe] at 8 layers
# ran out of memory with 21 GB reserved but unallocated.  Read when CUDA
# starts, so set before anything touches the card
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
# the library call timed beside flash_decode's lse is torch.compile'd:
# compile in this process, so that no pool of compile workers outlives it
os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")

import numpy as np  # noqa: E402

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
              (8, 17, 128, 256),
              (64, 640, 2048, 1024), (64, 640, 1024, 2048)]  # training
#: olmoe's capacities, ceil(S * 8 * 1.25 / 64), at the prefill chunks of
#: 256, 128, ..., 1 rows (40 .. 1) and a batch-8 decode step (2): timed at
#: the gate/up shape, and at 2 and 40 at the down shape
GMM_TIME_M = (1, 2, 3, 5, 10, 20, 40)
GMM_TIME_SHAPES = ([(64, M, 2048, 1024) for M in GMM_TIME_M]
                   + [(64, 2, 1024, 2048), (64, 40, 1024, 2048)])
#: the training step's shape: batch x sequence, and olmoe's capacity there,
#: ceil(2 * 2048 * 8 * 1.25 / 64) (``_olmoe_train_capacity``), at which
#: the forward is timed too (gate/up and down)
TRAIN_B, TRAIN_S = 2, 2048
GMM_TRAIN_M = 640
GMM_TIME_SHAPES += [(64, GMM_TRAIN_M, 2048, 1024),
                    (64, GMM_TRAIN_M, 1024, 2048)]
#: (H, K, D) of the attention the fused RoPE + cache write serves:
#: llama3.2-3b, olmoe-1b-7b, zamba2-1.2b's shared block and gemma2-2b
ROPE_HEADS = {"llama": (24, 8, 128), "olmoe": (16, 16, 128),
              "zamba2": (32, 32, 64), "gemma2": (8, 4, 256)}
#: (H, K, D) of nemotron-4-15b: 48 query heads over 8 kv heads, a GQA
#: group of 6 (minitron-4b's 24 over 8 is llama's group of 3); both rotate
#: half of each head (rotary_pct 0.5)
NEMOTRON_HEADS = (48, 8, 128)
MINITRON_ARCH, NEMOTRON_ARCH = "minitron-4b", "nemotron-4-15b"
#: (H, K, D) of qwen2-vl-72b: 64 query heads over 8 kv heads, a GQA group
#: of 8, so a decode step has 8 query rows a kv head and takes the
#: kernel's chunk path (more than DECODE_ROWS = 4)
QWEN2VL_HEADS = (64, 8, 128)


def _heads(model):
    """(H, K, D) of a model's attention in the cache-write checks."""
    return {**ROPE_HEADS, "nemotron": NEMOTRON_HEADS,
            "qwen2vl": QWEN2VL_HEADS}[model]
F32_OPS_PER_S = PEAK_FLOPS_F32  # float32 outside the tensor cores, 67e12
TRAIN_STEPS = 6
#: the position after which the training arms' causality check replaces
#: the tokens: inside the 8th 128-row SSD chunk (896..1023), no boundary
CAUSAL_T = 1000
#: the bf16 attention kernels' tiles: the forward's key tile, the dK/dV
#: pass's query step and the dQ pass's query tile (flash_attention*.cu)
FA_KEY_TILE, FA_KV_STEP, FA_DQ_TILE = 128, 64, 128
#: kernel-name fragments of the train step's device time by kind (bf16:
#: the tensor-core kernels)
TRAIN_PROFILE_GROUPS = {
    "flash_attention": ("attn_fwd_tc_kernel",),
    "flash_attention_bwd": ("attn_bwd_dkdv_tc_kernel",
                            "attn_bwd_dq_tc_kernel", "attn_delta_kernel"),
    "grouped_matmul": ("grouped_matmul_tc_kernel",),
    "grouped_matmul_bwd": ("gmm_bwd_tc_kernel",),
    "ssd": ("ssd_tc_kernel",),
    "ssd_bwd": ("ssd_bwd_states_tc_kernel", "ssd_bwd_scan_kernel",
                "ssd_bwd_chunk_tc_kernel"),
    "GEMM (cuBLAS)": ("nvjet", "gemm", "Gemm", "cutlass", "xmma"),
}
#: the training arms beside llama's [train]: (arch, layers or None for
#: full depth).  olmoe's 16 layers of f32 master, grad and AdamW state
#: (16 B a param, 6.92 B params: ~111 GB) do not fit the card; 8 layers
#: (57.0 GB of state) do
TRAIN_ARMS = {"olmoe": ("olmoe-1b-7b", 8), "mamba2": ("mamba2-370m", None),
              "zamba2": ("zamba2-1.2b", None)}
# [train:parity], f32 card (kernels, TF32 off) vs f32 CPU (plain), one
# step: loss and grad norm differ by summation order only; the AdamW
# update g / (|g| + eps) flips for a gradient within rounding of zero
# (2 lr for that entry), so the updates are compared as a relative norm
TRAIN_PARITY_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "update": 1e-2}
ARCH = "llama3.2-3b"
MOE_ARCH = "olmoe-1b-7b"
SSM_ARCH = "mamba2-370m"
HYBRID_ARCH = "zamba2-1.2b"
#: the bf16 ssd_bwd kernels by pass (csrc/ssd_bwd.cu): the state pass
#: (each chunk's state products, then the scans across chunks) and the
#: chunk pass
SSD_BWD_PASSES = {
    "state": ("ssd_bwd_states_tc_kernel", "ssd_bwd_scan_kernel"),
    "chunk": ("ssd_bwd_chunk_tc_kernel",)}
#: the ssd kernel's serving shapes, (H, P, N) of each Mamba-2 model
SSD_HEADS = {"mamba2": (32, 64, 128), "zamba2": (64, 64, 64)}
#: the heads one of two model ranks runs under the head-parallel Mamba-2
#: program ([dist:train-mamba2], [dist:train-zamba2]): half of each model's
SSD_RANK_HEADS = {"mamba2 rank": (16, 64, 128), "zamba2 rank": (32, 64, 64)}
#: zamba2's shared block on one of two model ranks: 16 of its 32 heads at
#: D = 64, at the training shape (causal)
ZAMBA2_RANK_FA = (16, 16, 64)
ZAMBA2_RANK_FA_CASES = [((TRAIN_B,) + ZAMBA2_RANK_FA, TRAIN_S, TRAIN_S, True,
                         None, None)]
#: the prefill chunks timed: a 256-row chunk and every tail ``chunk_plan``
#: cuts that takes the kernel (two rows or more)
SSD_TIME_S = (256, 128, 64, 32, 16, 8, 4, 2)
#: the bf16 ssd kernel's row tile (csrc/ssd.cu)
SSD_TILE = 64
# ssd_bwd's float32 sums (dA, dD, dh0) against the plain version, per
# entry: |got - want| <= SSD_BWD_F32_RTOL |want| + SSD_BWD_F32_ATOL
# max|want|.  dA sums Bb x S rows of a reverse cumsum over the chunk of
# row sums over the chunk (4096 x 128 x 128 terms at the training shape),
# which cancel: on an H100 the plain version's own f32 dA lies up to
# 1.5e-5 of max|dA| from the float64 plain version of the same inputs, and
# the kernel's as far (each [check] ssd_bwd line prints both), so the two
# can differ by ~3e-5 of max|dA|; 1e-4 leaves about three times that.  A
# dropped chunk's or head's share moves dA by far more.
SSD_BWD_F32_RTOL = 1e-5
SSD_BWD_F32_ATOL = 1e-4
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
    block of query rows; Sq 1024: a whole prompt), softcap/window, the
    reduced configs' head_dim 32, olmoe's H = K = 16 (one query head per
    kv head) and zamba2's shared attention (H = K = 32, head_dim 64):
    max|err| within DECODE_TOL and every entry within the per-entry rule
    (``_entry_ratio``)."""
    import torch
    rng = np.random.default_rng(0)
    checks = []
    # Sq 1024: [serve:static]'s whole-prompt prefill of up to 1024 rows
    shapes = [((8, 2048, 24, 8, 128), Sq) for Sq in (1, 5, 256, 1024)] \
        + [((3, 64, 4, 2, 32), Sq) for Sq in (1, 4)] \
        + [((8, 2048, 16, 16, 128), Sq) for Sq in (1, 5, 256)] \
        + [((8, 2048, 32, 32, 64), Sq) for Sq in (1, 5, 256)] \
        + [((8, 2048, *NEMOTRON_HEADS), Sq) for Sq in (1, 256)]  # group 6
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


#: [check] cache_update clip: local offsets of a rank's 1024-row slice of
#: a 2048-row cache cut by sequence: before it, across its start, inside,
#: across its end, at it and past it (a done lane's max_seq)
CLIP_SLICE = 1024
CLIP_INDEX = [-300, -100, 0, 900, 1000, 1023, 1024, 2048]


def check_cache_update_clip(tfa, ref):
    """The write's row-level clip (``clip_rows``: only the sharded path of
    ``models/layers.py`` sets it): the kernel against its plain version,
    bit for bit (cache and rotated q), on a rank's 1024-row slice at the
    local offsets CLIP_INDEX, chunks of 1 and 256 rows, bare and with RoPE
    of q and k, at llama's (24, 8, 128) and zamba2's (32, 32, 64) heads,
    bf16 and f32.  The planted fault: the same calls under the whole-slot
    rule (``clip_rows=False``), held to the clipped plain version, must
    leave rows unwritten in every 256-row case (each has chunks that
    straddle the slice's ends).  Returns (checks, fault)."""
    import torch
    B, S = len(CLIP_INDEX), CLIP_SLICE
    checks, fault = [], []
    for dtype, (H, K, D), Sn, rope in itertools.product(
            (torch.bfloat16, torch.float32), ((24, 8, 128), (32, 32, 64)),
            (1, 256), (False, True)):
        g = torch.Generator(device="cuda").manual_seed(len(checks))
        kc, vc = (torch.randn((B, S, K, D), generator=g,
                              device="cuda").to(dtype) for _ in range(2))
        kn, vn = (torch.randn((B, Sn, K, D), generator=g,
                              device="cuda").to(dtype) for _ in range(2))
        idx = torch.tensor(CLIP_INDEX, dtype=torch.int32, device="cuda")
        kw = {}
        if rope:
            ang = torch.rand((B, Sn, D // 2), generator=g, device="cuda") * 6
            kw = dict(q=torch.randn((B, Sn, H, D), generator=g,
                                    device="cuda").to(dtype),
                      cos=torch.cos(ang), sin=torch.sin(ang))
        got = tfa.cache_update(kc.clone(), vc.clone(), kn, vn, idx,
                               clip_rows=True, **kw)
        want = ref.rope_kv_cache_update_ref(
            kc.clone(), vc.clone(), kn, vn, idx, clip_rows=True,
            **kw) if rope else ref.kv_cache_update_ref(
                kc.clone(), vc.clone(), kn, vn, idx, clip_rows=True)
        whole = tfa.cache_update(kc.clone(), vc.clone(), kn, vn, idx,
                                 clip_rows=False, **kw)
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        # rows of the slice the clipped write fills and the whole-slot one
        # leaves as they were
        missed = (whole[0] != want[0]).any(-1).any(-1).sum().item()
        case = {"dtype": str(dtype).split(".")[1], "heads": (H, K, D),
                "Sn": Sn, "rope": rope, "bit_exact": exact}
        checks.append(case)
        fault.append(dict(case, rows_missed=missed))
        print(f"[check] cache_update clip {case}", flush=True)
        if not exact:
            raise AssertionError(f"cache_update clip_rows disagrees: {case}")
    missed = [f["rows_missed"] for f in fault if f["Sn"] > 1]
    print(f"[check] cache_update clip planted fault (the whole-slot rule on "
          f"the straddling chunks): rows the clipped write fills and it "
          f"misses, by 256-row case: {missed} (each must be > 0)",
          flush=True)
    if not all(m > 0 for m in missed):
        raise AssertionError("the whole-slot rule passes the clip's check")
    return checks, fault


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
    # nemotron's and minitron's serving step: half rotary, bf16 cache
    cases += [("nemotron", Sn, nd, torch.bfloat16, 0.5) for Sn in (1, 256)
              for nd in dts]
    checks = []
    for model, Sn, new_dt, cache_dt, rp in cases:
        H, K, D = _heads(model)
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


def time_rope_cache_update(tfa, ref, paged, model, B, Sn, index,
                           rotary_pct=1.0):
    """The fused RoPE + cache write (bf16) at one serving shape, beside the
    plain composition run eagerly (two apply_rope passes and the scatter)
    and its byte bound; no single PyTorch call does both, so there is no
    library time.  ``rotary_pct``: the share of each head rotated.  At
    qwen2-vl's heads the cos/sin are M-RoPE's of a 3-D grid
    (``_mrope_cos_sin``)."""
    import torch
    H, K, D = _heads(model)
    S, bs, esz = 2048, 16, 2
    kc, vc, _, table, _ = _rope_cache(paged, B, S, K, D, torch.bfloat16, Sn,
                                      4700)
    if paged:                    # every slot's table maps all its blocks
        mb = S // bs
        table = torch.tensor(np.random.default_rng(9).permutation(B * mb)
                             .reshape(B, mb), dtype=torch.int32,
                             device="cuda")
    q, kn, vn, c, s = _rope_case(B, Sn, H, K, D, torch.bfloat16, rotary_pct,
                                 index, 4700)
    if model == "qwen2vl":
        c, s = _mrope_cos_sin(index, Sn)
    idx = torch.tensor(index, dtype=torch.int32, device="cuda")
    rope = dict(q=q, cos=c, sin=s, rotary_pct=rotary_pct)
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
        rotary_pct, block_tables=table)], 50)
    valid = [b for b, i in enumerate(index) if 0 <= i and i + Sn <= S]
    half = int(D * rotary_pct) // 2
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
                     f"of q and k"
                     + (f" (rotary_pct {rotary_pct})" if rotary_pct < 1
                        else "")
                     + (f", {done} done slot" if done else "")
                     + (", M-RoPE cos/sin of a 3-D grid"
                        if model == "qwen2vl" else ""),
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


_FA_TRAIN, _FA_SMALL = (2, 24, 8, 128), (2, 4, 2, 32)
#: llama's training sequence over two model ranks (sequence parallelism):
#: each rank's query rows, and each rank's (keys gathered, q_offset)
SEQPAR_ROWS = 1024
SEQPAR_RANKS = ((1024, 0), (2048, 1024))
#: ((B, H, K, D), Sq, Sk, causal, window, softcap) of the attention checks:
#: the training shape and the reduced configs' D=32; causal, window +
#: softcap, bidirectional (+ softcap), an odd length, Sq != Sk both ways
FA_CHECK_CASES = [(_FA_TRAIN, 2048, 2048, True, None, None),
                  (_FA_TRAIN, 2048, 2048, True, 512, 30.0),
                  (_FA_TRAIN, 1000, 1000, False, None, 30.0),
                  (_FA_TRAIN, 1000, 1000, True, None, None),
                  (_FA_TRAIN, 300, 1000, True, None, None),
                  (_FA_TRAIN, 1000, 300, True, None, None),
                  (_FA_SMALL, 256, 256, True, None, None),
                  (_FA_SMALL, 130, 77, False, 100, 20.0)]
#: the query offset (``q_offset``): rank 1 of llama's training shape cut
#: over two model ranks by sequence parallelism (its 1024 query rows at
#: positions 1024.. over the 2048 keys gathered up to its last row);
#: gemma2's D = 256 there with a window that acts (300 rows) and its
#: softcap; an offset and lengths no tile divides; the reduced configs'
#: D = 32 with a window.  Tuples as FA_CHECK_CASES's, then q_offset.
FA_OFFSET_CASES = [(_FA_TRAIN, 1024, 2048, True, None, None, 1024),
                   ((2, 8, 4, 256), 1024, 2048, True, 300, 50.0, 1024),
                   (_FA_TRAIN, 1000, 1700, True, None, None, 700),
                   (_FA_SMALL, 77, 200, True, 100, 20.0, 123)]


def check_flash_attention(tfa, ref, cases=FA_CHECK_CASES):
    """Forward (out and lse) and backward (dq, dk, dv) kernels against
    ``attention_naive`` (with its lse) and ``attention_bwd_ref`` on the
    same inputs, entry by entry; the backward on the plain forward's out
    and lse.  ``cases`` (FA_CHECK_CASES, hubert's at D = 80, or
    FA_OFFSET_CASES with a query offset), bf16 and f32.  Every row sees at
    least one key (the reference's two plain versions disagree on rows
    that see none)."""
    import torch
    checks = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for (B, H, K, D), Sq, Sk, causal, window, cap, *off in cases:
            q, k, v, do = _attention_case(B, Sq, Sk, H, K, D, dtype,
                                          500 + len(checks))
            kw = dict(causal=causal, local_window=window, softcap=cap)
            if off:
                kw["q_offset"] = off[0]
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
                           **({"q_offset": off[0]} if off else {}),
                           "max_abs_err": err, "worst_over_limit": ratio})
            print(f"[check] flash_attention {name} B={B} Sq={Sq} Sk={Sk} "
                  f"H={H} K={K} D={D} causal={causal} window={window} "
                  f"softcap={cap}"
                  + (f" q_offset={off[0]}" if off else "")
                  + ": max|err| (worst entry / its limit) "
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


def check_offset_fault(tfa, ref):
    """The q_offset checks must reject a backward that ignores the offset:
    at the first FA_OFFSET_CASES case (rank 1 of llama's training shape,
    bf16), the kernel's gradient with q_offset 0 against the plain
    gradient at the true offset, on the plain forward's out and lse (the
    forward is right).  Raises unless each of dq, dk, dv has entries past
    their limit.  Returns each tensor's share of entries beyond it."""
    import torch
    (B, H, K, D), Sq, Sk, causal, window, cap, off = FA_OFFSET_CASES[0]
    q, k, v, do = _attention_case(B, Sq, Sk, H, K, D, torch.bfloat16, 701)
    kw = dict(causal=causal, local_window=window, softcap=cap)
    out, lse = ref.attention_naive(q, k, v, return_lse=True, q_offset=off,
                                   **kw)
    want = ref.attention_bwd_ref(q, k, v, out, lse, do, q_offset=off, **kw)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    faults = {}
    for n, g, w in zip(("dq", "dk", "dv"), got, want):
        faults[n] = (_entry_ratio("bfloat16", g, w) > 1).float().mean().item()
    print(f"[check] flash_attention q_offset planted fault B={B} Sq={Sq} "
          f"Sk={Sk} H={H} K={K} D={D} causal bf16 (the backward with the "
          f"offset {off} ignored): share of entries beyond their limit "
          + ", ".join(f"{n} {f:.4f}" for n, f in faults.items()), flush=True)
    missed = [n for n, f in faults.items() if not f > 0]
    if missed:
        raise AssertionError(f"flash_attention q_offset: the {missed} check "
                             f"passes a backward that ignores the offset")
    return faults


def _attention_pairs(B, H, Sq, Sk, causal, window=None, q_offset=0):
    """The (query, key) pairs the mask leaves: what the attention kernels'
    operations scale with."""
    rows = np.arange(Sq) + q_offset
    hi = np.minimum(rows + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(rows - window + 1, 0) if window else np.zeros(Sq)
    return int(B * H * np.maximum(hi - lo, 0).sum())


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


def time_flash_attention(tfa, ref, heads=(24, 8, 128), softcap=None, B=2,
                         S=2048, causal=True, Sk=None, q_offset=0):
    """Forward and backward kernel, plain and library times at a training
    shape (bf16; llama's heads, B 2, S 2048, causal, or ``heads`` with
    ``softcap``, or hubert's bidirectional B 4, S 1024), two input sets in
    turn (~67 MB each at llama's heads, beyond the 50 MB L2).  With ``Sk``
    and ``q_offset``: a sequence-parallel rank's S query rows at positions
    q_offset.. over the Sk keys gathered up to its last row (q_offset + S
    = Sk).  Library yardsticks, never called by the port:
    ``scaled_dot_product_attention(is_causal=causal, enable_gqa=True)``
    (with an offset, ``attn_mask=causal_lower_right(S, Sk)``, the same
    function when the keys end at the last query row) and its autograd
    backward.  SDPA has no softcap: with one there is no library call of
    the same function, and SDPA's time without the softcap is kept beside
    as ``sdpa_no_softcap_ms``.  The bound is reckoned at the tensors' D
    (at D = 80 the bf16 kernels run 128-wide tiles: the row shows that
    price)."""
    import torch
    import torch.nn.functional as F
    H, K, D = heads
    esz = 2
    Sk = S if Sk is None else Sk
    cap = dict(softcap=softcap, causal=causal)
    if q_offset:
        if not causal or q_offset + S != Sk:
            raise ValueError("the offset's library call needs the keys to "
                             "end at the last query row")
        cap["q_offset"] = q_offset
    cases = [_attention_case(B, S, Sk, H, K, D, torch.bfloat16, 900 + i)
             for i in range(2)]
    saved = [tfa.flash_attention(q, k, v, **cap) for q, k, v, _ in cases]
    fwd = [functools.partial(tfa.flash_attention, *c[:3], **cap)
           for c in cases]
    bwd = [functools.partial(tfa.flash_attention_bwd, *c[:3], o, l, c[3],
                             **cap)
           for c, (o, l) in zip(cases, saved)]

    def plain_fwd(q, k, v):
        return ref.attention_naive(q, k, v, return_lse=True, **cap)

    lib_in = [[t.transpose(1, 2).contiguous().requires_grad_()
               for t in c[:3]] for c in cases]
    lib_do = [c[3].transpose(1, 2).contiguous() for c in cases]

    def lib_fwd(q, k, v):
        if q_offset:
            from torch.nn.attention.bias import causal_lower_right
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=causal_lower_right(S, Sk),
                enable_gqa=True)
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
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
                 [functools.partial(ref.attention_bwd_ref, *c[:3], o, l, c[3],
                                    **cap)
                  for c, (o, l) in zip(cases, saved)], 1),
             "library_ms": _time_graph_ms(lib_b, min_calls=16,
                                          stream=lib_stream)}
    # the (q, k) pairs the mask leaves
    pairs = _attention_pairs(B, H, S, Sk, causal, q_offset=q_offset)
    q_bytes, kv_bytes = B * S * H * D * esz, B * Sk * K * D * esz
    lse_bytes = 4 * B * H * S
    # forward: reads q, k, v; writes out, lse
    t_fwd["bound_ms"], t_fwd["bound_by"] = _bound(
        2 * q_bytes + 2 * kv_bytes + lse_bytes, 4.0 * D * pairs,
        BF16_OPS_PER_S)
    # backward: reads q, k, v, out, dout, lse; writes dq, dk, dv
    t_bwd["bound_ms"], t_bwd["bound_by"] = _bound(
        4 * q_bytes + 4 * kv_bytes + lse_bytes, 10.0 * D * pairs,
        BF16_OPS_PER_S)
    shape = (f"B={B} S={S} H={H} K={K} D={D} "
             + (f"Sk={Sk} q_offset={q_offset} " if q_offset else "")
             + f"{'causal' if causal else 'bidirectional'} bf16"
             + (f" softcap {softcap}" if softcap else ""))
    lib = (f"attn_mask=causal_lower_right({S}, {Sk})" if q_offset
           else f"is_causal={causal}")
    t_fwd.update(shape=shape, ops=4.0 * D * pairs,
                 library=f"F.scaled_dot_product_attention({lib}, "
                         "enable_gqa=True) on (B,H,S,D) copies",
                 plain="ref.attention_naive(return_lse=True)")
    t_bwd.update(shape=shape, ops=10.0 * D * pairs,
                 library="torch.autograd.grad through the same SDPA call "
                         "(CUDA graph, as the kernel)",
                 plain="ref.attention_bwd_ref")
    if softcap:
        for t in (t_fwd, t_bwd):
            t["sdpa_no_softcap_ms"] = t.pop("library_ms")
            t["library_ms"] = None
            t["library"] = ("none: SDPA has no softcap; sdpa_no_softcap_ms "
                            "is " + t["library"] + " without it")
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


def ssd_rank_cases(dtype):
    """``check_ssd``'s cases at the training shape and the heads of one of
    two model ranks (``SSD_RANK_HEADS``), at dt_shift -3 and 0."""
    return [(dtype, model, H, P, N, TRAIN_S, 1, False, shift, False, 128,
             TRAIN_B)
            for model, (H, P, N) in SSD_RANK_HEADS.items()
            for shift in (-3.0, 0.0)]


def check_ssd(tssd, ref, cases=None):
    """The kernel against ``ref.ssd_chunked`` on the same card inputs,
    entry by entry (``_entry_ratio``: y in its dtype, the final state by
    the float32 rule), at mamba2's and zamba2's heads, S = 256 (two
    chunks: the state carried), 128, 64, 16 and 2 (one chunk of S rows,
    as serving cuts prompt tails), with and without h0, with D; the
    models' dt scale once per shape; G = 2 once; the final state written
    over h0 (the cache lane, in place) once; at mamba2's heads the chunks
    a whole-prompt prefill picks that are no power of two: 37 (S = 4 x
    37) and 1 (S = 131, a prime); the edges of the kernel's contract (P =
    48, N = 96, G = 2; P = 16, N = 32, chunk 48); and the training arms'
    shape, Bb = 2, S = 2048, chunk 128 (16 chunks), at both models' heads,
    with and without h0, at dt_shift -3 and at the models' dt scale, and
    at the heads of one of two model ranks (``SSD_RANK_HEADS``); bf16
    and f32.  ``cases``, if given, in their place."""
    import torch
    if cases is not None:
        return _check_ssd_cases(tssd, ref, cases)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for model, (H, P, N) in SSD_HEADS.items():
            cases += [(dtype, model, H, P, N, S, 1, h0, -3.0, False,
                       min(128, S))
                      for S in (256, 128, 64, 16, 2) for h0 in (True, False)]
            cases.append((dtype, model, H, P, N, 256, 1, True, 0.0, False,
                          128))
            cases += [(dtype, model, H, P, N, TRAIN_S, 1, h0, shift, False,
                       128, TRAIN_B)
                      for h0, shift in ((True, -3.0), (False, -3.0),
                                        (False, 0.0))]
        cases += ssd_rank_cases(dtype)
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
    return _check_ssd_cases(tssd, ref, cases)


#: seeds of the f32 ``ssd`` forward against the float64 plain version
SSD_F64_SEEDS = (9100, 9101, 9102)


def check_ssd_f32_exact(tssd, ref, models=None):
    """The f32 ``ssd`` forward (its prefill chunks run from a cache lane's
    h0, on a rank's heads under the head-parallel program) against the
    plain version in float64 of the same inputs, by the f32 per-entry rule
    of y and of the final state: the training shape (Bb 2, S 2048, chunk
    128) with h0, at the models' dt scale and at dt_shift -3, at mamba2's
    and zamba2's heads whole and on one of two model ranks (``models``, if
    given, names some of them), SSD_F64_SEEDS each.  Each line also gives
    the f32 plain version's distance, the bound a kernel of f32 sums can
    be held to."""
    import torch
    heads = {**SSD_HEADS, **SSD_RANK_HEADS}
    checks = []
    for model in models or heads:
        H, P, N = heads[model]
        worst = {"y": 0.0, "state": 0.0, "plain_y": 0.0, "plain_state": 0.0}
        for seed in SSD_F64_SEEDS:
            for shift in (0.0, -3.0):
                args = _ssd_case(TRAIN_B, TRAIN_S, H, P, 1, N, torch.float32,
                                 seed, shift)
                got = tssd.ssd(*args, chunk=128)
                plain = ref.ssd_chunked(*args, chunk=128)
                exact = ref.ssd_chunked(*(t.double() for t in args),
                                        chunk=128)
                for key, (a, p, w) in (("y", (got[0], plain[0], exact[0])),
                                       ("state", (got[1], plain[1],
                                                  exact[1]))):
                    worst[key] = max(worst[key], _entry_ratio(
                        "float32", a, w).max().item())
                    worst["plain_" + key] = max(
                        worst["plain_" + key],
                        _entry_ratio("float32", p, w).max().item())
        checks.append({"model": model, "H": H, "P": P, "N": N, **worst})
        print(f"[check] ssd f32 vs float64 {model} H={H} P={P} N={N} "
              f"Bb={TRAIN_B} S={TRAIN_S} chunk=128 h0, dt_shift 0 and -3, "
              f"{len(SSD_F64_SEEDS)} seeds: worst entry / the f32 rule: y "
              f"{worst['y']:.3f}, state {worst['state']:.3f} (the f32 plain "
              f"version: {worst['plain_y']:.3f}, "
              f"{worst['plain_state']:.3f})", flush=True)
        if not (worst["y"] <= 1.0 and worst["state"] <= 1.0):
            raise AssertionError(f"ssd f32 off the exact forward: "
                                 f"{checks[-1]}")
    return checks


def _check_ssd_cases(tssd, ref, cases):
    import torch
    checks = []
    for dtype, model, H, P, N, S, G, use_h0, shift, inplace, Q, *bb in cases:
        Bb = bb[0] if bb else 1
        x, dt, A, B, C, D, h0 = _ssd_case(Bb, S, H, P, G, N, dtype,
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
                       "Bb": Bb, "S": S, "G": G, "chunk": Q, "h0": use_h0,
                       "dt_shift": shift, "state_out_is_h0": inplace,
                       "max_abs_err": err, "worst_over_limit": ratio_y,
                       "state_worst_over_limit": ratio_s})
        print(f"[check] ssd {name} {model} H={H} P={P} N={N} Bb={Bb} S={S} "
              f"G={G} "
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
    ops = _ssd_ops(1, S, H, P, G, N, Q)
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
# phase 2: the training kernels of MoE and Mamba-2 (grouped_matmul_bwd,
# ssd_bwd) against their plain versions
# ---------------------------------------------------------------------------

def _olmoe_train_capacity():
    """The expert capacity of an olmoe training step at TRAIN_B x TRAIN_S
    tokens: ceil(T * top_k * capacity_factor / E) (``apply_moe``)."""
    from repro_torch.configs.registry import get_model_config
    cfg = get_model_config(MOE_ARCH)
    return math.ceil(TRAIN_B * TRAIN_S * cfg.top_k * cfg.capacity_factor
                     / cfg.n_experts)


def _gmm_bwd_case(G, M, K, N, dtype, seed, live=None):
    """lhs, rhs and a cotangent dout on the card; with ``live`` (G,) the
    rows of lhs and dout past each group's live count are zero, as
    ``_moe_dispatch_local`` leaves expert_in and the combine leaves the
    cotangent of rows it never reads."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    lhs, rhs, dout = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                      for shape in ((G, M, K), (G, K, N), (G, M, N)))
    if live is not None:
        dead = (torch.arange(M, device="cuda")[None]
                >= torch.tensor(live, device="cuda")[:, None])
        lhs[dead] = 0
        dout[dead] = 0
    return lhs, rhs, dout


def check_grouped_matmul_bwd(gmm, ref):
    """The gradient kernel against ``ref.grouped_matmul_bwd`` on the same
    inputs, entry by entry (``_entry_ratio``): at olmoe's training shapes
    (capacity GMM_TRAIN_M rows; gate/up and down), with each group's rows
    past a seeded live count zero in lhs and dout (their dlhs rows must be
    exactly zero), at odd capacities and the reduced configs' shapes, bf16
    and f32; only dlhs and only drhs once; and the same inputs twice, bit
    for bit."""
    import torch
    M = _olmoe_train_capacity()
    if M != GMM_TRAIN_M:
        raise AssertionError(f"olmoe's training capacity {M}, GMM_TRAIN_M "
                             f"{GMM_TRAIN_M}")
    rng = np.random.default_rng(7)
    shapes = [(64, M, 2048, 1024, None), (64, M, 1024, 2048, None),
              (64, M, 2048, 1024, rng.integers(0, M + 1, 64).tolist()),
              (64, 37, 1024, 2048, None), (64, 1, 2048, 1024, None),
              (8, 17, 128, 256, None), (8, 5, 256, 128, [5, 0, 3, 1, 5, 2,
                                                         4, 0])]
    checks = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for G, m, K, N, live in shapes:
            lhs, rhs, dout = _gmm_bwd_case(G, m, K, N, dtype,
                                           3300 + len(checks), live)
            got = gmm.grouped_matmul_bwd(lhs, rhs, dout)
            again = gmm.grouped_matmul_bwd(lhs, rhs, dout)
            want = ref.grouped_matmul_bwd(lhs, rhs, dout)
            torch.cuda.synchronize()
            if not all(torch.isfinite(t).all() for t in got):
                raise AssertionError("grouped_matmul_bwd: non-finite output")
            err = {n: (a.float() - w.float()).abs().max().item()
                   for n, a, w in zip(("dlhs", "drhs"), got, want)}
            ratio = {n: _entry_ratio(name, a, w).max().item()
                     for n, a, w in zip(("dlhs", "drhs"), got, want)}
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            check = {"dtype": name, "G": G, "M": m, "K": K, "N": N,
                     "live_rows": live is not None, "max_abs_err": err,
                     "worst_over_limit": ratio, "bit_equal_twice": same}
            if live is not None:
                dead = (torch.arange(m, device="cuda")[None]
                        >= torch.tensor(live, device="cuda")[:, None])
                check["dead_rows_dlhs_zero"] = bool(
                    (got[0][dead] == 0).all().item())
            checks.append(check)
            print(f"[check] grouped_matmul_bwd {name} G={G} M={m} K={K} "
                  f"N={N}{' live rows' if live is not None else ''}: "
                  "max|err| (worst entry / its limit) " + ", ".join(
                      f"{n} {err[n]:.3e} ({ratio[n]:.3f})" for n in err)
                  + f", bit-equal twice {same}"
                  + (f", dlhs zero on the dead rows "
                     f"{check['dead_rows_dlhs_zero']}"
                     if live is not None else ""), flush=True)
            if not (max(ratio.values()) <= 1.0 and same
                    and check.get("dead_rows_dlhs_zero", True)):
                raise AssertionError(f"grouped_matmul_bwd disagrees: {check}")
        lhs, rhs, dout = _gmm_bwd_case(8, 17, 128, 256, dtype, 3390)
        want = ref.grouped_matmul_bwd(lhs, rhs, dout)
        only_l = gmm.grouped_matmul_bwd(lhs, rhs, dout, need_rhs=False)
        only_r = gmm.grouped_matmul_bwd(lhs, rhs, dout, need_lhs=False)
        if only_l[1] is not None or only_r[0] is not None or not (
                _entry_ratio(name, only_l[0], want[0]).max() <= 1
                and _entry_ratio(name, only_r[1], want[1]).max() <= 1):
            raise AssertionError("grouped_matmul_bwd: one-sided call wrong")
    return checks


def check_grouped_matmul_bwd_faults(gmm, ref):
    """The check must reject a gradient kernel that leaves one group's
    drhs unwritten (zeros where the kernel did not store) or drops the
    last 64-row M-slice from both contractions: at olmoe's training gate
    shape (bf16), against the plain version of the intact inputs.  Raises
    unless more than half of the affected entries (the last group's drhs;
    every drhs entry and the slice's dlhs rows) are flagged and none
    elsewhere."""
    import torch
    G, M, K, N = 64, _olmoe_train_capacity(), 2048, 1024
    lhs, rhs, dout = _gmm_bwd_case(G, M, K, N, torch.bfloat16, 3400)
    want = ref.grouped_matmul_bwd(lhs, rhs, dout)
    dlhs, drhs = gmm.grouped_matmul_bwd(lhs, rhs, dout)
    unwritten = drhs.clone()
    unwritten[-1] = 0
    cut_l, cut_d = lhs.clone(), dout.clone()
    cut_l[:, -64:] = 0
    cut_d[:, -64:] = 0
    sliced = gmm.grouped_matmul_bwd(cut_l, rhs, cut_d)
    faults = {}
    for fault, got, affected in (
            ("one group's drhs unwritten", (dlhs, unwritten),
             (None, (slice(G - 1, G),))),
            ("last 64-row M-slice dropped", sliced,
             ((slice(None), slice(M - 64, None)), (slice(None),)))):
        flagged = [_entry_ratio("bfloat16", a, w) > 1
                   for a, w in zip(got, want)]
        hit = torch.cat([f[idx].flatten() for f, idx in zip(flagged, affected)
                         if idx is not None])
        outside = 0
        for f, idx in zip(flagged, affected):
            rest = f.clone()
            if idx is not None:
                rest[idx] = False
            outside += int(rest.sum().item())
        faults[fault] = {"flagged_share_of_affected":
                         hit.float().mean().item(),
                         "flagged_outside": outside}
        if not (faults[fault]["flagged_share_of_affected"] > 0.5
                and outside == 0):
            raise AssertionError(f"grouped_matmul_bwd check vs {fault}: "
                                 f"{faults[fault]}")
    print(f"[check] grouped_matmul_bwd planted faults G={G} M={M} K={K} "
          f"N={N} bf16: share of the affected entries beyond their limit: "
          + ", ".join(f"{n} {f['flagged_share_of_affected']:.4f} "
                      f"({f['flagged_outside']} flagged elsewhere)"
                      for n, f in faults.items()), flush=True)
    return faults


def time_grouped_matmul_bwd(gmm, ref, G, M, K, N):
    """Gradient kernel, plain and library times at one olmoe training
    shape (bf16), two input sets in turn (each ~0.8 GB, beyond the 50 MB
    L2).  The library yardstick, never called by the port: the two
    ``torch.bmm`` calls dout rhs^T and lhs^T dout."""
    import torch
    cases = [_gmm_bwd_case(G, M, K, N, torch.bfloat16, 3500 + i)
             for i in range(2)]
    kernel = [functools.partial(gmm.grouped_matmul_bwd, *c) for c in cases]
    plain = [functools.partial(ref.grouped_matmul_bwd, *c) for c in cases]

    def two_bmm(lhs, rhs, dout):
        return (torch.bmm(dout, rhs.transpose(1, 2)),
                torch.bmm(lhs.transpose(1, 2), dout))

    library = [functools.partial(two_bmm, *c) for c in cases]
    esz = 2
    nbytes = 2 * esz * (G * M * K + G * K * N) + esz * G * M * N
    ops = 4.0 * G * M * K * N
    bound_ms, bound_by = _bound(nbytes, ops, BF16_OPS_PER_S)
    return {"shape": f"G={G} M={M} K={K} N={N} bf16", "ms":
            _time_graph_ms(kernel, min_calls=8),
            "host_ms": _time_eager_ms(kernel, 4),
            "plain_ms": _time_eager_ms(plain, 1),
            "library_ms": _time_graph_ms(library, min_calls=8),
            "library": "torch.bmm(dout, rhs^T) and torch.bmm(lhs^T, dout) "
                       "(CUDA graph, as the kernel)",
            "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops,
            "bytes": nbytes}


#: the ssd_bwd cases: (model, H, P, N, G, Bb, S, chunk, h0, D, dstate,
#: dt_shift): the training shapes (no h0, no final-state gradient) at
#: mamba2's and zamba2's heads, chunks no power of two (37) and 1, G = 2
#: with h0 and the final state's gradient, the contract's edges, and the
#: training shapes at the heads of one of two model ranks
SSD_BWD_CASES = (
    [(m, *SSD_HEADS[m], 1, 2, 2048, 128, False, True, False, 0.0)
     for m in SSD_HEADS]
    + [(m, *SSD_HEADS[m], 1, 1, 256, 128, True, True, True, -3.0)
       for m in SSD_HEADS]
    + [("mamba2", *SSD_HEADS["mamba2"], 2, 1, 256, 128, True, True, True,
        -3.0),
       ("mamba2", *SSD_HEADS["mamba2"], 1, 2, 4 * 37, 37, True, False, True,
        -3.0),
       ("zamba2", *SSD_HEADS["zamba2"], 1, 1, 131, 1, True, True, True,
        -3.0),
       ("edges", 8, 48, 96, 2, 1, 256, 128, True, True, True, -3.0),
       ("edges", 4, 16, 32, 1, 2, 96, 48, False, False, True, -3.0)]
    + [(m, *SSD_RANK_HEADS[m], 1, 2, 2048, 128, False, True, False, 0.0)
       for m in SSD_RANK_HEADS])
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")


def _ssd_bwd_case(H, P, N, G, Bb, S, dtype, seed, use_h0, use_D, use_dstate,
                  shift):
    import torch
    x, dt, A, B, C, D, h0 = _ssd_case(Bb, S, H, P, G, N, dtype, seed, shift)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dy = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
    dstate = torch.randn(h0.shape, generator=g, device="cuda")
    return (x, dt, A, B, C, D if use_D else None, h0 if use_h0 else None, dy,
            dstate if use_dstate else None)


def _ssd_bwd_f32_ratio(got, want):
    """|got - want| over SSD_BWD_F32_RTOL |want| + SSD_BWD_F32_ATOL
    max|want|, entry by entry: the rule of ssd_bwd's float32 sums."""
    want = want.float()
    limit = SSD_BWD_F32_RTOL * want.abs() + SSD_BWD_F32_ATOL * \
        want.abs().max()
    return (got.float() - want).abs() / limit.clamp(min=1e-30)


def _ssd_bwd_ratios(name, got, want):
    """Each gradient's worst entry over its limit: the ones in x's dtype
    (dx, ddt, dB, dC) by that dtype's ``_entry_ratio`` rule, the float32
    sums (dA, dD, dh0) by ``_ssd_bwd_f32_ratio``."""
    return {n: (_entry_ratio(name, a, w) if n in ("dx", "ddt", "dB", "dC")
                else _ssd_bwd_f32_ratio(a, w)).max().item()
            for n, a, w in zip(SSD_BWD_NAMES, got, want) if w is not None}


def check_ssd_bwd(tssd, ref, cases=SSD_BWD_CASES):
    """The gradient kernels against ``ref.ssd_chunked_bwd`` on the same
    card inputs, entry by entry, every gradient: ``cases``
    (SSD_BWD_CASES), bf16 and f32; each case twice, bit for bit."""
    import torch
    checks = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for (model, H, P, N, G, Bb, S, Q, use_h0, use_D, use_ds,
             shift) in cases:
            args = _ssd_bwd_case(H, P, N, G, Bb, S, dtype,
                                 5400 + len(checks), use_h0, use_D, use_ds,
                                 shift)
            got = tssd.ssd_bwd(*args, chunk=Q)
            again = tssd.ssd_bwd(*args, chunk=Q)
            want = ref.ssd_chunked_bwd(*args, chunk=Q)
            torch.cuda.synchronize()
            if not all(torch.isfinite(t).all() for t in got if t is not None):
                raise AssertionError("ssd_bwd: non-finite output")
            ratio = _ssd_bwd_ratios(name, got, want)
            err = {n: (a.float() - w.float()).abs().max().item()
                   for n, a, w in zip(SSD_BWD_NAMES, got, want)
                   if w is not None}
            same = all(torch.equal(a, b) for a, b in zip(got, again)
                       if a is not None)
            # the f32 sums (dA, dD, dh0), kernel and plain, each against
            # the plain version in float64 of the same inputs, over the
            # largest exact entry
            exact = ref.ssd_chunked_bwd(
                *(t.double() if t is not None and t.is_floating_point()
                  else t for t in args), chunk=Q)
            f64 = {n: [((t.double() - e).abs().max() / e.abs().max()).item()
                       for t in (a, w)]
                   for n, a, w, e in zip(SSD_BWD_NAMES, got, want, exact)
                   if n in ("dA", "dD", "dh0") and w is not None}
            checks.append({"dtype": name, "model": model, "H": H, "P": P,
                           "N": N, "G": G, "Bb": Bb, "S": S, "chunk": Q,
                           "h0": use_h0, "D": use_D, "dstate": use_ds,
                           "dt_shift": shift, "max_abs_err": err,
                           "worst_over_limit": ratio,
                           "f32_sums_vs_float64": f64,
                           "bit_equal_twice": same})
            print(f"[check] ssd_bwd {name} {model} H={H} P={P} N={N} G={G} "
                  f"Bb={Bb} S={S} chunk={Q} h0={use_h0} D={use_D} "
                  f"dstate={use_ds} dt_shift={shift}: max|err| (worst entry "
                  "/ its limit) " + ", ".join(
                      f"{n} {err[n]:.3e} ({ratio[n]:.3f})" for n in ratio)
                  + f", bit-equal twice {same}; f32 sums vs float64 "
                  "(kernel, plain) over max|exact| " + ", ".join(
                      f"{n} {k:.2e}/{p:.2e}" for n, (k, p) in f64.items()),
                  flush=True)
    bad = [c for c in checks if not (max(c["worst_over_limit"].values())
                                      <= 1.0 and c["bit_equal_twice"])]
    if bad:
        raise AssertionError(f"ssd_bwd disagrees: {bad}")
    return checks


def check_ssd_bwd_faults(tssd, ref):
    """The check must reject a gradient kernel that does not carry the
    state's gradient between chunks, or does not sum dB over a group's
    heads: at mamba2's heads, Bb = 1, S = 256 (two chunks), bf16, against
    the plain version of the real inputs: (a) the kernel run on the two
    128-row halves, the second from the first's final state (so its own
    gradients are right) and the first given no gradient of its final
    state; (b) dB of the kernel run with B repeated for every head (G =
    H), taking each group's first head.  Raises unless more than a tenth
    of the affected entries (the first half's rows of dx, ddt, dB and dC,
    and dA; every dB entry) are flagged, and none of the first fault's
    unaffected rows (the second half)."""
    import torch
    H, P, N = SSD_HEADS["mamba2"]
    x, dt, A, B, C, D, h0, dy, ds = _ssd_bwd_case(
        H, P, N, 1, 1, 256, torch.bfloat16, 5500, True, True, True, -3.0)
    want = ref.ssd_chunked_bwd(x, dt, A, B, C, D, h0, dy, ds, chunk=128)
    half = (slice(None), slice(None, 128))
    rest = (slice(None), slice(128, None))
    _, mid = tssd.ssd(x[half].contiguous(), dt[half].contiguous(), A,
                      B[half].contiguous(), C[half].contiguous(), D, h0,
                      chunk=128)
    first = tssd.ssd_bwd(*(t[half].contiguous() for t in (x, dt)), A,
                         *(t[half].contiguous() for t in (B, C)), D, h0,
                         dy[half].contiguous(), None, chunk=128)
    second = tssd.ssd_bwd(*(t[rest].contiguous() for t in (x, dt)), A,
                          *(t[rest].contiguous() for t in (B, C)), D, mid,
                          dy[rest].contiguous(), ds, chunk=128)
    faults = {}
    flagged = {n: _entry_ratio("bfloat16", torch.cat([first[i], second[i]],
                                                     dim=1), want[i]) > 1
               for n, i in (("dx", 0), ("ddt", 1), ("dB", 3), ("dC", 4))}
    flagged["dA"] = _ssd_bwd_f32_ratio(first[2] + second[2], want[2]) > 1
    hit = torch.cat([flagged[n][half].flatten() for n in ("dx", "ddt", "dB",
                                                          "dC")]
                    + [flagged["dA"]])
    faults["state gradient not carried between chunks"] = {
        "flagged_share_of_affected": hit.float().mean().item(),
        "flagged_outside": int(sum(flagged[n][rest].sum().item()
                                   for n in ("dx", "ddt", "dB", "dC")))}
    rep = torch.repeat_interleave
    per_head = tssd.ssd_bwd(x, dt, A, rep(B, H, 2), rep(C, H, 2), D, h0, dy,
                            ds, chunk=128)
    fl = _entry_ratio("bfloat16", per_head[3][:, :, ::H].contiguous(),
                      want[3]) > 1
    faults["dB not summed over the group's heads"] = {
        "flagged_share_of_affected": fl.float().mean().item(),
        "flagged_outside": 0}
    for fault, f in faults.items():
        if not (f["flagged_share_of_affected"] > 0.1
                and f["flagged_outside"] == 0):
            raise AssertionError(f"ssd_bwd check vs a kernel with {fault}: "
                                 f"{f}")
    print("[check] ssd_bwd planted faults mamba2 heads S=256 bf16, against "
          "the plain version from the real inputs: share of the affected "
          "entries beyond their limit: " + ", ".join(
              f"{n} {f['flagged_share_of_affected']:.4f} "
              f"({f['flagged_outside']} flagged elsewhere)"
              for n, f in faults.items()), flush=True)
    return faults


def check_ssd_bwd_shortcut(ref):
    """The per-entry rules must reject the shortcut a bf16 tensor-core
    gradient invites: its f32 operands (x o wd and exp(a_cs) dy, h_prev
    and dh_next, S o L and dS) rounded to bf16 once
    (``ref.ssd_bwd_tc_emulated(parts=1)``), at mamba2's and zamba2's
    heads, Bb 1, S = 256, chunk 128, with h0, D and the final state's
    gradient, bf16, on the card, against the plain version on the same
    inputs (``_ssd_bwd_ratios``).  The kernels' split, hi = bf16(v) and lo
    = bf16(v - hi) (``parts=2``), is shown beside it, within the rules.
    Raises if the rules pass the shortcut or reject the split."""
    import torch
    res = {}
    for model, (H, P, N) in SSD_HEADS.items():
        args = _ssd_bwd_case(H, P, N, 1, 1, 256, torch.bfloat16, 5700, True,
                             True, True, -3.0)
        want = ref.ssd_chunked_bwd(*args, chunk=128)
        for parts in (1, 2):
            got = ref.ssd_bwd_tc_emulated(*args, chunk=128, parts=parts)
            res[f"{model}_parts{parts}"] = _ssd_bwd_ratios("bfloat16", got,
                                                           want)
    print("[check] ssd_bwd bf16 shortcut S=256 chunk=128 h0 D dstate (plain "
          "version, worst entry / its limit): the f32 operands rounded to "
          "bf16 once: " + "; ".join(
              f"{m} " + ", ".join(f"{n} {v:.3f}" for n, v in
                                  res[f"{m}_parts1"].items())
              for m in SSD_HEADS)
          + "; split hi + lo: " + "; ".join(
              f"{m} " + ", ".join(f"{n} {v:.3f}" for n, v in
                                  res[f"{m}_parts2"].items())
              for m in SSD_HEADS), flush=True)
    if any(max(v.values()) <= 1 for k, v in res.items()
           if k.endswith("parts1")):
        raise AssertionError(f"the ssd_bwd rules pass bf16 operands: {res}")
    if any(max(v.values()) > 1 for k, v in res.items()
           if k.endswith("parts2")):
        raise AssertionError(f"the ssd_bwd rules reject the split: {res}")
    return res


def _ssd_train_case(model, seed):
    """mamba2's or zamba2's heads at the training shape (TRAIN_B x
    TRAIN_S, chunk 128, bf16, D, no h0), at the models' dt scale."""
    import torch
    H, P, N = {**SSD_HEADS, **SSD_RANK_HEADS}[model]
    return _ssd_bwd_case(H, P, N, 1, TRAIN_B, TRAIN_S, torch.bfloat16, seed,
                         False, True, False, 0.0)


def _ssd_ops(Bb, S, H, P, G, N, Q):
    """The forward's operations: per chunk, C B^T once per group over the
    j <= i triangle; per head M x over the triangle, C state^T and the
    state update over all rows."""
    tri = Q * (Q + 1) / 2
    return Bb * (S // Q) * (G * 2 * tri * N
                            + H * (2 * tri * P + 4 * Q * N * P))


def time_ssd_train(tssd, ref, model):
    """The forward kernel and the gradient kernels at the training shape
    (bf16): kernel, plain and bound; no single PyTorch call computes
    either, so the library column is none.  Two input sets in turn (the
    split by pass is ``time_ssd_bwd_passes``, after the serving arms).
    ``model`` names SSD_HEADS' or SSD_RANK_HEADS' heads."""
    H, P, N = {**SSD_HEADS, **SSD_RANK_HEADS}[model]
    G, Q, Bb, S = 1, 128, TRAIN_B, TRAIN_S
    cases = [_ssd_train_case(model, 5600 + i) for i in range(2)]
    fwd = [functools.partial(tssd.ssd, *c[:7], chunk=Q) for c in cases]
    bwd = [functools.partial(tssd.ssd_bwd, *c, chunk=Q) for c in cases]
    esz = 2
    # the forward reads x, dt, B, C, A and D and writes y; the backward
    # reads x, dy, dt, B, C, A and D and writes dx, ddt, dB, dC, dA and dD:
    # the same bytes less one (Bb, S, H, P) plane
    io = esz * (2 * Bb * S * H * P + Bb * S * H + 2 * Bb * S * G * N) \
        + 4 * 2 * H
    tri = Q * (Q + 1) / 2
    # the backward: the states entering the chunks again (2 Q P N a head
    # and chunk) and the reverse scan of their gradient (2 Q P N); S o L
    # per group; dxdt (the triangle and 2 Q P N), dS (the triangle), dC
    # and dB (the triangle and 2 Q P N each)
    bwd_ops = Bb * (S // Q) * (G * 2 * tri * N + H * (
        10 * Q * P * N + 4 * tri * (P + N)))
    out = {}
    for name, calls, plain, nbytes, ops in (
            ("fwd", fwd, [functools.partial(ref.ssd_chunked, *c[:7], chunk=Q)
                          for c in cases],
             io + 4 * Bb * H * P * N, _ssd_ops(Bb, S, H, P, G, N, Q)),
            ("bwd", bwd, [functools.partial(ref.ssd_chunked_bwd, *c, chunk=Q)
                          for c in cases],
             2 * io - esz * Bb * S * H * P, bwd_ops)):
        bound_ms, bound_by = _bound(nbytes, ops, BF16_OPS_PER_S)
        out[name] = {
            "shape": f"Bb={Bb} S={S} H={H} P={P} G={G} N={N} chunk={Q} "
                     "bf16, D, no h0",
            "ms": _time_graph_ms(calls, min_calls=8),
            "host_ms": _time_eager_ms(calls, 4),
            "plain_ms": _time_eager_ms(plain, 1), "library_ms": None,
            "library": "none: no single PyTorch call computes SSD or its "
                       "gradient",
            "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops,
            "bytes": nbytes}
    return out


def time_ssd_bwd_passes(tssd, times):
    """The ``[time] ssd_bwd`` line by pass at each model's training shape,
    on ``time_ssd_train``'s inputs: torch.profiler's device ms a call of
    each pass (``SSD_BWD_PASSES``, ``_profile_window`` over four rounds of
    the calls, the CUDA activity alone), kept as ``pass_ms`` in the
    gradient's ``times`` entry (the whole call's [time] line is CUDA
    events over a graph).  Run after the serving arms, as every profile:
    launches slow down once the profiler has run."""
    import torch
    rounds = 4

    def run(calls):
        for _ in range(rounds):
            for c in calls:
                c()
        torch.cuda.synchronize()

    for model in SSD_HEADS:
        cases = [_ssd_train_case(model, 5600 + i) for i in range(2)]
        calls = [functools.partial(tssd.ssd_bwd, *c, chunk=128)
                 for c in cases]
        t = times[f"ssd_bwd train {model}"]
        run(calls)
        t["pass_ms"] = _profile_window(
            f"ssd_bwd-{model}", "ssd_bwd calls", rounds * len(calls),
            functools.partial(run, calls), groups=SSD_BWD_PASSES,
            cpu=False)["profile_group_ms_per_step"]
        if t["pass_ms"] is None:
            print(f"[time] ssd_bwd train {model} by pass: not measured (the "
                  "profiler saw no device time)", flush=True)
            continue
        print(f"[time] ssd_bwd train {model} by pass {t['shape']}: state "
              f"pass {t['pass_ms']['state']:.4f} ms (each chunk's state "
              f"products and the scans), chunk pass "
              f"{t['pass_ms']['chunk']:.4f} ms (profiler device ms a call; "
              f"the call {t['ms']:.4f} ms)", flush=True)


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
            "ssd": mamba * sum(size >= 2 for plan in plans for size in plan),
            "grouped_matmul_bwd": 0, "ssd_bwd": 0}


def _check_launches(arm, launches, want):
    """The arm's kernels launched exactly ``want`` times (each > 0), the
    other arm's kernels not at all."""
    ran = [k for k, n in want.items() if n]
    if launches != want or not ran \
            or min(launches[k] for k in ran) <= 0:
        raise AssertionError(f"{arm} arm: kernel launches {launches}, "
                             f"expected {want}")


def _percentile(xs, q):
    """The nearest-rank percentile ``benchmarks/serving_throughput.py``
    reads from ``completion_s``."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, round(q * (len(xs) - 1))))]


def _completion(engine, done):
    """p50 and p99 of the finished requests' ``completion_s``: each
    request's wall seconds from its stream's start to the end of the
    chunk (or token step) that finished it."""
    missing = [r.uid for r in done if r.uid not in engine.completion_s]
    if missing:
        raise AssertionError(f"completion_s lacks uids {missing}")
    lat = [engine.completion_s[r.uid] for r in done]
    return {"completion_p50_s": _percentile(lat, 0.50),
            "completion_p99_s": _percentile(lat, 0.99)}


def _arm_stats(engine, clock, done, wall, specs, joules=None):
    """The arm's numbers; ``prefill_chunks`` counts the chunk programs the
    engine reported to its phase hook (a shared prefix skips its own);
    ``joules`` is the arm's energy (None where not measured)."""
    import torch
    n_tok = sum(len(r.generated) for r in done)
    return {"requests": len(done), "wall_s": wall, "tok_per_s": n_tok / wall,
            **_completion(engine, done),
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
    """Seeded random weights of ``cfg`` made on the card (seed 0) in their
    compute dtypes: each f32 master leaf cast by ``lm.prepare_leaf`` as
    soon as it is drawn (the engine's ``prepare_params`` rule), so a model
    whose f32 masters and bf16 copy would not fit together (nemotron-4-15b:
    62.5 + 31.3 GB) holds one f32 leaf at a time."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import init_params
    params = init_params(lm.model_decls(cfg),
                         torch.Generator(device="cuda").manual_seed(0),
                         "cuda", functools.partial(lm.prepare_leaf,
                                                   Ctx(run, "cuda")))
    torch.cuda.empty_cache()
    return params


def serve_full_width(tfa, arch=ARCH, tag="", n_layers=None):
    """Phase 3a (llama), the first arm of 3d (``arch=MOE_ARCH``, arms
    named ``olmoe-*``), 3i (minitron-4b, nemotron-4-15b) and 3k
    (qwen2-vl-72b at ``n_layers`` of its 80): the dense arm.  Returns its
    launches and stats, and what the later arms reuse: (cfg, run, card
    params, request specs, streams)."""
    import torch
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.models import lm
    from repro_torch.models.params import param_count
    from repro_torch.serving.engine import Request

    cfg = get_model_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
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
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB held)",
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


AB_PAIRS, AB_CHUNKS = 5, 2      # [serve:graph-ab]: pairs, chunks a turn


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


PREFILL_AB_PAIRS = 3      # [serve:prefill-ab]: alternating pairs


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
# phase 3h: the engine's benchmark interface and the fleet layer
# ---------------------------------------------------------------------------

class _PhaseCount:
    """A ``power=`` hook that only counts phase entries (no sync)."""

    def __init__(self):
        self.entries = collections.Counter()

    @contextlib.contextmanager
    def phase(self, name, calls=None):
        self.entries[name] += 1
        yield None


def _shares_weights(engine, params):
    """Whether the engine holds the very tensors it was given (the port's
    ``prepare_params`` casts nothing that is already on the card in its
    compute dtype), and the bytes a copy would have cost."""
    from repro_torch.tree import leaves
    mine, given = leaves(engine.params), leaves(params)
    same = len(mine) == len(given) and all(
        a.data_ptr() == b.data_ptr() for a, b in zip(mine, given))
    return same, sum(a.numel() * a.element_size() for a in given)


def serve_static(tfa, cfg, run, params, specs, dense_streams, dense_stats):
    """[serve:static]: ``StaticServeEngine`` (the reference's throughput
    baseline: equal-length buckets at batch 8, each prompt prefilled whole
    as one chunk, one host sync a token step, eager) on the dense arm's 16
    requests, beside the graphed continuous engine's dense arm: tok/s, p50
    and p99 of ``completion_s``, J per generated token.  Every request
    must get its tokens, ``completion_s`` must hold every uid, and the two
    dense kernels must launch exactly 28 times per prefill batch and per
    decode step (the paged ones not).  Equal streams are counted, not
    gated: a whole-prompt prefill at batch 8 sums in another order than
    256-row chunks at batch 1."""
    import torch
    from repro_torch.models.layers import Ctx
    from repro_torch.serving.engine import Request
    from repro_torch.serving.legacy import StaticServeEngine
    counts = _PhaseCount()
    engine = StaticServeEngine(cfg, run, Ctx(run, "cuda"), params,
                               batch_size=8, max_seq=2048, power=counts)
    shared, _ = _shares_weights(engine, params)
    engine.generate([Request(uid=-1, max_new_tokens=4, prompt=np.random
                             .default_rng(6).integers(0, cfg.vocab, 64)
                             .tolist())])    # first-call costs, not counted
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n, _) in enumerate(specs)]
    counts.entries.clear()
    engine.sync_count = 0
    torch.cuda.synchronize()
    tfa.reset_launch_counts()
    e0 = METER.energy_mj() if METER is not None else None
    t0 = time.perf_counter()
    done = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    joules = (METER.energy_mj() - e0) / 1e3 if METER is not None else None
    launches = {fn.__name__: fn.launches for fn in tfa.KERNELS}
    _check_counters(tfa)
    if sorted(r.uid for r in done) != list(range(len(specs))):
        raise AssertionError("[serve:static] not every request finished")
    for r in done:
        if len(r.generated) != r.max_new_tokens \
                or not all(0 <= t < cfg.vocab for t in r.generated):
            raise AssertionError(f"[serve:static] request {r.uid}: "
                                 f"{len(r.generated)} tokens, wanted "
                                 f"{r.max_new_tokens} in the vocab")
    n = cfg.n_layers * (counts.entries["prefill"] + counts.entries["decode"])
    _check_launches("static", launches, {
        "flash_decode": n, "flash_decode_paged": 0, "cache_update": n,
        "cache_update_paged": 0, "flash_attention": 0,
        "flash_attention_bwd": 0, "grouped_matmul": 0, "ssd": 0,
        "grouped_matmul_bwd": 0, "ssd_bwd": 0})
    if joules is not None:
        _check_draw("static", joules, wall)
    n_tok = sum(len(r.generated) for r in done)
    st = {"requests": len(done), "wall_s": wall, "tok_per_s": n_tok / wall,
          "new_tokens": n_tok, "energy_j": joules,
          "j_per_token": joules / n_tok if joules is not None else None,
          **_completion(engine, done),
          "prefill_batches": counts.entries["prefill"],
          "decode_steps": counts.entries["decode"],
          "host_syncs": engine.sync_count, "weights_shared": shared,
          "streams_equal_dense": sum(r.generated == dense_streams[r.uid]
                                     for r in done),
          "launches": launches,
          "max_memory_allocated_gib":
              torch.cuda.max_memory_allocated() / 2**30}
    c = dense_stats

    def arm(name, s):
        j = (f", {s['j_per_token']:.4f} J per generated token"
             if s["j_per_token"] is not None else "")
        return (f"{name} {s['tok_per_s']:.1f} tok/s, completion p50 "
                f"{s['completion_p50_s']:.3f} s / p99 "
                f"{s['completion_p99_s']:.3f} s{j}")

    print(f"[serve:static] {st['requests']} requests, {n_tok} new tokens in "
          f"{wall:.2f}s: " + arm("static", st) + "; " + arm("graphed "
          "continuous (the dense arm)", c) + f"; static: "
          f"{st['prefill_batches']} whole-prompt prefill batches of 8, "
          f"{st['decode_steps']} decode steps, {st['host_syncs']} host "
          f"syncs; weights shared with the arms: {shared}; "
          f"{st['streams_equal_dense']}/16 streams equal the dense arm's "
          f"(not gated); launches {launches}", flush=True)
    del engine
    torch.cuda.empty_cache()
    return st


#: [fleet:engine]: an open-loop fleet of one paged and one dense engine on
#: the modelled H100 (sensitivity steering, the diurnal trace at seed 0,
#: admission and the autoscaler of ``benchmarks/traffic_slo.py``'s engine
#: arm), its budget dipping below both nodes' floors for the second
#: quarter of FLEET_DURATION_S: the dip suspends both jobs (lossless
#: drains of their in-flight streams, restored when it lifts), and the
#: autoscaler's shrinks park in-flight streams that the scheduler hands
#: to the other engine.  The quantum is
#: a quarter second, so streams are in flight when the fleet decides.
#: Arrivals are clamped to prompts of FLEET_PROMPT_CAP and outputs of
#: FLEET_OUTPUT_CAP against max_seq 2048.  The ``ServeJob``s' modelled
#: shape (batch 8, prompt 256, 64 new tokens, chunks of 8) paces the
#: virtual clock, as the engine arm's does; the engines do the real work.
FLEET_ENGINES = (dict(paged=True, block_size=16), {})
FLEET_DURATION_S = 10.0
FLEET_QUANTUM_S = 0.25
FLEET_RPS = 6.0
FLEET_BUDGET_FRACS = (0.9, 0.17, 0.9, 0.9)
FLEET_PROMPT_CAP, FLEET_OUTPUT_CAP = 1024, 256
FLEET_VALUE = 2.0          # benchmarks/traffic_slo.py's SERVE_VALUE
FLEET_WAKE_S = 2.0


def fleet_scenario(fleet, workload, cfg, engines, spec, seed=0):
    """The [fleet:engine] scenario through the packages ``fleet`` and
    ``workload`` (the port's here; ``tests/test_torch_fleet.py`` runs it
    on the CPU with reduced engines): one open-loop ``ServeJob`` per
    engine, ``cfg`` the full-width config that paces the virtual clock.
    Returns the run's pieces and its counters."""
    cluster = fleet.SimulatedCluster(
        n_nodes=len(engines), cabinet_size=len(engines),
        policy="sensitivity", spec=spec, quantum_s=FLEET_QUANTUM_S,
        idle_w=spec.p_floor, wake_latency_s=FLEET_WAKE_S)
    tracker = workload.SLOTracker(sink=cluster.telemetry)
    trace = [dataclasses.replace(
                 e, prompt_len=min(e.prompt_len, FLEET_PROMPT_CAP),
                 output_len=min(max(e.output_len, 1), FLEET_OUTPUT_CAP))
             for e in workload.diurnal_trace(
                 seed=seed, until_s=FLEET_DURATION_S, base_rps=FLEET_RPS)]
    feed = workload.WorkloadDriver(
        trace, tracker, admission=workload.AdmissionController(),
        autoscaler=workload.Autoscaler(min_slots=1, shrink_frac=0.5,
                                       park_after_s=4.0, park_rest_s=2.0,
                                       min_running=1, wake_threshold=4))
    jobs = [fleet.ServeJob(f"eng-{i}", cfg, batch=8, prompt=256,
                           new_tokens=64, total_requests=0, decode_chunk=8,
                           open_loop=True, partial=True, migrate=True,
                           value=FLEET_VALUE, slo=tracker, engine=engine)
            for i, engine in enumerate(engines)]
    leg = FLEET_DURATION_S / len(FLEET_BUDGET_FRACS)
    p_max = len(engines) * spec.p_max
    budget = [(i * leg, f * p_max) for i, f in enumerate(FLEET_BUDGET_FRACS)]
    counters = cluster.run(jobs=jobs, budget=budget,
                           until_s=FLEET_DURATION_S, workload=feed)
    return {"cluster": cluster, "jobs": jobs, "tracker": tracker,
            "feed": feed, "trace": trace, "budget": budget,
            "counters": counters}


def fleet_accounting(run):
    """Every arrival counted exactly once: completed, rejected, queued
    (in the feed's backlog or in a job, in flight or parked) or not
    delivered yet; every uid held by one job; every completed request
    with exactly its tokens.  Returns the counts and, per job, its
    completed requests (the job whose engine finished them)."""
    summary = run["tracker"].summary()
    jobs, feed, trace = run["jobs"], run["feed"], run["trace"]
    completed = sum(s["completed"] for s in summary.values())
    rejected = sum(s["rejected"] for s in summary.values())
    offered = sum(s["offered"] for s in summary.values())
    uids = [r.uid for j in jobs for r in (j.requests or [])]
    finished = {j.name: [r for r in (j.requests or []) if r.done]
                for j in jobs}
    outstanding = sum(1 for j in jobs for r in (j.requests or [])
                      if not r.done)
    queued = len(feed.backlog) + outstanding
    undelivered = len(trace) - feed.offered
    n_done = sum(len(v) for v in finished.values())
    if len(uids) != len(set(uids)):
        raise AssertionError("a request is held by two jobs")
    if offered != feed.offered \
            or completed + rejected + queued + undelivered != len(trace) \
            or completed != n_done:
        raise AssertionError(
            f"arrivals {len(trace)}: {completed} completed ({n_done} done "
            f"in the jobs), {rejected} rejected, {queued} queued, "
            f"{undelivered} not delivered; {offered} offered, "
            f"{feed.offered} by the feed")
    for r in (r for v in finished.values() for r in v):
        if len(r.generated) != r.max_new_tokens:
            raise AssertionError(f"request {r.uid}: {len(r.generated)} "
                                 f"tokens, wanted {r.max_new_tokens}")
    return {"arrivals": len(trace), "completed": completed,
            "rejected": rejected, "queued_at_end": queued,
            "undelivered": undelivered, "finished": finished}


def fleet_replay(run):
    """Each completed request served again alone by the engine that
    finished it (a fresh stream of that job's completed requests, in
    uid order, with their prompts): the streams it gives, by uid."""
    from repro_torch.serving.engine import Request
    out = {}
    for job in run["jobs"]:
        reqs = [Request(uid=r.uid, prompt=list(r.prompt),
                        max_new_tokens=r.max_new_tokens)
                for r in sorted(job.requests or [], key=lambda r: r.uid)
                if r.done]
        if reqs:
            out.update({r.uid: list(r.generated)
                        for r in job.engine.generate(reqs)})
    return out


def fleet_engine(tfa, cfg, run, params):
    """[fleet:engine]: ``fleet_scenario`` on the card over graphed,
    full-width llama3.2-3b engines (batch 8, max_seq 2048, prefill chunk
    256, decode chunk 8; one paged, one dense) that share the arms'
    weights, with the counts set to 0 just before the fleet runs and read
    just after.  Gates: every arrival counted once, in-flight tokens kept
    by the dip's drains, at least one stream moved from one engine to the
    other with its tokens, every completed stream equal to its request
    served alone by the engine that finished it, and the four attention
    and cache kernels launched.  The card's
    joules are measured on its energy counter; the fleet's own joules are
    its model of the H100 spec on the virtual clock, printed as such."""
    import torch
    from repro_torch import fleet, workload
    from repro_torch.hw.h100 import H100_SUPERCHIP
    from repro_torch.serving.engine import Request
    t_all = time.perf_counter()
    engines = [_engine(cfg, run, params, None, **kw) for kw in FLEET_ENGINES]
    shared = [_shares_weights(e, params) for e in engines]
    warm = np.random.default_rng(7).integers(0, cfg.vocab, WARM_LEN).tolist()
    for e in engines:                 # capture every graph before the run
        e.generate([Request(uid=-1, prompt=warm, max_new_tokens=8)])
    torch.cuda.synchronize()
    tfa.reset_launch_counts()
    e0 = METER.energy_mj() if METER is not None else None
    t0 = time.perf_counter()
    out = fleet_scenario(fleet, workload, cfg, engines, H100_SUPERCHIP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    joules = (METER.energy_mj() - e0) / 1e3 if METER is not None else None
    launches = {fn.__name__: fn.launches for fn in tfa.KERNELS}
    _check_counters(tfa)
    if joules is not None:
        _check_draw("fleet", joules, wall)
    acct = fleet_accounting(out)
    c = out["counters"]
    want = ("flash_decode", "cache_update", "flash_decode_paged",
            "cache_update_paged")
    if not all(launches[k] > 0 for k in want) or any(
            launches[k] for k in launches if k not in want):
        raise AssertionError(f"[fleet:engine] launches {launches}")
    if c["adoptions"] < 1 or c["adopted_tokens"] <= 0 \
            or c["migrated_tokens"] <= 0:
        raise AssertionError(f"[fleet:engine] {c['adoptions']} adoptions "
                             f"moving {c['adopted_tokens']} tokens between "
                             f"the engines, {c['migrated_tokens']} tokens "
                             f"kept by drains")
    graphs_before = [(e.graph, dict(e.prefill_graphs)) for e in engines]
    alone = fleet_replay(out)
    if [(e.graph, dict(e.prefill_graphs)) for e in engines] \
            != graphs_before:
        raise AssertionError("[fleet:engine] the replay captured a graph")
    done = [r for v in acct["finished"].values() for r in v]
    equal = sum(alone[r.uid] == r.generated for r in done)
    gen = c["tokens"]
    modelled_j = c["energy_j"] + c["idle_energy_j"]
    slo = out["tracker"].summary()
    st = {"engines": ["paged" if e.paged else "dense" for e in engines],
          "weights_shared": all(s for s, _ in shared),
          "weight_bytes": shared[0][1],
          "wall_s": wall, "virtual_s": c["virtual_s"],
          "generated_tokens": gen, "wall_tok_per_s": gen / wall,
          "energy_j": joules,
          "j_per_token": joules / gen if joules is not None else None,
          "modelled_energy_j": modelled_j,
          "modelled_j_per_token": modelled_j / gen,
          "launches": launches, "streams_equal_alone": equal,
          "slo": slo, "counters": c,
          **{k: v for k, v in acct.items() if k != "finished"}}
    print(f"[fleet:engine] {len(engines)} graphed llama3.2-3b engines "
          f"({', '.join(st['engines'])}; weights shared, not copied: "
          f"{st['weights_shared']}, {st['weight_bytes'] / 1e9:.2f} GB) "
          f"under SimulatedCluster(spec=H100_SUPERCHIP, policy="
          f"sensitivity, quantum {FLEET_QUANTUM_S} s), budget "
          + " -> ".join(f"{w:.0f} W" for _, w in out["budget"])
          + f" over {FLEET_DURATION_S:.0f} s virtual: "
          f"{acct['arrivals']} arrivals, {acct['completed']} completed, "
          f"{acct['rejected']} rejected, {acct['queued_at_end']} queued "
          f"and {acct['undelivered']} undelivered at the end; {gen} "
          f"generated tokens in {wall:.2f} s wall ({gen / wall:.1f} tok/s "
          f"wall)", flush=True)
    print(f"[fleet:engine] {c['preemptions']} preemptions "
          f"({c['migrated_tokens']} tokens kept by drains, "
          f"{c['dropped_tokens']} dropped), {c['migrations']} cross-node "
          f"transfers, {c['partial_drains']} partial drains "
          f"({c['shed_slots']} slots), {c['adoptions']} adoptions: "
          f"{c['adopted_slots']} streams with {c['adopted_tokens']} tokens "
          f"moved between the engines "
          f"({c['adoption_bytes'] / 1e6:.1f} MB); {c['sleeps']} sleeps / "
          f"{c['wakes']} wakes, queue peak {c['queue_depth_peak']}",
          flush=True)
    for name, s in sorted(slo.items()):
        print(f"[fleet:engine] slo {name}: attainment "
              f"{s['attainment']:.3f} ({s['met']}/{s['completed']} met, "
              f"{s['rejected']} rejected), p50 {s['p50_latency_s']:.2f} s / "
              f"p99 {s['p99_latency_s']:.2f} s virtual", flush=True)
    measured = (f"measured {joules:.1f} J on the card's counter "
                f"({joules / gen:.4f} J per generated token)"
                if joules is not None else "card joules not measured")
    print(f"[fleet:engine] launches {launches}; {measured}; the fleet's "
          f"modelled joules (H100 spec, virtual clock, not measured) "
          f"{modelled_j:.1f} J ({modelled_j / gen:.4f} J per token); "
          f"{equal}/{len(done)} completed streams equal their request "
          f"served alone by the engine that finished it; phase "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)
    if equal != len(done):
        raise AssertionError(f"[fleet:engine] {equal}/{len(done)} streams "
                             f"equal their replay")
    st["seconds"] = time.perf_counter() - t_all
    del engines, out
    torch.cuda.empty_cache()
    return st


# ---------------------------------------------------------------------------
# phase 4: logits parity at full width, reduced depth
# ---------------------------------------------------------------------------

def logits_parity(arch=ARCH, tag="parity"):
    import torch
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import (make_decode_step,
                                            make_prefill_chunk_step)
    from repro_torch.serving.scheduler import chunk_plan

    cfg = dataclasses.replace(get_model_config(arch), n_layers=2)
    run = get_run_config(arch, remat="none")
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
    print(f"[{tag}] {cfg.name} d{cfg.d_model} vocab {cfg.vocab}, 2 layers: "
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

    def tap(*args, **kwargs):
        out = real(*args, **kwargs)
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


def _train_launches(cfg, steps):
    """The exact kernel launches of ``steps`` train steps under
    remat="full": per attention layer (every layer of a decoder, zamba2's
    shared block once per invocation) two ``flash_attention`` (the forward
    and its recompute) and one ``flash_attention_bwd``; per MoE layer six
    ``grouped_matmul`` (gate, up, down, twice) and three
    ``grouped_matmul_bwd``; per Mamba layer two ``ssd`` and one
    ``ssd_bwd``; no decode kernel."""
    from repro_torch.models.lm import zamba_structure
    attn = {"ssm": 0, "hybrid": zamba_structure(cfg)[0]}.get(
        cfg.family, cfg.n_layers)
    mamba = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    moe = cfg.n_layers if cfg.n_experts else 0
    return {"flash_decode": 0, "flash_decode_paged": 0, "cache_update": 0,
            "cache_update_paged": 0,
            "flash_attention": 2 * attn * steps,
            "flash_attention_bwd": attn * steps,
            "grouped_matmul": 6 * moe * steps, "ssd": 2 * mamba * steps,
            "grouped_matmul_bwd": 3 * moe * steps,
            "ssd_bwd": mamba * steps}


def _active_params(cfg, n_params):
    """Parameters a token's forward multiplies: all of them, but of an MoE
    layer's experts only top_k of n_experts, and not the audio encoder's
    learned position table (a row read, not a product)."""
    if cfg.family == "audio":
        return n_params - cfg.max_wavelength_pos * cfg.d_model
    if not cfg.n_experts:
        return n_params
    experts = 3 * cfg.n_layers * cfg.n_experts * cfg.d_model * cfg.d_ff
    return n_params - experts + experts * cfg.top_k / cfg.n_experts


def train_full_width(tfa, arch=ARCH, n_layers=None, tag="train",
                     remat="full", profile=True, shape=(TRAIN_B, TRAIN_S)):
    """Phase 5, the training paths: full-width ``arch`` (full depth, or
    ``n_layers``; seeded f32 masters on the card, bf16 compute, AdamW,
    remat="full", batch TRAIN_B x TRAIN_S, logits_chunk 1024, 2 warmup
    steps) through ``make_train_step``, TRAIN_STEPS steps on one repeated
    TokenSource batch: llama3.2-3b as ``[train]``, and ``[train:olmoe]``,
    ``[train:mamba2]``, ``[train:zamba2]``, ``[train:gemma2]``; with
    ``remat="dots"`` the ``[train:dots]`` arms.  Every loss and grad norm
    finite, the last loss below the first, and exactly
    ``_train_launches`` per step (the same under "dots": the kernels'
    autograd Functions run again in the backward pass).  ``profile``:
    one more step under the profiler.  ``shape``: the batch, (B, S); the
    audio encoder (``[train:hubert]``) takes seeded frames
    (``FrameSource``) and labels over its vocab."""
    import torch
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import param_count
    from repro_torch.train.step import init_state, make_train_step

    B, S = shape
    cfg = get_model_config(arch)
    depth = ""
    if n_layers is not None:
        full = param_count(lm.model_decls(cfg))
        cut = dataclasses.replace(cfg, n_layers=n_layers)
        n_cut = param_count(lm.model_decls(cut))
        per = (full - n_cut) / (cfg.n_layers - n_layers)
        depth = (f"; depth cut to {n_layers} of {cfg.n_layers} layers: f32 "
                 f"master, grad and two AdamW moments are 16 B a param, "
                 f"{full / 1e9:.3f} B params at full depth need "
                 f"{16 * full / 1e9:.1f} GB (the card has 80), each layer "
                 f"{per / 1e9:.3f} B ({16 * per / 1e9:.1f} GB), the rest "
                 f"{(n_cut - n_layers * per) / 1e9:.3f} B, so {n_layers} "
                 f"layers hold {16 * n_cut / 1e9:.1f} GB of state")
        cfg = cut
    run = get_run_config(arch, remat=remat, logits_chunk=1024,
                         warmup_steps=2, total_steps=TRAIN_STEPS)
    _release_card()
    t0 = time.perf_counter()
    state = init_state(cfg, run, torch.Generator(device="cuda").manual_seed(0),
                       "cuda").tree()
    torch.cuda.synchronize()
    n_params = param_count(lm.model_decls(cfg))
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
          f"params; f32 masters + AdamW state ready in "
          f"{time.perf_counter() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated{depth}",
          flush=True)
    data = (FrameSource(B, S, cfg.frontend_dim, cfg.vocab)
            if cfg.family == "audio"
            else TokenSource(DataConfig(vocab=cfg.vocab, global_batch=B,
                                        seq_len=S)))
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
        _check_draw(f"[{tag}] step {i}", joules[-1], secs[-1])
        print(f"[{tag}] step {i} loss={losses[-1]:.4f} "
              f"grad_norm={gnorms[-1]:.4f} {secs[-1]:.3f}s "
              f"E={joules[-1]:.1f}J", flush=True)
    launches = {fn.__name__: fn.launches for fn in tfa.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    want = _train_launches(cfg, TRAIN_STEPS)
    step_s = float(np.median(secs[1:]))
    tokens = B * S
    attn_layers = want["flash_attention_bwd"] // TRAIN_STEPS
    attn_fwd_ops = 4.0 * cfg.head_dim * B * cfg.n_heads \
        * (S * (S + 1) / 2 if cfg.causal else S * S)
    # 6 N per token (forward 2, backward 4) over the params a token reads
    # plus the attention's forward and its 2.5x backward, per attention
    # layer; the remat recompute and the SSD scan are not counted
    model_ops = (6.0 * _active_params(cfg, n_params) * tokens
                 + 3.5 * attn_fwd_ops * attn_layers)
    stats = {"arch": cfg.name, "n_layers": cfg.n_layers, "remat": remat,
             "params": n_params, "steps": TRAIN_STEPS, "batch": B, "seq": S,
             "losses": losses, "grad_norms": gnorms, "step_s": secs,
             "median_step_s_after_first": step_s,
             "tokens_per_s": tokens / step_s,
             "peak_allocated_gb": peak / 1e9, "launches": launches,
             "model_ops_per_step": model_ops,
             "bf16_peak_share": model_ops / (step_s * BF16_OPS_PER_S),
             "step_j": joules,
             "median_step_j_after_first": float(np.median(joules[1:])),
             "j_per_step": sum(joules) / TRAIN_STEPS}
    print(f"[{tag}] {cfg.name} {cfg.n_layers} layers, {TRAIN_STEPS} steps "
          f"of {B} x {S} tokens: "
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
        raise AssertionError(f"[{tag}] non-finite loss or grad norm: "
                             f"{losses} {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[{tag}] loss did not fall: {losses}")
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches}, expected {want}")
    stats.update(_memorised_not_leaked(cfg, run, state["params"], batch,
                                       data, tag))

    def one_step():
        step_fn(state, batch)
        torch.cuda.synchronize()

    # one more step after the counted ones (and after the serving
    # profiles: the profiler slows later launches)
    if profile:
        stats["profile"] = _profile_window(
            tag.replace("train:", "train-"), "one train step", 1, one_step,
            top_n=12, groups=TRAIN_PROFILE_GROUPS)
    del state, batch
    _release_card()
    return launches, stats


def _memorised_not_leaked(cfg, run, params, batch, data, tag):
    """After an arm's steps on its one repeated batch of uniform random
    tokens, a loss below ln(vocab) can only be that batch learnt by
    heart, unless the forward lets a position see a later token.  So,
    without grad, on the trained weights: the cross-entropy on a fresh
    batch (``data.batch(1)``) must not fall below ln(vocab) - 1 (a leak
    would carry over to any batch); and, for a model without an MoE
    router (whose capacity cut couples tokens), the tokens after position
    CAUSAL_T are replaced, and the final hidden states at positions <=
    CAUSAL_T (in the middle of a 128-row SSD chunk) must stay bit-equal
    while those after it change.  The audio encoder is bidirectional: its
    frames are random and its labels uniform, and only the first check
    applies."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.train.step import make_loss_fn
    ctx = Ctx(run, "cuda")
    loss_fn = make_loss_fn(cfg, run, ctx)
    fresh = {k: torch.from_numpy(v).cuda() for k, v in data.batch(1).items()}
    t = CAUSAL_T
    with torch.no_grad():
        seen_ce = float(loss_fn(params, batch)[1]["ce"])
        fresh_ce = float(loss_fn(params, fresh)[1]["ce"])
        out = {"seen_ce": seen_ce, "fresh_ce": fresh_ce,
               "ln_vocab": math.log(cfg.vocab)}
        line = (f"[{tag}] after the steps: cross-entropy {seen_ce:.4f} on "
                f"the trained batch, {fresh_ce:.4f} on a fresh one (ln "
                f"vocab {out['ln_vocab']:.4f})")
        if not cfg.n_experts and cfg.causal:
            alt = batch["tokens"].clone()
            alt[:, t + 1:] = fresh["tokens"][:, t + 1:]
            h = lm.forward(ctx, cfg, params, {"tokens": batch["tokens"]})[0]
            h_alt = lm.forward(ctx, cfg, params, {"tokens": alt})[0]
            diff = (h.float() - h_alt.float()).abs()
            out["causal"] = {"t": t,
                             "upto_t_max_abs_diff": diff[:, :t + 1].max()
                             .item(),
                             "after_t_max_abs_diff": diff[:, t + 1:].max()
                             .item()}
            line += (f"; tokens after position {t} replaced: final hidden "
                     f"states max|diff| {out['causal']['upto_t_max_abs_diff']}"
                     f" at positions <= {t}, "
                     f"{out['causal']['after_t_max_abs_diff']:.4g} after")
            del h, h_alt, diff
    print(line, flush=True)
    if not fresh_ce >= out["ln_vocab"] - 1:
        raise AssertionError(f"[{tag}] cross-entropy {fresh_ce} on a fresh "
                             f"batch of uniform random tokens, below ln "
                             f"vocab - 1: a position sees later tokens")
    if "causal" in out and not (out["causal"]["upto_t_max_abs_diff"] == 0
                                and out["causal"]["after_t_max_abs_diff"]
                                > 0):
        raise AssertionError(f"[{tag}] not causal: {out['causal']}")
    return out


def train_parity(tfa, arch=ARCH, tag="train:parity", reduce=False):
    """Phase 6: one train step of ``arch`` at full width and 2 layers (or
    its reduced config with ``reduce``) in f32 from the same seeded
    weights and batch (``_train_batch``: hubert's frames; qwen2-vl's
    vision rows and grid positions), on the card (kernels) and on the CPU
    (plain versions): loss, grad norm and the parameter update agree, and
    the card launched exactly ``_train_launches`` (llama as
    ``[train:parity]``, then olmoe, mamba2, gemma2, hubert and reduced
    qwen2-vl)."""
    import torch
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.models.layers import Ctx
    from repro_torch.train.step import init_state, make_train_step
    from repro_torch.tree import leaves, tree_map

    cfg = (reduced(get_model_config(arch)) if reduce
           else dataclasses.replace(get_model_config(arch), n_layers=2))
    run = get_run_config(arch, remat="full", compute_dtype="float32",
                         logits_chunk=256, warmup_steps=0, total_steps=1)
    cpu = init_state(cfg, run, torch.Generator().manual_seed(2), "cpu").tree()
    p0 = [p.clone() for p in leaves(cpu["params"])]
    card = {"params": tree_map(lambda t: t.cuda(), cpu["params"]),
            "opt_state": tree_map(lambda t: t.cuda(), cpu["opt_state"]),
            "step": cpu["step"].clone()}
    host = _train_batch(cfg, 1, 256, 3)
    tfa.reset_launch_counts()
    card, m_card = make_train_step(cfg, run, Ctx(run, "cuda"))(
        card, {k: torch.from_numpy(v).cuda() for k, v in host.items()})
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in tfa.KERNELS}
    want = _train_launches(cfg, 1)
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
    ran = {k: n for k, n in launches.items() if n}
    print(f"[{tag}] {cfg.name} d{cfg.d_model} vocab {cfg.vocab}, "
          f"{cfg.n_layers} layers, f32, one AdamW step on 1 x 256 "
          f"{'frames' if cfg.family == 'audio' else 'tokens'}"
          + (f" ({cfg.vision_tokens} of them vision rows at grid positions)"
             if cfg.family == "vlm" else "") + ": card (kernels, "
          f"launches {ran}) vs CPU (plain): loss "
          f"{float(m_card['loss']):.6f} vs {float(m_cpu['loss']):.6f}, "
          f"grad_norm {float(m_card['grad_norm']):.6f} vs "
          f"{float(m_cpu['grad_norm']):.6f}; relative errors "
          + ", ".join(f"{k} {v:.2e} (tol {TRAIN_PARITY_TOL[k]})"
                      for k, v in err.items()), flush=True)
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches}, expected {want}")
    bad = [k for k, v in err.items() if not v <= TRAIN_PARITY_TOL[k]]
    if bad:
        raise AssertionError(f"[{tag}] disagrees on {bad}: {err}")
    del card
    _release_card()
    return err


# ---------------------------------------------------------------------------
# gemma2-2b: the attention kernels at head_dim 256 (phase 2), its serving
# arms (phase 3j) and training (phase 5), and remat="dots" ([train:dots])
# ---------------------------------------------------------------------------

GEMMA2_ARCH = "gemma2-2b"
#: gemma2-2b's attention: H, K, D, the logit softcap and the local window
G2_HEADS = (8, 4, 256)
G2_CAP, G2_WINDOW = 50.0, 4096
#: the serving arms' cache rows: past the window, so local and global
#: layers compute different things (at 2048 they would not)
G2_MAX_SEQ = 8192
#: the two long prompts' rows are drawn from [4500, 6000]
G2_LONG = (4500, 6000)
#: the decode checks' ragged kv_len over 8192 rows: past the window, a
#: full slot and a done lane (S + 1)
G2_DECODE_LENS = [5000, 4097, 300, 8192, 6000, 2048, 4500, 8193]
G2_CHUNK_LENS = [5000, 300, 8193]
#: the head_dim 256 kernels' key tiles (the .cu notes): the bf16 chunk
#: kernel's 64 rows, the bf16 decode-step kernel's 128; the forward's 64,
#: the dK/dV pass's 64-row query step and the dQ pass's 128-row query tile
G2_TILE = {"chunk": 64, "step": 128, "fwd": 64, "kv_step": 64,
           "dq_tile": 128}
#: [train:dots]: olmoe's depth under "dots" (as [train:olmoe]'s)
DOTS_OLMOE_LAYERS = 8


def _pools_of(k, v, bs, seed):
    """The dense caches (B, S, K, D) scattered into pools of 16-row blocks
    through a seeded permutation: (k pool, v pool, table)."""
    import torch
    B, S = k.shape[:2]
    mb = S // bs
    perm = np.random.default_rng(seed).permutation(B * mb)
    table = torch.tensor(perm.reshape(B, mb), dtype=torch.int32,
                         device="cuda")
    idx = table.reshape(-1).long()
    kp = torch.empty((B * mb, bs) + tuple(k.shape[2:]), dtype=k.dtype,
                     device="cuda")
    vp = torch.empty_like(kp)
    kp[idx] = k.reshape(B * mb, bs, *k.shape[2:])
    vp[idx] = v.reshape(B * mb, bs, *v.shape[2:])
    return kp, vp, table


def _cols_dropped(got, want, name):
    """Share of entries of columns 128..255 beyond their limit when a
    kernel leaves them at zero (the second half of the head dim dropped),
    and how many entries of columns 0..127 are (none should be)."""
    cut = got.clone()
    cut[..., 128:] = 0
    flagged = _entry_ratio(name, cut, want) > 1
    return {"flagged_share_cols_128_255": flagged[..., 128:].float().mean()
            .item(),
            "flagged_cols_0_127": int(flagged[..., :128].sum().item())}


def check_gemma2_decode(tfa, ref):
    """``flash_decode`` and ``flash_decode_paged`` at gemma2's heads (H = 8,
    K = 4, D = 256, softcap 50) over 8192 rows: a decode step (B = 8, Sq =
    1) and a 256-row chunk (B = 3), ragged kv_len past the window with a
    done lane, the local layers' window of 4096 and the global layers'
    none, bf16 and f32, entry by entry (``_entry_ratio``, and max|err|
    within DECODE_TOL); the paged kernel over 16-row blocks scattered
    through a pool equal to the dense one bit for bit.  Then the planted
    faults, bf16 with the window: one key tile of the head_dim 256 tile
    size dropped (K and V rows of one slot zeroed on the kernel's side:
    64 rows in a chunk, 128 in a decode step; more than half of the
    affected entries must be flagged and none other) and the output's
    columns 128..255 dropped (more than half of them flagged, none of
    columns 0..127); the paged check must reject both (bit-equality with
    the intact dense output)."""
    import torch
    H, K, D = G2_HEADS
    S = G2_MAX_SEQ
    checks, faults = [], []
    cases = [(1, G2_DECODE_LENS), (256, G2_CHUNK_LENS)]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for Sq, lens in cases:
            for window in (G2_WINDOW, None):
                B = len(lens)
                seed = 6000 + len(checks)
                q, k, v, kl = _decode_case(B, S, H, K, D, Sq, dtype, lens,
                                           seed)
                kw = dict(softcap=G2_CAP, local_window=window)
                got = tfa.flash_decode(q, k, v, kl, **kw)
                want = ref.decode_attention_ref(q, k, v, kl, **kw)
                kp, vp, table = _pools_of(k, v, 16, seed)
                paged = tfa.flash_decode_paged(q, kp, vp, kl, table, **kw)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    raise AssertionError("flash_decode D=256: non-finite")
                err = (got.float() - want.float()).abs().max().item()
                ratio = _entry_ratio(name, got, want).max().item()
                same = torch.equal(paged, got)
                checks.append({"dtype": name, "B": B, "S": S, "H": H,
                               "K": K, "D": D, "Sq": Sq, "softcap": G2_CAP,
                               "window": window, "kv_len": lens,
                               "max_abs_err": err, "tol": DECODE_TOL[name],
                               "worst_over_limit": ratio,
                               "paged_equals_dense": same})
                print(f"[check] flash_decode(_paged) {name} B={B} S={S} "
                      f"H={H} K={K} D={D} Sq={Sq} softcap={G2_CAP} "
                      f"window={window}: max|err| {err:.3e} (tol "
                      f"{DECODE_TOL[name]}), worst entry / its limit "
                      f"{ratio:.3f}, paged == dense {same}", flush=True)
                if not (err <= DECODE_TOL[name] and ratio <= 1.0 and same):
                    raise AssertionError(f"flash_decode at head_dim 256 "
                                         f"disagrees: {checks[-1]}")
                if dtype != torch.bfloat16 or window is None:
                    continue
                # the planted faults: slot 0 (kv_len 5000) loses one key
                # tile its rows see, or the output loses columns 128..255
                n = G2_TILE["chunk" if Sq > 1 else "step"]
                lo = 4992 - n
                k_cut, v_cut = k.clone(), v.clone()
                k_cut[0, lo:lo + n] = 0
                v_cut[0, lo:lo + n] = 0
                cut = tfa.flash_decode(q, k_cut, v_cut, kl, **kw)
                kp_cut, vp_cut, _ = _pools_of(k_cut, v_cut, 16, seed)
                paged_cut = tfa.flash_decode_paged(q, kp_cut, vp_cut, kl,
                                                   table, **kw)
                flagged = _entry_ratio(name, cut, want) > 1
                qpos = kl.long()[:, None] - Sq + torch.arange(Sq,
                                                              device="cuda")
                affected = torch.zeros_like(qpos, dtype=torch.bool)
                affected[0] = qpos[0] >= lo
                affected = affected[:, :, None, None].expand_as(flagged)
                res = {"Sq": Sq, "tile_rows": [lo, lo + n],
                       "tile_flagged_share_of_affected":
                           flagged[affected].float().mean().item(),
                       "tile_flagged_outside":
                           int((flagged & ~affected).sum().item()),
                       **_cols_dropped(got, want, name),
                       "paged_rejects_tile": not torch.equal(paged_cut, got)}
                paged_cols = paged.clone()
                paged_cols[..., 128:] = 0
                res["paged_rejects_cols"] = not torch.equal(paged_cols, got)
                faults.append(res)
                print(f"[check] flash_decode(_paged) D=256 planted faults "
                      f"Sq={Sq}: {res}", flush=True)
                if not (res["tile_flagged_share_of_affected"] > 0.5
                        and res["tile_flagged_outside"] == 0
                        and res["flagged_share_cols_128_255"] > 0.5
                        and res["flagged_cols_0_127"] == 0
                        and res["paged_rejects_tile"]
                        and res["paged_rejects_cols"]):
                    raise AssertionError(f"the head_dim 256 decode checks "
                                         f"pass a planted fault: {res}")
                del k_cut, v_cut, kp_cut, vp_cut
            del q, k, v, kp, vp
    return checks, faults


def check_gemma2_cache_faults(tfa, ref):
    """The bit-for-bit cache_update(_paged) checks at gemma2's heads
    (``check_rope_cache_update``, ``ROPE_HEADS["gemma2"]``) must reject a
    kernel that leaves one 64-row block of a 256-row chunk unwritten and
    one that leaves columns 128..255 of every written row unwritten (the
    cache keeps its old rows there)."""
    import torch
    H, K, D = G2_HEADS
    B, S, Sn = 8, 2048, 256
    res = {}
    for paged in (False, True):
        name = "cache_update_paged" if paged else "cache_update"
        kc, vc, index, table, _ = _rope_cache(paged, B, S, K, D,
                                              torch.bfloat16, Sn, 6500)
        q, kn, vn, c, s = _rope_case(B, Sn, H, K, D, torch.bfloat16, 1.0,
                                     index, 6500)
        idx = torch.tensor(index, dtype=torch.int32, device="cuda")
        got, want = _rope_both(tfa, ref, paged, kc, vc, idx, table, q, kn,
                               vn, c, s, 1.0)
        # slot 2 writes rows 700..955: its rows 764..827 left as they were
        # (dense), or its every written row's columns 128.. (both layouts:
        # the kernel's k cache against the old cache where it kept it)
        k_tile, k_cols = got[0].clone(), got[0].clone()
        if paged:
            rows = [(int(table[2, (700 + j) // 16]), (700 + j) % 16)
                    for j in range(Sn)]
            for j, (blk, off) in enumerate(rows):
                if 64 <= j < 128:
                    k_tile[blk, off] = kc[blk, off]
                k_cols[blk, off, :, 128:] = kc[blk, off, :, 128:]
        else:
            k_tile[2, 764:828] = kc[2, 764:828]
            k_cols[2, 700:956, :, 128:] = kc[2, 700:956, :, 128:]
        res[name] = {"rejects_tile": not torch.equal(k_tile, want[0]),
                     "rejects_cols": not torch.equal(k_cols, want[0])}
        del kc, vc, got, want
    print(f"[check] cache_update(_paged) D=256 planted faults (bf16, 256-row "
          f"chunk, rot_dim 256): {res}", flush=True)
    if not all(all(r.values()) for r in res.values()):
        raise AssertionError(f"the head_dim 256 cache checks pass a planted "
                             f"fault: {res}")
    return res


def check_gemma2_attention(tfa, ref):
    """``flash_attention`` (out, lse) and ``flash_attention_bwd`` (dq, dk,
    dv) at gemma2's heads and training shape (B = 2, S = 2048, H = 8, K =
    4, D = 256), causal with softcap 50, without a window and with one of
    1024 (acting at 2048 rows), bf16 and f32, entry by entry against
    ``attention_naive`` and ``attention_bwd_ref`` (the backward on the
    plain forward's out and lse).  Then the planted faults, bf16 causal:
    one tile of the head_dim 256 tile sizes dropped (the last 64 rows of
    v for the forward, the last 64-row query step of dout for dk/dv, the
    last 128-row query tile of dout for dq; each must flag entries) and
    each output's columns 128..255 dropped (more than half flagged, none
    of columns 0..127)."""
    import torch
    (B, S), (H, K, D) = (TRAIN_B, TRAIN_S), G2_HEADS
    checks = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for window in (None, 1024):
            q, k, v, do = _attention_case(B, S, S, H, K, D, dtype,
                                          6600 + len(checks))
            kw = dict(causal=True, local_window=window, softcap=G2_CAP)
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
                    raise AssertionError("flash_attention D=256: non-finite")
            err = {"lse": (lse - want_lse).abs().max().item()}
            ratio = {"lse": err["lse"] / LSE_TOL}
            for n, got, w in (("out", out, want_out),
                              *zip(("dq", "dk", "dv"), grads, want)):
                err[n] = (got.float() - w.float()).abs().max().item()
                ratio[n] = _entry_ratio(name, got, w).max().item()
            checks.append({"dtype": name, "B": B, "Sq": S, "Sk": S, "H": H,
                           "K": K, "D": D, "causal": True, "window": window,
                           "softcap": G2_CAP, "max_abs_err": err,
                           "worst_over_limit": ratio})
            print(f"[check] flash_attention(_bwd) {name} B={B} S={S} H={H} "
                  f"K={K} D={D} causal window={window} softcap={G2_CAP}: "
                  "max|err| (worst entry / its limit) "
                  + ", ".join(f"{n} {err[n]:.3e} ({ratio[n]:.3f})"
                              for n in err), flush=True)
            bad = [n for n in ratio if not ratio[n] <= 1.0]
            if bad:
                raise AssertionError(f"flash_attention at head_dim 256 "
                                     f"disagrees on {bad}: {ratio}")
            if dtype == torch.bfloat16 and window is None:
                kept = (q, k, v, do, want_out, want_lse, want, out, grads)
            del q, k, v, do, out, lse, grads, want, want_out, want_lse
    q, k, v, do, want_out, want_lse, want, out, grads = kept
    kw = dict(causal=True, softcap=G2_CAP)
    v_cut, do_step, do_tile = v.clone(), do.clone(), do.clone()
    v_cut[:, -G2_TILE["fwd"]:] = 0
    do_step[:, -G2_TILE["kv_step"]:] = 0
    do_tile[:, -G2_TILE["dq_tile"]:] = 0
    cut_out, _ = tfa.flash_attention(q, k, v_cut, **kw)
    _, cut_dk, cut_dv = tfa.flash_attention_bwd(q, k, v, want_out, want_lse,
                                                do_step, **kw)
    cut_dq, _, _ = tfa.flash_attention_bwd(q, k, v, want_out, want_lse,
                                           do_tile, **kw)
    faults = {}
    for n, cut, got, w in (("out", cut_out, out, want_out),
                           ("dq", cut_dq, grads[0], want[0]),
                           ("dk", cut_dk, grads[1], want[1]),
                           ("dv", cut_dv, grads[2], want[2])):
        ratio = _entry_ratio("bfloat16", cut, w)
        faults[n] = {"tile_flagged_share": (ratio > 1).float().mean().item(),
                     **_cols_dropped(got, w, "bfloat16")}
    print(f"[check] flash_attention(_bwd) D=256 planted faults B={B} S={S} "
          f"H={H} K={K} D={D} causal softcap {G2_CAP} bf16 (out: last "
          f"{G2_TILE['fwd']} rows of v zeroed; dk/dv: last "
          f"{G2_TILE['kv_step']}-row query step of dout zeroed; dq: last "
          f"{G2_TILE['dq_tile']}-row query tile of dout zeroed; and each "
          f"output's columns 128..255 zeroed): {faults}", flush=True)
    bad = [n for n, f in faults.items()
           if not (f["tile_flagged_share"] > 0
                   and f["flagged_share_cols_128_255"] > 0.5
                   and f["flagged_cols_0_127"] == 0)]
    if bad:
        raise AssertionError(f"the head_dim 256 attention checks pass a "
                             f"planted fault on {bad}: {faults}")
    return checks, faults


def _visible_rows(kv_len, Sq, S, window):
    """Per slot, the kv rows [lo, hi) its Sq query rows see, and the
    visible (query row, key) pairs of one query head."""
    spans, pairs = [], 0
    for n in kv_len:
        hi = min(int(n), S)
        first = int(n) - Sq
        lo = max(0, first - window + 1) if window else 0
        spans.append((lo, hi))
        for t in range(Sq):
            pos = first + t
            top = min(pos + 1, S)
            bot = max(0, pos - window + 1) if window else 0
            pairs += max(0, top - bot)
    return spans, pairs


def time_gemma2_decode(tfa, ref, paged, B, Sq, kv_len):
    """The decode kernel (dense or paged over 16-row blocks) at gemma2's
    heads over 8192 rows, bf16, softcap 50, window 4096, beside its plain
    version and its bound (the K/V rows its rows see, read once).  SDPA
    has no softcap, so there is no library call of this function; SDPA's
    time without the softcap (a length-and-window mask over the whole
    dense cache) is kept beside as ``sdpa_no_softcap_ms``."""
    import torch
    import torch.nn.functional as F
    (H, K, D), S, esz = G2_HEADS, G2_MAX_SEQ, 2
    kw = dict(softcap=G2_CAP, local_window=G2_WINDOW)
    spans, pairs1 = _visible_rows(kv_len, Sq, S, G2_WINDOW)
    kv_bytes = sum(hi - lo for lo, hi in spans) * K * D * 2 * esz
    n_copies = 2
    cases = [_decode_case(B, S, H, K, D, Sq, torch.bfloat16, kv_len, 6800 + i)
             for i in range(n_copies)]
    if paged:
        pools = [_pools_of(k, v, 16, 6800 + i)
                 for i, (_, k, v, _) in enumerate(cases)]
        kernel = [functools.partial(tfa.flash_decode_paged, c[0], kp, vp,
                                    c[3], tab, **kw)
                  for c, (kp, vp, tab) in zip(cases, pools)]
        plain = [functools.partial(ref.decode_attention_paged_ref, c[0], kp,
                                   vp, c[3], tab, **kw)
                 for c, (kp, vp, tab) in zip(cases, pools)]
    else:
        kernel = [functools.partial(tfa.flash_decode, *c, **kw)
                  for c in cases]
        plain = [functools.partial(ref.decode_attention_ref, *c, **kw)
                 for c in cases]
    k_pos = torch.arange(S, device="cuda")
    q_pos = (torch.tensor(kv_len, device="cuda")[:, None] - Sq
             + torch.arange(Sq, device="cuda")[None])
    mask = ((k_pos[None, None] <= q_pos[:, :, None])
            & (k_pos[None, None] > q_pos[:, :, None] - G2_WINDOW))[:, None]
    lib_cases = [(q.transpose(1, 2).contiguous(),
                  k.transpose(1, 2).contiguous(),
                  v.transpose(1, 2).contiguous()) for q, k, v, _ in cases]
    library = [functools.partial(F.scaled_dot_product_attention, *c,
                                 attn_mask=mask, enable_gqa=True,
                                 scale=256 ** -0.5) for c in lib_cases]
    ms = _time_graph_ms(kernel)
    host_ms = _time_eager_ms(kernel, 10)
    plain_ms = _time_eager_ms(plain, 2)
    sdpa_ms = _time_graph_ms(library)
    nbytes = kv_bytes + 2 * B * Sq * H * D * esz + 4 * B
    if paged:
        nbytes += 4 * sum(-(-(hi - lo) // 16) for lo, hi in spans)
    bound_ms, bound_by = _bound(nbytes, 4.0 * D * pairs1 * H, BF16_OPS_PER_S)
    rows = [min(int(n), S) for n in kv_len]
    return {"shape": f"B={B} Sq={Sq} S={S} H={H} K={K} D={D} bf16 softcap "
                     f"{G2_CAP} window {G2_WINDOW}, kv_len {min(rows)}.."
                     f"{max(rows)}" + (", 16-row blocks" if paged else ""),
            "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "library_ms": None, "sdpa_no_softcap_ms": sdpa_ms,
            "library": "none: F.scaled_dot_product_attention has no "
                       "softcap; sdpa_no_softcap_ms is SDPA without it "
                       "(length and window mask over the dense cache)",
            "bound_ms": bound_ms, "bound_by": bound_by}


def serve_gemma2(tfa):
    """Phase 3j: gemma2-2b at full width and depth (26 layers, bf16),
    engine batch 8, max_seq 8192, prefill chunk 256, decode chunk 8,
    graphed: the smoke's 16 requests plus two prompts of 4500..6000 rows,
    whose every decode step reads past the local layers' window of 4096;
    dense (``[serve:gemma2-dense]``) and paged (``[serve:gemma2-paged]``,
    every stream equal to the dense arm's), exact launches, ms per decode
    step and per 256 prompt rows."""
    import torch
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.models import lm
    from repro_torch.models.params import param_count
    from repro_torch.serving.engine import Request

    cfg = get_model_config(GEMMA2_ARCH)
    run = get_run_config(GEMMA2_ARCH, remat="none")
    _release_card()
    t0 = time.perf_counter()
    params = _card_weights(cfg, run)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers d{cfg.d_model} head_dim "
          f"{cfg.head_dim} vocab {cfg.vocab}, "
          f"{param_count(lm.model_decls(cfg)) / 1e9:.3f} B params, weights "
          f"ready in {time.perf_counter() - t0:.1f}s; max_seq {G2_MAX_SEQ}, "
          f"local window {cfg.local_window}", flush=True)
    rng = np.random.default_rng(0)
    specs = []
    for _ in range(16):
        plen = int(rng.integers(64, 1025))
        specs.append((rng.integers(0, cfg.vocab, plen).tolist(),
                      int(rng.integers(32, 129)), 0))
    for _ in range(2):
        plen = int(rng.integers(G2_LONG[0], G2_LONG[1] + 1))
        specs.append((rng.integers(0, cfg.vocab, plen).tolist(),
                      int(rng.integers(32, 129)), 0))
    out, streams, stats_all = {}, None, {}
    for name, paged in (("gemma2-dense", False), ("gemma2-paged", True)):
        clock = PhaseClock()
        engine = _engine(cfg, run, params, clock, max_seq=G2_MAX_SEQ,
                         **(dict(paged=True, block_size=16) if paged else {}))
        warm = Request(uid=-1, max_new_tokens=8,
                       prompt=np.random.default_rng(5)
                       .integers(0, cfg.vocab, WARM_LEN).tolist())
        engine.generate([warm])               # first-call costs, not counted
        torch.cuda.reset_peak_memory_stats()
        done, wall, launches, joules = _serve(tfa, engine, clock, cfg, specs)
        st = _arm_stats(engine, clock, done, wall, specs, joules)
        _check_launches(name, launches, _serving_launches(
            cfg, st["decode_steps"], specs, paged))
        st["ms_per_decode_step"] = st["decode_s"] / st["decode_steps"] * 1e3
        st["ms_per_256_prompt_rows"] = (st["prefill_s"] * 1e3 * 256
                                        / st["prompt_tokens"])
        st["long_prompts"] = [len(p) for p, _, _ in specs[16:]]
        _print_arm(name, st, launches)
        got = {r.uid: r.generated for r in done}
        if streams is None:
            streams = got
        else:
            same = sum(got[u] == streams[u] for u in streams)
            st["streams_equal_dense"] = same
            st.update(n_blocks=engine.n_blocks,
                      peak_used_blocks=engine.peak_used_blocks)
            if same != len(specs) or engine._alloc.used_blocks:
                raise AssertionError(f"{name}: {same}/{len(specs)} streams "
                                     "equal the dense arm's, or the pool "
                                     "did not drain")
        print(f"[serve:{name}] {cfg.name}: {st['tok_per_s']:.1f} tok/s, "
              + (f"{st['j_per_token']:.4f} J per generated token, "
                 if st["j_per_token"] is not None else "")
              + f"{st['ms_per_decode_step']:.2f} ms per decode step, "
              f"{st['ms_per_256_prompt_rows']:.2f} ms per 256 prompt rows; "
              f"the long prompts {st['long_prompts']} rows (window "
              f"{cfg.local_window})"
              + (f"; {st['streams_equal_dense']}/{len(specs)} streams equal "
                 "the dense arm's" if paged else ""), flush=True)
        out[name], stats_all[name] = launches, st
        del engine
        torch.cuda.empty_cache()
    del params
    _release_card()
    return out, stats_all


def gemma2_parity():
    """[parity:gemma2]: gemma2-2b at full width and 2 layers (one local,
    one global), card bf16 (kernels) against CPU f32 (plain), as
    ``logits_parity``: the last prompt token's logits of four prompts
    (37..300 rows) and the first decode step's, within PARITY_TOL."""
    return logits_parity(GEMMA2_ARCH, "parity:gemma2")


def train_dots(tfa):
    """[train:dots]: llama3.2-3b at full width under remat="dots" in the
    same call as ``[train]``'s "full": s and J a step and peak memory as
    ratios over "full"'s, exact launches (the Functions' forwards run
    again, as under "full"), one step under the profiler as ``[train]``'s
    (device busy and idle ms a step beside "full"'s); the f32 loss and
    gradients at 2 layers on the card under
    "dots" against the same step under "full", its loss and each leaf's
    gradient within TRAIN_PARITY_TOL (``train_dots_parity``); and olmoe
    at 8 layers under "dots"."""
    _, dots = train_full_width(tfa, ARCH, tag="train:dots", remat="dots")
    dots["parity_vs_full"] = train_dots_parity(tfa)
    dots["olmoe"] = train_full_width(tfa, MOE_ARCH, DOTS_OLMOE_LAYERS,
                                     "train:dots-olmoe", remat="dots",
                                     profile=False)[1]
    return dots


def train_dots_parity(tfa):
    """llama3.2-3b at full width and 2 layers in f32 on the card, one
    seeded batch: the loss and every parameter's gradient under "dots"
    against "full".  The loss is the forward's, which no remat policy
    changes; the gradients are what a wrong "dots" backward (a stale or
    wrongly saved mm output, a recompute that differs) would move, so each
    leaf's gradient is held to ``TRAIN_PARITY_TOL["grad_norm"]`` in
    relative norm, and so is the grad norm.  A planted fault, the first
    mm output the recompute takes from the saved ones scaled by 1.01,
    must be flagged."""
    import torch
    from torch.utils._python_dispatch import (TorchDispatchMode,
                                              _disable_current_modes)
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import init_params
    from repro_torch.train.step import make_loss_fn
    from repro_torch.tree import leaves

    class StaleMm(TorchDispatchMode):
        """Scales the first saved mm output one recompute takes."""
        done = False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in lm.DOTS_SAVED and not self.done:
                self.done = True
                with _disable_current_modes():    # no op of the recompute
                    out = out * 1.01
            return out

    def planted_contexts(stale=StaleMm()):
        fwd, rec = dots_contexts()

        @contextlib.contextmanager
        def recompute():
            with rec, stale:
                yield
        return fwd, recompute()

    cfg = dataclasses.replace(get_model_config(ARCH), n_layers=2)
    host = TokenSource(DataConfig(vocab=cfg.vocab, global_batch=1,
                                  seq_len=256, seed=3)).batch(0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    dots_contexts = lm._dots_contexts
    res = {}
    for arm, remat in (("full", "full"), ("dots", "dots"),
                       ("planted", "dots")):
        run = get_run_config(ARCH, remat=remat, compute_dtype="float32",
                             logits_chunk=256)
        params = init_params(lm.model_decls(cfg),
                             torch.Generator().manual_seed(2), "cuda")
        for p in leaves(params):
            p.requires_grad_(True)
        if arm == "planted":
            lm._dots_contexts = planted_contexts
        try:
            loss, _ = make_loss_fn(cfg, run, Ctx(run, "cuda"))(params, batch)
            loss.backward()
        finally:
            lm._dots_contexts = dots_contexts
        torch.cuda.synchronize()
        grads = [p.grad.detach() for p in leaves(params)]
        res[arm] = (float(loss.detach()), math.sqrt(sum(
            float(g.double().square().sum()) for g in grads)), grads)
        del params, loss

    def err(arm):
        (l0, n0, g0), (l1, n1, g1) = res["full"], res[arm]
        return {"loss": abs(l1 - l0) / abs(l0),
                "grad_norm": abs(n1 - n0) / n0,
                "grad": max(float((b - a).double().norm())
                            / max(float(a.double().norm()), 1e-30)
                            for a, b in zip(g0, g1))}

    def bad(e):
        return [k for k, v in e.items()
                if not v <= TRAIN_PARITY_TOL["grad_norm" if k == "grad"
                                             else k]]

    e, e_planted = err("dots"), err("planted")
    out = {"loss": [res["full"][0], res["dots"][0]],
           "grad_norm": [res["full"][1], res["dots"][1]],
           "relative_errors": e, "planted_relative_errors": e_planted,
           "bit_equal": all(torch.equal(a, b) for a, b in
                            zip(res["full"][2], res["dots"][2]))
           and res["full"][:2] == res["dots"][:2]}
    print(f"[train:dots] {cfg.name} 2 layers f32, loss and gradients of 1 x "
          f"256 tokens on the card, remat full vs dots: loss {out['loss']}, "
          f"grad_norm {out['grad_norm']}, relative errors "
          + ", ".join(f"{k} {v:.2e}" for k, v in e.items())
          + f" (tol loss {TRAIN_PARITY_TOL['loss']}, grad_norm and each "
          f"leaf's grad {TRAIN_PARITY_TOL['grad_norm']}; bit for bit: "
          f"{out['bit_equal']}); planted fault (first saved mm output the "
          f"recompute takes x 1.01): "
          + ", ".join(f"{k} {v:.2e}" for k, v in e_planted.items())
          + f", flagged on {bad(e_planted)}", flush=True)
    if bad(e):
        raise AssertionError(f"[train:dots] the dots step disagrees with "
                             f"full's on {bad(e)}: {e}")
    if not bad(e_planted):
        raise AssertionError(f"[train:dots] a stale saved mm output was not "
                             f"flagged: {e_planted}")
    del res
    _release_card()
    return out


# ---------------------------------------------------------------------------
# hubert-xlarge and qwen2-vl-72b: the cache-free attention at head_dim 80
# and the decode kernels at a GQA group of 8 (phase 2), qwen2-vl's serving
# arm and vision prefill (phase 3k), hubert's encode (3l), their parity
# (phase 4) and training (phases 5 and 6)
# ---------------------------------------------------------------------------

HUBERT_ARCH, QWEN2VL_ARCH = "hubert-xlarge", "qwen2-vl-72b"
#: hubert-xlarge's attention: H, K, D (bidirectional)
HUBERT_HEADS = (16, 16, 80)
#: [encode:hubert]'s batch of frames of 512, and [train:hubert]'s: 4 x
#: 1024 frames, the other training arms' 4096 a step
HUBERT_ENCODE, HUBERT_TRAIN = (8, 1024), (4, 1024)
#: hubert's attention checks, as FA_CHECK_CASES: its training shape, an
#: odd pair of lengths (1000 queries over 300 keys), one causal case and a
#: small one
HUBERT_FA_CASES = [((4, 16, 16, 80), 1024, 1024, False, None, None),
                   ((2, 16, 16, 80), 1000, 300, False, None, None),
                   ((2, 16, 16, 80), 1024, 1024, True, None, None),
                   ((1, 2, 2, 80), 130, 77, False, None, None)]
#: the columns a D = 80 kernel would misread if it took its 160-byte rows
#: as whole 128-byte swizzle boxes: the planted fault zeroes them
D80_FAULT_COLS = slice(64, 80)
#: [encode:hubert]: encodes repeat over at least this many seconds of the
#: energy counter
ENCODE_WINDOW_S = 2.0
#: the layers of qwen2-vl-72b the card serves, of its 80: 20.04 B params,
#: 40.1 GB in bf16 (the full depth's 145 GB waits for ROADMAP queue 1 item
#: 14)
QWEN2VL_LAYERS = 20
#: [prefill:qwen2vl-vision]: a VISION_GRID x VISION_GRID grid of seeded
#: patch embeddings at positions (0, i, j), then text at VISION_GRID + k in
#: all three sections: VISION_S rows at batch 1, timed VISION_RUNS times
VISION_GRID, VISION_S, VISION_RUNS = 32, 2048, 5
#: M-RoPE must act: the vision prefill's logits with 1-D positions
#: broadcast to the three sections differ from the grid's by more than this
MROPE_ACTS = 1e-3


class FrameSource:
    """``batch(step)`` -> seeded audio frames (B, S, F) float32 and labels
    (B, S) int32 uniform over the vocab: the audio encoder's counterpart
    of ``TokenSource`` (its frontend is a stub, as in the reference)."""

    def __init__(self, B, S, F, vocab, seed=0):
        self.shape, self.vocab, self.seed = (B, S, F), vocab, seed

    def batch(self, step):
        B, S, F = self.shape
        rng = np.random.default_rng([self.seed, step])
        return {"frames": rng.standard_normal((B, S, F), dtype=np.float32),
                "labels": rng.integers(0, self.vocab, (B, S),
                                       dtype=np.int32)}


def grid_positions(batch, n_vision, grid_w, seq):
    """(3, batch, seq) int32 M-RoPE positions: ``n_vision`` patch rows of
    a grid ``grid_w`` wide at (t 0, h r // grid_w, w r % grid_w), then
    text at the grid's largest position + 1 + k in all three sections."""
    pos = np.zeros((3, seq), np.int32)
    r = np.arange(n_vision)
    pos[1, :n_vision], pos[2, :n_vision] = r // grid_w, r % grid_w
    start = int(pos[:, :n_vision].max()) + 1 if n_vision else 0
    pos[:, n_vision:] = start + np.arange(seq - n_vision)
    return np.broadcast_to(pos[:, None], (3, batch, seq)).copy()


def _train_batch(cfg, B, S, seed):
    """One seeded host batch of ``cfg``'s family: frames and labels for
    the audio encoder; else ``TokenSource``'s tokens and labels, and for a
    vlm also ``vision_embeds`` (its ``vision_tokens`` rows, at most S / 2)
    at grid positions."""
    from repro_torch.data.pipeline import DataConfig, TokenSource
    if cfg.family == "audio":
        return FrameSource(B, S, cfg.frontend_dim, cfg.vocab, seed).batch(0)
    out = TokenSource(DataConfig(vocab=cfg.vocab, global_batch=B,
                                 seq_len=S, seed=seed)).batch(0)
    if cfg.family == "vlm":
        nv = min(cfg.vision_tokens, S // 2)
        out["vision_embeds"] = np.random.default_rng(seed).standard_normal(
            (B, nv, cfg.d_model), dtype=np.float32)
        out["positions"] = grid_positions(B, nv, max(1, math.isqrt(nv)), S)
    return out


def _mrope_cos_sin(index, Sn):
    """qwen2-vl's M-RoPE cos/sin (its config's ``rope_cos_sin``) of rows
    index[b] + j on the vision prefill's layout (rows below VISION_GRID^2
    on the patch grid, later rows text), on the card."""
    import torch
    from repro_torch.configs.registry import get_model_config
    from repro_torch.models.layers import rope_cos_sin
    rows = np.clip(np.asarray(index), 0, None)[:, None] + np.arange(Sn)
    nv = VISION_GRID ** 2
    grid = grid_positions(1, nv, VISION_GRID,
                          max(int(rows.max()) + 1, nv + 1))[:, 0]
    pos = torch.from_numpy(np.ascontiguousarray(grid[:, rows])).cuda()
    return rope_cos_sin(get_model_config(QWEN2VL_ARCH), pos)


def check_d80_faults(tfa, ref):
    """The D = 80 checks must flag what the hazard of 160-byte rows would
    do: the kernels' out, dq, dk and dv with columns 64-79 zeroed (a
    second swizzle box read from the wrong place), at hubert's training
    shape in bf16, against the plain versions of the intact inputs.
    Raises if a check passes one; reports the share of entries flagged,
    over the tensor and over those columns, and none flagged elsewhere."""
    import torch
    (B, S), (H, K, D) = HUBERT_TRAIN, HUBERT_HEADS
    q, k, v, do = _attention_case(B, S, S, H, K, D, torch.bfloat16, 800)
    kw = dict(causal=False)
    out, _ = tfa.flash_attention(q, k, v, **kw)
    want_out, want_lse = ref.attention_naive(q, k, v, return_lse=True, **kw)
    grads = tfa.flash_attention_bwd(q, k, v, want_out, want_lse, do, **kw)
    want = ref.attention_bwd_ref(q, k, v, want_out, want_lse, do, **kw)
    faults = {}
    for n, got, w in (("out", out, want_out),
                      *zip(("dq", "dk", "dv"), grads, want)):
        bad = got.clone()
        bad[..., D80_FAULT_COLS] = 0
        ratio = _entry_ratio("bfloat16", bad, w)
        faults[n] = {
            "flagged_share": (ratio > 1).float().mean().item(),
            "flagged_share_of_cols": (ratio[..., D80_FAULT_COLS] > 1)
            .float().mean().item(),
            "flagged_elsewhere": bool((ratio[..., :D80_FAULT_COLS.start]
                                       > 1).any())}
        if not (ratio > 1).any() or faults[n]["flagged_elsewhere"]:
            raise AssertionError(f"flash_attention D=80: the {n} check "
                                 f"misjudges columns 64-79 zeroed: "
                                 f"{faults[n]}")
    print(f"[check] flash_attention planted faults D=80 B={B} S={S} H={H} "
          f"K={K} bidirectional bf16 (columns 64-79 of each output zeroed):"
          " share of entries beyond their limit, of those columns: "
          + ", ".join(f"{n} {f['flagged_share']:.4f}, "
                      f"{f['flagged_share_of_cols']:.4f}"
                      for n, f in faults.items())
          + "; none flagged in columns 0-63", flush=True)
    return faults


def check_qwen2vl_decode(tfa, ref):
    """``flash_decode`` at qwen2-vl's heads (QWEN2VL_HEADS: 8 query rows a
    kv head at a decode step, the chunk path) against the plain version
    entry by entry: a decode step (B 8, ragged, a done lane), a 256-row
    chunk over 768 rows and the vision prefill's 2048 rows (B 1), bf16
    and f32; and ``cache_update`` with M-RoPE's cos/sin of a 3-D grid
    (``_mrope_cos_sin``) bit for bit against the plain composition at the
    same three row counts, bf16 and f32.  Returns both lists of checks."""
    import torch
    H, K, D = QWEN2VL_HEADS
    S = VISION_S
    rng = np.random.default_rng(29)
    lens = rng.integers(1, S + 1, 8)
    lens[-1] = S + 1                               # a done lane
    cases = [(8, 1, lens.tolist()), (1, 256, [768]), (1, S, [S])]
    checks, cache_checks = [], []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for B, Sq, kv_len in cases:
            q, k, v, kl = _decode_case(B, S, H, K, D, Sq, dtype, kv_len,
                                       2900 + len(checks))
            got = tfa.flash_decode(q, k, v, kl)
            want = ref.decode_attention_ref(q, k, v, kl)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError("flash_decode: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            ratio = _entry_ratio(name, got, want).max().item()
            tol = DECODE_TOL[name]
            checks.append({"dtype": name, "B": B, "S": S, "H": H, "K": K,
                           "D": D, "Sq": Sq, "max_abs_err": err, "tol": tol,
                           "worst_over_limit": ratio})
            print(f"[check] flash_decode qwen2vl {name} B={B} S={S} H={H} "
                  f"K={K} D={D} Sq={Sq}: max|err| {err:.3e} (tol {tol}), "
                  f"worst entry / its limit {ratio:.3f}", flush=True)
            if not (err <= tol and ratio <= 1.0):
                raise AssertionError(f"flash_decode at qwen2-vl's heads "
                                     f"disagrees: {err}, {ratio}")
            del q, k, v, got, want
            seed = 3000 + len(cache_checks)
            kc, vc, index, _, _ = _rope_cache(False, B, S, K, D, dtype, Sq,
                                              seed)
            q, kn, vn, _, _ = _rope_case(B, Sq, H, K, D, dtype, 1.0, index,
                                         seed)
            c, s = _mrope_cos_sin(index, Sq)
            idx = torch.tensor(index, dtype=torch.int32, device="cuda")
            got, want = _rope_both(tfa, ref, False, kc, vc, idx, None, q, kn,
                                   vn, c, s, 1.0)
            exact = all(torch.equal(a, b) for a, b in zip(got, want))
            cache_checks.append({"model": "qwen2vl", "dtype": name, "B": B,
                                 "Sn": Sq, "index": index,
                                 "cos_sin": "M-RoPE of a 3-D grid",
                                 "max_abs_diff": _max_diff(got, want),
                                 "bit_exact": exact})
            print(f"[check] cache_update rope qwen2vl {cache_checks[-1]}",
                  flush=True)
            if not exact:
                raise AssertionError("cache_update with M-RoPE cos/sin is "
                                     "not bit for bit the plain composition")
    return checks, cache_checks


def encode_hubert(tfa):
    """[encode:hubert], phase 3l: hubert-xlarge at full width and depth
    (48 layers, 1.03 B params, seeded, bf16) encoding HUBERT_ENCODE seeded
    frames of 512 through ``make_prefill_step`` (no cache: the last
    frame's logits): one encode launches ``flash_attention`` exactly once
    a layer and no other kernel, its logits are finite, and ms and J per
    encode are read over at least ENCODE_WINDOW_S of the energy counter,
    each encode ended by a synchronise."""
    import torch
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import param_count
    from repro_torch.serving.engine import make_prefill_step

    cfg = get_model_config(HUBERT_ARCH)
    run = get_run_config(HUBERT_ARCH, remat="none")      # bf16 compute
    B, S = HUBERT_ENCODE
    _release_card()
    t0 = time.perf_counter()
    params = _card_weights(cfg, run)
    torch.cuda.synchronize()
    n_params = param_count(lm.model_decls(cfg))
    print(f"[encode] {cfg.name}: {cfg.n_layers} layers d{cfg.d_model} "
          f"head_dim {cfg.head_dim}, {n_params / 1e9:.3f} B params, weights "
          f"ready in {time.perf_counter() - t0:.1f}s", flush=True)
    prefill = make_prefill_step(cfg, run, Ctx(run, "cuda"), S)
    g = torch.Generator(device="cuda").manual_seed(12)
    batch = {"frames": torch.randn((B, S, cfg.frontend_dim), generator=g,
                                   device="cuda")}
    with torch.no_grad():
        cache, logits = prefill(params, batch)       # first-call costs
        torch.cuda.synchronize()
        if cache is not None \
                or tuple(logits.shape) != (B, 1, cfg.vocab_padded) \
                or not torch.isfinite(logits).all():
            raise AssertionError(f"[encode:hubert] encode gave cache "
                                 f"{cache}, logits {tuple(logits.shape)}")
        tfa.reset_launch_counts()
        prefill(params, batch)
        torch.cuda.synchronize()
        one = {fn.__name__: fn.launches for fn in tfa.KERNELS}
        want = {k: cfg.n_layers if k == "flash_attention" else 0
                for k in one}
        if one != want:
            raise AssertionError(f"[encode:hubert] launches {one}, "
                                 f"expected {want}")
        tfa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        n, e0, t0 = 0, METER.energy_mj(), time.perf_counter()
        while time.perf_counter() - t0 < ENCODE_WINDOW_S:
            prefill(params, batch)
            torch.cuda.synchronize()
            n += 1
        wall = time.perf_counter() - t0
        joules = (METER.energy_mj() - e0) / 1e3
    _check_draw("[encode:hubert]", joules, wall)
    if tfa.flash_attention.launches != n * cfg.n_layers:
        raise AssertionError(f"[encode:hubert] {tfa.flash_attention.launches}"
                             f" launches over {n} encodes")
    H, D = cfg.n_heads, cfg.head_dim
    ops = (2.0 * _active_params(cfg, n_params) * B * S
           + 4.0 * D * B * H * S * S * cfg.n_layers)
    ms = wall / n * 1e3
    stats = {"arch": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
             "batch": B, "frames": S, "encodes": n, "window_s": wall,
             "ms_per_encode": ms, "j_per_encode": joules / n,
             "frames_per_s": B * S / (wall / n),
             "model_ops_per_encode": ops,
             "bf16_peak_share": ops / (ms / 1e3 * BF16_OPS_PER_S),
             "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches_per_encode": one}
    print(f"[encode:hubert] {cfg.name} {cfg.n_layers} layers, {B} x {S} "
          f"frames of {cfg.frontend_dim}, bf16: {n} encodes over "
          f"{wall:.2f} s: {ms:.2f} ms and {joules / n:.2f} J per encode, "
          f"{stats['frames_per_s']:.0f} frames/s, "
          f"{100 * stats['bf16_peak_share']:.1f}% of the bf16 peak "
          f"({ops:.3e} model operations an encode), peak allocated "
          f"{stats['peak_allocated_gb']:.2f} GB; launches per encode {one}",
          flush=True)
    del params
    _release_card()
    return one, stats


def vision_prefill(tfa, cfg, run, params):
    """[prefill:qwen2vl-vision]: ``make_prefill_step`` at batch 1 over
    VISION_S rows whose first VISION_GRID^2 are seeded 8192-wide
    ``vision_embeds`` at grid positions (0, i, j) and the rest text at
    VISION_GRID + k (``grid_positions``): ms per prefill over VISION_RUNS
    runs, each ended by a synchronise, exactly one ``flash_decode`` (the
    chunk path, Sq = 2048) and one ``cache_update`` (M-RoPE's cos/sin
    folded in) a layer; and M-RoPE acts: the same batch with 1-D
    positions broadcast to the three sections gives last logits more than
    MROPE_ACTS apart."""
    import torch
    from repro_torch.models.layers import Ctx
    from repro_torch.serving.engine import make_prefill_step
    ctx = Ctx(run, "cuda")
    nv = VISION_GRID ** 2
    g = torch.Generator(device="cuda").manual_seed(13)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, VISION_S),
                                     generator=g, device="cuda",
                                     dtype=torch.int32),
             "vision_embeds": torch.randn((1, nv, cfg.d_model), generator=g,
                                          device="cuda").to(ctx.cdtype),
             "positions": torch.from_numpy(grid_positions(
                 1, nv, VISION_GRID, VISION_S)).cuda()}
    flat = dict(batch, positions=torch.arange(
        VISION_S, dtype=torch.int32, device="cuda")[None, None]
        .expand(3, 1, VISION_S))
    prefill = make_prefill_step(cfg, run, ctx, VISION_S)
    with torch.no_grad():
        prefill(params, batch)                       # first-call costs
        torch.cuda.synchronize()
        tfa.reset_launch_counts()
        secs = []
        for _ in range(VISION_RUNS):
            t0 = time.perf_counter()
            cache, logits = prefill(params, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            del cache
        launches = {fn.__name__: fn.launches for fn in tfa.KERNELS}
        _, flat_logits = prefill(params, flat)
    diff = (logits.float() - flat_logits.float()).abs().max().item()
    want = {k: cfg.n_layers * VISION_RUNS
            if k in ("flash_decode", "cache_update") else 0 for k in launches}
    stats = {"rows": VISION_S, "vision_rows": nv, "runs": VISION_RUNS,
             "ms": [t * 1e3 for t in secs],
             "median_ms": float(np.median(secs)) * 1e3,
             "mrope_vs_1d_max_abs_diff": diff, "launches": launches}
    print(f"[prefill:qwen2vl-vision] {cfg.name} {cfg.n_layers} layers, batch "
          f"1 x {VISION_S} rows ({nv} vision rows on a {VISION_GRID} x "
          f"{VISION_GRID} grid, then text): {stats['median_ms']:.2f} ms per "
          f"prefill (median of {VISION_RUNS}: "
          + ", ".join(f"{t:.2f}" for t in stats["ms"])
          + f"); last logits with 1-D positions differ by {diff:.4g} (must "
          f"exceed {MROPE_ACTS}); launches {launches}", flush=True)
    if launches != want:
        raise AssertionError(f"[prefill:qwen2vl-vision] launches {launches},"
                             f" expected {want}")
    if not torch.isfinite(logits).all() or not diff > MROPE_ACTS:
        raise AssertionError(f"[prefill:qwen2vl-vision] logits finite "
                             f"{bool(torch.isfinite(logits).all())}, M-RoPE "
                             f"moved them by {diff}")
    return stats


def serve_qwen2vl(tfa):
    """Phase 3k: qwen2-vl-72b at full width and QWEN2VL_LAYERS of its 80
    layers (seeded, bf16): ``[serve:qwen2vl-dense]``, ``serve_full_width``'s
    dense arm (batch 8, max_seq 2048, graphed, the 16 requests: text, at
    the default positions, M-RoPE's three equal rows), with ms per decode
    step and per 256 prompt rows; then ``vision_prefill`` on its weights."""
    launches, stats, shared = serve_full_width(tfa, QWEN2VL_ARCH, "qwen2vl-",
                                               QWEN2VL_LAYERS)
    cfg = shared[0]
    stats["ms_per_decode_step"] = stats["decode_s"] / stats["decode_steps"] \
        * 1e3
    stats["ms_per_256_prompt_rows"] = (stats["prefill_s"] * 1e3 * 256
                                       / stats["prompt_tokens"])
    print(f"[serve:qwen2vl-dense] {cfg.name} at {cfg.n_layers} of 80 layers: "
          f"{stats['tok_per_s']:.1f} tok/s, "
          + (f"{stats['j_per_token']:.4f} J per generated token, "
             if stats["j_per_token"] is not None else "")
          + f"{stats['ms_per_decode_step']:.2f} ms per decode step, "
          f"{stats['ms_per_256_prompt_rows']:.2f} ms per 256 prompt rows",
          flush=True)
    stats["vision"] = vision_prefill(tfa, *shared[:3])
    del shared
    _release_card()
    return launches, stats


def item12_parity(arch, tag):
    """[parity:hubert] and [parity:qwen2vl]: the model at full width and 2
    layers, card bf16 (kernels) against CPU f32 (plain) from the same
    seeded f32 weights (drawn on the card, copied to the host): hubert's
    logits of every frame of two 300-frame encodes; qwen2-vl's last-row
    logits of ``make_prefill_step`` on a 300-row prompt whose first 64
    rows are vision embeddings at grid positions, and of one
    ``make_decode_step`` after it (its M-RoPE positions the index, as the
    reference's), both against one CPU forward over the 301 rows; within
    PARITY_TOL."""
    import torch
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import make_decode_step, make_prefill_step
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_model_config(arch), n_layers=2)
    run = get_run_config(arch, remat="none")
    ctx = Ctx(run, "cuda")
    cpu_ctx = Ctx(run.replace(compute_dtype="float32"), "cpu")
    master = init_params(lm.model_decls(cfg),
                         torch.Generator(device="cuda").manual_seed(1), "cuda")
    params = tree_map(lambda t: t.cpu(), master)
    card = lm.prepare_params(ctx, master)
    del master
    _release_card()
    rng = np.random.default_rng(1)
    S = 300
    tfa.reset_launch_counts()
    with torch.no_grad():
        if cfg.family == "audio":
            frames = torch.from_numpy(rng.standard_normal(
                (2, S, cfg.frontend_dim), dtype=np.float32))
            h = lm.forward(ctx, cfg, card, {"frames": frames.cuda()})[0]
            got = lm.logits_for(ctx, cfg, card, h).float().cpu()
            hc = lm.forward(cpu_ctx, cfg, params, {"frames": frames})[0]
            want = lm.logits_for(cpu_ctx, cfg, params, hc)
            worst = (got - want)[..., :cfg.vocab].abs().max().item()
            what = "every frame's logits of two 300-frame encodes"
        else:
            nv = 64
            host = {"tokens": rng.integers(0, cfg.vocab, (1, S),
                                           dtype=np.int32),
                    "vision_embeds": rng.standard_normal(
                        (1, nv, cfg.d_model), dtype=np.float32),
                    "positions": grid_positions(1, nv, 8, S)}
            cache, first = make_prefill_step(cfg, run, ctx, 512)(
                card, {k: torch.from_numpy(v).cuda() for k, v in host.items()})
            nxt = int(first[0, -1].argmax())
            _, dec = make_decode_step(cfg, run, ctx)(
                card, cache, torch.tensor([[nxt]], dtype=torch.int32,
                                          device="cuda"), S)
            # one CPU forward over the 301 rows: row S at position S in all
            # three sections, as the decode step put it
            full = {"tokens": np.concatenate([host["tokens"], [[nxt]]], 1),
                    "vision_embeds": host["vision_embeds"],
                    "positions": np.concatenate(
                        [host["positions"], np.full((3, 1, 1), S, np.int32)],
                        2)}
            hc = lm.forward(cpu_ctx, cfg, params,
                            {k: torch.from_numpy(v) for k, v in full.items()})[0]
            want = lm.logits_for(cpu_ctx, cfg, params, hc[:, -2:])[0]
            worst = max((first[0, -1].float().cpu() - want[0]).abs().max().item(),
                        (dec[0].float().cpu() - want[1]).abs().max().item())
            what = (f"the last-row logits of a {S}-row prefill ({nv} vision "
                    "rows at grid positions) and of one decode step")
    launches = {k: fn.launches for k, fn in
                ((fn.__name__, fn) for fn in tfa.KERNELS) if fn.launches}
    print(f"[{tag}] {cfg.name} d{cfg.d_model} vocab {cfg.vocab}, 2 layers: "
          f"card bf16 (kernels, launches {launches}) vs CPU f32 (plain), "
          f"{what}: max|diff| {worst:.4f} (tol {PARITY_TOL})", flush=True)
    if not worst <= PARITY_TOL:
        raise AssertionError(f"[{tag}] logits parity {worst} > {PARITY_TOL}")
    del card, params
    _release_card()
    return worst


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


# ---------------------------------------------------------------------------
# phase 2c: the distributed layer (``tools/dist_probe.py`` runs it alone)
# ---------------------------------------------------------------------------
#
# The card's host has one H100, and NCCL refuses two ranks on one device,
# so every [dist:*] phase runs two ranks that share the card over the
# ``gloo`` backend: their collectives are copied to the host and back
# (``sharding/collectives.py`` counts the bytes).  The numbers show that
# the sharded paths run the port's kernels on the card and give the right
# results; their times are those of two ranks time-slicing one card, not
# of two cards.  Each rank is a spawned process that imports this module.

LLAMA_HEADS = (24, 8, 128)
#: [dist:decode]: the bf16 arm at 8 of llama's 28 layers (every layer runs
#: the same program; 28 until PR 32) and the f32 arm at 2
DIST_DECODE = dict(B=8, prompt=1024, max_seq=2048, steps=16,
                   layers={"bf16": 8, "f32": 2})
#: the llama [dist:train*] steps at 2 of 28 layers (4 until PR 32)
DIST_TRAIN = dict(layers=2, B=2, S=2048)
#: [dist:train-mamba2] and [dist:train-zamba2]: the head-parallel Mamba-2
#: program at full width and cut depth, bf16: mamba2 at 4 of 48 layers;
#: zamba2 at 7 of 38, six Mamba-2 layers, the shared block's first
#: invocation and one trailing layer
DIST_SSM_TRAIN = dict(B=2, S=2048, layers={SSM_ARCH: 4, HYBRID_ARCH: 7})
#: [dist:decode-ssm]: f32, mamba2 at 2 layers and zamba2 at 7 (the shared
#: block's first invocation over its sequence-sharded cache), 8 prompts
#: of DIST_DECODE's length, 4 steps
DIST_SSM_DECODE = dict(layers={SSM_ARCH: 2, HYBRID_ARCH: 7}, steps=4)
#: zamba2's ``lora_b`` is drawn ~N(0, DIST_LORA_B_STD^2) in every [dist:*]
#: phase of the hybrid: its init is zeros, which leaves ``q_delta`` zero
#: and ``lora_a``'s gradient zero, so a fault on that path would not show
DIST_LORA_B_STD = 0.05
#: olmoe's train step at one row of 2048: without drops its all-to-alls
#: carry 8x the default capacity's rows (~6.6 GB a step through the host
#: at two rows); its MoE layer check at two
DIST_MOE = dict(layers=2, train_B=1, B=2, S=2048, decode_steps=4)
#: gates of a sharded bf16 step against the one-device step from the same
#: seed, read on each rank's shard, the worst rank counting: the loss and
#: the gradient norm relative; ``grad_rel`` the worst leaf's
#: |g - g_one| / |g_one| (the gradients the step clips, summed over the
#: data-parallel ranks); ``params_apart`` the share of parameter entries
#: more than 1e-3 lr apart after the step.  In bf16 a gradient entry near
#: zero changes sign under another order of sums, and AdamW's first step
#: moves every entry by about lr * sign(g), so a few per cent of entries
#: land 2 lr apart on a sound run.  Each gate lies between the sound runs'
#: largest reading and the reading of a planted fault
#: (``DIST_FAULTS``), which must fail it.
#: Read on an H100 (sound; planted fault), llama (1, 2): 1.03e-5, 2.14e-4,
#: 1.49e-2, 6.8e-2; 1.85e-3, 2e9, 5e9, 1.0; (2, 1): 0, 3.1e-5, 2.4e-3,
#: 3.0e-2; 0.50, 0.31, 0.75, 0.72.
DIST_TRAIN_GATES = {"loss_rel": 2e-4, "grad_norm_rel": 5e-3,
                    "grad_rel": 0.1, "params_apart": 0.2}
#: olmoe's step with a capacity that drops nothing (expert parallelism
#: counts each rank's tokens, one device all of them: with drops the two
#: drop different tokens).  Its experts' gradients sum their rows in
#: another tiling on each side (EP's 2 x cap rows against one device's
#: cap), so more near-zero entries flip: read (sound; planted fault)
#: 1.08e-4, 6.7e-4, 0.126 (the router), 0.248; 3.7e-3, 0.19, 1.24, 0.77.
#: The int8 wire (1.3e-5, 2.9e-4) is held to the bf16 wire's loss and
#: norm gates.
DIST_MOE_GATES = {"bf16": {"loss_rel": 6e-4, "grad_norm_rel": 5e-3,
                           "grad_rel": 0.5, "params_apart": 0.45},
                  "int8": {"loss_rel": 6e-4, "grad_norm_rel": 5e-3}}
#: the head-parallel Mamba-2 steps' gates.  A planted backward fault of
#: these paths moves the gradients by a few per cent outside the leaves
#: it reaches first, and AdamW's first step moves an entry by about
#: lr * sign(g), so it flips about as many signs as bf16's order of sums
#: does on a sound run: params_apart cannot tell them apart, and its gate
#: only bounds the sound run.  Read on an H100 (sound; planted fault:
#: loss_rel, grad_norm_rel, grad_rel, params_apart): mamba2 (1, 2) 5.0e-6,
#: 5.5e-5, 2.6e-2 (A_log), 0.138; 5.0e-6, 1.4e-2, 0.30 (conv_b), 0.202;
#: zamba2 (1, 2) 1.3e-6, 3.1e-5, 3.9e-2 (lora_a), 0.176; 1.3e-6, 2.9e-4,
#: 0.71 (lora_a), 0.180.  zamba2's grad_norm_rel gate is the one between
#: those two readings.
DIST_SSM_GATES = {
    "mamba2": {"loss_rel": 2e-4, "grad_norm_rel": 5e-3, "grad_rel": 0.1,
               "params_apart": 0.3},
    "zamba2": {"loss_rel": 2e-4, "grad_norm_rel": 1e-4, "grad_rel": 0.1,
               "params_apart": 0.3}}
#: the planted faults, one per sharded path: the all-reduce after the
#: row-parallel projections dropped (tensor parallelism), the gradients
#: not summed over ``data`` (data parallelism), the all-to-all's chunks
#: exchanged in reverse order (expert parallelism), the K/V gather's
#: backward slicing the rank's own cotangent instead of reduce-scattering
#: the ranks' partial sums (sequence parallelism), the data-parallel sum
#: applied again to the leaves fsdp's gathers reduce-scattered (ZeRO-3)
DIST_FAULTS = {"1x2": "reduce_from dropped", "2x1": "data psum dropped",
               "olmoe": "all_to_all order reversed",
               "seqpar": "K/V gather's backward sliced (gather_from)",
               "fsdp": "data psum applied to the fsdp leaves too",
               "mamba2": "the gated norm's all-reduce with an identity "
                         "backward (reduce_from)",
               "zamba2": "a_in @ lora_a without its copy_to"}
#: the gates a planted fault must fail, where not all of them: the two
#: faults of the gradients' collectives act in the backward pass only, so
#: the step's loss (the forward's) is the sound one's and loss_rel cannot
#: see them.  Read on an H100 (sound; planted fault: loss_rel,
#: grad_norm_rel, grad_rel, params_apart): seqparallel (1, 2) 0, 1.5e-5,
#: 6.2e-3, 1.3e-2; 0, 0.24, 0.68, 0.60; fsdp (2, 1) 0, 3.1e-5, 2.4e-3,
#: 3.0e-2; 0, 0.42, 1.06, 0.71.
DIST_FAULT_GATES = {"seqpar": ("grad_norm_rel", "grad_rel", "params_apart"),
                    "fsdp": ("grad_norm_rel", "grad_rel", "params_apart"),
                    "mamba2": ("grad_norm_rel", "grad_rel"),
                    "zamba2": ("grad_norm_rel", "grad_rel")}
#: [dist:decode-seqpar]: llama f32 at 2 layers under its serve rules
#: (seqparallel): every rank gathers the layers' weights whole each step
#: (~0.8 GB in f32 at 2 layers, staged through the host), so fewer steps
#: than [dist:decode]
DIST_SEQ_DECODE_STEPS = 4
DIST_ELASTIC_RTOL = 1e-5   # f32, reduced
DIST_SPAWN_TIMEOUT_S = 480


def _dist_lse_case(B, S, H, K, D, dtype, kv_len, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, 1, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, S, K, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, K, D), generator=g, device="cuda").to(dtype)
    return q, k, v, torch.tensor(kv_len, dtype=torch.int32, device="cuda")


def lse_flagged(got, want):
    """Entries of an lse outside the rule: -inf where the plain version
    has -inf, else within LSE_TOL (1 + |want|)."""
    import torch
    inf_w, inf_g = torch.isinf(want), torch.isinf(got)
    bad = inf_w != inf_g
    fin = ~inf_w & ~inf_g
    bad |= fin & ((got - want).abs() > LSE_TOL * (1 + want.abs()))
    return bad


def check_flash_decode_lse(tfa, ref):
    """``flash_decode(..., return_lse=True)`` against
    ``ref.decode_attention_lse_ref``, bf16 and f32, at llama's heads over a
    slice of 2048 rows (B = 8, one slot with kv_len 0, a window),
    qwen2-vl's group of 8 (the chunk kernels) and the reduced D = 32: out
    entry by entry (``_entry_ratio``), lse by LSE_TOL with -inf where no
    key is visible (kv_len 0: output 0), and out bit for bit the call
    without lse.  Then the planted fault: the plain lse of the
    neighbouring slice (kv_len of the next slot) must be flagged."""
    import torch
    rng = np.random.default_rng(5)
    checks = []
    shapes = [(8, 2048, *LLAMA_HEADS), (8, 2048, *QWEN2VL_HEADS),
              (3, 64, 4, 2, 32)]
    fault = None
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for B, S, H, K, D in shapes:
            for window in (None, 512 if S > 512 else 16):
                kv_len = rng.integers(1, S + 1, B)
                kv_len[0], kv_len[-1] = 0, S       # an empty slice, a full one
                q, k, v, kl = _dist_lse_case(B, S, H, K, D, dtype,
                                             kv_len.tolist(), len(checks))
                out, lse = tfa.flash_decode(q, k, v, kl, local_window=window,
                                            return_lse=True)
                plain = tfa.flash_decode(q, k, v, kl, local_window=window)
                want, wlse = ref.decode_attention_lse_ref(
                    q, k, v, kl, local_window=window)
                torch.cuda.synchronize()
                ratio = _entry_ratio(name, out, want).max().item()
                lse_bad = int(lse_flagged(lse, wlse).sum())
                lse_err = (lse - wlse)[torch.isfinite(wlse)].abs().max().item()
                same = torch.equal(out, plain)
                empty = (out[0].abs().max().item(),
                         bool(torch.isneginf(lse[0]).all()))
                checks.append({"dtype": name, "B": B, "S": S, "H": H, "K": K,
                               "D": D, "window": window,
                               "out_worst_over_limit": ratio,
                               "lse_max_abs_err": lse_err,
                               "lse_flagged": lse_bad,
                               "out_equals_no_lse_call": same,
                               "empty_slot_out_max": empty[0],
                               "empty_slot_lse_neg_inf": empty[1]})
                print(f"[check] flash_decode lse {name} B={B} S={S} H={H} "
                      f"K={K} D={D} window={window}: out worst entry / its "
                      f"limit {ratio:.3f}, lse max|err| {lse_err:.3e} (tol "
                      f"{LSE_TOL} (1 + |want|)), {lse_bad} flagged; out == "
                      f"the call without lse: {same}; kv_len 0: out max "
                      f"{empty[0]}, lse -inf {empty[1]}", flush=True)
                if not (ratio <= 1.0 and lse_bad == 0 and same
                        and empty == (0.0, True)):
                    raise AssertionError(f"flash_decode lse disagrees: "
                                         f"{checks[-1]}")
                if fault is None and H == LLAMA_HEADS[0] and name == "bfloat16":
                    # the planted fault: the lse of the neighbouring slice
                    other = torch.roll(kl, 1)
                    _, wrong = ref.decode_attention_lse_ref(
                        q, k, v, other, local_window=window)
                    rows = (kl != other)
                    flagged = lse_flagged(lse, wrong).any(-1).any(-1)
                    share = (flagged & rows).sum().item() / max(
                        rows.sum().item(), 1)
                    fault = {"slots_moved": int(rows.sum()),
                             "share_flagged": share}
                    print(f"[check] flash_decode lse planted fault (the lse "
                          f"of the neighbouring slot's slice): "
                          f"{share:.3f} of {int(rows.sum())} slots flagged",
                          flush=True)
                    if share <= 0.5:
                        raise AssertionError(f"lse fault not caught: {fault}")
    return checks, fault


def _flex_decode_lse(kv_len, window, B, S):
    """The library call of a masked decode step with its log-sum-exp:
    ``flex_attention`` compiled, GQA on, a block mask of each slot's
    visible rows (``kv_len`` and the window counted back from it), the
    lse asked for through ``AuxRequest``.  Returns (call(q, k, v) -> (out,
    lse) in the decode layout, the mask's build s)."""
    import torch
    from torch.nn.attention.flex_attention import (AuxRequest,
                                                   create_block_mask,
                                                   flex_attention)

    def visible(b, h, q_idx, kv_idx):
        q_pos = kv_len[b] - 1 + q_idx
        m = kv_idx <= q_pos
        if window is not None:
            m = m & (q_pos - kv_idx < window)
        return m
    t0 = time.perf_counter()
    mask = create_block_mask(visible, B, None, 1, S, device="cuda")
    built = time.perf_counter() - t0
    flex = torch.compile(flex_attention, fullgraph=True)

    def call(q, k, v):
        out, aux = flex(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), block_mask=mask, enable_gqa=True,
                        return_aux=AuxRequest(lse=True))
        return out.transpose(1, 2), aux.lse
    return call, built


def time_flash_decode_lse(tfa, ref, B=8, S=2048):
    """``flash_decode`` at llama's decode step over a 2048-row slice, with
    and without the lse, in one call, both graph-timed (alternated
    without, with, with, without); the plain version; the library call
    (``_flex_decode_lse``, held to the plain version on the first case
    first); the bound (the cache rows read, q, out and lse)."""
    import torch
    H, K, D = LLAMA_HEADS
    rng = np.random.default_rng(9)
    kv_len = rng.integers(96, S + 1, B).tolist()
    kv_bytes = sum(kv_len) * K * D * 2 * 2
    n = max(2, min(8, math.ceil(100e6 / kv_bytes)))
    cases = [_dist_lse_case(B, S, H, K, D, torch.bfloat16, kv_len, 200 + i)
             for i in range(n)]
    no = [functools.partial(tfa.flash_decode, *c) for c in cases]
    yes = [functools.partial(tfa.flash_decode, *c, return_lse=True)
           for c in cases]
    turns = [_time_graph_ms(f) for f in (no, yes, yes, no)]
    plain = [functools.partial(ref.decode_attention_lse_ref, *c)
             for c in cases]
    plain_ms = _time_eager_ms(plain, 2)
    flex, mask_s = _flex_decode_lse(cases[0][3], None, B, S)
    t0 = time.perf_counter()
    got, glse = flex(*cases[0][:3])
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    want, wlse = ref.decode_attention_lse_ref(*cases[0])
    # the same function: the lse within LSE_TOL, the output within 2e-2 of
    # its largest entry (the library rounds P to bf16 before P @ V, which
    # the plain version and the kernel do not)
    lib_rel = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
    lib_lse_err = (glse - wlse).abs().max().item()
    if not (lib_rel <= 2e-2 and lib_lse_err <= LSE_TOL * (
            1 + wlse.abs().max().item())):
        raise AssertionError(f"flex_attention is not the same function: "
                             f"out {lib_rel}, lse {lib_lse_err}")
    library_ms = _time_graph_ms([functools.partial(flex, *c[:3])
                                 for c in cases])
    nbytes = kv_bytes + 2 * B * H * D * 2 + 4 * B * H + 4 * B
    ops = 4.0 * D * H * sum(kv_len)
    bound_ms, bound_by = _bound(nbytes, ops, BF16_OPS_PER_S)
    t = {"shape": f"B={B} Sq=1 S={S} H={H} K={K} D={D} bf16, kv_len "
                  f"{min(kv_len)}..{max(kv_len)}",
         "ms": (turns[1] + turns[2]) / 2, "ms_without_lse":
         (turns[0] + turns[3]) / 2, "turns_ms": turns, "plain_ms": plain_ms,
         "library_ms": library_ms,
         "library": "torch.compile(flex_attention) with a kv_len block "
                    "mask, enable_gqa, AuxRequest(lse=True)",
         "library_vs_plain": {"out_max_abs_err_over_max": lib_rel,
                              "lse_max_abs_err": lib_lse_err},
         "library_compile_s": compile_s, "library_mask_s": mask_s,
         "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"[time] flash_decode lse {t['shape']}: with lse {t['ms']:.4f} ms, "
          f"without {t['ms_without_lse']:.4f} ms (turns without, with, with, "
          f"without: {', '.join(f'{x:.4f}' for x in turns)}), plain "
          f"{plain_ms:.4f} ms, library {library_ms:.4f} ms (flex_attention "
          f"compiled in {compile_s:.1f} s; vs plain: out max|err| "
          f"{lib_rel:.2e} of max|out|, lse max|err| {lib_lse_err:.2e}), bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    return t


# --- the ranks' programs (each rank a spawned process; the card is cuda:0)

def _dist_rank_setup():
    import torch
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _dist_launches(tfa):
    return {fn.__name__: fn.launches for fn in tfa.KERNELS if fn.launches}


def _dist_sync_ms(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _dist_draw(cfg, ctx, seed, specs=None, mesh=None):
    """Weights drawn whole from ``seed`` on the card, each leaf cast as
    ``lm.prepare_leaf`` casts it and, with ``specs``, cut to this rank's
    shard as it is drawn."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.params import init_params
    from repro_torch.sharding import local_slice
    from repro_torch.tree import leaves_with_paths
    flat = dict(leaves_with_paths(specs)) if specs is not None else None

    def prepare(path, t):
        if flat is not None:
            t = local_slice(mesh, flat[path], t).clone()
        return lm.prepare_leaf(ctx, path, t)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(lm.model_decls(cfg), gen, "cuda", prepare=prepare)
    _dist_lora(cfg, params, seed,
               flat.get(("shared", "lora_b")) if flat else None, mesh)
    return params


def _dist_lora(cfg, params, seed, spec=None, mesh=None):
    """For the hybrid, ``lora_b`` drawn whole ~N(0, DIST_LORA_B_STD^2) from
    ``seed`` (this rank's shard of it with ``spec``) in place of its zero
    init, in its own dtype; other families are left as they are."""
    import torch
    from repro_torch.models import lm
    from repro_torch.sharding import local_slice
    if cfg.family != "hybrid":
        return
    lb = params["shared"]["lora_b"]
    shape = lm.model_decls(cfg)["shared"]["lora_b"].shape
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    full = torch.randn(shape, generator=g, device="cuda") * DIST_LORA_B_STD
    if spec is not None:
        full = local_slice(mesh, spec, full)
    with torch.no_grad():
        lb.copy_(full)


def _dist_init(cfg, run, seed, ctx=None):
    """``init_state`` from ``seed`` on the card (this rank's shards with a
    mesh ``ctx``), ``lora_b`` drawn by ``_dist_lora``."""
    import torch
    from repro_torch.tree import leaves_with_paths
    from repro_torch.train.step import init_state, state_specs
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = init_state(cfg, run, gen, "cuda", ctx).tree()
    spec = None
    if ctx is not None and ctx.mesh is not None and cfg.family == "hybrid":
        spec = dict(leaves_with_paths(state_specs(cfg, run, ctx)["params"]))[
            ("shared", "lora_b")]
    _dist_lora(cfg, state["params"], seed, spec,
               ctx.mesh if ctx is not None else None)
    return state


def _dist_param_specs(cfg, ctx, decls=None):
    from repro_torch.models import lm
    from repro_torch.models.params import abstract_params, logical_axes
    from repro_torch.sharding import tree_shardings
    decls = lm.model_decls(cfg) if decls is None else decls
    return tree_shardings(ctx.rules, ctx.mesh, logical_axes(decls),
                          abstract_params(decls))


class _swapped:
    """A planted fault in one rank, for the ``with`` block: ``module.name``
    replaced by ``fn``."""

    def __init__(self, module, name, fn):
        self.module, self.name, self.fn = module, name, fn

    def __enter__(self):
        self.real = getattr(self.module, self.name)
        setattr(self.module, self.name, self.fn)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def _planted(where, **swap):
    """``where``'s collectives module (``C``) replaced by a copy with
    ``swap``'s functions in place of its own."""
    import types
    from repro_torch.sharding import collectives
    return _swapped(where, "C", types.SimpleNamespace(
        **{**vars(collectives), **swap}))


def _fault(name):
    """The planted fault ``DIST_FAULTS[name]`` as a context manager."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.sharding import collectives as C
    from repro_torch.train import step as S
    if name == "1x2":
        return _planted(L, reduce_from=lambda x, axes, mesh: x)
    if name == "mamba2":
        return _planted(L, all_reduce=C.reduce_from)
    if name == "zamba2":
        return _planted(lm, copy_to=lambda x, axes, mesh: x)
    if name == "seqpar":
        return _planted(L, gather_sum=C.gather_from)
    if name == "fsdp":
        return _swapped(S, "grad_sum_axes", lambda split, ax: tuple(
            a for a in split if a not in ax or a in ("pod", "data")))
    if name == "2x1":
        def psum(x, axes, mesh):
            return x.clone() if "data" in mesh.present(axes) else C.psum(
                x, axes, mesh)
        return _planted(S, psum=psum)
    return _planted(
        L, all_to_all=lambda x, axes, mesh: C.all_to_all(
            x.flip(0).contiguous(), axes, mesh),
        all_to_all_grad=lambda x, axes, mesh: C.all_to_all_grad(
            x.flip(0).contiguous(), axes, mesh))


def _dist_decode_run(cfg, dtype, seed, prompt_tokens, feed_steps, mesh, rank,
                     rules="default", arch=ARCH):
    """One [dist:decode] arm of ``arch`` on this rank: prefill on one
    device (each rank its own copy), rank 0 also the unsharded steps (the
    other waits); then the sharded steps under ``rules`` teacher-forced by
    rank 0's stream.  Returns the numbers rank 0 compares."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_run_config
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import shard_params
    from repro_torch.serving.engine import make_decode_step, make_prefill_step
    from repro_torch.sharding import RULE_SETS, collectives as C
    run = get_run_config(arch, rules_name=rules, compute_dtype=dtype)
    ctx0 = Ctx(run, "cuda")
    ctx = Ctx(run, "cuda", RULE_SETS[rules], mesh)
    params = _dist_draw(cfg, ctx0, seed)
    P, S = DIST_DECODE["prompt"], DIST_DECODE["max_seq"]
    tokens = torch.from_numpy(prompt_tokens).cuda()
    with torch.no_grad():
        cache, first = make_prefill_step(cfg, run, ctx0, S)(
            params, {"tokens": tokens})
    shard = lm.shard_cache(ctx, cfg, cache)
    B = tokens.shape[0]
    stream = torch.zeros((feed_steps, B), dtype=torch.int64)
    full_logits, full_ms = [], []
    if rank == 0:
        step = make_decode_step(cfg, run, ctx0)
        tok = first[:, 0].argmax(-1)
        with torch.no_grad():
            for i in range(feed_steps):
                stream[i] = tok.cpu()
                (cache, lg), ms = _dist_sync_ms(
                    lambda: step(params, cache, tok[:, None], P + i))
                full_logits.append(lg.float().cpu())
                full_ms.append(ms)
                tok = lg.argmax(-1)
    del cache
    dist.broadcast(stream, src=0)
    params = shard_params(params, _dist_param_specs(cfg, ctx), mesh)
    torch.cuda.empty_cache()
    step = make_decode_step(cfg, run, ctx)
    tfa.reset_launch_counts()
    C.reset_staged()
    sharded_ms, worst, equal = [], 0.0, torch.ones(B, dtype=torch.bool)
    max_diff = 0.0
    with torch.no_grad():
        for i in range(feed_steps):
            tok = stream[i].cuda()[:, None]
            (shard, lg), ms = _dist_sync_ms(
                lambda: step(params, shard, tok, P + i))
            sharded_ms.append(ms)
            if rank == 0:
                got, want = lg.float().cpu(), full_logits[i]
                name = "float32" if dtype == "float32" else "bfloat16"
                limit = (ATTN_RTOL[name] * want.abs()
                         + ATTN_ATOL * want.abs().max())
                worst = max(worst, ((got - want).abs() / limit).max().item())
                max_diff = max(max_diff, (got - want).abs().max().item())
                equal &= got.argmax(-1) == want.argmax(-1)
                if not torch.isfinite(got).all():
                    raise AssertionError("[dist:decode] non-finite logits")
    out = {"launches": _dist_launches(tfa), "staged_bytes": C.staged_total(),
           "sharded_ms_per_step": float(np.median(sharded_ms))}
    if rank == 0:
        out.update(unsharded_ms_per_step=float(np.median(full_ms)),
                   streams_equal=int(equal.sum()), streams=B,
                   logits_worst_over_limit=worst, logits_max_abs_diff=max_diff)
    return out


def _dist_phase_decode(rank, mesh):
    """[dist:decode] on mesh (1, 2): llama bf16 at full depth, then f32 at
    2 layers."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_model_config
    cfg = get_model_config(ARCH)
    rng = np.random.default_rng(21)
    prompts = rng.integers(0, cfg.vocab, (DIST_DECODE["B"],
                                          DIST_DECODE["prompt"]))
    out = {}
    for arm, dtype, seed in (("bf16", "bfloat16", 3), ("f32", "float32", 4)):
        out[arm] = _dist_decode_run(
            dataclasses.replace(cfg, n_layers=DIST_DECODE["layers"][arm]),
            dtype, seed, prompts, DIST_DECODE["steps"], mesh, rank)
        torch.cuda.empty_cache()
    return out


def _dist_phase_decode_ssm(rank, mesh):
    """[dist:decode-ssm] on mesh (1, 2): mamba2 f32 at 2 layers and zamba2
    f32 at 7, each prefilled on one device, its cache cut by
    ``lm.shard_cache`` (the SSM state by heads, the conv state to the
    head-parallel program's channels, the shared block's KV rows by
    sequence), then the decode steps under ``default``."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_model_config
    out = {}
    for i, arch in enumerate((SSM_ARCH, HYBRID_ARCH)):
        cfg = get_model_config(arch)
        prompts = np.random.default_rng(23 + i).integers(
            0, cfg.vocab, (DIST_DECODE["B"], DIST_DECODE["prompt"]))
        out[arch] = _dist_decode_run(
            dataclasses.replace(cfg,
                                n_layers=DIST_SSM_DECODE["layers"][arch]),
            "float32", 33 + i, prompts, DIST_SSM_DECODE["steps"], mesh, rank,
            arch=arch)
        torch.cuda.empty_cache()
    return out


def _dist_phase_decode_seqpar(rank, mesh):
    """[dist:decode-seqpar] on mesh (1, 2): llama f32 at 2 layers under
    its serve rules (``seqparallel``), the weights gathered whole on each
    rank, every head over the sequence-sharded cache."""
    import dataclasses
    from repro_torch.configs.registry import get_model_config
    cfg = get_model_config(ARCH)
    prompts = np.random.default_rng(22).integers(
        0, cfg.vocab, (DIST_DECODE["B"], DIST_DECODE["prompt"]))
    return _dist_decode_run(dataclasses.replace(cfg, n_layers=2), "float32",
                            9, prompts, DIST_SEQ_DECODE_STEPS, mesh, rank,
                            rules="seqparallel")


def _dist_batch(cfg, B, S, seed):
    import torch
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1))
    return {"tokens": torch.from_numpy(toks[:, :-1]).cuda(),
            "labels": torch.from_numpy(toks[:, 1:]).cuda()}


def _dist_step(cfg, run, ctx, state, batch):
    """``make_train_step``'s step, with the gradients it clips (summed
    over the data-parallel ranks) copied out on their way: (state,
    metrics, grads)."""
    from repro_torch.train import step as S
    from repro_torch.tree import tree_map
    seen, clip = {}, S.clip_by_global_norm

    def copying(grads, *a, **k):
        seen["grads"] = tree_map(lambda g: g.detach().clone(), grads)
        return clip(grads, *a, **k)
    fn = S.make_train_step(cfg, run, ctx)
    S.clip_by_global_norm = copying
    try:
        state, m = fn(state, batch)
    finally:
        S.clip_by_global_norm = clip
    return state, m, seen["grads"]


def _dist_reference(cfg, run, mesh, batch, seed):
    """The one-device step from ``seed`` on the whole batch, taken by each
    rank in turn (one at a time on the card): its loss and grad norm, and
    this rank's shard of its gradients and new parameters."""
    import torch
    import torch.distributed as dist
    from repro_torch.models.layers import Ctx
    from repro_torch.sharding import RULE_SETS, local_slice
    from repro_torch.train.step import state_specs
    from repro_torch.tree import leaves
    ctx = Ctx(run, "cuda", RULE_SETS[run.rules_name], mesh)
    specs = leaves(state_specs(cfg, run, ctx)["params"])
    ref = None
    for turn in range(mesh.size):
        if turn == mesh.rank:
            state = _dist_init(cfg, run, seed)
            state, m, grads = _dist_step(cfg, run, Ctx(run, "cuda"), state,
                                         batch)
            ref = {"loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"]),
                   "grads": [local_slice(mesh, s, g).clone()
                             for s, g in zip(specs, leaves(grads))],
                   "params": [local_slice(mesh, s, p).detach().clone()
                              for s, p in zip(specs,
                                              leaves(state["params"]))]}
            del state, grads
            torch.cuda.empty_cache()
        dist.barrier()
    return ref


def _dist_train_case(cfg, run, mesh, batch, seed, ref, fault=None):
    """One step on this rank of ``mesh`` from ``seed`` (under ``fault``, if
    given, the planted fault ``DIST_FAULTS[fault]``) against ``ref``, this
    rank's shard of the one-device step (``_dist_reference``).  Each entry
    of the result is this rank's reading of a ``DIST_TRAIN_GATES`` gate,
    or its launches, staged bytes and seconds."""
    import contextlib
    import torch
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models.layers import Ctx
    from repro_torch.sharding import RULE_SETS, collectives as C
    from repro_torch.tree import leaves, leaves_with_paths
    ctx = Ctx(run, "cuda", RULE_SETS[run.rules_name], mesh)
    state = _dist_init(cfg, run, seed, ctx)
    dp = mesh.axis_size(("pod", "data"))
    n = batch["tokens"].shape[0] // dp
    d = mesh.index(("pod", "data"))
    local = {k: v[d * n:(d + 1) * n] for k, v in batch.items()}
    tfa.reset_launch_counts()
    C.reset_staged()
    with _fault(fault) if fault else contextlib.nullcontext():
        (state, m, grads), ms = _dist_sync_ms(
            lambda: _dist_step(cfg, run, ctx, state, local))
    launches, staged = _dist_launches(tfa), C.staged_total()
    lr = run.learning_rate
    grad_rel, grad_leaf, worst, apart, total = 0.0, None, 0.0, 0, 0
    for (path, g), g1, p, p1 in zip(leaves_with_paths(grads), ref["grads"],
                                    leaves(state["params"]), ref["params"]):
        rel = ((g.float() - g1.float()).norm()
               / g1.float().norm().clamp(min=1e-30)).item()
        if rel >= grad_rel:
            grad_rel, grad_leaf = rel, "/".join(path)
        diff = (p.detach().float() - p1.float()).abs()
        worst = max(worst, diff.max().item())
        apart += int((diff > 1e-3 * lr).sum())
        total += diff.numel()
    loss, gn = float(m["loss"]), float(m["grad_norm"])
    out = {"loss": loss, "ref_loss": ref["loss"], "grad_norm": gn,
           "ref_grad_norm": ref["grad_norm"],
           "loss_rel": abs(loss - ref["loss"]) / abs(ref["loss"]),
           "grad_norm_rel": abs(gn - ref["grad_norm"]) / ref["grad_norm"],
           "grad_rel": grad_rel, "grad_rel_leaf": grad_leaf,
           "params_apart": apart / total,
           "max_param_diff": worst, "lr": lr, "launches": launches,
           "staged_bytes": staged, "step_s": ms / 1e3}
    del state, grads
    torch.cuda.empty_cache()
    return out


def _dist_train_setup(rules="default"):
    import dataclasses
    from repro_torch.configs.registry import get_model_config, get_run_config
    cfg = dataclasses.replace(get_model_config(ARCH),
                              n_layers=DIST_TRAIN["layers"])
    run = get_run_config(ARCH, rules_name=rules, warmup_steps=0,
                         total_steps=10)
    return cfg, run, _dist_batch(cfg, DIST_TRAIN["B"], DIST_TRAIN["S"], 31)


def _dist_phase_train(rank, mesh, key, rules="default"):
    """[dist:train] on ``mesh`` under ``rules``: llama at full width, 4
    layers, the sound step and the planted fault ``key``'s, each against
    the one-device step."""
    cfg, run, batch = _dist_train_setup(rules)
    ref = _dist_reference(cfg, run, mesh, batch, 5)
    return {"sound": _dist_train_case(cfg, run, mesh, batch, 5, ref),
            "fault": _dist_train_case(cfg, run, mesh, batch, 5, ref, key)}


def _dist_phase_train_ssm(rank, mesh, arch):
    """[dist:train-mamba2] / [dist:train-zamba2] on ``mesh`` under the
    arch's own ``default``: full width, DIST_SSM_TRAIN's depth, the sound
    step and the planted fault ``DIST_FAULTS[<family>]``'s, each against
    the one-device step."""
    import dataclasses
    from repro_torch.configs.registry import get_model_config, get_run_config
    cfg = dataclasses.replace(get_model_config(arch),
                              n_layers=DIST_SSM_TRAIN["layers"][arch])
    run = get_run_config(arch, warmup_steps=0, total_steps=10)
    batch = _dist_batch(cfg, DIST_SSM_TRAIN["B"], DIST_SSM_TRAIN["S"], 35)
    key = "mamba2" if arch == SSM_ARCH else "zamba2"
    ref = _dist_reference(cfg, run, mesh, batch, 9)
    return {"sound": _dist_train_case(cfg, run, mesh, batch, 9, ref),
            "fault": _dist_train_case(cfg, run, mesh, batch, 9, ref, key)}


def _dist_reduced_train():
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_model_config, get_run_config
    cfg = reduced(get_model_config(ARCH), n_heads=4, n_kv_heads=2)
    run = get_run_config(ARCH, rules_name="default", warmup_steps=0,
                         compute_dtype="float32", remat="none",
                         logits_chunk=64)
    return cfg, run


def _dist_phase_elastic(rank, mesh, ckpt_dir):
    """Reduced llama, f32, on (2, 1): two steps, a checkpoint (saved
    full), and the third step straight through."""
    import torch
    from repro_torch.ckpt import checkpoint
    from repro_torch.models.layers import Ctx
    from repro_torch.sharding import RULE_SETS
    from repro_torch.train.step import (init_state, make_train_step,
                                        state_specs)
    cfg, run = _dist_reduced_train()
    ctx = Ctx(run, "cuda", RULE_SETS["default"], mesh)
    state = init_state(cfg, run, torch.Generator(device="cuda").manual_seed(6),
                       "cuda", ctx).tree()
    step = make_train_step(cfg, run, ctx)
    d = mesh.coord("data")
    for i in range(2):
        b = _dist_batch(cfg, 4, 256, 40 + i)
        state, _ = step(state, {k: v[2 * d:2 * d + 2] for k, v in b.items()})
    checkpoint.save(state, 2, ckpt_dir, shardings=state_specs(cfg, run, ctx),
                    mesh=mesh)
    b = _dist_batch(cfg, 4, 256, 42)
    _, m = step(state, {k: v[2 * d:2 * d + 2] for k, v in b.items()})
    return {"loss": float(m["loss"])}


def dist_elastic_restore(ckpt_dir):
    """The restart on ``plan_mesh_shape(1, model_parallel=1)``'s (1, 1),
    in this process (a mesh of one rank needs no process group)."""
    import torch
    from repro_torch.ckpt import checkpoint
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.layers import Ctx
    from repro_torch.runtime.supervisor import plan_mesh_shape
    from repro_torch.sharding import RULE_SETS
    from repro_torch.train.step import (init_state, make_train_step,
                                        state_specs)
    from repro_torch.tree import leaves
    shape, names = plan_mesh_shape(1, model_parallel=1)
    mesh = Mesh(shape, names, rank=0, backend="gloo")
    cfg, run = _dist_reduced_train()
    ctx = Ctx(run, "cuda", RULE_SETS["default"], mesh)
    state = init_state(cfg, run, torch.Generator(device="cuda").manual_seed(0),
                       "cuda", ctx).tree()
    restored, start = checkpoint.restore(
        ckpt_dir, state, shardings=state_specs(cfg, run, ctx), mesh=mesh)
    with torch.no_grad():
        for dst, src in zip(leaves(state), leaves(restored)):
            dst.copy_(src)
    b = _dist_batch(cfg, 4, 256, 40 + start)
    _, m = make_train_step(cfg, run, ctx)(state, b)
    return {"shape": shape, "start": start, "loss": float(m["loss"])}


def _dist_moe_layer(cfg, run, mesh):
    """One MoE layer of olmoe at full width, bf16, with a capacity that
    drops nothing: expert parallelism over the bf16 wire against the
    local path's output on the same rows (every rank computing the whole
    layer), entry by entry; the planted fault (the all-to-all's order
    reversed) flagged; and q_rel, the int8 wire's output against the
    bf16 wire's."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models.layers import Ctx
    from repro_torch.sharding import RULE_SETS
    ctx0 = Ctx(run, "cuda")
    ctx = Ctx(run, "cuda", RULE_SETS["default"], mesh)
    decls = L.moe_decls(cfg)
    gen = torch.Generator(device="cuda").manual_seed(71)
    from repro_torch.models.params import init_params
    from repro_torch.sharding import local_slice
    from repro_torch.tree import leaves_with_paths
    full = init_params(decls, gen, "cuda")
    specs = dict(leaves_with_paths(_dist_param_specs(cfg, ctx, decls)))
    mine = {k: local_slice(mesh, specs[(k,)], v).clone()
            for k, v in full.items()}
    g = torch.Generator(device="cuda").manual_seed(72)
    x = (torch.randn((DIST_MOE["B"], DIST_MOE["S"], cfg.d_model),
                     generator=g, device="cuda") * 0.3).to(torch.bfloat16)
    with torch.no_grad():
        want = L.apply_moe(ctx0, cfg, full, x)[0]
        ys = {a: L.apply_moe(Ctx(run.replace(moe_a2a_dtype=a), "cuda",
                                 RULE_SETS["default"], mesh), cfg, mine,
                             x)[0] for a in ("bf16", "int8")}
        with _fault("olmoe"):
            bad = L.apply_moe(ctx, cfg, mine, x)[0]
    ratio = _entry_ratio("bfloat16", ys["bf16"], want)
    q_rel = ((ys["int8"].float() - ys["bf16"].float()).norm()
             / ys["bf16"].float().norm()).item()
    return {"ep_worst_over_limit": ratio.max().item(),
            "ep_max_abs_diff": (ys["bf16"].float() - want.float()).abs()
            .max().item(),
            "fault_share_flagged": (_entry_ratio("bfloat16", bad, want) > 1)
            .float().mean().item(), "q_rel": q_rel}


def _dist_phase_olmoe(rank, mesh):
    """[dist:train-olmoe] on (1, 2): 2 layers of olmoe at full width with
    a capacity that drops nothing, expert parallelism over the bf16 wire,
    the int8 wire and the planted fault, each step against the one-device
    step; one MoE layer's output, EP against the local path; then decode
    steps of all 16 layers under the mesh (experts sharded; a sequence of
    one token takes the branch without expert parallelism)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.serving.engine import make_decode_step
    from repro_torch.sharding import RULE_SETS, collectives as C
    full_cfg = get_model_config(MOE_ARCH)
    cfg = dataclasses.replace(
        full_cfg, n_layers=DIST_MOE["layers"],
        capacity_factor=full_cfg.n_experts / full_cfg.top_k)
    batch = _dist_batch(cfg, DIST_MOE["train_B"], DIST_MOE["S"], 51)
    out, ref = {}, None
    for arm, a2a, fault in (("bf16", "bf16", None), ("int8", "int8", None),
                            ("fault", "bf16", "olmoe")):
        run = get_run_config(MOE_ARCH, rules_name="default", warmup_steps=0,
                             total_steps=10, moe_a2a_dtype=a2a)
        if ref is None:         # the wire is no part of the one-device step
            ref = _dist_reference(cfg, run, mesh, batch, 7)
        out[arm] = _dist_train_case(cfg, run, mesh, batch, 7, ref, fault)
    out["layer"] = _dist_moe_layer(cfg, get_run_config(MOE_ARCH), mesh)
    torch.cuda.empty_cache()
    # the decode step of all 16 layers: experts sharded, no EP (S = 1)
    run = get_run_config(MOE_ARCH, rules_name="default")
    ctx0 = Ctx(run, "cuda")
    ctx = Ctx(run, "cuda", RULE_SETS["default"], mesh)
    B, S = 8, 256
    toks = np.random.default_rng(61).integers(0, full_cfg.vocab,
                                              (DIST_MOE["decode_steps"], B))
    ref_logits = []
    if rank == 0:
        params = _dist_draw(full_cfg, ctx0, 8)
        cache = lm.init_cache(ctx0, full_cfg, B, S)
        step = make_decode_step(full_cfg, run, ctx0)
        with torch.no_grad():
            for i in range(DIST_MOE["decode_steps"]):
                cache, lg = step(params, cache,
                                 torch.from_numpy(toks[i][:, None]).cuda(), i)
                ref_logits.append(lg.float().cpu())
        del params, cache
        torch.cuda.empty_cache()
    dist.barrier()
    params = _dist_draw(full_cfg, ctx, 8, _dist_param_specs(full_cfg, ctx),
                        mesh)
    cache = lm.shard_cache(ctx, full_cfg, lm.init_cache(ctx0, full_cfg, B, S))
    step = make_decode_step(full_cfg, run, ctx)
    tfa.reset_launch_counts()
    C.reset_staged()
    diffs, agree = [], 0
    with torch.no_grad():
        for i in range(DIST_MOE["decode_steps"]):
            cache, lg = step(params, cache,
                             torch.from_numpy(toks[i][:, None]).cuda(), i)
            lg = lg.float().cpu()
            if not torch.isfinite(lg).all() or lg.shape != (
                    B, full_cfg.vocab_padded):
                raise AssertionError(f"olmoe decode under the mesh: "
                                     f"{lg.shape}")
            if rank == 0:
                diffs.append((lg - ref_logits[i]).abs().max().item())
                agree += int((lg.argmax(-1) == ref_logits[i].argmax(-1)).sum())
    out["decode"] = {"launches": _dist_launches(tfa),
                     "staged_bytes": C.staged_total(), "layers":
                     full_cfg.n_layers, "steps": DIST_MOE["decode_steps"],
                     "B": B}
    if rank == 0:
        out["decode"].update(max_abs_logit_diff=max(diffs),
                             argmax_equal=agree,
                             argmax_total=B * DIST_MOE["decode_steps"])
    return out


#: [dist:prefill]: the serving step functions on the mesh (item 14b (d)).
#: Eight prompts of 1100-1900 rows, each prefilled on the mesh as one
#: chunk into its slot of a 2048-row cache, so every chunk crosses the
#: 1024-row slice edge (the write's row-level clip, the log-sum-exp
#: combine over a whole chunk), then DIST_PREFILL["steps"] per-slot decode
#: steps teacher-forced by the unsharded stream.  Arms: (tag, dtype, rules,
#: arch, layers): llama at full width, 4 of 28 layers in bf16 under its
#: serve rules (seqparallel: each chunk gathers the layers' weights whole
#: through the host) and default,
#: 2 layers in f32 under default (streams gated); zamba2 f32 at 7 layers
#: under default (the Mamba-2 prefill on each rank's heads, the shared
#: block's q_delta path)
DIST_PREFILL = dict(B=8, lens=(1100, 1900), max_seq=2048, steps=4,
                    arms=(("bf16-seqpar", "bfloat16", "seqparallel", ARCH, 4),
                          ("bf16-default", "bfloat16", "default", ARCH, 4),
                          ("f32-default", "float32", "default", ARCH, 2),
                          ("zamba2-f32", "float32", "default", HYBRID_ARCH,
                           7)))
#: the planted faults of [dist:prefill], each run on the bf16 default
#: arm's first DIST_PREFILL_FAULT_PROMPTS prompts, whose last logits must
#: then differ from one device's by at least DIST_BF16_DRIFT
DIST_PREFILL_FAULTS = {
    "clip": "the straddling chunk written with the whole-slot rule "
            "(dropped on both ranks)",
    "combine": "the log-sum-exp combine without the other rank's slice"}
DIST_PREFILL_FAULT_PROMPTS = 2
#: [dist:prefill]'s gate in bf16: the reference's bf16 bound on decode
#: logits (max|diff| < 0.15, ``repro``'s tests/test_serving.py:63, "bf16
#: cache drift"), on logits and cache rows alike.  The per-entry rule
#: (ATTN_RTOL) holds one kernel to its plain version; four layers whose
#: row-parallel sums round in another order on the mesh drift past it on
#: entries near zero (read 276-587x it, max|diff| 0.031 on the logits, on
#: an NVIDIA H100 80GB HBM3 at 700 W).  f32 arms keep the per-entry rule.
DIST_BF16_DRIFT = 0.15
#: [dist:serve-engine]: the eager ServeEngine on both ranks against one
#: device's eager engine, llama f32 at 2 layers under default (under
#: seqparallel every step gathers the weights whole through the host,
#: ~0.4 GB a step at f32; tests/test_torch_distributed.py runs the engine
#: under seqparallel on the CPU), dense and paged, 16 requests
DIST_ENGINE = dict(requests=16, lens=(100, 600), new=16, batch_size=8,
                   max_seq=2048, prefill_chunk=256, decode_chunk=8,
                   block_size=16, layers=2)


def _dist_prompts(cfg, seed, B, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, int(n)).tolist()
            for n in rng.integers(lens[0], lens[1] + 1, B)]


def _dist_worst(got, want, dtype):
    """The worst entry's |got - want| over its per-entry limit."""
    got, want = got.float(), want.float()
    limit = (ATTN_RTOL[dtype] * want.abs()
             + ATTN_ATOL * want.abs().max())
    return ((got - want).abs() / limit).max().item()


def _dist_prefill_chunks(step, params, cache, prompts, idx=None):
    """Each prompt (its first ``idx`` of them) prefilled as one chunk into
    its slot; returns (their last logits (B, V), ms per chunk)."""
    import torch
    logits, ms = [], []
    with torch.no_grad():
        for b, p in enumerate(prompts[:idx]):
            tok = torch.tensor([p], dtype=torch.int64, device="cuda")
            (_, lg), t = _dist_sync_ms(lambda: step(params, cache, tok, b, 0))
            logits.append(lg)
            ms.append(t)
    return torch.cat(logits), ms


def _dist_prefill_run(arm, dtype, rules, arch, layers, seed, mesh, rank):
    """One [dist:prefill] arm on this rank: the prompts prefilled on one
    device (each rank its own copy, so each holds the unsharded cache its
    slice is compared with), rank 0 also the unsharded decode steps (the
    other waits); then the prefill on the mesh, chunk by chunk, and the
    per-slot decode steps teacher-forced by rank 0's stream.  Returns the
    numbers rank 0 reports."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import shard_params
    from repro_torch.serving.engine import (make_decode_step,
                                            make_prefill_chunk_step)
    from repro_torch.sharding import RULE_SETS, collectives as C
    cfg = dataclasses.replace(get_model_config(arch), n_layers=layers)
    run = get_run_config(arch, rules_name=rules, compute_dtype=dtype)
    ctx0 = Ctx(run, "cuda")
    ctx = Ctx(run, "cuda", RULE_SETS[rules], mesh)
    B, S, steps = DIST_PREFILL["B"], DIST_PREFILL["max_seq"], \
        DIST_PREFILL["steps"]
    prompts = _dist_prompts(cfg, seed, B, DIST_PREFILL["lens"])
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    params = _dist_draw(cfg, ctx0, seed)
    cache = lm.init_cache(ctx0, cfg, B, S)
    want, full_ms = _dist_prefill_chunks(make_prefill_chunk_step(
        cfg, run, ctx0), params, cache, prompts)
    want_shard = lm.shard_cache(ctx, cfg, cache)
    stream = torch.zeros((steps, B), dtype=torch.int64)
    full_logits = []
    if rank == 0:
        step = make_decode_step(cfg, run, ctx0)
        tok = want.argmax(-1)
        with torch.no_grad():
            for i in range(steps):
                stream[i] = tok.cpu()
                cache, lg = step(params, cache, tok[:, None],
                                 (lens + i).cuda())
                full_logits.append(lg.float().cpu())
                tok = lg.argmax(-1)
    dist.broadcast(stream, src=0)
    del cache
    sp = shard_params(params, _dist_param_specs(cfg, ctx), mesh)
    del params
    torch.cuda.empty_cache()
    shard = lm.init_cache(ctx, cfg, B, S)
    tfa.reset_launch_counts()
    C.reset_staged()
    got, ms = _dist_prefill_chunks(make_prefill_chunk_step(cfg, run, ctx),
                                   sp, shard, prompts)
    staged_prefill = C.staged_total()
    name = "float32" if dtype == "float32" else "bfloat16"
    out = {"prefill_ms_per_chunk": float(np.median(ms)),
           "unsharded_ms_per_chunk": float(np.median(full_ms)),
           "staged_gb_per_chunk": staged_prefill / len(prompts) / 1e9,
           "rows": [len(p) for p in prompts],
           "logits_worst_over_limit": _dist_worst(got, want, name),
           "logits_max_abs_diff": (got.float() - want.float()).abs()
           .max().item()}
    pairs = []
    for key, leaves in want_shard.items():
        for k, w in leaves.items():
            if key == "mamba":
                # the recurrent state: the chunk's final state by heads
                pairs.append((shard[key][k], w))
                continue
            for b, n in enumerate(out["rows"]):
                r0 = mesh.coord("model") * w.shape[2]
                hi = max(0, min(n - r0, w.shape[2]))
                if hi:
                    pairs.append((shard[key][k][:, b, :hi], w[:, b, :hi]))
    out["cache_worst_over_limit"] = max(_dist_worst(a, w, name)
                                        for a, w in pairs)
    out["cache_max_abs_diff"] = max((a.float() - w.float()).abs().max()
                                    .item() for a, w in pairs)
    del want_shard, pairs
    step = make_decode_step(cfg, run, ctx)
    equal, worst, dec_ms = torch.ones(B, dtype=torch.bool), 0.0, []
    diff = 0.0
    with torch.no_grad():
        for i in range(steps):
            tok = stream[i].cuda()[:, None]
            (shard, lg), t = _dist_sync_ms(
                lambda: step(sp, shard, tok, (lens + i).cuda()))
            dec_ms.append(t)
            if rank == 0:
                worst = max(worst, _dist_worst(lg.float().cpu(),
                                               full_logits[i], name))
                diff = max(diff, (lg.float().cpu() - full_logits[i]).abs()
                           .max().item())
                equal &= lg.argmax(-1).cpu() == full_logits[i].argmax(-1)
                if not torch.isfinite(lg).all():
                    raise AssertionError("[dist:prefill] non-finite logits")
    out.update(launches=_dist_launches(tfa),
               staged_bytes=C.staged_total(), staged_prefill=staged_prefill,
               decode_ms_per_step=float(np.median(dec_ms)),
               decode_worst_over_limit=worst, decode_max_abs_diff=diff,
               streams_equal=int(equal.sum()), streams=B)
    if arm == "bf16-default":
        out["faults"] = _dist_prefill_faults(cfg, run, ctx, sp, prompts,
                                             want, name)
    return out


def _dist_prefill_faults(cfg, run, ctx, params, prompts, want, dtype):
    """The planted faults of [dist:prefill] on the first prompts, each on
    a fresh cache: the worst logit entry over its limit (must be > 1)."""
    import types
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.serving.engine import make_prefill_chunk_step
    n = DIST_PREFILL_FAULT_PROMPTS

    def whole_slot(*args, clip_rows=False, **kw):
        return ops.kv_cache_update(*args, **kw)

    out = {}
    for key, fault in (
            ("clip", _swapped(L, "ops", types.SimpleNamespace(
                **{**vars(ops), "kv_cache_update": whole_slot}))),
            ("combine", _planted(L, psum=lambda x, axes, mesh: x.clone()))):
        cache = lm.init_cache(ctx, cfg, DIST_PREFILL["B"],
                              DIST_PREFILL["max_seq"])
        with fault:
            got, _ = _dist_prefill_chunks(make_prefill_chunk_step(
                cfg, run, ctx), params, cache, prompts, n)
        out[key] = {"worst_over_limit": _dist_worst(got, want[:n], dtype),
                    "max_abs_diff": (got.float() - want[:n].float()).abs()
                    .max().item()}
        del cache
    return out


def _dist_phase_prefill(rank, mesh):
    """[dist:prefill] on mesh (1, 2): every arm of DIST_PREFILL."""
    import torch
    out = {}
    for i, (arm, dtype, rules, arch, layers) in enumerate(
            DIST_PREFILL["arms"]):
        out[arm] = _dist_prefill_run(arm, dtype, rules, arch, layers, 41 + i,
                                     mesh, rank)
        torch.cuda.empty_cache()
    return out


def _dist_phase_engine(rank, mesh):
    """[dist:serve-engine] on mesh (1, 2): the eager engine on both ranks
    over their shards, dense and paged, and on rank 0 one device's eager
    engine over the same weights and requests."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import shard_params
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.sharding import RULE_SETS, collectives as C
    E = DIST_ENGINE
    cfg = dataclasses.replace(get_model_config(ARCH), n_layers=E["layers"])
    run = get_run_config(ARCH, rules_name="default", compute_dtype="float32")
    ctx0 = Ctx(run, "cuda")
    ctx = Ctx(run, "cuda", RULE_SETS["default"], mesh)
    params = _dist_draw(cfg, ctx0, 51)
    prompts = _dist_prompts(cfg, 52, E["requests"], E["lens"])
    kw = {k: E[k] for k in ("batch_size", "max_seq", "prefill_chunk",
                            "decode_chunk")}

    def serve(c, p, paged):
        eng = ServeEngine(cfg, run, c, p, eager=True, paged=paged,
                          block_size=E["block_size"], **kw)
        reqs = [Request(uid=i, prompt=q, max_new_tokens=E["new"])
                for i, q in enumerate(prompts)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.generate(reqs)
        torch.cuda.synchronize()
        return {r.uid: list(r.generated) for r in done}, \
            time.perf_counter() - t0, eng.sync_count

    out = {}
    for mode, paged in (("dense", False), ("paged", True)):
        want = serve(ctx0, params, paged)[0] if rank == 0 else None
        dist.barrier()
        sp = shard_params(params, _dist_param_specs(cfg, ctx), mesh)
        tfa.reset_launch_counts()
        C.reset_staged()
        got, secs, syncs = serve(ctx, sp, paged)
        out[mode] = {"launches": _dist_launches(tfa), "seconds": secs,
                     "staged_bytes": C.staged_total(), "host_syncs": syncs,
                     "tokens": E["requests"] * E["new"]}
        if rank == 0:
            out[mode]["streams_equal"] = sum(got[u] == want[u] for u in want)
        del sp
        torch.cuda.empty_cache()
    return out


def dist_report_prefill(ranks, secs):
    """[dist:prefill] and [dist:serve-engine]."""
    out, failed = {}, []
    card = _smi_line()
    res = [r["prefill"] for r in ranks]
    for arm, dtype, rules, arch, layers in DIST_PREFILL["arms"]:
        r0, r1 = res[0][arm], res[1][arm]
        launches = [r[arm]["launches"] for r in res]
        _dist_need(launches, ("cache_update", "flash_decode")
                   + (("ssd",) if arch == HYBRID_ARCH else ()),
                   "dist:prefill")
        full = 38 if arch == HYBRID_ARCH else 28
        worst = max(r0["cache_worst_over_limit"],
                    r1["cache_worst_over_limit"])
        cdiff = max(r0["cache_max_abs_diff"], r1["cache_max_abs_diff"])
        gate = ("the per-entry rule" if dtype == "float32" else
                f"bf16: max|diff| < {DIST_BF16_DRIFT}")
        print(f"[dist:prefill] {arch} {arm}, {layers} of {full} layers, "
              f"rules {rules}, mesh (1, 2) over gloo (two ranks sharing the "
              f"card; collectives staged through the host, not a "
              f"multi-card time): {DIST_PREFILL['B']} prompts of "
              f"{min(r0['rows'])}-{max(r0['rows'])} rows, each one chunk "
              f"into a {DIST_PREFILL['max_seq']}-row cache cut at "
              f"{DIST_PREFILL['max_seq'] // 2}: last logits worst entry / "
              f"its limit {r0['logits_worst_over_limit']:.3f} (max|diff| "
              f"{r0['logits_max_abs_diff']:.3e}), cache rows worst "
              f"{worst:.3f} (max|diff| {cdiff:.3e}; both ranks' slices); "
              f"gate {gate}; ms per chunk sharded "
              f"{r0['prefill_ms_per_chunk']:.1f} / "
              f"{r1['prefill_ms_per_chunk']:.1f} by rank (unsharded "
              f"{r0['unsharded_ms_per_chunk']:.1f}), "
              f"{r0['staged_gb_per_chunk']:.3f} / "
              f"{r1['staged_gb_per_chunk']:.3f} GB staged a rank a chunk; "
              f"{DIST_PREFILL['steps']} per-slot decode steps "
              f"teacher-forced: worst {r0['decode_worst_over_limit']:.3f} "
              f"(max|diff| {r0['decode_max_abs_diff']:.3e}), "
              f"{r0['streams_equal']}/{r0['streams']} greedy streams equal, "
              f"{r0['decode_ms_per_step']:.1f} ms a step; launches by rank "
              f"{launches}; {card}", flush=True)
        out[arm] = {"rank0": r0, "rank1": r1, "launches": launches}
        for what, x, d in (
                ("last logits", r0["logits_worst_over_limit"],
                 r0["logits_max_abs_diff"]),
                ("cache rows", worst, cdiff),
                ("decode logits", r0["decode_worst_over_limit"],
                 r0["decode_max_abs_diff"])):
            if not (x <= 1.0 if dtype == "float32" else d < DIST_BF16_DRIFT):
                failed.append(f"[dist:prefill] {arm} {what} apart: {x} of "
                              f"the per-entry rule, max|diff| {d}")
        if dtype == "float32" and r0["streams_equal"] != DIST_PREFILL["B"]:
            failed.append(f"[dist:prefill] {arm} streams differ from the "
                          f"unsharded ones")
    faults = res[0]["bf16-default"]["faults"]
    for key, x in faults.items():
        print(f"[dist:prefill] planted fault ({DIST_PREFILL_FAULTS[key]}), "
              f"{DIST_PREFILL_FAULT_PROMPTS} prompts, bf16 default: last "
              f"logits max|diff| {x['max_abs_diff']:.3g} (must be >= "
              f"{DIST_BF16_DRIFT}), worst entry / its limit "
              f"{x['worst_over_limit']:.3g}", flush=True)
        if not x["max_abs_diff"] >= DIST_BF16_DRIFT:
            failed.append(f"[dist:prefill] planted fault {key!r} passes: "
                          f"{x}")
    out["faults"] = faults
    print(f"[dist:prefill] {secs['prefill']:.1f} s for the phase",
          flush=True)
    res = [r["engine"] for r in ranks]
    E = DIST_ENGINE
    for mode in ("dense", "paged"):
        r0, r1 = res[0][mode], res[1][mode]
        launches = [r[mode]["launches"] for r in res]
        names = (("cache_update_paged", "flash_decode_paged") if
                 mode == "paged" else ("cache_update", "flash_decode"))
        _dist_need(launches, names, "dist:serve-engine")
        print(f"[dist:serve-engine] {ARCH} f32, {E['layers']} layers, rules "
              f"default, {mode}: the eager ServeEngine on both ranks of mesh "
              f"(1, 2) over gloo (not a multi-card time), {E['requests']} "
              f"requests of {E['lens'][0]}-{E['lens'][1]} rows x "
              f"{E['new']} tokens, batch {E['batch_size']}: "
              f"{r0['streams_equal']}/{E['requests']} streams equal one "
              f"device's eager engine; {r0['seconds']:.2f} / "
              f"{r1['seconds']:.2f} s by rank, "
              f"{r0['tokens'] / r0['seconds']:.1f} tok/s, "
              f"{r0['host_syncs']} host syncs, "
              f"{r0['staged_bytes'] / 1e9:.3f} GB staged a rank; launches "
              f"by rank {launches}; {card}", flush=True)
        out["engine_" + mode] = {"rank0": r0, "rank1": r1,
                                 "launches": launches}
        if r0["streams_equal"] != E["requests"]:
            failed.append(f"[dist:serve-engine] {mode}: "
                          f"{r0['streams_equal']}/{E['requests']} streams "
                          f"equal")
    print(f"[dist:serve-engine] {secs['engine']:.1f} s for the phase",
          flush=True)
    return out, failed


def dist_rank_all(rank, world, ckpt_dir, only=None):
    """Every [dist:*] phase on this rank (those named in ``only``, if
    given), in one process: mesh (1, 2) and (2, 1) over the same two ranks
    (two sets of groups), each phase's memory released before the
    next."""
    import torch
    import torch.distributed as dist
    _dist_rank_setup()
    from repro_torch.launch.mesh import make_mesh_for
    tp = make_mesh_for((1, 2), ("data", "model"), device_type="cpu")
    dp = make_mesh_for((2, 1), ("data", "model"), device_type="cpu")
    out, secs = {}, {}
    for name, fn in (("decode", lambda: _dist_phase_decode(rank, tp)),
                     ("decode_seqpar",
                      lambda: _dist_phase_decode_seqpar(rank, tp)),
                     ("decode_ssm", lambda: _dist_phase_decode_ssm(rank, tp)),
                     ("train_mamba2", lambda: _dist_phase_train_ssm(
                         rank, tp, SSM_ARCH)),
                     ("train_zamba2", lambda: _dist_phase_train_ssm(
                         rank, tp, HYBRID_ARCH)),
                     ("train_1x2", lambda: _dist_phase_train(rank, tp, "1x2")),
                     ("train_2x1", lambda: _dist_phase_train(rank, dp, "2x1")),
                     ("train_seqpar", lambda: _dist_phase_train(
                         rank, tp, "seqpar", "seqparallel")),
                     ("train_fsdp", lambda: _dist_phase_train(
                         rank, dp, "fsdp", "fsdp")),
                     ("elastic", lambda: _dist_phase_elastic(rank, dp,
                                                             ckpt_dir)),
                     ("olmoe", lambda: _dist_phase_olmoe(rank, tp)),
                     ("prefill", lambda: _dist_phase_prefill(rank, tp)),
                     ("engine", lambda: _dist_phase_engine(rank, tp))):
        if only is not None and name not in only:
            continue
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.empty_cache()
        dist.barrier()
        secs[name] = time.perf_counter() - t0
    out["seconds"] = secs
    return out


def dist_rank_reduced(rank, world):
    """Reduced llama on the card, f32, mesh (1, 2): two sharded decode
    steps against the unsharded ones (each rank computes both) and one
    sharded train step against the one-device step, with each part's
    launches.  ``tests/test_torch_distributed_card.py`` runs it."""
    import torch
    _dist_rank_setup()
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import shard_params
    from repro_torch.serving.engine import make_decode_step, make_prefill_step
    from repro_torch.sharding import RULE_SETS
    mesh = make_mesh_for((1, 2), ("data", "model"), device_type="cpu")
    cfg, run = _dist_reduced_train()
    ctx0 = Ctx(run, "cuda")
    ctx = Ctx(run, "cuda", RULE_SETS["default"], mesh)
    params = _dist_draw(cfg, ctx0, 12)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 40))).cuda()
    with torch.no_grad():
        cache, _ = make_prefill_step(cfg, run, ctx0, 128)(
            params, {"tokens": toks[:, :32]})
        shard = lm.shard_cache(ctx, cfg, cache)
        sharded = shard_params(params, _dist_param_specs(cfg, ctx), mesh)
        full_step = make_decode_step(cfg, run, ctx0)
        mesh_step = make_decode_step(cfg, run, ctx)
        tfa.reset_launch_counts()
        got = [mesh_step(sharded, shard, toks[:, 32 + i:33 + i], 32 + i)[1]
               for i in range(2)]
        decode_launches = _dist_launches(tfa)
        want = [full_step(params, cache, toks[:, 32 + i:33 + i], 32 + i)[1]
                for i in range(2)]
        diffs = [((g - w).abs().max() / w.abs().max()).item()
                 for g, w in zip(got, want)]
    batch = _dist_batch(cfg, 2, 128, 14)
    train = _dist_train_case(cfg, run, mesh, batch, 15,
                             _dist_reference(cfg, run, mesh, batch, 15))
    return {"decode_rel_diff": max(diffs), "decode_launches": decode_launches,
            **{k: train[k] for k in ("loss_rel", "grad_norm_rel", "grad_rel",
                                     "params_apart", "launches")}}


def dist_rank_reduced_serve(rank, world):
    """Reduced llama on the card, f32, mesh (1, 2), under ``default`` and
    ``seqparallel``: a 40-row prompt prefilled into slot 1 of a 64-row
    cache in chunks of 24 and 16 rows (the second straddling the slices'
    edge at 32), a per-slot decode step with a done lane, the same chunks
    through a paged pool, and the eager engine over three requests, each
    against one device; with the launches of the sharded parts.
    ``tests/test_torch_distributed_card.py`` runs it."""
    import torch
    _dist_rank_setup()
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import shard_params
    from repro_torch.serving.engine import (Request, ServeEngine,
                                            make_decode_step,
                                            make_prefill_chunk_step,
                                            make_prefill_chunk_step_paged)
    from repro_torch.sharding import RULE_SETS
    mesh = make_mesh_for((1, 2), ("data", "model"), device_type="cpu")
    cfg, run = _dist_reduced_train()
    ctx0 = Ctx(run, "cuda")
    params = _dist_draw(cfg, ctx0, 12)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 41))).cuda()
    index = torch.tensor([40, 64], dtype=torch.int32, device="cuda")

    def steps(ctx, p):
        out = {}
        with torch.no_grad():
            cache = lm.init_cache(ctx, cfg, 2, 64)
            chunk = make_prefill_chunk_step(cfg, run, ctx)
            for j, (o, n) in enumerate(((0, 24), (24, 16))):
                _, out[f"chunk{j}"] = chunk(p, cache, toks[1:, o:o + n], 1, o)
            _, out["decode"] = make_decode_step(cfg, run, ctx)(
                p, cache, toks[:, 40:], index)
            pc = lm.init_paged_cache(ctx, cfg, 2, 64, 16)
            pc["block_tables"].copy_(torch.tensor([[4, 5, 6, 7],
                                                   [3, 0, 2, 1]]))
            paged = make_prefill_chunk_step_paged(cfg, run, ctx)
            for j, (o, n) in enumerate(((0, 24), (24, 16))):
                _, out[f"paged{j}"] = paged(p, pc, toks[1:, o:o + n], 1, o)
            eng = ServeEngine(cfg, run, ctx, p, batch_size=2, max_seq=64,
                              prefill_chunk=16, decode_chunk=4, eager=True)
            done = eng.generate([Request(uid=i, prompt=toks[0, :n].tolist(),
                                         max_new_tokens=6)
                                 for i, n in enumerate((40, 17, 9))])
            out["streams"] = {r.uid: list(r.generated) for r in done}
        return out

    want = steps(ctx0, params)
    res = {}
    for rules in ("default", "seqparallel"):
        ctx = Ctx(run.replace(rules_name=rules), "cuda", RULE_SETS[rules],
                  mesh)
        sp = shard_params(params, _dist_param_specs(cfg, ctx), mesh)
        tfa.reset_launch_counts()
        got = steps(ctx, sp)
        res[rules] = {
            "rel_diff": max(((got[k] - want[k]).abs().max()
                             / want[k].abs().max()).item()
                            for k in want if k != "streams"),
            "streams_equal": got["streams"] == want["streams"],
            "launches": _dist_launches(tfa)}
    return res


def dist_rank_reduced_rules(rank, world):
    """Reduced llama on the card, f32: one train step under
    ``seqparallel`` on mesh (1, 2) and one under ``fsdp`` on (2, 1), each
    against the one-device step, with its launches.
    ``tests/test_torch_distributed_card.py`` runs it."""
    _dist_rank_setup()
    from repro_torch.launch.mesh import make_mesh_for
    out = {}
    for rules, shape in (("seqparallel", (1, 2)), ("fsdp", (2, 1))):
        mesh = make_mesh_for(shape, ("data", "model"), device_type="cpu")
        cfg, run = _dist_reduced_train()
        run = run.replace(rules_name=rules)
        batch = _dist_batch(cfg, 2, 128, 16)
        out[rules] = _dist_train_case(
            cfg, run, mesh, batch, 17,
            _dist_reference(cfg, run, mesh, batch, 17))
    return out


def dist_rank_reduced_ssm(rank, world):
    """Reduced mamba2 and zamba2 on the card, f32, mesh (1, 2) under their
    ``default`` (the SSM state and head sizes raised to 32, the ``ssd``
    kernel's contract): for each one train step against the one-device
    step, and the step under its planted fault (``DIST_FAULTS``), with
    their launches.  ``tests/test_torch_distributed_card.py`` runs it."""
    _dist_rank_setup()
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.launch.mesh import make_mesh_for
    mesh = make_mesh_for((1, 2), ("data", "model"), device_type="cpu")
    out = {}
    for arch, key in ((SSM_ARCH, "mamba2"), (HYBRID_ARCH, "zamba2")):
        cfg = reduced(get_model_config(arch), ssm_state=32, ssm_headdim=32)
        run = get_run_config(arch, rules_name="default", warmup_steps=0,
                             compute_dtype="float32", remat="none",
                             logits_chunk=64)
        batch = _dist_batch(cfg, 2, 128, 18)
        ref = _dist_reference(cfg, run, mesh, batch, 19)
        out[key] = {"sound": _dist_train_case(cfg, run, mesh, batch, 19, ref),
                    "fault": _dist_train_case(cfg, run, mesh, batch, 19, ref,
                                              key)}
    return out


# --- the phases (in the calling process, which spawns the ranks)

def _dist_need(launches_by_rank, names, tag):
    for r, got in enumerate(launches_by_rank):
        missing = [n for n in names if not got.get(n)]
        if missing:
            raise AssertionError(f"[{tag}] rank {r} launched no {missing}")


def _dist_gate(cases, gates):
    """The worst rank's reading of each gate, and the gates it fails."""
    worst = {k: max(c[k] for c in cases) for k in gates}
    if "grad_rel" in gates:
        worst["grad_rel_leaf"] = max(cases, key=lambda c: c["grad_rel"])[
            "grad_rel_leaf"]
    return worst, [k for k, lim in gates.items() if not worst[k] <= lim]


def _dist_gate_text(worst, gates):
    return ", ".join(
        f"{k} {worst[k]:.2e}" + (f" at {worst['grad_rel_leaf']}"
                                 if k == "grad_rel" else "")
        + f" (gate {gates[k]})" for k in gates)


def dist_report_decode(ranks, secs):
    res = [r["decode"] for r in ranks]
    out = {"phase_s": secs}
    for arm in ("bf16", "f32"):
        r0 = res[0][arm]
        launches = [r[arm]["launches"] for r in res]
        _dist_need(launches, ("flash_decode", "cache_update"), "dist:decode")
        layers = DIST_DECODE["layers"][arm]
        print(f"[dist:decode] {ARCH} {arm}, {layers} of 28 layers, mesh "
              f"(1, 2) over "
              f"gloo (two ranks sharing the card; collectives staged through "
              f"the host: {res[0][arm]['staged_bytes']} / "
              f"{res[1][arm]['staged_bytes']} bytes by rank), B="
              f"{DIST_DECODE['B']} prompts of {DIST_DECODE['prompt']}, cache "
              f"{DIST_DECODE['max_seq']} rows cut by sequence, "
              f"{DIST_DECODE['steps']} steps teacher-forced by the unsharded "
              f"stream: logits max|diff| {r0['logits_max_abs_diff']:.3e}, "
              f"worst entry / its limit {r0['logits_worst_over_limit']:.3f}, "
              f"{r0['streams_equal']}/{r0['streams']} greedy streams equal; "
              f"ms per step: unsharded {r0['unsharded_ms_per_step']:.2f} "
              f"(one rank alone), sharded {r0['sharded_ms_per_step']:.2f} / "
              f"{res[1][arm]['sharded_ms_per_step']:.2f} by rank; launches "
              f"by rank {launches}", flush=True)
        out[arm] = {"rank0": r0, "rank1": res[1][arm], "launches": launches}
    failed = []
    if out["f32"]["rank0"]["streams_equal"] != DIST_DECODE["B"]:
        failed.append("[dist:decode] f32 streams differ from the unsharded "
                      "ones")
    res = [r["decode_seqpar"] for r in ranks]
    r0 = res[0]
    launches = [r["launches"] for r in res]
    _dist_need(launches, ("flash_decode", "cache_update"),
               "dist:decode-seqpar")
    print(f"[dist:decode-seqpar] {ARCH} f32, 2 layers, serve rules "
          f"seqparallel: the layers' weights gathered whole on each rank, "
          f"every head over the cache cut by sequence, the embedding and "
          f"logits vocab-parallel; mesh (1, 2) over gloo (staged "
          f"through the host: {r0['staged_bytes']} / "
          f"{res[1]['staged_bytes']} bytes by rank), B={DIST_DECODE['B']} "
          f"prompts of {DIST_DECODE['prompt']}, {DIST_SEQ_DECODE_STEPS} "
          f"steps teacher-forced by the unsharded stream: logits max|diff| "
          f"{r0['logits_max_abs_diff']:.3e}, worst entry / its limit "
          f"{r0['logits_worst_over_limit']:.3f}, {r0['streams_equal']}/"
          f"{r0['streams']} greedy streams equal; ms per step: unsharded "
          f"{r0['unsharded_ms_per_step']:.2f} (one rank alone), sharded "
          f"{r0['sharded_ms_per_step']:.2f} / "
          f"{res[1]['sharded_ms_per_step']:.2f} by rank; launches by rank "
          f"{launches}", flush=True)
    out["seqpar"] = {"rank0": r0, "rank1": res[1], "launches": launches}
    if r0["streams_equal"] != DIST_DECODE["B"]:
        failed.append("[dist:decode-seqpar] f32 streams differ from the "
                      "unsharded ones")
    if not r0["logits_worst_over_limit"] <= 1.0:
        failed.append(f"[dist:decode-seqpar] logits apart: "
                      f"{r0['logits_worst_over_limit']}")
    return out, failed


def _dist_train_lines(tag, what, cases, faults, gates, fault_name):
    """Print a sharded step's sound and planted-fault readings against
    ``gates``; returns (the phase's record, its failures).  The sound
    step must pass every gate and the fault fail every one."""
    worst, fails = _dist_gate(cases, gates)
    r0 = cases[0]
    print(f"[{tag}] {what}: loss {r0['loss']:.6f} vs one device "
          f"{r0['ref_loss']:.6f}, grad norm {r0['grad_norm']:.5f} vs "
          f"{r0['ref_grad_norm']:.5f}; worst rank: "
          f"{_dist_gate_text(worst, gates)}; max param diff "
          f"{max(c['max_param_diff'] for c in cases):.3e} (lr "
          f"{r0['lr']}); step {r0['step_s']:.2f} / {cases[1]['step_s']:.2f} "
          f"s by rank, {r0['staged_bytes']} / {cases[1]['staged_bytes']} "
          f"bytes staged; launches by rank "
          f"{[c['launches'] for c in cases]}", flush=True)
    failed = [f"[{tag}] {what}: {k} {worst[k]} > {gates[k]}" for k in fails]
    rec = {"worst": worst, "rank0": r0, "rank1": cases[1]}
    if faults is not None:
        fworst, ffails = _dist_gate(faults, gates)
        must = DIST_FAULT_GATES.get(fault_name, tuple(gates))
        held = [k for k in must if k not in ffails]
        print(f"[{tag}] {what}, planted fault ({DIST_FAULTS[fault_name]}): "
              f"{_dist_gate_text(fworst, gates)}; gates failed "
              f"{len(ffails)}/{len(gates)}"
              + (f" (must fail {', '.join(must)}: the fault acts in the "
                 f"backward only" + ("" if "params_apart" in must else
                                     ", and flips no more signs than bf16")
                 + ")" if len(must) < len(gates) else ""),
              flush=True)
        failed += [f"[{tag}] planted fault {DIST_FAULTS[fault_name]!r} "
                   f"passes {k}" for k in held]
        rec["fault"] = {"name": DIST_FAULTS[fault_name], "worst": fworst,
                        "gates_failed": ffails, "must_fail": list(must)}
    return rec, failed


def dist_report_train(ranks, secs, restored):
    out, failed = {}, []
    for key, shape, tag, rules in (
            ("1x2", (1, 2), "dist:train", "default"),
            ("2x1", (2, 1), "dist:train", "default"),
            ("seqpar", (1, 2), "dist:train-seqpar", "seqparallel"),
            ("fsdp", (2, 1), "dist:train-fsdp", "fsdp")):
        res = [r["train_" + key] for r in ranks]
        launches = [r["sound"]["launches"] for r in res]
        _dist_need(launches, ("flash_attention", "flash_attention_bwd"), tag)
        rec, f = _dist_train_lines(
            tag, f"{ARCH} {DIST_TRAIN['layers']} of 28 layers, "
            f"batch {DIST_TRAIN['B']} x {DIST_TRAIN['S']}, bf16, rules "
            f"{rules}, mesh {shape} over gloo (two ranks sharing the card; "
            f"collectives staged through the host, not a multi-card time), "
            f"{secs['train_' + key]:.1f} s",
            [r["sound"] for r in res], [r["fault"] for r in res],
            DIST_TRAIN_GATES, key)
        out[key], failed = dict(rec, launches=launches), failed + f
    res = [r["elastic"] for r in ranks]
    back = restored
    rel = abs(back["loss"] - res[0]["loss"]) / abs(res[0]["loss"])
    print(f"[dist:train] elastic: reduced {ARCH} f32, two steps on (2, 1), a "
          f"checkpoint saved full, restored on plan_mesh_shape(1, "
          f"model_parallel=1) = {back['shape']} at step {back['start']}: "
          f"third step loss {back['loss']:.7f} vs straight through "
          f"{res[0]['loss']:.7f} (rel {rel:.2e}, tol {DIST_ELASTIC_RTOL})",
          flush=True)
    if not (back["start"] == 2 and rel <= DIST_ELASTIC_RTOL):
        failed.append(f"[dist:train] elastic restart apart: {back}")
    out["elastic"] = {"restart_loss": back["loss"],
                      "straight_loss": res[0]["loss"], "rel": rel}
    return out, failed


def dist_report_ssm(ranks, secs):
    """[dist:decode-ssm], [dist:train-mamba2] and [dist:train-zamba2]."""
    out, failed = {}, []
    res = [r["decode_ssm"] for r in ranks]
    for arch in (SSM_ARCH, HYBRID_ARCH):
        r0, r1 = res[0][arch], res[1][arch]
        launches = [r[arch]["launches"] for r in res]
        if arch == HYBRID_ARCH:
            _dist_need(launches, ("flash_decode", "cache_update"),
                       "dist:decode-ssm")
        layers = DIST_SSM_DECODE["layers"][arch]
        print(f"[dist:decode-ssm] {arch} f32, {layers} layers, rules "
              f"default: each rank steps its heads of the SSM state and "
              f"rolls its conv channels (x of its heads, B and C whole)"
              + (", the shared block over its cache cut by sequence"
                 if arch == HYBRID_ARCH else "")
              + f"; mesh (1, 2) over gloo (staged through the host: "
              f"{r0['staged_bytes']} / {r1['staged_bytes']} bytes by rank), "
              f"B={DIST_DECODE['B']} prompts of {DIST_DECODE['prompt']} "
              f"prefilled on one device, {DIST_SSM_DECODE['steps']} steps "
              f"teacher-forced by the unsharded stream: logits max|diff| "
              f"{r0['logits_max_abs_diff']:.3e}, worst entry / its limit "
              f"{r0['logits_worst_over_limit']:.3f}, {r0['streams_equal']}/"
              f"{r0['streams']} greedy streams equal; ms per step: "
              f"unsharded {r0['unsharded_ms_per_step']:.2f} (one rank "
              f"alone), sharded {r0['sharded_ms_per_step']:.2f} / "
              f"{r1['sharded_ms_per_step']:.2f} by rank (not a multi-card "
              f"time); launches by rank {launches}", flush=True)
        out[f"decode_{arch}"] = {"rank0": r0, "rank1": r1,
                                 "launches": launches}
        if r0["streams_equal"] != DIST_DECODE["B"]:
            failed.append(f"[dist:decode-ssm] {arch} streams differ from "
                          f"the unsharded ones")
        if not r0["logits_worst_over_limit"] <= 1.0:
            failed.append(f"[dist:decode-ssm] {arch} logits apart: "
                          f"{r0['logits_worst_over_limit']}")
    print(f"[dist:decode-ssm] {secs['decode_ssm']:.1f} s for the phase",
          flush=True)
    for key, arch, tag in (("mamba2", SSM_ARCH, "dist:train-mamba2"),
                           ("zamba2", HYBRID_ARCH, "dist:train-zamba2")):
        res = [r["train_" + key] for r in ranks]
        launches = [r["sound"]["launches"] for r in res]
        _dist_need(launches, ("ssd", "ssd_bwd") + (
            ("flash_attention", "flash_attention_bwd")
            if arch == HYBRID_ARCH else ()), tag)
        full = 48 if arch == SSM_ARCH else 38
        rec, f = _dist_train_lines(
            tag, f"{arch} {DIST_SSM_TRAIN['layers'][arch]} of {full} "
            f"layers, batch {DIST_SSM_TRAIN['B']} x {DIST_SSM_TRAIN['S']}, "
            f"bf16, rules default (head-parallel: each rank's ssd and "
            f"ssd_bwd on half the heads), mesh (1, 2) over gloo (two ranks "
            f"sharing the card; collectives staged through the host, not a "
            f"multi-card time), {secs['train_' + key]:.1f} s",
            [r["sound"] for r in res], [r["fault"] for r in res],
            DIST_SSM_GATES[key], key)
        out["train_" + key], failed = dict(rec, launches=launches), \
            failed + f
    return out, failed


def dist_report_olmoe(ranks, secs):
    res = [r["olmoe"] for r in ranks]
    out, failed = {}, []
    what = (f"{MOE_ARCH} {DIST_MOE['layers']} of 16 layers, batch "
            f"{DIST_MOE['train_B']} x {DIST_MOE['S']}, bf16, capacity factor 8 "
            f"(no drops), mesh (1, 2), expert parallelism over the")
    for arm in ("bf16", "int8"):
        launches = [r[arm]["launches"] for r in res]
        _dist_need(launches, ("grouped_matmul", "grouped_matmul_bwd"),
                   "dist:train-olmoe")
        rec, f = _dist_train_lines(
            "dist:train-olmoe", f"{what} {arm} wire",
            [r[arm] for r in res],
            [r["fault"] for r in res] if arm == "bf16" else None,
            DIST_MOE_GATES[arm], "olmoe")
        out[arm], failed = dict(rec, launches=launches), failed + f
    lay = [r["layer"] for r in res]
    ep = max(x["ep_worst_over_limit"] for x in lay)
    flt = min(x["fault_share_flagged"] for x in lay)
    q_rel = max(x["q_rel"] for x in lay)
    print(f"[dist:train-olmoe] one MoE layer at full width, bf16, "
          f"{DIST_MOE['B']} x {DIST_MOE['S']} rows, no drops: expert "
          f"parallelism vs the local path, worst entry / its limit {ep:.3f} "
          f"(max|diff| {max(x['ep_max_abs_diff'] for x in lay):.3e}, gate "
          f"<= 1); planted fault ({DIST_FAULTS['olmoe']}): {flt:.3f} of "
          f"entries flagged (gate > 0.5); q_rel int8 vs bf16 wire "
          f"{q_rel:.4f} (gate < 0.05)", flush=True)
    if not ep <= 1.0:
        failed.append(f"[dist:train-olmoe] EP layer vs local: {ep}")
    if not flt > 0.5:
        failed.append(f"[dist:train-olmoe] planted a2a fault flagged on "
                      f"{flt} of entries only")
    if not q_rel < 0.05:
        failed.append(f"[dist:train-olmoe] q_rel {q_rel}")
    out["layer"] = {"ep_worst_over_limit": ep, "fault_share_flagged": flt,
                    "q_rel": q_rel}
    dec = res[0]["decode"]
    _dist_need([r["decode"]["launches"] for r in res],
               ("grouped_matmul", "flash_decode", "cache_update"),
               "dist:train-olmoe decode")
    print(f"[dist:train-olmoe] decode under the mesh, all {dec['layers']} "
          f"layers, experts sharded (no EP at one token), B={dec['B']}, "
          f"{dec['steps']} steps: max|logit diff| vs one device "
          f"{dec['max_abs_logit_diff']:.3e} (bf16, not gated), argmax equal "
          f"{dec['argmax_equal']}/{dec['argmax_total']}; launches by rank "
          f"{[r['decode']['launches'] for r in res]}; {secs:.1f} s for the "
          f"phase", flush=True)
    out["decode"] = {"rank0": dec, "rank1": res[1]["decode"]}
    return out, failed


def dist_phases(only=None):
    """Every [dist:*] phase (with ``only``, the ``dist_rank_all`` phases it
    names): one spawn of two ranks runs them all, then the elastic restart
    in this process; the caller has built the kernels, so the ranks load
    them and none builds.  Every phase prints before any failed gate
    raises."""
    import tempfile
    from repro_torch.launch.mesh import spawn_ranks
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dist-ckpt-") as ckpt:
        ranks = spawn_ranks(dist_rank_all, 2, "gloo", args=(ckpt, only),
                            timeout_s=DIST_SPAWN_TIMEOUT_S,
                            collective_timeout_s=300)
        wall = time.perf_counter() - t0
        restored = (dist_elastic_restore(ckpt)
                    if only is None or "elastic" in only else None)
    secs = ranks[0]["seconds"]
    out, failed = {"spawn_s": wall, "phase_s": secs}, []
    reports = (
        ("decode", ("decode", "decode_seqpar"), lambda: dist_report_decode(
            ranks, secs["decode"] + secs["decode_seqpar"])),
        ("train", ("train_1x2", "train_2x1", "train_seqpar", "train_fsdp",
                   "elastic"), lambda: dist_report_train(ranks, secs,
                                                         restored)),
        ("ssm", ("decode_ssm", "train_mamba2", "train_zamba2"),
         lambda: dist_report_ssm(ranks, secs)),
        ("train_olmoe", ("olmoe",), lambda: dist_report_olmoe(
            ranks, secs["olmoe"])),
        ("prefill", ("prefill", "engine"), lambda: dist_report_prefill(
            ranks, secs)))
    for key, phases, report in reports:
        if not all(p in secs for p in phases):
            continue
        rec, f = report()
        out[key], failed = rec, failed + f
    out["seconds"] = time.perf_counter() - t0
    print(f"[dist] phases in {out['seconds']:.1f} s (the ranks' spawn "
          f"{wall:.1f} s; by phase, rank 0: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()) + ")",
          flush=True)
    if failed:
        raise AssertionError("; ".join(failed))
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
    # the log-sum-exp output of the sequence-sharded decode's combine
    lse_checks, lse_fault = check_flash_decode_lse(tfa, ref)
    lse_time = time_flash_decode_lse(tfa, ref)
    cu_checks = check_cache_update(tfa, ref)
    clip_checks, clip_fault = check_cache_update_clip(tfa, ref)
    fdp_checks = check_flash_decode_paged(tfa, ref)
    fd_faults = check_decode_faults(tfa, ref)
    fd_shortcut = check_decode_shortcut(ref)
    cup_checks = check_cache_update_paged(tfa, ref)
    cu_rope_checks = check_rope_cache_update(tfa, ref, paged=False)
    cup_rope_checks = check_rope_cache_update(tfa, ref, paged=True)
    rope_faults = check_rope_faults(tfa, ref)
    # gemma2's head_dim 256 (cache_update's bit-for-bit checks run at its
    # heads above, ROPE_HEADS["gemma2"])
    g2_decode_checks, g2_decode_faults = check_gemma2_decode(tfa, ref)
    g2_cache_faults = check_gemma2_cache_faults(tfa, ref)
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
    # gemma2's heads over 8192 rows, softcap 50, window 4096
    for paged in (False, True):
        name = "flash_decode_paged" if paged else "flash_decode"
        times[f"{name} decode D=256"] = time_gemma2_decode(
            tfa, ref, paged, 8, 1, G2_DECODE_LENS)
        times[f"{name} prefill D=256"] = time_gemma2_decode(
            tfa, ref, paged, 1, 256, [5000])
    # the fused RoPE + cache write at each model's heads: a decode step (one
    # done slot) and a 256-row prefill chunk
    for model, suffix in (("llama", ""), ("olmoe", " g=1"),
                          ("zamba2", " D=64"), ("gemma2", " D=256")):
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
    # the query offset of the sequence-parallel forward: llama's training
    # shape over two model ranks, rank 0's 1024 rows and rank 1's
    off_checks = check_flash_attention(tfa, ref, FA_OFFSET_CASES)
    off_fault = check_offset_fault(tfa, ref)
    for rank, (Sk, off) in enumerate(SEQPAR_RANKS):
        t = time_flash_attention(tfa, ref, S=SEQPAR_ROWS, Sk=Sk, q_offset=off)
        times[f"flash_attention seqpar rank {rank}"] = t["fwd"]
        times[f"flash_attention_bwd seqpar rank {rank}"] = t["bwd"]
    g2_fa_checks, g2_fa_faults = check_gemma2_attention(tfa, ref)
    g2_fa_times = time_flash_attention(tfa, ref, G2_HEADS, G2_CAP)
    times["flash_attention training D=256"] = g2_fa_times["fwd"]
    times["flash_attention_bwd training D=256"] = g2_fa_times["bwd"]
    # hubert-xlarge's head_dim 80, bidirectional
    hub_fa_checks = check_flash_attention(tfa, ref, HUBERT_FA_CASES)
    hub_fa_faults = check_d80_faults(tfa, ref)
    hub_fa_times = time_flash_attention(tfa, ref, HUBERT_HEADS,
                                        B=HUBERT_TRAIN[0], S=HUBERT_TRAIN[1],
                                        causal=False)
    times["flash_attention training D=80"] = hub_fa_times["fwd"]
    times["flash_attention_bwd training D=80"] = hub_fa_times["bwd"]
    # qwen2-vl-72b's heads (a GQA group of 8) with M-RoPE's cos/sin: a
    # decode step, a 256-row chunk and the vision prefill's 2048 rows
    qwen_decode_checks, qwen_cache_checks = check_qwen2vl_decode(tfa, ref)
    Hq, Kq, Dq = QWEN2VL_HEADS
    for step, B, Sq, lens, index in (
            ("decode", 8, 1, decode_lens, decode_index),
            ("prefill", 1, 256, [768], [512]),
            ("vision", 1, VISION_S, [VISION_S], [0])):
        times[f"flash_decode {step} qwen2vl"] = time_flash_decode(
            tfa, ref, B, Sq, lens, H=Hq, K=Kq, D=Dq)
        times[f"cache_update rope {step} qwen2vl"] = time_rope_cache_update(
            tfa, ref, False, "qwen2vl", B, Sq, index)
    # nemotron-4-15b's heads: a GQA group of 6, half rotary
    H6, K6, _ = NEMOTRON_HEADS
    times["flash_decode decode g=6"] = time_flash_decode(
        tfa, ref, 8, 1, decode_lens, H=H6, K=K6)
    times["flash_decode prefill g=6"] = time_flash_decode(
        tfa, ref, 1, 256, [768], H=H6, K=K6)
    times["cache_update rope decode g=6"] = time_rope_cache_update(
        tfa, ref, False, "nemotron", 8, 1, decode_index, rotary_pct=0.5)
    times["cache_update rope prefill g=6"] = time_rope_cache_update(
        tfa, ref, False, "nemotron", 1, 256, [512], rotary_pct=0.5)
    gmm_checks = check_grouped_matmul(gmm, ref)
    gmm_faults = check_grouped_matmul_faults(gmm, ref)
    for G, M, K, N in GMM_TIME_SHAPES:
        times[f"grouped_matmul M={M} {K}x{N}"] = time_grouped_matmul(
            gmm, ref, G, M, K, N)
    gmm_bwd_checks = check_grouped_matmul_bwd(gmm, ref)
    gmm_bwd_faults = check_grouped_matmul_bwd_faults(gmm, ref)
    for K, N in ((2048, 1024), (1024, 2048)):
        times[f"grouped_matmul_bwd M={GMM_TRAIN_M} {K}x{N}"] = \
            time_grouped_matmul_bwd(gmm, ref, 64, GMM_TRAIN_M, K, N)
    ssd_checks = check_ssd(tssd, ref)
    ssd_f64 = check_ssd_f32_exact(tssd, ref)
    ssd_faults = check_ssd_faults(tssd, ref)
    ssd_shortcut = check_ssd_shortcut(ref)
    for model in SSD_HEADS:
        for S in SSD_TIME_S:
            times[_ssd_time_key(model, S)] = time_ssd(tssd, ref, model, S)
    ssd_bwd_checks = check_ssd_bwd(tssd, ref)
    ssd_bwd_faults = check_ssd_bwd_faults(tssd, ref)
    ssd_bwd_shortcut = check_ssd_bwd_shortcut(ref)
    for model in (*SSD_HEADS, *SSD_RANK_HEADS):
        t = time_ssd_train(tssd, ref, model)
        times[f"ssd train {model}"] = t["fwd"]
        times[f"ssd_bwd train {model}"] = t["bwd"]
    # zamba2's shared block on one of two model ranks
    z2_fa_checks = check_flash_attention(tfa, ref, ZAMBA2_RANK_FA_CASES)
    t = time_flash_attention(tfa, ref, ZAMBA2_RANK_FA)
    times["flash_attention zamba2 rank"] = t["fwd"]
    times["flash_attention_bwd zamba2 rank"] = t["bwd"]
    for name, t in times.items():
        lib = (f"{t['library_ms']:.4f} ms" if t["library_ms"] is not None
               else "none")
        if "sdpa_no_softcap_ms" in t:
            lib += (f" (SDPA without the softcap, not the same function: "
                    f"{t['sdpa_no_softcap_ms']:.4f} ms)")
        print(f"[time] {name} {t['shape']}: kernel {t['ms']:.4f} ms "
              f"(eager with its host work {t['host_ms']:.4f} ms), plain "
              f"{t['plain_ms']:.4f} ms, library {lib}, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})", flush=True)

    # 2c: the distributed layer: two gloo ranks sharing the card, run
    # while this process holds little of it (each rank needs a context of
    # its own, and [dist:train] ~40 GB between them)
    _release_card()
    print(f"[dist] this process holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved",
          flush=True)
    dist = dist_phases()
    dist_launches = {
        "decode": dist["decode"]["bf16"]["launches"],
        "decode_seqpar": dist["decode"]["seqpar"]["launches"],
        "train_1x2": dist["train"]["1x2"]["launches"],
        "train_2x1": dist["train"]["2x1"]["launches"],
        "train_seqpar": dist["train"]["seqpar"]["launches"],
        "train_fsdp": dist["train"]["fsdp"]["launches"],
        "train_mamba2": dist["ssm"]["train_mamba2"]["launches"],
        "train_zamba2": dist["ssm"]["train_zamba2"]["launches"],
        "decode_zamba2": dist["ssm"][f"decode_{HYBRID_ARCH}"]["launches"],
        "train_olmoe_bf16": dist["train_olmoe"]["bf16"]["launches"],
        "decode_olmoe": [dist["train_olmoe"]["decode"][r]["launches"]
                         for r in ("rank0", "rank1")],
        **{"prefill_" + arm: dist["prefill"][arm]["launches"]
           for arm, *_ in DIST_PREFILL["arms"]},
        "engine_dense": dist["prefill"]["engine_dense"]["launches"],
        "engine_paged": dist["prefill"]["engine_paged"]["launches"]}

    def by_rank(name):
        """Each rank's launches of ``name`` in each [dist:*] phase."""
        return {ph: [r.get(name, 0) for r in ranks]
                for ph, ranks in dist_launches.items()
                if any(r.get(name, 0) for r in ranks)}
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
        f"({st['decode_s'] / st['decode_steps'] * 1e3:.1f} ms/step, "
        f"completion p50 {st['completion_p50_s']:.3f} s / p99 "
        f"{st['completion_p99_s']:.3f} s)"
        for n, st in order), flush=True)
    paged_serving["again"] = paged2
    serving["again"] = dense2
    prefix_serving, prefix_specs, prefix_streams = serve_prefix_sharing(
        tfa, *shared[:3])
    # 3g: slot migration, on llama's weights and arms
    migrate = migrate_llama(tfa, *shared, prefix_specs, prefix_streams)
    # 3h: the engine's benchmark interface and the fleet layer
    serving["static"] = serve_static(tfa, *shared, serving)
    fleet_st = fleet_engine(tfa, *shared[:3])
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
    # 3i: full-width minitron-4b and nemotron-4-15b, dense and graphed
    nemo_launches, nemo_serving = {}, {}
    for arch, tag in ((MINITRON_ARCH, "minitron"), (NEMOTRON_ARCH,
                                                    "nemotron")):
        nemo_launches[tag], nemo_serving[tag], shared = serve_full_width(
            tfa, arch, tag + "-")
        del shared
        _release_card()
    # 3j: full-width gemma2-2b at max_seq 8192, dense and paged
    g2_launches, g2_serving = serve_gemma2(tfa)
    # 3k: qwen2-vl-72b at 20 of its 80 layers and its vision prefill; 3l:
    # hubert-xlarge's encode
    qwen_launches, qwen_serving = serve_qwen2vl(tfa)
    hub_encode_launches, hub_encode = encode_hubert(tfa)
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
    time_ssd_bwd_passes(tssd, times)
    parity = logits_parity()
    g2_serving["parity_max_abs_diff"] = gemma2_parity()
    qwen_serving["parity_max_abs_diff"] = item12_parity(QWEN2VL_ARCH,
                                                        "parity:qwen2vl")
    hub_encode["parity_max_abs_diff"] = item12_parity(HUBERT_ARCH,
                                                      "parity:hubert")
    moe_parity = olmoe_parity()
    mamba_parity = {SSM_ARCH: ssm_parity(SSM_ARCH, 2),
                    HYBRID_ARCH: ssm_parity(HYBRID_ARCH, 7)}
    train_launches, training = train_full_width(tfa)
    for name, (arch, layers) in TRAIN_ARMS.items():
        training[name] = train_full_width(tfa, arch, layers,
                                          "train:" + name)[1]
    training["parity_rel_err"] = train_parity(tfa)
    for name in ("olmoe", "mamba2"):
        training[name]["parity_rel_err"] = train_parity(
            tfa, TRAIN_ARMS[name][0], "train:parity-" + name)
    # gemma2-2b at full width and depth, then remat="dots" beside [train]
    training["gemma2"] = train_full_width(tfa, GEMMA2_ARCH,
                                          tag="train:gemma2",
                                          profile=False)[1]
    training["gemma2"]["parity_rel_err"] = train_parity(
        tfa, GEMMA2_ARCH, "train:parity-gemma2")
    # hubert-xlarge at full width and depth (4 x 1024 frames), then one f32
    # step of it at 2 layers and of reduced qwen2-vl against the CPU
    training["hubert"] = train_full_width(tfa, HUBERT_ARCH, tag="train:hubert",
                                          profile=False,
                                          shape=HUBERT_TRAIN)[1]
    training["hubert"]["parity_rel_err"] = train_parity(
        tfa, HUBERT_ARCH, "train:parity-hubert")
    training["qwen2vl_parity_rel_err"] = train_parity(
        tfa, QWEN2VL_ARCH, "train:parity-qwen2vl", reduce=True)
    training["dots"] = train_dots(tfa)
    ratio = {k: training["dots"][k] / training[k]
             for k in ("median_step_s_after_first",
                       "median_step_j_after_first", "peak_allocated_gb")}
    training["dots"]["over_full"] = ratio

    def busy_idle(prof):
        busy = prof["profile_device_busy_ms_per_step"]
        if busy is None:
            return "device busy not measured"
        return (f"{prof['profile_ms_per_step']:.2f} ms, device busy "
                f"{busy:.2f} ms, idle {prof['profile_ms_per_step'] - busy:.2f}"
                f" ms")
    print(f"[train:dots] {ARCH} dots over full, same call: s/step "
          f"{ratio['median_step_s_after_first']:.3f}x, J/step "
          f"{ratio['median_step_j_after_first']:.3f}x, peak allocated "
          f"{ratio['peak_allocated_gb']:.3f}x ({training['peak_allocated_gb']:.2f}"
          f" -> {training['dots']['peak_allocated_gb']:.2f} GB); one step "
          f"under the profiler: full {busy_idle(training['profile'])}, dots "
          f"{busy_idle(training['dots']['profile'])}; olmoe "
          f"{DOTS_OLMOE_LAYERS} layers under dots: peak "
          f"{training['dots']['olmoe']['peak_allocated_gb']:.2f} GB",
          flush=True)
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
        # nemotron-4-15b (H = 48, K = 8: a group of 6), dense only
        g6 = {"launches": nemo_launches["nemotron"][name],
              "launches_arm": "nemotron-dense"}
        g6.update({" ".join(k.split()[1:-1]): times[k] for k in times
                   if k.startswith(name + " ") and k.endswith("g=6")})
        # gemma2 (H = 8, K = 4, D = 256, softcap 50, window 4096)
        g2 = {"launches": g2_launches["gemma2-" + arm][name],
              "launches_arm": "gemma2-" + arm}
        g2.update({" ".join(k.split()[1:-1]): times[k] for k in times
                   if k.startswith(name + " ") and k.endswith("D=256")})
        g2["checks"] = (g2_decode_checks if "decode" in name
                        else [c for c in (cup_rope_checks if "paged" in name
                                          else cu_rope_checks)
                              if c["model"] == "gemma2"])
        g2["planted_fault"] = (g2_decode_faults if "decode" in name
                               else g2_cache_faults[name])
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches, max_abs_err=err,
                    tolerance=tol, ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t["library_ms"], library=t["library"],
                    shape=t["shape"], max_abs_diff=err, kernel_ms=t["ms"],
                    host_ms=t["host_ms"], launches_per_decode_step=28,
                    launches_arm=arm, prefill_chunk=prefill, checks=checks,
                    olmoe_g1=g1, zamba2_d64=d64, nemotron_g6=g6,
                    gemma2_d256=g2,
                    launches_fleet=fleet_st["launches"][name],
                    launches_static=serving["static"]["launches"][name],
                    **extra)

    def qwen2vl(name, checks):
        # qwen2-vl-72b (H = 64, K = 8: a group of 8), dense, 20 layers
        return {"launches": qwen_launches[name],
                "launches_arm": "qwen2vl-dense",
                "launches_vision": qwen_serving["vision"]["launches"][name],
                **{k.split()[-2]: times[k] for k in times
                   if k.startswith(name + " ") and k.endswith("qwen2vl")},
                "checks": checks}

    csrc = "src/repro_torch/kernels/csrc/"
    fa = "src/repro/kernels/flash_attention.py"
    kernels = [
        row("flash_decode", csrc + "decode_attention.cu", fa + ":212",
            dense_launches["flash_decode"], bf16_err(fd_checks),
            DECODE_TOL["bfloat16"], times["flash_decode decode"],
            times["flash_decode prefill"], fd_checks, "dense",
            worst_over_limit=max(c["worst_over_limit"] for c in fd_checks),
            planted_fault=fd_faults, bf16_shortcut=fd_shortcut,
            qwen2vl_g8=qwen2vl("flash_decode", qwen_decode_checks),
            lse={**lse_time, "checks": lse_checks,
                 "planted_fault": lse_fault,
                 "tolerance": f"out by the per-entry rule; lse "
                              f"{LSE_TOL} (1 + |want|), -inf "
                              f"where no key is visible"},
            launches_dist=by_rank("flash_decode")),
        row("cache_update", csrc + "cache_update.cu", fa + ":394",
            dense_launches["cache_update"],
            max(c["max_abs_diff"] for c in cu_rope_checks), 0.0,
            times["cache_update rope decode"],
            times["cache_update rope prefill"], cu_rope_checks, "dense",
            scatter_only={"decode": times["cache_update decode"],
                          "checks": cu_checks},
            row_clip={"checks": clip_checks, "planted_fault": clip_fault},
            planted_fault=rope_faults,
            qwen2vl_g8=qwen2vl("cache_update", qwen_cache_checks),
            launches_dist=by_rank("cache_update")),
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
        extra["hubert_d80"] = {
            "launches": training["hubert"]["launches"][name],
            "launches_arm": "train:hubert",
            "launches_encode": hub_encode_launches[name],
            **times[name + " training D=80"],
            "checks": [dict(c, max_abs_err={
                n: c["max_abs_err"][n] for n in (
                    ("out", "lse") if name == "flash_attention"
                    else ("dq", "dk", "dv"))}) for c in hub_fa_checks],
            "planted_fault": {n: hub_fa_faults[n] for n in (
                ("out",) if name == "flash_attention" else ("dq", "dk",
                                                            "dv"))}}
        extra["gemma2_d256"] = {
            "launches": training["gemma2"]["launches"][name],
            "launches_arm": "train:gemma2",
            "launches_dots": training["dots"]["launches"][name],
            **times[name + " training D=256"],
            "checks": g2_fa_checks,
            "planted_fault": {n: g2_fa_faults[n] for n in (
                ("out",) if name == "flash_attention" else ("dq", "dk",
                                                            "dv"))}}
        names = ("out", "lse") if name == "flash_attention" else ("dq", "dk",
                                                                  "dv")
        extra["q_offset"] = {
            "ranks": {f"rank {r}": times[f"{name} seqpar rank {r}"]
                      for r in range(len(SEQPAR_RANKS))},
            "checks": [dict(c, max_abs_err={n: c["max_abs_err"][n]
                                            for n in names})
                       for c in off_checks],
            "planted_fault": ("the backward with the offset ignored: "
                              f"{off_fault}" if name != "flash_attention"
                              else None)}
        extra["zamba2_rank"] = {
            "heads": ZAMBA2_RANK_FA, **times[f"{name} zamba2 rank"],
            "checks": [dict(c, max_abs_err={n: c["max_abs_err"][n]
                                            for n in names})
                       for c in z2_fa_checks]}
        worst = max(max(v for n, v in c["max_abs_err"].items()
                        if n != "lse") for c in checks
                    if c["dtype"] == "bfloat16")
        extra["launches_dist"] = by_rank(name)
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
        planted_fault=gmm_faults,
        launches_train=training["olmoe"]["launches"]["grouped_matmul"],
        launches_dist=by_rank("grouped_matmul")))
    t = times[f"grouped_matmul_bwd M={GMM_TRAIN_M} 2048x1024"]
    kernels.append(dict(
        name="grouped_matmul_bwd", route="cuda",
        source=csrc + "grouped_matmul_bwd.cu", replaces=train_src + ":346",
        replaces_note="XLA autodiff of ref.grouped_matmul_ref: the Pallas "
                      "grouped_matmul has no VJP",
        launches=training["olmoe"]["launches"]["grouped_matmul_bwd"],
        launches_arm="train:olmoe",
        max_abs_err=max(max(c["max_abs_err"].values())
                        for c in gmm_bwd_checks if c["dtype"] == "bfloat16"),
        worst_over_limit=max(max(c["worst_over_limit"].values())
                             for c in gmm_bwd_checks),
        tolerance=_ATTN_TOL_TEXT, ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"], library=t["library"], shape=t["shape"],
        host_ms=t["host_ms"],
        times={k: v for k, v in times.items()
               if k.startswith("grouped_matmul_bwd")},
        checks=gmm_bwd_checks, planted_fault=gmm_bwd_faults,
        launches_dist=by_rank("grouped_matmul_bwd")))
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
        bf16_shortcut=ssd_shortcut, f32_vs_float64=ssd_f64,
        launches_train={m: training[m]["launches"]["ssd"]
                        for m in ("mamba2", "zamba2")},
        launches_dist=by_rank("ssd")))
    t = times["ssd_bwd train mamba2"]
    kernels.append(dict(
        name="ssd_bwd", route="cuda", source=csrc + "ssd_bwd.cu",
        replaces=train_src + ":277",
        replaces_note="XLA autodiff of ref.ssd_chunked: the Pallas ssd has "
                      "no VJP",
        launches=training["mamba2"]["launches"]["ssd_bwd"],
        launches_arm="train:mamba2",
        launches_zamba2=training["zamba2"]["launches"]["ssd_bwd"],
        max_abs_err=max(max(v for n, v in c["max_abs_err"].items()
                            if n in ("dx", "ddt", "dB", "dC"))
                        for c in ssd_bwd_checks if c["dtype"] == "bfloat16"),
        worst_over_limit=max(max(c["worst_over_limit"].values())
                             for c in ssd_bwd_checks),
        tolerance=_ATTN_TOL_TEXT + f"; the f32 sums dA, dD, dh0: per entry "
                  f"{SSD_BWD_F32_RTOL} |want| + {SSD_BWD_F32_ATOL} "
                  "max|want|",
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=None, library=t["library"],
        shape=t["shape"], host_ms=t["host_ms"],
        times={k: v for k, v in times.items() if k.startswith("ssd")
               and "train" in k},
        checks=ssd_bwd_checks, planted_fault=ssd_bwd_faults,
        bf16_shortcut=ssd_bwd_shortcut, launches_dist=by_rank("ssd_bwd")))
    serving.update(paged=paged_serving, prefix_sharing=prefix_serving)
    moe_serving["paged"] = moe_paged
    print(json.dumps({"kernels": kernels, "serving": serving,
                      "olmoe_serving": moe_serving,
                      "mamba2_serving": ssm_serving,
                      "zamba2_serving": hyb_serving,
                      "nemotron_serving": nemo_serving,
                      "gemma2_serving": g2_serving,
                      "qwen2vl_serving": qwen_serving,
                      "hubert_encode": hub_encode,
                      "training": training,
                      "parity_max_abs_diff": parity,
                      "olmoe_parity": moe_parity,
                      "ssm_parity": mamba_parity, "ptxas": ptxas,
                      "power": power, "fleet": fleet_st, "dist": dist,
                      "total_s": time.perf_counter() - t_start}))
    smi_end = _smi_line()
    if smi_end != smi:
        raise AssertionError(f"the card's limit moved: nvidia-smi read "
                             f"{smi!r} at the start, {smi_end!r} at the end")
    print(smi_end)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
