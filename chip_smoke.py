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
     (the bound), at decode and at a 256-row prefill chunk;
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
     then a torch.profiler window of steady decode, dense and paged (last:
     launches slow down once the profiler has run);
  4. logits parity at full width and 2 layers: the card (bf16, kernels)
     against a float32 CPU forward of the same weights (plain path).

It prints one ``{"kernels": [...]}`` line, the nvidia-smi line, and as
its last line ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository's ``src/`` beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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
ARCH = "llama3.2-3b"


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


def _time_graph_ms(calls, min_calls: int = 64, replays: int = 10) -> float:
    """Device time per call: the calls are captured once into a CUDA graph
    and replayed, so the host's per-call work is left out."""
    import torch
    calls = calls * max(1, math.ceil(min_calls / len(calls)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm up off the capture
        for c in calls[:4]:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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
    block of query rows), softcap/window, and the reduced configs'
    head_dim 32."""
    import torch
    rng = np.random.default_rng(0)
    checks = []
    shapes = [((8, 2048, 24, 8, 128), Sq) for Sq in (1, 5, 256)] \
        + [((3, 64, 4, 2, 32), Sq) for Sq in (1, 4)]
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
    """Kernel vs plain version, bit-exact, including dropped slots."""
    import torch
    B, S, K, D = 8, 2048, 8, 128
    checks = []
    for new_dt, cache_dt in ((torch.bfloat16, torch.bfloat16),
                             (torch.float32, torch.float32),
                             (torch.float32, torch.bfloat16)):
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
                           "cache": str(cache_dt).split(".")[1], "Sn": Sn,
                           "bit_exact": exact})
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
    gathered cache (must be equal: the reduction order is shared)."""
    import torch
    rng = np.random.default_rng(10)
    checks = []
    shapes = [((8, 2048, 24, 8, 128), 16, Sq) for Sq in (1, 5, 256)] \
        + [((3, 64, 4, 2, 32), 8, Sq) for Sq in (1, 4)]
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
    maps must stay untouched."""
    import torch
    B, S, K, D, bs = 8, 2048, 8, 128, 16
    mb, mapped = S // bs, 100                 # 100 of 128 blocks mapped
    n_pool = B * mb + 1
    checks = []
    for new_dt, pool_dt in ((torch.bfloat16, torch.bfloat16),
                            (torch.float32, torch.float32),
                            (torch.float32, torch.bfloat16)):
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
                           "pool": str(pool_dt).split(".")[1], "Sn": Sn,
                           "bit_exact": exact,
                           "unmapped_blocks_untouched": untouched,
                           "unmapped_blocks": len(unmapped)})
            print(f"[check] cache_update_paged {checks[-1]}", flush=True)
            if not (exact and untouched):
                raise AssertionError("cache_update_paged is not bit-exact "
                                     "or wrote an unmapped block")
    return checks


def time_flash_decode(tfa, ref, B, Sq, kv_len):
    """Kernel, plain and library times at one main-path shape (bf16),
    rotating over enough cache copies that reads come from HBM, not L2."""
    import torch
    import torch.nn.functional as F
    S, H, K, D = 2048, 24, 8, 128
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


def time_cache_update(tfa, ref):
    """Decode-step write (Sn=1, bf16) of 8 slots, one of them done."""
    import torch
    B, S, K, D, Sn = 8, 2048, 8, 128, 1
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


def time_flash_decode_paged(tfa, ref, B, Sq, kv_len):
    """Paged kernel, plain and library times at one main-path shape (bf16,
    pool of B * 128 + 1 blocks of 16), rotating over enough pools that
    reads come from HBM, not L2."""
    import torch
    import torch.nn.functional as F
    S, H, K, D, bs = 2048, 24, 8, 128, 16
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


def time_cache_update_paged(tfa, ref, B, Sn, index):
    """Paged write (bf16) of Sn rows per slot into a (B * 128 + 1, 16, 8,
    128) pool through scattered tables."""
    import torch
    S, K, D, bs = 2048, 8, 128, 16
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


def _plain_chunks(specs) -> int:
    """Prefill chunk programs for ``specs`` with nothing shared."""
    from repro_torch.serving.scheduler import chunk_plan
    return sum(len(chunk_plan(len(p), 256)) for p, _, _ in specs)


def _print_arm(name, st, launches):
    print(f"[serve:{name}] {st['requests']} requests, "
          f"{st['prompt_tokens']} prompt tokens, "
          f"{st['new_tokens']} new tokens in {st['wall_s']:.2f}s: "
          f"{st['tok_per_s']:.1f} tok/s; prefill {st['prefill_s']:.2f}s, "
          f"decode {st['decode_s']:.2f}s; {st['host_syncs']} host syncs "
          f"({st['decode_steps']} decode steps, {st['prefill_chunks']} "
          f"prefill chunks); launches {launches}; max_memory_allocated "
          f"{st['max_memory_allocated_gib']:.2f} GiB", flush=True)


def serve_full_width(tfa):
    """Phase 3a, the dense arm.  Returns its launches and stats, and what
    the later arms reuse: (cfg, run, card params, request specs, streams)."""
    import torch
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.models import lm
    from repro_torch.models.params import init_params, param_count
    from repro_torch.serving.engine import Request

    cfg = get_model_config(ARCH)
    run = get_run_config(ARCH, remat="none")          # bf16 compute
    decls = lm.model_decls(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(decls, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    clock = PhaseClock()
    engine = _engine(cfg, run, params, clock)
    del params                                        # f32 masters
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers d{cfg.d_model} "
          f"vocab {cfg.vocab}, {param_count(decls) / 1e9:.3f} B params, "
          f"weights ready in {time.perf_counter() - t0:.1f}s", flush=True)

    rng = np.random.default_rng(0)
    warm = Request(uid=-1, prompt=rng.integers(0, cfg.vocab, 64).tolist(),
                   max_new_tokens=8)
    engine.generate([warm])                   # first-call costs, not counted
    specs = []
    for _ in range(16):
        plen = int(rng.integers(64, 1025))
        specs.append((rng.integers(0, cfg.vocab, plen).tolist(),
                      int(rng.integers(32, 129)), 0))
    done, wall, launches = _serve(tfa, engine, clock, cfg, specs)
    stats = _arm_stats(engine, clock, done, wall, specs)
    L, steps = cfg.n_layers, stats["decode_steps"]
    chunks = _plain_chunks(specs)
    _check_launches("dense", launches, {
        "flash_decode": L * (steps + chunks), "flash_decode_paged": 0,
        "cache_update": L * steps, "cache_update_paged": 0})
    _print_arm("dense", stats, launches)
    shared = (cfg, run, engine.params, specs,
              {r.uid: r.generated for r in done})
    del engine
    torch.cuda.empty_cache()
    return launches, stats, shared


def serve_arm(tfa, cfg, run, params, specs, dense_streams, name, paged):
    """Phase 3b: the dense arm's 16 requests once more, through
    ``paged=True`` or dense; every stream must equal the dense arm's and
    only that engine's kernels may launch."""
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
    if paged:
        stats.update(n_blocks=engine.n_blocks,
                     peak_used_blocks=engine.peak_used_blocks,
                     used_blocks_at_end=engine._alloc.used_blocks)
        msg += (f"; pool {engine.n_blocks} + 1 blocks of 16, peak "
                f"{engine.peak_used_blocks} used, "
                f"{engine._alloc.used_blocks} used at the end")
    print(msg, flush=True)
    if same != len(specs):
        raise AssertionError(f"{name} arm: {same}/16 streams equal dense")
    L, steps = cfg.n_layers, stats["decode_steps"]
    n = L * (steps + _plain_chunks(specs))
    _check_launches(name, launches, {
        "flash_decode": 0 if paged else n,
        "flash_decode_paged": n if paged else 0,
        "cache_update": 0 if paged else L * steps,
        "cache_update_paged": n if paged else 0})
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


def profile_decode(cfg, run, params, name, **kw):
    """Where a steady decode step's time goes: two decode chunks of 8
    full lanes of a fresh engine under torch.profiler.  It runs after
    every serving arm, as the launches slow down once the profiler has
    run.  Device busy share = the kernels' summed device time over the
    window's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(7)
    engine = _engine(cfg, run, params, None, **kw)
    engine.start([Request(uid=100 + i,
                          prompt=rng.integers(0, cfg.vocab, 128).tolist(),
                          max_new_tokens=24) for i in range(8)])
    engine.step()                             # admission + first chunk
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = 2 * engine.decode_chunk
    dev = [(e.key, e.device_time_total, e.count)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy_s = sum(t for _, t, _ in dev) / 1e6
    dev.sort(key=lambda r: -r[1])
    top = [{"kernel": k[:80], "ms_per_step": t / 1e3 / steps,
            "launches_per_step": n / steps} for k, t, n in dev[:8]]
    if dev:
        print(f"[profile:{name}] steady decode, 8 lanes: "
              f"{wall / steps * 1e3:.2f} ms "
              f"per step, device busy {busy_s / steps * 1e3:.2f} ms per step "
              f"({100 * busy_s / wall:.1f}% busy, "
              f"{100 * (1 - busy_s / wall):.1f}% idle)", flush=True)
        for row in top:
            print(f"[profile:{name}]   {row['ms_per_step']:.3f} ms/step "
                  f"x{row['launches_per_step']:.0f}  {row['kernel']}",
                  flush=True)
    else:
        print(f"[profile:{name}] the profiler saw no device events: device "
              "busy share not measured", flush=True)
    return {"profile_ms_per_step": wall / steps * 1e3,
            "profile_device_busy_ms_per_step":
                busy_s / steps * 1e3 if dev else None,
            "profile_top_kernels": top}


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ref

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
    }
    for name, t in times.items():
        print(f"[time] {name} {t['shape']}: kernel {t['ms']:.4f} ms "
              f"(eager with its host work {t['host_ms']:.4f} ms), plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
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
    serving.update(profile_decode(*shared[:3], "dense"))
    paged_serving.update(profile_decode(*shared[:3], "paged", paged=True,
                                        block_size=16))
    del shared
    parity = logits_parity()

    def bf16_err(checks):
        return max(c["max_abs_err"] for c in checks
                   if c["dtype"] == "bfloat16")

    def row(name, source, replaces, launches, err, tol, t, prefill, checks,
            arm, **extra):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches, max_abs_err=err,
                    tolerance=tol, ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t["library_ms"], library=t["library"],
                    shape=t["shape"], max_abs_diff=err, kernel_ms=t["ms"],
                    host_ms=t["host_ms"], launches_per_decode_step=28,
                    launches_arm=arm, prefill_chunk=prefill, checks=checks,
                    **extra)

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
    serving.update(paged=paged_serving, prefix_sharing=prefix_serving)
    print(json.dumps({"kernels": kernels, "serving": serving,
                      "parity_max_abs_diff": parity,
                      "total_s": time.perf_counter() - t_start}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
