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
     bf16 and f32 (TF32 off), with stated tolerances; then kernel (device
     time, from a CUDA graph), plain-version and library times beside the
     card's least possible time (the bound);
  3. the main path: full-width llama3.2-3b (28 layers, seeded random
     weights) served by ``ServeEngine`` (batch 8, max_seq 2048, prefill
     chunk 256, decode chunk 8) on 16 seeded requests; every request must
     get exactly its tokens and both kernels must have launched;
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
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


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


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

class PhaseClock:
    """The engine's ``power=`` hook, used here as a stopwatch: each phase
    is bracketed by device synchronisation, so its seconds are the card's
    time for that phase (it adds syncs beyond the engine's own count)."""

    def __init__(self):
        self.seconds = {"prefill": 0.0, "decode": 0.0}
        self.entries = {"prefill": 0, "decode": 0}

    @contextlib.contextmanager
    def phase(self, name, calls=None):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield None
        torch.cuda.synchronize()
        self.seconds[name] += time.perf_counter() - t0
        self.entries[name] += 1


def serve_full_width(tfa):
    import torch
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import init_params, param_count
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.serving.scheduler import chunk_plan

    cfg = get_model_config(ARCH)
    run = get_run_config(ARCH, remat="none")          # bf16 compute
    ctx = Ctx(run, "cuda")
    decls = lm.model_decls(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(decls, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    clock = PhaseClock()
    engine = ServeEngine(cfg, run, ctx, params, batch_size=8, max_seq=2048,
                         prefill_chunk=256, decode_chunk=8, power=clock)
    del params                                        # f32 masters
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers d{cfg.d_model} "
          f"vocab {cfg.vocab}, {param_count(decls) / 1e9:.3f} B params, "
          f"weights ready in {time.perf_counter() - t0:.1f}s", flush=True)

    rng = np.random.default_rng(0)
    warm = Request(uid=-1, prompt=rng.integers(0, cfg.vocab, 64).tolist(),
                   max_new_tokens=8)
    engine.generate([warm])                   # first-call costs, not counted
    reqs = []
    for uid in range(16):
        plen = int(rng.integers(64, 1025))
        reqs.append(Request(uid=uid,
                            prompt=rng.integers(0, cfg.vocab, plen).tolist(),
                            max_new_tokens=int(rng.integers(32, 129))))
    clock.seconds = {"prefill": 0.0, "decode": 0.0}
    clock.entries = {"prefill": 0, "decode": 0}
    engine.sync_count = 0
    tfa.reset_launch_counts()
    t0 = time.perf_counter()
    done = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in tfa.KERNELS}

    if sorted(r.uid for r in done) != list(range(16)):
        raise AssertionError("not every request finished")
    for r in done:
        if len(r.generated) != r.max_new_tokens:
            raise AssertionError(f"request {r.uid}: {len(r.generated)} "
                                 f"tokens, wanted {r.max_new_tokens}")
        if not all(0 <= t < cfg.vocab for t in r.generated):
            raise AssertionError(f"request {r.uid}: token outside vocab")
    steps = engine.sync_count * engine.decode_chunk
    n_chunks = sum(len(chunk_plan(len(r.prompt), 256)) for r in reqs)
    want = {"cache_update": cfg.n_layers * steps,
            "flash_decode": cfg.n_layers * (steps + n_chunks)}
    if launches != want or min(launches.values()) <= 0:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    n_tok = sum(len(r.generated) for r in done)
    n_prompt = sum(len(r.prompt) for r in reqs)
    print(f"[serve] 16 requests, {n_prompt} prompt tokens, {n_tok} new "
          f"tokens in {wall:.2f}s: {n_tok / wall:.1f} tok/s; prefill "
          f"{clock.seconds['prefill']:.2f}s, decode "
          f"{clock.seconds['decode']:.2f}s; {engine.sync_count} host syncs "
          f"({steps} decode steps, {n_chunks} prefill chunks); launches "
          f"{launches} = {cfg.n_layers} per decode step each; "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    stats = {"wall_s": wall, "tok_per_s": n_tok / wall,
             "prefill_s": clock.seconds["prefill"],
             "decode_s": clock.seconds["decode"],
             "host_syncs": engine.sync_count, "decode_steps": steps,
             "prefill_chunks": n_chunks,
             "max_memory_allocated_gib":
                 torch.cuda.max_memory_allocated() / 2**30}
    stats.update(profile_decode(engine, cfg, rng))
    del engine
    torch.cuda.empty_cache()
    return launches, stats


def profile_decode(engine, cfg, rng):
    """Where a steady decode step's time goes: two decode chunks of 8
    full lanes under torch.profiler (after the main path, so its launch
    counts are already read).  Device busy share = the kernels' summed
    device time over the window's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import Request

    engine.power = None                       # no stopwatch syncs inside
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
        print(f"[profile] steady decode, 8 lanes: {wall / steps * 1e3:.2f} ms "
              f"per step, device busy {busy_s / steps * 1e3:.2f} ms per step "
              f"({100 * busy_s / wall:.1f}% busy, "
              f"{100 * (1 - busy_s / wall):.1f}% idle)", flush=True)
        for row in top:
            print(f"[profile]   {row['ms_per_step']:.3f} ms/step "
                  f"x{row['launches_per_step']:.0f}  {row['kernel']}",
                  flush=True)
    else:
        print("[profile] the profiler saw no device events: device busy "
              "share not measured", flush=True)
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
    rng = np.random.default_rng(3)
    fd_time = time_flash_decode(tfa, ref, 8, 1,
                                rng.integers(96, 1153, 8).tolist())
    fd_prefill = time_flash_decode(tfa, ref, 1, 256, [768])
    cu_time = time_cache_update(tfa, ref)
    for name, t in (("flash_decode decode", fd_time),
                    ("flash_decode prefill", fd_prefill),
                    ("cache_update", cu_time)):
        print(f"[time] {name} {t['shape']}: kernel {t['ms']:.4f} ms "
              f"(eager with its host work {t['host_ms']:.4f} ms), plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})", flush=True)

    launches, serving = serve_full_width(tfa)
    parity = logits_parity()

    bf16_err = max(c["max_abs_err"] for c in fd_checks
                   if c["dtype"] == "bfloat16")
    kernels = [
        dict(name="flash_decode", route="cuda",
             source="src/repro_torch/kernels/csrc/decode_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:212",
             launches=launches["flash_decode"], max_abs_err=bf16_err,
             tolerance=DECODE_TOL["bfloat16"], ms=fd_time["ms"],
             plain_ms=fd_time["plain_ms"], bound_ms=fd_time["bound_ms"],
             bound_by=fd_time["bound_by"], library_ms=fd_time["library_ms"],
             library="F.scaled_dot_product_attention(enable_gqa=True) "
                     "over the whole cache with a length mask",
             shape=fd_time["shape"], max_abs_diff=bf16_err,
             kernel_ms=fd_time["ms"], host_ms=fd_time["host_ms"],
             launches_per_decode_step=28,
             prefill_chunk=fd_prefill, checks=fd_checks),
        dict(name="cache_update", route="cuda",
             source="src/repro_torch/kernels/csrc/cache_update.cu",
             replaces="src/repro/kernels/flash_attention.py:394",
             launches=launches["cache_update"], max_abs_err=0.0,
             tolerance=0.0, ms=cu_time["ms"], plain_ms=cu_time["plain_ms"],
             bound_ms=cu_time["bound_ms"], bound_by=cu_time["bound_by"],
             library_ms=cu_time["library_ms"], library=cu_time["library"],
             shape=cu_time["shape"], max_abs_diff=0.0,
             kernel_ms=cu_time["ms"], host_ms=cu_time["host_ms"],
             launches_per_decode_step=28,
             checks=cu_checks),
    ]
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
