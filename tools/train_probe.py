#!/usr/bin/env python3
"""MoE and Mamba-2 training and the nemotron serving arms on one card,
through ``chip_smoke.py``'s own helpers: a quick check of the gradient
kernels and of those arms before a full ``chip_smoke.py`` run.

    python3 tools/train_probe.py [--no-arms | --arms-only]

Builds every kernel (printing ``ptxas -v``'s registers and spills of the
gradient kernels), then ``ssd`` (``check_ssd``, the training shape among
its cases), ``grouped_matmul_bwd`` and ``ssd_bwd`` against
their plain versions entry by entry (bf16 and f32, at the training shapes,
twice bit for bit), their planted faults, the bf16 gradient's shortcut
(``check_ssd_bwd_shortcut``), and their times beside their bounds
(``ssd_bwd``'s also by pass; the forward kernels' at the training
shapes, and the decode kernels' at nemotron's group of 6); then, unless
``--no-arms``, the ``[serve:minitron-dense]`` and
``[serve:nemotron-dense]`` arms, ``[train:olmoe]``, ``[train:mamba2]``,
``[train:zamba2]`` and the f32 parity steps of olmoe and mamba2.  Any
failed check raises.
"""

from __future__ import annotations

import contextlib
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs                  # puts this checkout's src first
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as tssd
    if not torch.cuda.is_available():
        raise SystemExit("train_probe: no CUDA device")
    t0 = time.perf_counter()
    build.build_all()
    print(f"[probe] build {time.perf_counter() - t0:.1f}s; {cs._smi_line()}; "
          f"torch {torch.__version__}", flush=True)
    print("[probe] ptxas -v: " + "; ".join(
        f"{k} {v}" for k, v in sorted(build.kernel_resources().items())
        if "bwd" in k), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    times = None
    if "--arms-only" not in sys.argv:
        times = checks_and_times(cs, tfa, gmm, ref, tssd)
    if "--no-arms" not in sys.argv:
        arms(cs, tfa)
    if times is not None:   # a profiler, after the arms
        cs.time_ssd_bwd_passes(tssd, times)
    print(f"[probe] done in {time.perf_counter() - t0:.1f}s")
    return 0


def checks_and_times(cs, tfa, gmm, ref, tssd):
    cs.check_ssd(tssd, ref)
    cs.check_grouped_matmul_bwd(gmm, ref)
    cs.check_grouped_matmul_bwd_faults(gmm, ref)
    cs.check_ssd_bwd(tssd, ref)
    cs.check_ssd_bwd_faults(tssd, ref)
    cs.check_ssd_bwd_shortcut(ref)
    times = {}
    for G, M, K, N in cs.GMM_TIME_SHAPES[-2:]:
        times[f"grouped_matmul M={M} {K}x{N}"] = cs.time_grouped_matmul(
            gmm, ref, G, M, K, N)
        times[f"grouped_matmul_bwd M={M} {K}x{N}"] = \
            cs.time_grouped_matmul_bwd(gmm, ref, G, M, K, N)
    for model in cs.SSD_HEADS:
        t = cs.time_ssd_train(tssd, ref, model)
        times[f"ssd train {model}"] = t["fwd"]
        times[f"ssd_bwd train {model}"] = t["bwd"]
    lens = [int(n) for n in __import__("numpy").random.default_rng(3)
            .integers(96, 1153, 8)]
    H, K, _ = cs.NEMOTRON_HEADS
    times["flash_decode decode g=6"] = cs.time_flash_decode(
        tfa, ref, 8, 1, lens, H=H, K=K)
    times["flash_decode prefill g=6"] = cs.time_flash_decode(
        tfa, ref, 1, 256, [768], H=H, K=K)
    for n, (B, Sn, idx) in (("decode", (8, 1, [96, 140, 333, 512, 700, 911,
                                                 1100, 2048])),
                            ("prefill", (1, 256, [512]))):
        times[f"cache_update rope {n} g=6"] = cs.time_rope_cache_update(
            tfa, ref, False, "nemotron", B, Sn, idx, rotary_pct=0.5)
    for name, t in times.items():
        lib = (f"{t['library_ms']:.4f} ms" if t["library_ms"] is not None
               else "none")
        print(f"[time] {name} {t['shape']}: kernel {t['ms']:.4f} ms (eager "
              f"{t['host_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, "
              f"library {lib}, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})", flush=True)
    return times


def arms(cs, tfa):
    from repro_torch.power.nvml import open_card
    with contextlib.ExitStack() as stack:
        cs.METER = open_card(stack, 0).nvml
        for arch, tag in ((cs.MINITRON_ARCH, "minitron-"),
                          (cs.NEMOTRON_ARCH, "nemotron-")):
            shared = cs.serve_full_width(tfa, arch, tag)
            del shared
            cs._release_card()
        for name, (arch, layers) in cs.TRAIN_ARMS.items():
            cs.train_full_width(tfa, arch, layers, "train:" + name)
        for name in ("olmoe", "mamba2"):
            cs.train_parity(tfa, cs.TRAIN_ARMS[name][0],
                            "train:parity-" + name)
        cs.METER = None


if __name__ == "__main__":
    sys.exit(main())
