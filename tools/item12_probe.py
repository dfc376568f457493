#!/usr/bin/env python3
"""hubert-xlarge's and qwen2-vl-72b's kernels and arms on one card,
through ``chip_smoke.py``'s own helpers: a quick check of the head_dim 80
attention and of those arms before a full ``chip_smoke.py`` run.

    python3 tools/item12_probe.py [--no-arms | --arms-only]

Builds every kernel (printing ``ptxas -v``'s registers and spills of the
attention kernels), then ``flash_attention`` and ``flash_attention_bwd``
at D = 80 against their plain versions entry by entry (hubert's heads,
bidirectional, odd lengths, one causal case; bf16 and f32), the planted
fault of columns 64-79, their times beside SDPA and the bound at D = 80,
and ``flash_decode`` and ``cache_update`` (M-RoPE's cos/sin) at
qwen2-vl's heads, checked and timed; then, unless ``--no-arms``,
``[serve:qwen2vl-dense]`` and ``[prefill:qwen2vl-vision]`` (20 of its 80
layers), ``[encode:hubert]``, ``[parity:qwen2vl]``, ``[parity:hubert]``,
``[train:hubert]`` and the f32 parity steps of hubert and reduced
qwen2-vl.  Any failed check raises.
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
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        raise SystemExit("item12_probe: no CUDA device")
    t0 = time.perf_counter()
    build.build_all()
    print(f"[probe] build {time.perf_counter() - t0:.1f}s; {cs._smi_line()}; "
          f"torch {torch.__version__}", flush=True)
    print("[probe] ptxas -v: " + "; ".join(
        f"{k} {v}" for k, v in sorted(build.kernel_resources().items())
        if "attn" in k), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if "--arms-only" not in sys.argv:
        checks_and_times(cs, tfa, ref)
    if "--no-arms" not in sys.argv:
        arms(cs, tfa)
    print(f"[probe] done in {time.perf_counter() - t0:.1f}s")
    return 0


def checks_and_times(cs, tfa, ref):
    cs.check_flash_attention(tfa, ref, cs.HUBERT_FA_CASES)
    cs.check_d80_faults(tfa, ref)
    cs.check_qwen2vl_decode(tfa, ref)
    t = cs.time_flash_attention(tfa, ref, cs.HUBERT_HEADS,
                                B=cs.HUBERT_TRAIN[0], S=cs.HUBERT_TRAIN[1],
                                causal=False)
    times = {"flash_attention training D=80": t["fwd"],
             "flash_attention_bwd training D=80": t["bwd"]}
    lens = [int(n) for n in __import__("numpy").random.default_rng(3)
            .integers(96, 1153, 8)]
    H, K, D = cs.QWEN2VL_HEADS
    for kind, B, Sq, kv_len, index in (
            ("decode", 8, 1, lens, [96, 140, 333, 512, 700, 911, 1100,
                                    2048]),
            ("prefill", 1, 256, [768], [512]),
            ("vision", 1, cs.VISION_S, [cs.VISION_S], [0])):
        times[f"flash_decode {kind} qwen2vl"] = cs.time_flash_decode(
            tfa, ref, B, Sq, kv_len, H=H, K=K, D=D)
        times[f"cache_update rope {kind} qwen2vl"] = \
            cs.time_rope_cache_update(tfa, ref, False, "qwen2vl", B, Sq,
                                      index)
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
        cs.serve_qwen2vl(tfa)
        cs.encode_hubert(tfa)
        cs.item12_parity(cs.QWEN2VL_ARCH, "parity:qwen2vl")
        cs.item12_parity(cs.HUBERT_ARCH, "parity:hubert")
        cs.train_full_width(tfa, cs.HUBERT_ARCH, tag="train:hubert",
                            profile=False, shape=cs.HUBERT_TRAIN)
        cs.train_parity(tfa, cs.HUBERT_ARCH, "train:parity-hubert")
        cs.train_parity(tfa, cs.QWEN2VL_ARCH, "train:parity-qwen2vl",
                        reduce=True)
        cs.METER = None


if __name__ == "__main__":
    sys.exit(main())
