#!/usr/bin/env python3
"""The distributed layer on one card, alone: ``chip_smoke.py``'s
``flash_decode`` log-sum-exp checks and times, its ``flash_attention``
query-offset checks, planted fault and times (the sequence-parallel
ranks' shapes), its ``ssd`` and ``ssd_bwd`` checks and times at the heads
of one of two model ranks and ``flash_attention`` at zamba2's shared
block's (the head-parallel Mamba-2 program's shapes), then its
``[dist:*]`` phases (two gloo ranks sharing the card; sizes, gates and
planted faults at ``chip_smoke.DIST_TRAIN_GATES``).  ``--serve`` runs
the mesh serving paths alone instead: the dense write's row-level clip
check and its planted fault, the f32 ``ssd`` forward against its float64
plain version, then only the ``[dist:prefill]`` and
``[dist:serve-engine]`` phases.

    python3 tools/dist_probe.py [--checks-only | --serve]

Any failed check or gate raises.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as tssd
    if not torch.cuda.is_available():
        raise SystemExit("dist_probe: no CUDA device")
    t0 = time.perf_counter()
    build.build_all()
    print(f"[probe] build {time.perf_counter() - t0:.1f}s; {cs._smi_line()}; "
          f"torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if "--serve" in sys.argv:
        cs.check_cache_update_clip(tfa, ref)
        cs.check_ssd_f32_exact(tssd, ref)
        cs.dist_phases(only=("prefill", "engine"))
        print(f"[probe] done in {time.perf_counter() - t0:.1f}s; "
              f"{cs._smi_line()}")
        return 0
    cs.check_flash_decode_lse(tfa, ref)
    cs.time_flash_decode_lse(tfa, ref)
    cs.check_flash_attention(tfa, ref, cs.FA_OFFSET_CASES)
    cs.check_offset_fault(tfa, ref)
    # the kernels as they were (q_offset 0) at the old training shape
    shapes = [("training", {})] + [
        (f"seqpar rank {r}", dict(S=cs.SEQPAR_ROWS, Sk=Sk, q_offset=off))
        for r, (Sk, off) in enumerate(cs.SEQPAR_RANKS)]
    for name, kw in shapes:
        t = cs.time_flash_attention(tfa, ref, **kw)
        for kind, key in (("flash_attention", "fwd"),
                          ("flash_attention_bwd", "bwd")):
            x = t[key]
            print(f"[time] {kind} {name} {x['shape']}: kernel "
                  f"{x['ms']:.4f} ms (eager {x['host_ms']:.4f}), plain "
                  f"{x['plain_ms']:.4f} ms, library {x['library_ms']:.4f} "
                  f"ms, bound {x['bound_ms']:.4f} ms ({x['bound_by']})",
                  flush=True)
    cs.check_ssd(tssd, ref, [c for dt in (torch.bfloat16, torch.float32)
                             for c in cs.ssd_rank_cases(dt)])
    cs.check_ssd_bwd(tssd, ref, [c for c in cs.SSD_BWD_CASES
                                 if c[0] in cs.SSD_RANK_HEADS])
    cs.check_flash_attention(tfa, ref, cs.ZAMBA2_RANK_FA_CASES)
    times = {}
    for model in cs.SSD_RANK_HEADS:
        t = cs.time_ssd_train(tssd, ref, model)
        times[f"ssd train {model}"] = t["fwd"]
        times[f"ssd_bwd train {model}"] = t["bwd"]
    t = cs.time_flash_attention(tfa, ref, cs.ZAMBA2_RANK_FA)
    times["flash_attention zamba2 rank"] = t["fwd"]
    times["flash_attention_bwd zamba2 rank"] = t["bwd"]
    for name, x in times.items():
        lib = (f"{x['library_ms']:.4f} ms" if x["library_ms"] is not None
               else "none")
        print(f"[time] {name} {x['shape']}: kernel {x['ms']:.4f} ms (eager "
              f"{x['host_ms']:.4f}), plain {x['plain_ms']:.4f} ms, library "
              f"{lib}, bound {x['bound_ms']:.4f} ms ({x['bound_by']})",
              flush=True)
    if "--checks-only" not in sys.argv:
        cs.dist_phases()
    print(f"[probe] done in {time.perf_counter() - t0:.1f}s; {cs._smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
