#!/usr/bin/env python3
"""The distributed layer on one card, alone: ``chip_smoke.py``'s
``flash_decode`` log-sum-exp checks and times, its ``flash_attention``
query-offset checks, planted fault and times (the sequence-parallel
ranks' shapes), then its ``[dist:*]`` phases (two gloo ranks sharing the
card; sizes, gates and planted faults at ``chip_smoke.DIST_TRAIN_GATES``).

    python3 tools/dist_probe.py [--checks-only]

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
    if not torch.cuda.is_available():
        raise SystemExit("dist_probe: no CUDA device")
    t0 = time.perf_counter()
    build.build_all()
    print(f"[probe] build {time.perf_counter() - t0:.1f}s; {cs._smi_line()}; "
          f"torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
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
    if "--checks-only" not in sys.argv:
        cs.dist_phases()
    print(f"[probe] done in {time.perf_counter() - t0:.1f}s; {cs._smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
