#!/usr/bin/env python3
"""The distributed layer on one card, alone: ``chip_smoke.py``'s
``flash_decode`` log-sum-exp checks and times, then its ``[dist:*]``
phases (two gloo ranks sharing the card; sizes, gates and planted faults
at ``chip_smoke.DIST_TRAIN_GATES``).

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
    if "--checks-only" not in sys.argv:
        cs.dist_phases()
    print(f"[probe] done in {time.perf_counter() - t0:.1f}s; {cs._smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
