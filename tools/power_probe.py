#!/usr/bin/env python3
"""The power phases of ``chip_smoke.py`` alone on one card, through its own
helpers: a quick check of the power backend (about three minutes of
command time) before a full ``chip_smoke.py`` run.

    python3 tools/power_probe.py

``[power:nvml]`` (the card's limits, the energy counter's update period,
one probe write), ``[power:calibrate]`` (idle, compute- and memory-bound
windows and the envelope fitted from them), then full-width llama3.2-3b
(seeded random weights, ``chip_smoke.py``'s engine settings): its graphed
dense arm, ``[power:table]`` (prefill and decode windows at every cap of
the sweep, or at the default limit where writes are refused) and
``[power:serve]`` (the arm under the measured SED caps, in the order
default, SED, SED, default where writes are allowed).  The limit in
force at the start is put back at the end, also on a failure.  Any
failed check raises.
"""

from __future__ import annotations

import contextlib
import signal
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
    from repro_torch.power.nvml import open_card
    if not torch.cuda.is_available():
        raise SystemExit("power_probe: no CUDA device")
    t0 = time.perf_counter()
    build.build_all()
    smi = cs._smi_line()
    print(f"[probe] build {time.perf_counter() - t0:.1f}s; {smi}; "
          f"torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    with contextlib.ExitStack() as stack:
        card = open_card(stack, 0)
        cs.METER = card.nvml
        try:
            info = cs.power_nvml(card)
            cs.power_calibrate(card.nvml)
            _, _, shared = cs.serve_full_width(tfa)
            table, _ = cs.power_table(tfa, card, *shared[:4])
            cs.power_serve(tfa, card, table, info, *shared)
        finally:
            cs.METER = None
    end = cs._smi_line()
    print(f"[probe] total {time.perf_counter() - t0:.1f}s; {end}", flush=True)
    if end != smi:
        raise AssertionError(f"the limit moved: {smi!r} -> {end!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
