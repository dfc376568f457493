#!/usr/bin/env python3
"""The LSMS phases of ``chip_smoke.py`` alone on one card, through its own
helpers: a quick check of the LSMS port (``models/lsms.py``) before a full
``chip_smoke.py`` run.  It builds no kernel: LSMS runs on PyTorch's own
products and factorisations.

    python3 tools/lsms_probe.py

``[power:nvml]`` (the card's limits, the energy counter's update period,
one probe write), then ``[lsms:parity]``, ``[lsms:scf]``,
``[lsms:table1]``, ``[lsms:table2]``, ``[lsms:power]`` and
``[profile:lsms]`` as in the smoke run, and the ``{"lsms": ...}`` line.
The limit in force at the start is put back at the end, also on a
failure.  Any failed check raises.
"""

from __future__ import annotations

import contextlib
import json
import signal
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs                  # puts this checkout's src first
    import torch
    from repro_torch.power.nvml import open_card
    if not torch.cuda.is_available():
        raise SystemExit("lsms_probe: no CUDA device")
    t0 = time.perf_counter()
    smi = cs._smi_line()
    print(f"[probe] {smi}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    with contextlib.ExitStack() as stack:
        card = open_card(stack, 0)
        cs.METER = card.nvml
        try:
            cs.power_nvml(card)
            out = cs.lsms_phases(card)
        finally:
            cs.METER = None
    print(json.dumps({"lsms": out}))
    end = cs._smi_line()
    print(f"[probe] total {time.perf_counter() - t0:.1f}s; {end}", flush=True)
    if end != smi:
        raise AssertionError(f"the limit moved: {smi!r} -> {end!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
