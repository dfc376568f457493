#!/usr/bin/env python3
"""The slot-migration phases of ``chip_smoke.py`` alone on one card, through
its own helpers: a quick check of drain / restore / checkpoint and int8
snapshots on the graphed engine before a full ``chip_smoke.py`` run.

    python3 tools/migrate_probe.py

Per family at full width and depth, the dense arm the migrate arms are
held to (``serve_full_width``: seeded random weights and the smoke run's
16 requests; llama also the prefix arm's, and olmoe its no-drop arm), then
``[migrate:dense]``, ``[migrate:int8]``, ``[migrate:partial]`` and
``[migrate:paged]`` on llama and ``[migrate:olmoe|mamba2|zamba2]``, and a
``{"migrate": ...}`` line.  Any failed check raises.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FAMILIES = {"llama": "llama3.2-3b", "olmoe": "olmoe-1b-7b",
            "mamba2": "mamba2-370m", "zamba2": "zamba2-1.2b"}


def main() -> int:
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs                  # puts this checkout's src first
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as tfa
    if not torch.cuda.is_available():
        raise SystemExit("migrate_probe: no CUDA device")
    t0 = time.perf_counter()
    build.build_all()
    print(f"[probe] build {time.perf_counter() - t0:.1f}s; {cs._smi_line()}; "
          f"torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for fam, arch in FAMILIES.items():
        t1 = time.perf_counter()
        shared = cs.serve_full_width(tfa, arch, arch + "-")[2]
        if fam == "llama":
            _, pspecs, pstreams = cs.serve_prefix_sharing(tfa, *shared[:3])
            out.update(cs.migrate_llama(tfa, *shared, pspecs, pstreams))
        elif fam == "olmoe":
            _, cfg, streams = cs.serve_moe_no_drop(tfa, *shared[:4])
            out[fam] = cs.migrate_family(tfa, fam, cfg, *shared[1:4],
                                         streams)
        else:
            out[fam] = cs.migrate_family(tfa, fam, *shared)
        del shared
        cs._release_card()
        print(f"[probe] {fam} {time.perf_counter() - t1:.1f}s", flush=True)
    print(json.dumps({"migrate": out}))
    print(f"[probe] total {time.perf_counter() - t0:.1f}s; {cs._smi_line()}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
