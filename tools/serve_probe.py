#!/usr/bin/env python3
"""Serve the four families at full width and cut depth on one card, through
``chip_smoke.py``'s own helpers: a quick check of the serving path (about
a minute of command time) before a full ``chip_smoke.py`` run.

    python3 tools/serve_probe.py

Per family (llama3.2-3b at 2 layers, olmoe-1b-7b at 2, mamba2-370m at 4,
zamba2-1.2b at 7; seeded random weights, the engine settings of
``chip_smoke.py``): the warm-up request's capture seconds per prefill
chunk size, the graphed dense arm (exact launches, every prefill chunk a
graph replay), the ``eager=True`` arm (streams equal bit for bit), the
paged arm (mamba2 refuses paging), ``[serve:prefill-ab]`` with
PROBE_PAIRS pairs, llama's prefix-sharing arms and
``[serve:capture-refused]``, and the profiled graphed prefill of a
1024-row prompt.  Any failed check raises.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PROBE_PAIRS = 3
DEPTH = {"llama3.2-3b": 2, "olmoe-1b-7b": 2, "mamba2-370m": 4,
         "zamba2-1.2b": 7}


def main() -> int:
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs                  # puts this checkout's src first
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.serving.engine import Request
    if not torch.cuda.is_available():
        raise SystemExit("serve_probe: no CUDA device")
    t0 = time.perf_counter()
    build.build_all()
    print(f"[probe] build {time.perf_counter() - t0:.1f}s; {cs._smi_line()}; "
          f"torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.PREFILL_AB_PAIRS = PROBE_PAIRS
    for arch, depth in DEPTH.items():
        cfg = dataclasses.replace(get_model_config(arch), n_layers=depth)
        run = get_run_config(arch, remat="none")
        params = cs._card_weights(cfg, run)
        rng = np.random.default_rng(0)
        specs = [(rng.integers(0, cfg.vocab, int(rng.integers(64, 1025)))
                  .tolist(), int(rng.integers(32, 129)), 0)
                 for _ in range(16)]
        clock = cs.PhaseClock()
        engine = cs._engine(cfg, run, params, clock)
        engine.generate([Request(uid=-1, max_new_tokens=8, prompt=rng.integers(
            0, cfg.vocab, cs.WARM_LEN).tolist())])
        print(f"[probe] {arch} at {depth} layers: capture s by chunk size "
              + ", ".join(f"{n}: {g.capture_s:.3f}"
                          for n, g in engine.prefill_graphs.items())
              + f", decode {engine.graph.capture_s:.3f}", flush=True)
        done, wall, launches, joules = cs._serve(tfa, engine, clock, cfg,
                                                 specs)
        stats = cs._arm_stats(engine, clock, done, wall, specs, joules)
        cs._print_arm(arch + "-dense", stats, launches)
        cs._check_launches(arch, launches, cs._serving_launches(
            cfg, stats["decode_steps"], specs, False))
        dense = {r.uid: r.generated for r in done}
        del engine
        cs.serve_arm(tfa, cfg, run, params, specs, dense, arch + "-eager",
                     False, eager=True)
        if cfg.family != "ssm":
            cs.serve_arm(tfa, cfg, run, params, specs, dense, arch + "-paged",
                         True, gate_equal=not cfg.n_experts)
        cs.prefill_ab(tfa, cfg, run, params, specs)
        if arch == cs.ARCH:
            cs.serve_prefix_sharing(tfa, cfg, run, params)
            cs.capture_refused(cfg, run, params)
        cs.profile_prefill(cfg, run, params, arch + "-prefill")
        del params
        cs._release_card()
    print(f"[probe] total {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
