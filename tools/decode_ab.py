#!/usr/bin/env python3
"""The serving engine's steady decode step on one card, compared across
source trees in turns: ``python3 tools/decode_ab.py --trees OLD . . OLD``.

Each tree (a checkout's root, whose ``src/`` holds ``repro_torch``) runs in
a process of its own, in the order given.  In each, the full-width dense
engines of llama3.2-3b, olmoe-1b-7b and zamba2-1.2b (seeded random
weights, bf16, batch 8, prompts of 128 tokens) take one step (admission
and the first decode chunk); then

  * two decode chunks (16 steps) on the host clock, ending in a
    synchronise, with CUDA events around each step's decode chunk
    (``chip_smoke._steps_ms``): wall and chunk-stream ms per step (a
    graph replay's device time, or an eager chunk's issue time); every
    model first, as launches slow down once the profiler has run;
  * two more chunks of a fresh engine under torch.profiler
    (``chip_smoke._profile_window``): device ms per step, the busy share
    and every device launch per step ("not measured" where the profiler
    does not see a CUDA graph's kernels).

Each tree's engine runs as that tree builds it: one whose ``ServeEngine``
has no ``eager=`` runs every decode chunk eagerly, one that graphs the
chunk by default replays its graph (``"graphed"`` in the line).  The
measuring code is this checkout's ``chip_smoke.py`` in every process, so
each tree is read the same way; only ``repro_torch`` differs.  One
``[ab]`` line per tree and model, then a summary of the turns.  Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("llama3.2-3b", "olmoe-1b-7b", "zamba2-1.2b")
PROMPT, NEW, STEPS = 128, 48, 2


def _steady_engine(cs, cfg, run, params):
    """A dense engine at batch 8 after its first step (admission and one
    decode chunk), every lane live for the next four chunks."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(7)
    engine = cs._engine(cfg, run, params, None)
    engine.start([Request(uid=100 + i,
                          prompt=rng.integers(0, cfg.vocab, PROMPT).tolist(),
                          max_new_tokens=NEW) for i in range(8)])
    engine.step()
    torch.cuda.synchronize()
    return engine


def one(tree: str) -> None:
    """Measure the tree ``tree`` (run in a process of its own)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs                  # puts this checkout's src first
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    import repro_torch
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as tfa
    if not torch.cuda.is_available():
        raise SystemExit("decode_ab: no CUDA device")
    src = Path(repro_torch.__file__).resolve().parents[1]
    build.build_all()
    models = {a: (get_model_config(a), get_run_config(a, remat="none"))
              for a in ARCHS}
    out = {a: {"tree": tree, "src": str(src), "arch": a} for a in ARCHS}
    for arch, (cfg, run) in models.items():          # host clock first
        params = cs._card_weights(cfg, run)
        engine = _steady_engine(cs, cfg, run, params)
        out[arch]["graphed"] = getattr(engine, "graph", None) is not None
        (out[arch]["wall_ms_per_step"],
         out[arch]["chunk_stream_ms_per_step"]) = cs._steps_ms(engine,
                                                               STEPS)
        del engine, params
        cs._release_card()
    for arch, (cfg, run) in models.items():          # then the profiler
        params = cs._card_weights(cfg, run)
        engine = _steady_engine(cs, cfg, run, params)

        def window():
            before = cs._wrapper_launches(tfa)
            for _ in range(STEPS):
                engine.step()
            torch.cuda.synchronize()
            return cs._wrapper_launches(tfa) - before

        prof = cs._profile_window(f"ab:{arch}", f"{tree}, steady decode",
                                  STEPS * engine.decode_chunk, window)
        out[arch].update(
            profiled_wall_ms_per_step=prof["profile_ms_per_step"],
            device_ms_per_step=prof["profile_device_busy_ms_per_step"],
            device_launches_per_step=prof["profile_device_launches_per_step"])
        del engine, params
        cs._release_card()
    for arch in ARCHS:
        print("[ab] " + json.dumps(out[arch]), flush=True)
    print(f"[ab] device {torch.cuda.get_device_name(0)} | nvidia-smi: "
          f"{cs._smi_line()}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", help="checkout roots, in turn")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(args.one)
        return 0
    if not args.trees:
        ap.error("--trees: give at least one checkout root")
    rows = []
    for tree in args.trees:
        res = subprocess.run([sys.executable, __file__, "--one", tree],
                             capture_output=True, text=True, timeout=900)
        sys.stdout.write(res.stdout)
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode:
            return res.returncode
        rows += [json.loads(line[5:]) for line in res.stdout.splitlines()
                 if line.startswith("[ab] {")]
    def num(x, fmt):
        return "not measured" if x is None else format(x, fmt)

    for arch in ARCHS:
        turns = [r for r in rows if r["arch"] == arch]
        print(f"[ab:summary] {arch}: " + "; ".join(
            f"{r['tree']} ({'graphed' if r['graphed'] else 'eager'}) wall "
            f"{r['wall_ms_per_step']:.2f} ms, chunk-stream "
            f"{r['chunk_stream_ms_per_step']:.3f} ms, device "
            f"{num(r['device_ms_per_step'], '.3f')} ms, "
            f"{num(r['device_launches_per_step'], '.1f')} launches per step"
            for r in turns), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
