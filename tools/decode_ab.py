#!/usr/bin/env python3
"""The serving engine's steady decode step, or the attention kernels'
times, on one card, compared across source trees in turns:
``python3 tools/decode_ab.py [--kernels] --trees OLD . . OLD``.

Each tree (a checkout's root, whose ``src/`` holds ``repro_torch``) runs in
a process of its own, in the order given, and builds its own kernels into
its ``build/``.  Without ``--kernels``, in each, the full-width dense
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
chunk by default replays its graph (``"graphed"`` in the line).  One
``[ab]`` line per tree and model, then a summary of the turns.

With ``--kernels``, each tree's attention kernels are timed instead at the
main paths' D = 64 and D = 128 shapes by ``chip_smoke.py``'s timers
(``time_flash_decode``, ``time_flash_decode_paged`` at llama's decode step
and 256-row chunk and zamba2's D = 64 chunk; ``time_flash_attention`` at
the training shape, forward and backward): one ``[kernel-ab]`` line per
tree, then a ``[kernel-ab:summary]`` line per row.  Each line also
carries a digest of ``flash_attention``'s and ``flash_attention_bwd``'s
outputs on fixed seeded inputs (``_digests``), and a
``[kernel-ab:digest]`` line says whether every tree's are equal: equal
digests are outputs equal bit for bit.

The measuring code is this checkout's ``chip_smoke.py`` in every process,
so each tree is read the same way; only ``repro_torch`` differs (each line
names the ``src`` it loaded).  Needs one CUDA card.
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


def _load(tree: str):
    """This checkout's ``chip_smoke`` and the tree's ``repro_torch``
    (``chip_smoke`` imports this checkout's on its way in: dropped)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    want = Path(tree).resolve() / "src"
    sys.path.insert(0, str(want))
    import torch
    import repro_torch
    from repro_torch.kernels import build
    src = Path(repro_torch.__file__).resolve().parents[1]
    if src != want:
        raise SystemExit(f"decode_ab: loaded {src}, not {want}")
    if not torch.cuda.is_available():
        raise SystemExit("decode_ab: no CUDA device")
    build.build_all()
    return cs, src


def _digests(cs, tfa) -> dict:
    """sha256 (16 hex digits) of the cache-free attention's outputs (out,
    lse, dq, dk, dv) on seeded inputs, bf16 and f32: llama's heads at the
    causal training shape, and a windowed, softcapped case of 1000 rows.
    The call passes no query offset, so a tree without one reads the same
    inputs the same way."""
    import hashlib
    import torch
    out = {}
    cases = {"causal S=2048": (2048, {}),
             "window 300 softcap 30 S=1000": (1000, dict(local_window=300,
                                                          softcap=30.0))}
    for dtype in (torch.bfloat16, torch.float32):
        for name, (S, kw) in cases.items():
            q, k, v, do = cs._attention_case(2, S, S, 24, 8, 128, dtype, 77)
            o, lse = tfa.flash_attention(q, k, v, **kw)
            grads = tfa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            h = hashlib.sha256()
            for t in (o, lse, *grads):
                h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                         .tobytes())
            out[f"{name} {str(dtype).split('.')[1]}"] = h.hexdigest()[:16]
    return out


def kernels(tree: str) -> None:
    """Time the tree ``tree``'s attention kernels (run in a process of
    its own)."""
    cs, src = _load(tree)
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    lens = np.random.default_rng(3).integers(96, 1153, 8).tolist()
    rows = {
        "flash_decode decode": cs.time_flash_decode(tfa, ref, 8, 1, lens),
        "flash_decode prefill": cs.time_flash_decode(tfa, ref, 1, 256,
                                                     [768]),
        "flash_decode prefill D=64": cs.time_flash_decode(
            tfa, ref, 1, 256, [768], H=32, K=32, D=64),
        "flash_decode_paged decode": cs.time_flash_decode_paged(
            tfa, ref, 8, 1, lens),
        "flash_decode_paged prefill": cs.time_flash_decode_paged(
            tfa, ref, 1, 256, [768]),
        "flash_decode_paged prefill D=64": cs.time_flash_decode_paged(
            tfa, ref, 1, 256, [768], H=32, K=32, D=64),
    }
    fa = cs.time_flash_attention(tfa, ref)
    rows["flash_attention training"] = fa["fwd"]
    rows["flash_attention_bwd training"] = fa["bwd"]
    from repro_torch.kernels import build
    ptxas = {k: v for k, v in build.kernel_resources().items()
             if "attn_" in k}
    print("[kernel-ab] " + json.dumps(
        {"tree": tree, "src": str(src),
         "ms": {k: v["ms"] for k, v in rows.items()},
         "digest": _digests(cs, tfa), "ptxas": ptxas}), flush=True)
    print(f"[kernel-ab] device {torch.cuda.get_device_name(0)} | "
          f"nvidia-smi: {cs._smi_line()}", flush=True)


def one(tree: str) -> None:
    """Measure the tree ``tree``'s decode step (run in a process of its
    own)."""
    cs, src = _load(tree)
    import torch
    from repro_torch.configs.registry import get_model_config, get_run_config
    from repro_torch.kernels import flash_attention as tfa
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
    ap.add_argument("--kernels", action="store_true",
                    help="time the attention kernels, not the decode step")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        (kernels if args.kernels else one)(args.one)
        return 0
    if not args.trees:
        ap.error("--trees: give at least one checkout root")
    tag = "[kernel-ab] {" if args.kernels else "[ab] {"
    rows = []
    for tree in args.trees:
        res = subprocess.run([sys.executable, __file__, "--one", tree]
                             + ["--kernels"] * args.kernels,
                             capture_output=True, text=True, timeout=900)
        sys.stdout.write(res.stdout)
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode:
            return res.returncode
        rows += [json.loads(line[len(tag) - 1:])
                 for line in res.stdout.splitlines() if line.startswith(tag)]
    if args.kernels:
        for key in rows[0]["ms"]:
            print(f"[kernel-ab:summary] {key}: " + ", ".join(
                f"{r['tree']} {r['ms'][key]:.4f}" for r in rows), flush=True)
        same = all(r["digest"] == rows[0]["digest"] for r in rows)
        print(f"[kernel-ab:digest] attention outputs bit for bit equal "
              f"across the trees: {same} ({rows[0]['digest']})", flush=True)
        return 0

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
