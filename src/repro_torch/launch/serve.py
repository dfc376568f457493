"""Serving launcher of the port: batched greedy generation on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 --new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \\
      --max-seq 2048 --batch-size 8 --prefill-chunk 256    # full width
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
      --no-reduced --max-seq 2048 --batch-size 8 --prefill-chunk 256
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --no-reduced --max-seq 2048 --batch-size 8 --prefill-chunk 256
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --no-reduced --max-seq 2048 --batch-size 8 --prefill-chunk 256

The flags are those of ``repro.launch.serve`` plus ``--device`` (default
``cuda``; ``--device cpu`` runs the plain PyTorch path).  ``--reduced``
can be turned off here (``--no-reduced``).  The JAX launcher's ``[caps]``
and ``[energy]`` lines come from its power manager on the TPU chip model;
they are left out until an H100 chip model is ported (ROADMAP queue 1
item 5), so ``--power-metric`` is accepted and not used yet.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import reduced as reduce_cfg
from repro_torch.configs.registry import (ARCH_IDS, get_model_config,
                                          get_run_config)
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.models.params import init_params, resolve_device
from repro_torch.serving.engine import Request, ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="decode tokens per host sync")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="max power-of-two prompt chunk per prefill step")
    ap.add_argument("--power-metric", default="sed", choices=["sed", "ed"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_model_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    run = get_run_config(args.arch, remat="none", logits_chunk=64)
    ctx = Ctx(run, device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(lm.model_decls(cfg), gen, device)
    engine = ServeEngine(cfg, run, ctx, params, batch_size=args.batch_size,
                         max_seq=args.max_seq,
                         prefill_chunk=args.prefill_chunk,
                         decode_chunk=args.decode_chunk)
    del params          # the engine holds its compute-dtype copy
    reqs = [Request(uid=i, prompt=[(5 * i + j) % cfg.vocab
                                   for j in range(4 + i % 5)],
                    max_new_tokens=args.new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = engine.generate(reqs)
    wall = time.perf_counter() - t0
    for r in done:
        print(f"req {r.uid}: {len(r.generated)} tokens -> "
              f"{r.generated[:8]}{'...' if len(r.generated) > 8 else ''}")
    n_tok = sum(len(r.generated) for r in done)
    print(f"[throughput] {n_tok} tokens in {wall:.2f}s "
          f"({n_tok / wall:.1f} tok/s, {engine.sync_count} host syncs) "
          f"on {device}")


if __name__ == "__main__":
    main()
