"""Training launcher of the port: the supervised, preemption-safe loop on
the card.

  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 3 \\
      --device cpu                                   # plain path, CPU
  PYTHONPATH=src python -m repro_torch.launch.train --batch 2 --seq 2048 \\
      --steps 6                                      # full width, one H100

The flags are those of ``repro.launch.train`` plus ``--device`` (default
``cuda``; without a card it raises unless ``--device cpu`` is given), and
``--reduced`` can be turned off (``--no-reduced``).  It restores the
newest valid checkpoint, then runs the loop under the restart supervisor,
printing ``step i loss=... grad_norm=...`` per step and a ``[throughput]``
line.  Left out until their slices: ``--mesh`` (ROADMAP queue 1 item 14,
distributed) and ``--power-metric``, ``--pod-budget-frac`` and the
``E=`` energy column (queue 1 item 5, the H100 power backend).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.ckpt import checkpoint
from repro_torch.configs.base import reduced as reduce_cfg
from repro_torch.configs.registry import (ARCH_IDS, get_model_config,
                                          get_run_config)
from repro_torch.data.pipeline import DataConfig, TokenSource
from repro_torch.models.layers import Ctx
from repro_torch.models.params import resolve_device
from repro_torch.runtime.supervisor import (PreemptionGuard,
                                            StragglerWatchdog, Supervisor)
from repro_torch.train.step import init_state, make_train_step
from repro_torch.tree import leaves


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False, help="reduced config (CPU-sized)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_model_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    run = get_run_config(args.arch, total_steps=args.steps,
                         remat="none" if args.reduced else "full",
                         logits_chunk=min(args.seq, 1024))
    ctx = Ctx(run, device)
    data = TokenSource(DataConfig(vocab=cfg.vocab, global_batch=args.batch,
                                  seq_len=args.seq))
    os.makedirs(args.ckpt_dir, exist_ok=True)

    def train_once(restart: int) -> str:
        gen = torch.Generator(device=device).manual_seed(0)
        state = init_state(cfg, run, gen, device).tree()
        start = 0
        if checkpoint.available_steps(args.ckpt_dir):
            restored, start = checkpoint.restore(args.ckpt_dir, state)
            with torch.no_grad():
                for dst, src in zip(leaves(state), leaves(restored)):
                    dst.copy_(src)
            print(f"[restore] step {start} (restart #{restart})")
        step_fn = make_train_step(cfg, run, ctx)
        watchdog = StragglerWatchdog()
        tokens, t_loop = 0, time.perf_counter()
        with PreemptionGuard() as guard:
            for i in range(start, args.steps):
                t0 = time.perf_counter()
                batch = {k: torch.from_numpy(v).to(device)
                         for k, v in data.batch(i).items()}
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])         # waits for the step
                slow = watchdog.observe(i, time.perf_counter() - t0)
                tokens += batch["tokens"].numel()
                print(f"step {i:5d} loss={loss:.4f} "
                      f"grad_norm={float(metrics['grad_norm']):.4f}"
                      f"{' [STRAGGLER]' if slow else ''}", flush=True)
                if (i + 1) % args.ckpt_every == 0 or guard.should_stop:
                    checkpoint.save(state, i + 1, args.ckpt_dir)
                if guard.should_stop:
                    raise SystemExit(143)
        wall = time.perf_counter() - t_loop
        if tokens:
            print(f"[throughput] {tokens} tokens in {wall:.2f}s "
                  f"({tokens / wall:.1f} tokens/s) on {device}")
        checkpoint.save(state, args.steps, args.ckpt_dir)
        return f"completed at step {args.steps}"

    result = Supervisor(max_restarts=args.max_restarts).run(train_once)
    print(f"[supervisor] {result}")


if __name__ == "__main__":
    main()
