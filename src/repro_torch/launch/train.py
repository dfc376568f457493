"""Training launcher of the port: the supervised, preemption-safe loop on
the card.

  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 3 \\
      --device cpu                                   # plain path, CPU
  PYTHONPATH=src python -m repro_torch.launch.train --batch 2 --seq 2048 \\
      --steps 6                                      # full width, one H100
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --no-reduced --batch 2 --seq 2048 --steps 6    # gemma2, one H100

The flags are those of ``repro.launch.train`` plus ``--device`` (default
``cuda``; without a card it raises unless ``--device cpu`` is given), and
``--reduced`` can be turned off (``--no-reduced``).  It restores the
newest valid checkpoint, then runs the loop under the restart supervisor,
printing ``step i loss=... grad_norm=... E=...`` per step and a
``[throughput]`` line.  ``E=`` is, on the card, the step's joules on
NVML's energy counter (read where the loop already waits for the step's
loss, so it adds no sync; the counter moves every ~100 ms, so a shorter
step reads 0 or one update), beside the modelled saving of the
``--power-metric`` schedule on the H100 model (``hw/h100.py``); with
``--device cpu``, the reference's modelled step energy on the TPU model.
``--pod-budget-frac`` splits a pod budget over the chips as the
reference does; the port trains on one device, so that branch does not
run.  Left out until its slice: ``--mesh`` (ROADMAP queue 1 item 14,
distributed).
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
from repro_torch.power import PodPowerArbiter, PowerManager, available_metrics
from repro_torch.runtime.supervisor import (PreemptionGuard,
                                            StragglerWatchdog, Supervisor)
from repro_torch.train.phases import training_phase_tasks
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
    ap.add_argument("--power-metric", default="sed",
                    choices=available_metrics())
    ap.add_argument("--pod-budget-frac", type=float, default=0.85,
                    help="pod power budget as a fraction of N x p_max")
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

    chips = 1                       # one device: no --mesh yet
    on_card = device.type == "cuda"
    if on_card:
        from repro_torch.hw.h100 import H100_SUPERCHIP as spec
    else:
        from repro_torch.hw.tpu import DEFAULT_SUPERCHIP as spec
    tasks = training_phase_tasks(cfg, batch=args.batch, seq=args.seq,
                                 chips=chips)
    pm = PowerManager(tasks=tasks, metric=args.power_metric, spec=spec,
                      min_dwell_s=2e-4)
    if chips > 1 and pm.schedule.caps:
        # one pod budget split across the chips, each running the same
        # phase mix: the grant of the hungriest phase is installed as the
        # cap ceiling (as ``repro/launch/train.py:84-105``)
        phase0 = max(pm.schedule.caps, key=pm.schedule.caps.get)
        arbiter = PodPowerArbiter(
            budget_w=args.pod_budget_frac * chips * spec.p_max, spec=spec)
        grants = arbiter.split_phase(
            {f"chip{i}": pm.schedule for i in range(chips)}, phase0)
        pm.set_grant(grants["chip0"])
        print(f"[pod] budget {arbiter.budget_w:.0f}W over {chips} chips; "
              f"{phase0}-phase grant {grants['chip0']:.0f}W (installed as "
              f"cap ceiling)")
    meter = None
    if on_card:
        from repro_torch.power.nvml import NvmlBackend
        meter = NvmlBackend(device.index or 0)

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
        e_prev = meter.energy_mj() if meter is not None else None
        with PreemptionGuard() as guard:
            for i in range(start, args.steps):
                t0 = time.perf_counter()
                batch = {k: torch.from_numpy(v).to(device)
                         for k, v in data.batch(i).items()}
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])         # waits for the step
                slow = watchdog.observe(i, time.perf_counter() - t0)
                tokens += batch["tokens"].numel()
                e = pm.account_step()
                if meter is not None:
                    e_now = meter.energy_mj()
                    energy = (f"E={(e_now - e_prev) / 1e3:.2f}J "
                              f"(-{e['energy_saving_pct']:.1f}% modelled)")
                    e_prev = e_now
                else:
                    energy = (f"E={e['energy_j']:.2f}J "
                              f"(-{e['energy_saving_pct']:.1f}%)")
                print(f"step {i:5d} loss={loss:.4f} "
                      f"grad_norm={float(metrics['grad_norm']):.4f} {energy}"
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

    try:
        result = Supervisor(max_restarts=args.max_restarts).run(train_once)
    finally:
        if meter is not None:
            meter.close()
    print(f"[supervisor] {result}")


if __name__ == "__main__":
    main()
