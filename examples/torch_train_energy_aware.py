"""End-to-end energy-aware, fault-tolerant training on the PyTorch port;
the counterpart of ``examples/train_energy_aware.py``.

  PYTHONPATH=src python examples/torch_train_energy_aware.py --device cpu \\
      [--steps 30] [--size 100m|20m|tiny] [--ckpt-dir DIR] \\
      [--power-metric sed|ed] [--resume] [--kill-at N]
  PYTHONPATH=src python examples/torch_train_energy_aware.py --size 100m \\
      --steps 300                                             # the card

Every production feature in one loop:
  * a llama-family config (~100M, ~20M or tiny) + deterministic data
  * the port's train step (remat, chunked cross-entropy)
  * async checkpointing every --ckpt-every steps + exact resume
  * SIGTERM preemption guard (--kill-at simulates a preemption)
  * straggler watchdog (EWMA step-time monitor)
  * the paper's technique: per-phase power caps via SED/ED + energy ledger

The port has no sharding yet (ROADMAP item 14), so there are no
``RULE_SETS``: the loop trains on one device through the port's
unsharded ``Ctx``.  On the CPU the caps and ``E=`` are modelled on the
TPU superchip, as in the JAX example; on the card the caps come from
the H100 model (``hw/h100.py``) and ``E=`` is the step's joules on
NVML's energy counter, read where the loop already waits for the loss.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import tempfile
import time

import torch

from repro_torch.ckpt import checkpoint
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.data.pipeline import DataConfig, TokenSource
from repro_torch.models.layers import Ctx
from repro_torch.models.params import resolve_device
from repro_torch.power import PowerManager, available_metrics
from repro_torch.runtime.supervisor import PreemptionGuard, StragglerWatchdog
from repro_torch.train.phases import training_phase_tasks
from repro_torch.train.step import init_state, make_train_step
from repro_torch.tree import leaves

SIZES = {
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 head_dim=64, d_ff=2048, vocab=32000),
    "20m": dict(n_layers=6, d_model=384, n_heads=6, n_kv_heads=2,
                head_dim=64, d_ff=1024, vocab=8192),
    "tiny": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                 head_dim=32, d_ff=256, vocab=512),
}


def build_config(size: str) -> ModelConfig:
    return ModelConfig(name=f"ea-{size}", family="dense",
                       mlp="swiglu", norm="rmsnorm", **SIZES[size])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="tiny", choices=list(SIZES))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "ea_ckpt_torch"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--kill-at", type=int, default=-1,
                    help="send ourselves SIGTERM at this step (preemption "
                         "demo)")
    ap.add_argument("--power-metric", default="sed",
                    choices=available_metrics())
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = build_config(args.size)
    run = RunConfig(remat="none" if args.size == "tiny" else "full",
                    logits_chunk=min(args.seq, 512), total_steps=args.steps,
                    warmup_steps=max(args.steps // 10, 2),
                    power_metric=args.power_metric)
    ctx = Ctx(run, device)
    data = TokenSource(DataConfig(vocab=cfg.vocab, global_batch=args.batch,
                                  seq_len=args.seq))
    step_fn = make_train_step(cfg, run, ctx)

    os.makedirs(args.ckpt_dir, exist_ok=True)
    st = init_state(cfg, run, torch.Generator(device=device).manual_seed(0),
                    device).tree()
    start = 0
    if args.resume and checkpoint.available_steps(args.ckpt_dir):
        restored, start = checkpoint.restore(args.ckpt_dir, st)
        with torch.no_grad():
            for dst, src in zip(leaves(st), leaves(restored)):
                dst.copy_(src)
        print(f"[resume] restored step {start}")

    with contextlib.ExitStack() as stack:
        meter = None
        if device.type == "cuda":
            from repro_torch.power.nvml import open_card
            card = open_card(stack, device.index or 0)
            meter, spec = card.nvml, card.spec
        else:
            from repro_torch.hw.tpu import DEFAULT_SUPERCHIP as spec
        # -- the paper's technique wired into the loop ----------------------
        tasks = training_phase_tasks(cfg, batch=args.batch, seq=args.seq)
        pm = PowerManager(tasks=tasks, metric=args.power_metric, spec=spec,
                          min_dwell_s=2e-4)
        print(f"[caps:{args.power_metric}] "
              f"{ {k: round(v) for k, v in pm.schedule.caps.items()} }")

        watchdog = StragglerWatchdog()
        pending_ckpt = None
        loss = float("nan")
        e_prev = meter.energy_mj() if meter is not None else None
        with PreemptionGuard() as guard:
            for i in range(start, args.steps):
                if i == args.kill_at:
                    os.kill(os.getpid(), signal.SIGTERM)
                t0 = time.perf_counter()
                batch = {k: torch.from_numpy(v).to(device)
                         for k, v in data.batch(i).items()}
                st, metrics = step_fn(st, batch)
                loss = float(metrics["loss"])        # waits for the step
                dt = time.perf_counter() - t0
                slow = watchdog.observe(i, dt)
                e = pm.account_step()
                if meter is not None:
                    e_now = meter.energy_mj()
                    joules, e_prev = (e_now - e_prev) / 1e3, e_now
                    energy = f"E={joules:.3f}J (measured)"
                else:
                    energy = (f"E={e['energy_j']:.3f}J "
                              f"(-{e['energy_saving_pct']:.1f}%)")
                if i % 5 == 0 or slow:
                    print(f"step {i:4d} loss={loss:.4f} "
                          f"wall={dt*1e3:7.1f}ms {energy}"
                          f"{'  [STRAGGLER]' if slow else ''}")
                if (i + 1) % args.ckpt_every == 0 or guard.should_stop:
                    if pending_ckpt is not None:
                        pending_ckpt.join()
                    pending_ckpt = checkpoint.save(
                        st, i + 1, args.ckpt_dir, blocking=False)
                if guard.should_stop:
                    if pending_ckpt is not None:
                        pending_ckpt.join()
                    print(f"[preempted] checkpointed at step {i+1}; "
                          "exiting 143")
                    raise SystemExit(143)
        if pending_ckpt is not None:
            pending_ckpt.join()
    checkpoint.save(st, args.steps, args.ckpt_dir)
    print(f"[done] {args.steps} steps; final loss {loss:.4f}; straggler "
          f"events: {len(watchdog.events)}")


if __name__ == "__main__":
    main()
