"""Quickstart on the PyTorch port: train a reduced LM with the energy-aware
loop; the counterpart of ``examples/quickstart.py``.

  PYTHONPATH=src python examples/torch_quickstart.py --device cpu --steps 3
  PYTHONPATH=src python examples/torch_quickstart.py --steps 20   # the card

The public API end to end: config registry -> reduced model -> data
pipeline -> train step -> per-phase power-capping ledger.  The port has
no sharding yet (ROADMAP item 14), so there are no ``RULE_SETS``: the
loop runs on one device through the port's unsharded ``Ctx``.

* ``--device cpu``: the JAX example's ledger, the FULL arch's training
  phases at production scale (train_4k, 256 chips) on the modelled TPU
  superchip, while the loop trains the reduced model.
* on the card: the caps come from the H100 model (``hw/h100.py``) of the
  loop's own shape, and each step's joules are read from NVML's energy
  counter where the loop already waits for the loss (a step shorter than
  the counter's ~100 ms period reads 0 or one update).
"""

from __future__ import annotations

import argparse
import contextlib
import time

import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_model_config, get_run_config
from repro_torch.data.pipeline import DataConfig, TokenSource
from repro_torch.models.layers import Ctx
from repro_torch.models.params import resolve_device
from repro_torch.power import PowerManager, available_metrics
from repro_torch.train.phases import training_phase_tasks
from repro_torch.train.step import init_state, make_train_step

BATCH, SEQ = 8, 128


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--power-metric", default="sed",
                    choices=available_metrics())
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get_model_config(args.arch))
    run = get_run_config(args.arch, remat="none", logits_chunk=64,
                         power_metric=args.power_metric,
                         total_steps=args.steps)
    ctx = Ctx(run, device)
    data = TokenSource(DataConfig(vocab=cfg.vocab, global_batch=BATCH,
                                  seq_len=SEQ))
    st = init_state(cfg, run, torch.Generator(device=device).manual_seed(0),
                    device).tree()
    step_fn = make_train_step(cfg, run, ctx)

    with contextlib.ExitStack() as stack:
        meter = None
        if device.type == "cuda":
            from repro_torch.power.nvml import open_card
            card = open_card(stack, device.index or 0)
            meter, spec = card.nvml, card.spec
            tasks = training_phase_tasks(cfg, batch=BATCH, seq=SEQ)
        else:
            from repro_torch.hw.tpu import DEFAULT_SUPERCHIP as spec
            # the FULL arch at production scale, as the JAX example
            tasks = training_phase_tasks(get_model_config(args.arch),
                                         batch=256, seq=4096, chips=256)
        # 200 us dwell: one power-API write amortizes over phases >= 200 us
        pm = PowerManager(tasks=tasks, metric=args.power_metric, spec=spec,
                          min_dwell_s=2e-4)
        print(f"arch={cfg.name} params per-phase caps: "
              f"{ {k: round(v) for k, v in pm.schedule.caps.items()} }")
        e_prev = meter.energy_mj() if meter is not None else None
        for i in range(args.steps):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in data.batch(i).items()}
            st, metrics = step_fn(st, batch)
            loss = float(metrics["loss"])           # waits for the step
            dt = time.perf_counter() - t0
            stats = pm.account_step()
            if meter is not None:
                e_now = meter.energy_mj()
                energy = (f"measured: E={(e_now - e_prev) / 1e3:.2f}J; "
                          f"modelled saving {stats['energy_saving_pct']:.1f}%")
                e_prev = e_now
            else:
                energy = (f"modeled: E={stats['energy_j']:.2f}J (saved "
                          f"{stats['energy_saving_pct']:.1f}% vs uncapped)")
            print(f"step {i:3d} loss={loss:.4f} wall={dt*1e3:6.1f}ms "
                  f"{energy}")
    print("done.")


if __name__ == "__main__":
    main()
