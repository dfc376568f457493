"""Serving launcher of the port: batched greedy generation on the card,
with per-phase power capping.

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
``cuda``; ``--device cpu`` runs the plain PyTorch path), and
``--reduced`` can be turned off (``--no-reduced``).  Prefill and decode
run under their own caps, picked by ``--power-metric`` (any registered
metric), and the run prints the reference's ``[caps:<metric>]`` and
``[energy]`` lines:

* on the card, the caps come from the H100 model (``hw/h100.py``, the
  limits NVML reports) of the served shape, and a
  ``MeteredPowerManager`` writes them through NVML and measures each
  phase's seconds and joules on the card's energy counter; ``[energy]``
  gives the measured joules and J per generated token beside the
  modelled saving.  If the card refuses a probe write, the caps are only
  logged (``LoggingBackend``) and a ``[power]`` line says so.  The limit
  in force before the run is put back after it.
* ``--device cpu`` keeps the reference's simulated session: the full
  arch at production serving scale on the modelled TPU.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import torch

from repro_torch.configs.base import reduced as reduce_cfg
from repro_torch.configs.registry import (ARCH_IDS, get_model_config,
                                          get_run_config)
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.models.params import init_params, resolve_device
from repro_torch.power import PowerManager, available_metrics
from repro_torch.serving.engine import Request, ServeEngine, serve_phase_tasks


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
    ap.add_argument("--power-metric", default="sed",
                    choices=available_metrics())
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_model_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    with contextlib.ExitStack() as stack:
        pm, model, nvml = _power_session(args, cfg, device, stack)
        print(f"[caps:{args.power_metric}] "
              f"{ {k: round(v) for k, v in pm.schedule.caps.items()} }")
        done, wall, engine = _generate(args, cfg, device, pm)
        for r in done:
            print(f"req {r.uid}: {len(r.generated)} tokens -> "
                  f"{r.generated[:8]}"
                  f"{'...' if len(r.generated) > 8 else ''}")
        n_tok = sum(len(r.generated) for r in done)
        print(f"[throughput] {n_tok} tokens in {wall:.2f}s "
              f"({n_tok / wall:.1f} tok/s, {engine.sync_count} host syncs) "
              f"on {device}")
        e = model.account_step()
        dt, de = pm.overhead_totals()
        if nvml is None:
            print(f"[energy] modeled step {e['energy_j']:.1f}J "
                  f"(-{e['energy_saving_pct']:.1f}% vs uncapped); "
                  f"{pm.transitions} cap writes ({de*1e3:.1f} mJ overhead)")
        else:
            j = pm.total_joules()
            print(f"[energy] measured {j:.1f}J (prefill "
                  f"{pm.joules.get('prefill', 0.0):.1f}J, decode "
                  f"{pm.joules.get('decode', 0.0):.1f}J), "
                  f"{j / max(n_tok, 1):.3f} J per generated token; modeled "
                  f"saving of the caps {e['energy_saving_pct']:.1f}% vs "
                  f"uncapped; {pm.transitions} cap writes, "
                  f"{pm.apply_failures} failed, {pm.syncs} syncs of the "
                  "power session")


def _power_session(args, cfg, device, stack):
    """The run's power manager, the modelled session its ``[energy]``
    saving comes from, and, on the card, its ``NvmlBackend``.  On the
    card the manager's table starts as the model's and takes the
    measurements, so the saving is read from the untouched model."""
    if device.type != "cuda":
        # phase caps for the FULL arch at production serving scale; the
        # engine drives the same phases on the (reduced) model
        full = get_model_config(args.arch)
        pm = PowerManager(
            tasks=serve_phase_tasks(full, batch=128, prompt=32768,
                                    new_tokens=args.new, chips=256),
            metric=args.power_metric)
        return pm, pm, None
    from repro_torch.core.tasks import TaskTable
    from repro_torch.power.metered import MeteredPowerManager
    from repro_torch.power.nvml import open_card
    card = open_card(stack, device.index or 0)
    nvml, spec = card.nvml, card.spec
    if not card.writable:
        print(f"[power] limit writes refused ({card.probe.code}): caps are "
              f"logged, not applied; energy is measured at the "
              f"{nvml.limit_w():.2f} W limit in force")
    tasks = serve_phase_tasks(cfg, batch=args.batch_size,
                              prompt=args.max_seq, new_tokens=args.new)
    model = PowerManager(tasks=tasks, metric=args.power_metric, spec=spec)
    return MeteredPowerManager(
        TaskTable(list(model.table.rows)), tasks=tasks,
        metric=args.power_metric, backend=card.backend, meter=nvml,
        spec=spec), model, nvml


def _generate(args, cfg, device, pm):
    run = get_run_config(args.arch, remat="none", logits_chunk=64)
    ctx = Ctx(run, device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(lm.model_decls(cfg), gen, device)
    engine = ServeEngine(cfg, run, ctx, params, batch_size=args.batch_size,
                         max_seq=args.max_seq, power=pm,
                         prefill_chunk=args.prefill_chunk,
                         decode_chunk=args.decode_chunk)
    del params          # the engine holds its compute-dtype copy
    reqs = [Request(uid=i, prompt=[(5 * i + j) % cfg.vocab
                                   for j in range(4 + i % 5)],
                    max_new_tokens=args.new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = engine.generate(reqs)
    return done, time.perf_counter() - t0, engine


if __name__ == "__main__":
    main()
