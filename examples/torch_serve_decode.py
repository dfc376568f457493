"""Batched serving on the PyTorch port: prefill + continuous decode with
phase-level caps; the counterpart of ``examples/serve_decode.py``.

  PYTHONPATH=src python examples/torch_serve_decode.py --device cpu
  PYTHONPATH=src python examples/torch_serve_decode.py       # the card

Prefill is compute-bound (cap near max per SED); decode is memory-bound
(KV-cache streaming: a low cap is nearly free).  The port has no
sharding yet (ROADMAP item 14), so there are no ``RULE_SETS``: the
engine serves on one device through the port's unsharded ``Ctx``.

* ``--device cpu``: the JAX example's session, the FULL arch's serving
  phases at production scale (256 chips) on the modelled TPU superchip,
  driven by the engine serving the reduced model.
* on the card: a ``MeteredPowerManager`` on the H100 model of the served
  shape runs each phase under its cap (written through NVML where the
  card takes the write, else logged) and measures its seconds and joules
  on the card's energy counter.
"""

from __future__ import annotations

import argparse
import contextlib

import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_model_config, get_run_config
from repro_torch.core.tasks import TaskTable
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.models.params import init_params, resolve_device
from repro_torch.power import PowerManager
from repro_torch.serving.engine import Request, ServeEngine, serve_phase_tasks

BATCH, MAX_SEQ = 4, 64


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get_model_config(args.arch))
    run = get_run_config(args.arch, remat="none", logits_chunk=64)
    ctx = Ctx(run, device)
    params = init_params(lm.model_decls(cfg),
                         torch.Generator(device=device).manual_seed(0),
                         device)

    with contextlib.ExitStack() as stack:
        if device.type == "cuda":
            from repro_torch.power.metered import MeteredPowerManager
            from repro_torch.power.nvml import open_card
            card = open_card(stack, device.index or 0)
            spec = card.spec
            tasks = serve_phase_tasks(cfg, batch=BATCH, prompt=MAX_SEQ,
                                      new_tokens=args.new)
            model = PowerManager(tasks=tasks, metric="sed", spec=spec)
            pm = MeteredPowerManager(TaskTable(list(model.table.rows)),
                                     tasks=tasks, metric="sed",
                                     backend=card.backend, meter=card.nvml,
                                     spec=spec)
        else:
            from repro_torch.hw.tpu import DEFAULT_SUPERCHIP as spec
            # per-phase capping for the FULL arch at production serving
            # scale; the engine runs prefill/decode under these caps
            full = get_model_config(args.arch)
            pm = PowerManager(tasks=serve_phase_tasks(
                full, batch=128, prompt=32768, new_tokens=128, chips=256),
                metric="sed")

        engine = ServeEngine(cfg, run, ctx, params, batch_size=BATCH,
                             max_seq=MAX_SEQ, power=pm)
        reqs = [Request(uid=i, prompt=[(7 * i + j) % cfg.vocab
                                       for j in range(5 + i % 3)],
                        max_new_tokens=args.new)
                for i in range(args.requests)]
        done = engine.generate(reqs)
        for r in done[:4]:
            print(f"req {r.uid}: prompt={r.prompt} -> generated={r.generated}")
        if any(len(r.generated) != args.new for r in done):
            raise RuntimeError("a request did not get all its tokens")

        for metric in ("sed", "ed"):
            decisions = PowerManager(pm.table, metric=metric,
                                     spec=spec).decide()
            summary = {d.task: (round(d.cap),
                                f"-{d.energy_reduction_pct:.1f}%E",
                                f"+{d.runtime_increase_pct:.1f}%t")
                       for d in decisions}
            print(f"[{metric}] {summary}")
        print(f"[phases] {len(pm.history)} capped phase entries, "
              f"{pm.transitions} cap writes")
        if device.type == "cuda":
            print(f"[energy] measured {pm.total_joules():.1f} J (prefill "
                  f"{pm.joules.get('prefill', 0.0):.1f} J, decode "
                  f"{pm.joules.get('decode', 0.0):.1f} J) on "
                  f"{torch.cuda.get_device_name(device)}; caps "
                  + ("written" if card.writable else
                     f"logged, not applied ({card.probe.code})")
                  + f", {pm.apply_failures} failed writes")
    print("serving demo done.")


if __name__ == "__main__":
    main()
