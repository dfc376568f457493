"""Training launcher of the port: the supervised, preemption-safe loop on
the card.

  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 3 \\
      --device cpu                                   # plain path, CPU
  PYTHONPATH=src python -m repro_torch.launch.train --batch 2 --seq 2048 \\
      --steps 6                                      # full width, one H100
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --no-reduced --batch 2 --seq 2048 --steps 6    # gemma2, one H100
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch \\
      olmoe-1b-7b --reduced --mesh 2x2 --backend gloo --device cpu \\
      --steps 3                                      # a 2x2 mesh, CPU

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
reference does, with the chips the world size of a ``--mesh`` run.

``--mesh`` (e.g. ``2x2``: data x model) runs one rank of a sharded run
per process: the process group starts from the environment, as
``torchrun`` sets it (``launch.mesh.init_distributed``; ``--backend``
nccl when every rank has its own card, gloo when ranks share a card or
run on the CPU), the state is sharded by the arch's own rule set
(``rules_name``: llama, minitron, gemma2 and phi3.5-moe train under
``seqparallel``, qwen2-vl under ``fsdp``, the others under ``default``),
each data-parallel rank takes its rows of the step's global batch (host
id = its data coordinate, so the losses are the one device's; under
``seqparallel`` the model ranks then split its sequence), checkpoints
are saved full and restored as the mesh's slices, and rank 0 prints.
mamba2 and zamba2 train head-parallel under their own ``default``; the
Mamba-2 stack and the hybrid under a sequence-parallel rule set raise,
naming ROADMAP item 14b (c2), before the process group starts.  On the card each rank uses card ``LOCAL_RANK`` modulo
the cards present, and only rank 0 reads NVML.
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
from repro_torch.launch.mesh import init_distributed, make_mesh_for
from repro_torch.models.lm import require_mesh_family
from repro_torch.models.layers import DP_AXES, Ctx
from repro_torch.models.params import resolve_device
from repro_torch.power import PodPowerArbiter, PowerManager, available_metrics
from repro_torch.runtime.supervisor import (PreemptionGuard,
                                            StragglerWatchdog, Supervisor)
from repro_torch.sharding import executed_rules
from repro_torch.train.phases import training_phase_tasks
from repro_torch.train.step import init_state, make_train_step, state_specs
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
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2x2 (data x model) or 2x2x2 (pod x data x "
                         "model): one rank per process, from the "
                         "environment")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                    help="collectives of a --mesh run: nccl (a card per "
                         "rank) or gloo (shared card, or CPU)")
    args = ap.parse_args(argv)

    cfg = get_model_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    run = get_run_config(args.arch, total_steps=args.steps,
                         remat="none" if args.reduced else "full",
                         logits_chunk=min(args.seq, 1024))
    mesh, rank0, dp = None, True, 1
    device_arg = args.device
    if args.mesh:
        rules = executed_rules(run.rules_name)   # before the group starts
        require_mesh_family(cfg, rules)
        init_distributed(args.backend)
        if device_arg == "cuda" and torch.cuda.is_available():
            local = int(os.environ.get("LOCAL_RANK", 0))
            device_arg = f"cuda:{local % torch.cuda.device_count()}"
        mesh = make_mesh_for(args.mesh)
        rank0 = mesh.rank == 0
    device = resolve_device(device_arg)
    if mesh is not None:
        ctx = Ctx(run, device, rules, mesh)
        dp = mesh.axis_size(DP_AXES)
        host = mesh.index(DP_AXES)
        if args.batch % dp:
            raise ValueError(f"--batch {args.batch} does not divide over "
                             f"{dp} data-parallel ranks")
        rows = slice(host * (args.batch // dp), (host + 1) * (args.batch // dp))
        specs = state_specs(cfg, run, ctx)
    else:
        ctx = Ctx(run, device)
        rows = slice(None)
        specs = None
    data = TokenSource(DataConfig(vocab=cfg.vocab, global_batch=args.batch,
                                  seq_len=args.seq))
    os.makedirs(args.ckpt_dir, exist_ok=True)
    say = print if rank0 else (lambda *a, **k: None)

    chips = mesh.size if mesh is not None else 1
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
        my_grant = grants[f"chip{mesh.rank % chips}"]
        pm.set_grant(my_grant)
        say(f"[pod] budget {arbiter.budget_w:.0f}W over {chips} chips; "
            f"{phase0}-phase grant {my_grant:.0f}W (installed as cap "
            f"ceiling)")
    meter = None
    if on_card and rank0:      # ranks that share a card: one reads NVML
        from repro_torch.power.nvml import NvmlBackend
        meter = NvmlBackend(device.index or 0)

    def train_once(restart: int) -> str:
        gen = torch.Generator(device=device).manual_seed(0)
        state = init_state(cfg, run, gen, device, ctx).tree()
        start = 0
        if checkpoint.available_steps(args.ckpt_dir):
            restored, start = checkpoint.restore(args.ckpt_dir, state,
                                                 shardings=specs, mesh=mesh)
            with torch.no_grad():
                for dst, src in zip(leaves(state), leaves(restored)):
                    dst.copy_(src)
            say(f"[restore] step {start} (restart #{restart})")
        step_fn = make_train_step(cfg, run, ctx)
        watchdog = StragglerWatchdog()
        tokens, t_loop = 0, time.perf_counter()
        e_prev = meter.energy_mj() if meter is not None else None
        with PreemptionGuard() as guard:
            for i in range(start, args.steps):
                t0 = time.perf_counter()
                batch = {k: torch.from_numpy(v[rows]).to(device)
                         for k, v in data.batch(i).items()}
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])         # waits for the step
                slow = watchdog.observe(i, time.perf_counter() - t0)
                tokens += batch["tokens"].numel() * dp
                e = pm.account_step()
                if meter is not None:
                    e_now = meter.energy_mj()
                    energy = (f"E={(e_now - e_prev) / 1e3:.2f}J "
                              f"(-{e['energy_saving_pct']:.1f}% modelled)")
                    e_prev = e_now
                else:
                    energy = (f"E={e['energy_j']:.2f}J "
                              f"(-{e['energy_saving_pct']:.1f}%)")
                say(f"step {i:5d} loss={loss:.4f} "
                    f"grad_norm={float(metrics['grad_norm']):.4f} {energy}"
                    f"{' [STRAGGLER]' if slow else ''}", flush=True)
                if (i + 1) % args.ckpt_every == 0 or guard.should_stop:
                    checkpoint.save(state, i + 1, args.ckpt_dir,
                                    shardings=specs, mesh=mesh)
                if guard.should_stop:
                    raise SystemExit(143)
        wall = time.perf_counter() - t_loop
        if tokens:
            say(f"[throughput] {tokens} tokens in {wall:.2f}s "
                f"({tokens / wall:.1f} tokens/s) on {device}")
        checkpoint.save(state, args.steps, args.ckpt_dir, shardings=specs,
                        mesh=mesh)
        return f"completed at step {args.steps}"

    try:
        result = Supervisor(max_restarts=args.max_restarts).run(train_once)
    finally:
        if meter is not None:
            meter.close()
    say(f"[supervisor] {result}")
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
