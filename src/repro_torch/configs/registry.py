"""Architecture registry of the port: ``--arch <id>`` -> (ModelConfig, RunConfig).

Only the architectures whose layers and kernels are ported are listed.
Every other id of the JAX package's registry raises, naming the ROADMAP
item that ports it.  ``phi3.5-moe-42b-a6.6b`` is listed and runs at
reduced size; at full width its 41.87 B parameters (83.7 GB in bf16) do
not fit one 80 GB card and wait for the distributed slice (ROADMAP queue
1 item 14).
"""

from __future__ import annotations

from repro_torch.configs import (llama32_3b, mamba2_370m, olmoe, phi35_moe,
                                 zamba2_1p2b)
from repro_torch.configs.base import ModelConfig, RunConfig

_MODULES = {
    "llama3.2-3b": llama32_3b,
    "olmoe-1b-7b": olmoe,
    "phi3.5-moe-42b-a6.6b": phi35_moe,
    "mamba2-370m": mamba2_370m,
    "zamba2-1.2b": zamba2_1p2b,
}

#: Architectures of the JAX package not ported yet -> the ROADMAP item
#: (queue 1, "Modules to port") that brings them.
NOT_PORTED = {
    "gemma2-2b": "queue 1 item 11 (gemma2 and nemotron/minitron)",
    "nemotron-4-15b": "queue 1 item 11 (gemma2 and nemotron/minitron)",
    "minitron-4b": "queue 1 item 11 (gemma2 and nemotron/minitron)",
    "hubert-xlarge": "queue 1 item 12 (VLM and audio)",
    "qwen2-vl-72b": "queue 1 item 12 (VLM and audio)",
}

ARCH_IDS = list(_MODULES)


def _module(arch: str):
    if arch in _MODULES:
        return _MODULES[arch]
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: ROADMAP {NOT_PORTED[arch]}")
    raise KeyError(f"unknown arch {arch!r}; ported: {ARCH_IDS}")


def get_model_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_run_config(arch: str, **overrides) -> RunConfig:
    base = dict(getattr(_module(arch), "RUN_OVERRIDES", {}))
    base.update(overrides)
    return RunConfig(**base)
