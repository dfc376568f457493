"""Architecture registry of the port: ``--arch <id>`` -> (ModelConfig, RunConfig).

Every architecture of the JAX package's registry is listed, in its
order, so ``ARCH_IDS`` equals the reference's.  Two do not
fit one 80 GB card whole and wait for a host with two or more cards
(ROADMAP queue 1 item 14b (f)): ``phi3.5-moe-42b-a6.6b`` (41.87 B
parameters, 83.7 GB in bf16) runs at reduced size, and ``qwen2-vl-72b``
(72.7 B, 145 GB) serves on the card at 20 of its 80 layers.
"""

from __future__ import annotations

from repro_torch.configs import (gemma2_2b, hubert_xlarge, llama32_3b,
                                 mamba2_370m, minitron_4b, nemotron4_15b,
                                 olmoe, phi35_moe, qwen2_vl_72b, zamba2_1p2b)
from repro_torch.configs.base import ModelConfig, RunConfig

_MODULES = {      # the reference's order
    "phi3.5-moe-42b-a6.6b": phi35_moe,
    "olmoe-1b-7b": olmoe,
    "mamba2-370m": mamba2_370m,
    "zamba2-1.2b": zamba2_1p2b,
    "minitron-4b": minitron_4b,
    "llama3.2-3b": llama32_3b,
    "gemma2-2b": gemma2_2b,
    "nemotron-4-15b": nemotron4_15b,
    "hubert-xlarge": hubert_xlarge,
    "qwen2-vl-72b": qwen2_vl_72b,
}

ARCH_IDS = list(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; ported: {ARCH_IDS}")
    return _MODULES[arch]


def get_model_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_run_config(arch: str, **overrides) -> RunConfig:
    base = dict(getattr(_module(arch), "RUN_OVERRIDES", {}))
    base.update(overrides)
    return RunConfig(**base)
