"""Declarative parameters, as in ``repro/models/params.py``.

A model describes its parameters once, as a nested dict of ``PD`` leaves
(shape + logical axes + init style); ``init_params`` materializes them as
float32 tensors on a device with the reference's std rule, and
``load_numpy_params`` takes the JAX package's parameters, converted to
numpy by the caller, so both packages compute on the same weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths as _leaves


@dataclasses.dataclass(frozen=True)
class PD:
    """One parameter declaration."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"        # normal | zeros | ones | embed
    scale: float | None = None  # stddev override; default 1/sqrt(fan_in)
    dtype: torch.dtype = torch.float32   # master dtype (compute casts separately)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``cuda`` without a card raises:
    nothing carries on quietly on the CPU unless the caller asked for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port on the CPU")
    return dev


def _fan_in(shape: tuple[int, ...]) -> int:
    # as the reference: the product of all dims but the last -- including
    # a leading layer-stack dim on stacked leaves without an explicit scale
    # (e.g. the MLP's w_up), a quirk kept so the std rule is the same
    if len(shape) == 1:
        return shape[0]
    fan = 1
    for d in shape[:-1]:
        fan *= d
    return max(fan, 1)


def _set(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def init_params(decls, generator: torch.Generator, device="cuda"):
    """Materialize concrete float32 parameters on ``device``, drawing every
    leaf in turn from ``generator`` (a ``torch.Generator`` on that device
    or on the CPU).  Same std rule as the reference; not the same numbers
    (use ``load_numpy_params`` for those)."""
    dev = resolve_device(device)
    out: dict = {}
    for path, pd in _leaves(decls):
        if pd.init == "zeros":
            t = torch.zeros(pd.shape, dtype=pd.dtype, device=dev)
        elif pd.init == "ones":
            t = torch.ones(pd.shape, dtype=pd.dtype, device=dev)
        else:
            if pd.init == "embed":
                std = pd.scale if pd.scale is not None else 1.0
            else:
                std = (pd.scale if pd.scale is not None
                       else _fan_in(pd.shape) ** -0.5)
            t = torch.randn(pd.shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
            t = (t.to(dev) * std).to(pd.dtype)
        _set(out, path, t)
    return out


def param_count(decls) -> int:
    total = 0
    for _, pd in _leaves(decls):
        n = 1
        for d in pd.shape:
            n *= d
        total += n
    return total


def load_numpy_params(tree, device):
    """The JAX package's parameter tree, already converted leaf by leaf
    with ``np.asarray``, as tensors on ``device`` with the same keys and
    dtypes."""
    dev = resolve_device(device)
    out: dict = {}
    for path, a in _leaves(tree):
        _set(out, path, torch.from_numpy(np.array(a)).to(dev))   # owned copy
    return out


def load_numpy_state(tree, device):
    """The JAX package's train state ``{"params", "opt_state", "step"}``,
    converted leaf by leaf with ``np.asarray``, as the port's state tree:
    parameters and optimizer state on ``device``, ``step`` a 0-d int32
    tensor on the host (as ``repro_torch.train.step.init_state`` keeps
    it)."""
    out = load_numpy_params({k: v for k, v in tree.items() if k != "step"},
                            device)
    out["step"] = torch.tensor(int(np.asarray(tree["step"])),
                               dtype=torch.int32)
    return out
