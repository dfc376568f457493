"""Meshes of ranks, the port's counterpart of ``repro/launch/mesh.py``.

A ``Mesh`` holds named axes and their sizes (``.shape``, a dict, as a
``jax.sharding.Mesh``'s) and, when a process group is up, this rank's
coordinates and one process group per axis and per combination of axes
(the per-axis groups are a torch ``DeviceMesh``'s).  Ranks lie on the mesh
in row-major order, as ``np.array(devices).reshape(shape)`` lays devices.
A mesh without live ranks is shape-only: ``resolve_spec`` reads its shape,
and nothing else of it may be used.

``init_distributed`` starts the process group from the environment, as
``torchrun`` sets it (``RANK``, ``WORLD_SIZE`` and ``env://``'s
``MASTER_ADDR``/``MASTER_PORT``), or from ``DIST_INIT_METHOD`` (e.g. a
``file://`` store, which needs no port).  ``spawn_ranks`` starts a
program on N local ranks that way, each with a timeout, and returns each
rank's result: the CPU tests and the card's two-rank phases use it.

Backends: ``nccl`` when every rank has a card of its own; ``gloo`` when
ranks share a card, and on the CPU.  The caller names it; see
``sharding/collectives.py`` for what each does.
"""

from __future__ import annotations

import datetime
import itertools
import math
import os
import pickle
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

#: seconds a collective may wait before it raises (the process group's
#: timeout); ``DIST_TIMEOUT_S`` overrides it
DEFAULT_TIMEOUT_S = 600.0


class Mesh:
    """Named mesh axes over the ranks of the default process group (or
    over no ranks: shape-only).  ``coord(axis)`` is this rank's index
    along ``axis``; ``group(axes)`` the process group of the ranks that
    share every coordinate but those along ``axes`` (one axis name or a
    tuple), None when those axes have one rank."""

    def __init__(self, shape, axes, *, rank: int | None = None,
                 backend: str | None = None):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                             f"length")
        self.devices_shape = shape
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self.size = math.prod(shape)
        self.rank = rank
        self.backend = backend
        self.device_mesh = None
        self._groups: dict = {}
        if rank is None:
            self.coords = None
            return
        idx, coords = rank, {}
        for a, s in reversed(list(zip(axes, shape))):
            coords[a] = idx % s
            idx //= s
        self.coords = {a: coords[a] for a in axes}

    @property
    def live(self) -> bool:
        return self.rank is not None

    def coord(self, axis: str) -> int:
        if self.coords is None:
            raise RuntimeError("a shape-only mesh has no rank")
        return self.coords[axis]

    def axis_size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape.get(a, 1) for a in axes)

    def present(self, axes) -> tuple[str, ...]:
        """The axes of ``axes`` (one name or a tuple) this mesh has."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in axes if a in self.shape)

    def index(self, axes) -> int:
        """This rank's row-major index over the present ``axes`` (e.g. its
        data-parallel rank over ("pod", "data"))."""
        idx = 0
        for a in self.present(axes):
            idx = idx * self.shape[a] + self.coord(a)
        return idx

    def group(self, axes):
        axes = tuple(sorted(self.present(axes), key=self.axis_names.index))
        if self.axis_size(axes) == 1:
            return None
        return self._groups[axes]

    def _init_groups(self, device_type: str) -> None:
        """Every rank makes every group, in the same order."""
        from torch.distributed.device_mesh import DeviceMesh
        ranks = torch.arange(self.size).reshape(self.devices_shape)
        self.device_mesh = DeviceMesh(device_type, ranks,
                                      mesh_dim_names=self.axis_names)
        for a in self.axis_names:
            self._groups[(a,)] = self.device_mesh.get_group(a)
        # combinations of two or more axes (e.g. the data-parallel
        # ("pod", "data")): groups of their own
        for n in range(2, len(self.axis_names) + 1):
            for combo in itertools.combinations(range(len(self.axis_names)),
                                                n):
                names = tuple(self.axis_names[i] for i in combo)
                rest = [i for i in range(len(self.axis_names))
                        if i not in combo]
                moved = ranks.permute(*rest, *combo).reshape(
                    -1, math.prod(self.devices_shape[i] for i in combo))
                mine = None
                for row in moved.tolist():
                    g = dist.new_group(row)
                    if self.rank in row:
                        mine = g
                self._groups[names] = mine

    def __repr__(self):
        where = "shape-only" if self.rank is None else f"rank {self.rank}"
        return f"Mesh({self.shape}, {where}, backend={self.backend})"


def _parse(shape, axes):
    if isinstance(shape, str):
        shape = tuple(int(x) for x in shape.split("x"))
    if axes is None:
        axes = ("pod", "data", "model")[-len(shape):]
    return tuple(shape), tuple(axes)


def make_mesh_for(shape, axes=None, device_type: str | None = None) -> Mesh:
    """A mesh of ``shape`` (a tuple, or ``"2x4"``) over named ``axes``
    (default: the trailing names of ("pod", "data", "model")).  Over the
    live process group when one is up, which must hold exactly that many
    ranks; shape-only otherwise (a dry run, a test of the rules)."""
    shape, axes = _parse(shape, axes)
    if not dist.is_initialized():
        return Mesh(shape, axes)
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"process group has {world}")
    backend = dist.get_backend()
    mesh = Mesh(shape, axes, rank=dist.get_rank(), backend=backend)
    if device_type is None:
        device_type = "cuda" if backend == "nccl" else "cpu"
    mesh._init_groups(device_type)
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 ranks per pod; 2x16x16 = 512 across two pods.
    Shape-only unless a process group of that size is up."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_for(shape, axes)


def init_distributed(backend: str, timeout_s: float | None = None):
    """Start the default process group from the environment: ``RANK``,
    ``WORLD_SIZE`` and ``DIST_INIT_METHOD`` (default ``env://``, which
    reads ``MASTER_ADDR``/``MASTER_PORT`` as ``torchrun`` sets them).
    Returns (rank, world size).  The counterpart of the reference's
    ``maybe_init_distributed`` (``repro/launch/train.py:38-40``)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    if timeout_s is None:
        timeout_s = float(os.environ.get("DIST_TIMEOUT_S", DEFAULT_TIMEOUT_S))
    dist.init_process_group(
        backend, init_method=os.environ.get("DIST_INIT_METHOD", "env://"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world


def _rank_entry(rank, world, backend, init_method, out_dir, timeout_s, fn,
                args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), DIST_INIT_METHOD=init_method)
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        init_distributed(backend, timeout_s)
        result = ("ok", fn(rank, world, *args))
    except BaseException:           # reported to the parent, which raises
        result = ("error", traceback.format_exc())
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)
    if result[0] == "error":
        os._exit(1)          # the parent stops the ranks still waiting
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, backend: str = "gloo", args=(),
                timeout_s: float = 300.0, collective_timeout_s: float = 120.0):
    """Run ``fn(rank, world, *args)`` on ``world`` new processes (the
    ``spawn`` start method), each with the default process group up over a
    ``file://`` store in a temporary directory.  Returns the ranks' return
    values (picklable) in rank order.  A rank that raises, dies or is
    still running after ``timeout_s`` fails the call: every rank is then
    stopped and RuntimeError raised with what the ranks reported.  A
    collective waits at most ``collective_timeout_s``."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_entry, args=(world, backend, init, tmp,
                               collective_timeout_s, fn, tuple(args)),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        failure = None
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    failure = f"ranks still running after {timeout_s:.0f} s"
                    break
        except Exception as e:   # a rank died: ProcessExitedException
            failure = f"a rank failed: {e}"
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        results, errors = [], []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r}: no result")
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status == "ok":
                results.append(value)
            else:
                errors.append(f"rank {r}:\n{value}")
        if failure is not None or errors:
            raise RuntimeError("; ".join(filter(None, [failure] + errors)))
        return results
