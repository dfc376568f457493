"""Several graphed engines on one card, as the fleet steps them (the
``cuda`` cases; they skip without one): bf16, reduced llama3.2-3b.  Two
engines of different geometries stepped alternately from one thread give
the streams each gives stepped alone, and a ``ServeJob`` that sheds lanes
hands its in-flight streams to the other engine's job without changing a
token; the split-KV counters are left at zero.  The CPU tests against the
JAX package are in ``tests/test_torch_fleet_engine.py``; this file imports
no JAX."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import (get_model_config,  # noqa: E402
                                          get_run_config)
from repro_torch.fleet import ServeJob  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

ARCH = "llama3.2-3b"
GEOM = {"a": dict(batch_size=3, max_seq=32, decode_chunk=4),
        "b": dict(batch_size=3, max_seq=48, decode_chunk=4, paged=True,
                  block_size=8)}
PROMPTS = {"a": [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [2, 4], [9, 8, 7, 6, 5]],
           "b": [[3, 1, 4, 1, 5, 9, 2, 6, 5], [7, 7, 1]]}
NEW = {"a": [10, 12, 9, 11], "b": [14, 8]}


def _reqs(side):
    base = 100 if side == "b" else 0
    return [Request(uid=base + i, prompt=list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(PROMPTS[side], NEW[side]))]


def _streams(reqs):
    return {r.uid: list(r.generated) for r in reqs}


@pytest.fixture
def card():
    """The card, or a skip: decided here, never while the module is
    imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc to build the kernels)")
    return torch.device("cuda")


@pytest.fixture
def setup(card):
    cfg = reduced(get_model_config(ARCH))
    run = get_run_config(ARCH, remat="none")
    params = init_params(lm.model_decls(cfg),
                         torch.Generator().manual_seed(0), "cpu")

    def mk(side):
        return ServeEngine(cfg, run, Ctx(run, "cuda"), params, **GEOM[side])

    gold = {}
    for side in ("a", "b"):
        gold.update(_streams(mk(side).generate(_reqs(side))))
    return cfg, mk, gold


def _no_counters_left():
    for counters in tfa._counters.values():
        assert not counters.any()


@pytest.mark.cuda
def test_engines_stepped_alternately_equal_each_alone(setup):
    cfg, mk, gold = setup
    engines = {side: mk(side) for side in ("a", "b")}
    for side, eng in engines.items():
        eng.generate(_reqs(side))          # every graph captured
    reqs = {side: _reqs(side) for side in engines}
    for side, eng in engines.items():
        eng.start(reqs[side])
    while any(e.pending for e in engines.values()):
        for eng in engines.values():       # one thread, in turn
            eng.step()
    assert _streams(reqs["a"] + reqs["b"]) == gold
    for eng in engines.values():
        assert eng.graph.replays == eng.sync_count - 1
    _no_counters_left()


@pytest.mark.cuda
def test_a_shed_stream_moves_to_the_other_engine_unchanged(setup):
    cfg, mk, gold = setup
    reqs = {side: _reqs(side) for side in ("a", "b")}
    jobs = {side: ServeJob(f"job-{side}", cfg,
                           batch=GEOM[side]["batch_size"], prompt=8,
                           new_tokens=12, total_requests=len(reqs[side]),
                           decode_chunk=4, partial=True, migrate=True,
                           engine=mk(side), requests=reqs[side])
            for side in ("a", "b")}
    for job in jobs.values():
        job.advance(0.1)
    jobs["a"].preempt(max_slots=1)         # sheds two in-flight lanes
    assert jobs["a"].parked_streams == 2
    moved, tokens, nbytes = jobs["a"].donate_to(jobs["b"])
    assert moved >= 1 and tokens > 0 and nbytes > 0
    while not all(job.done for job in jobs.values()):
        for job in jobs.values():
            if not job.done:
                job.advance(0.1)
            if job is jobs["a"] and not job.done and \
                    not job.engine.pending and job.parked_streams:
                job.grow(job.capacity)     # the lanes it kept come back
    done = [r for job in jobs.values() for r in job.requests]
    assert sorted(r.uid for r in done) == sorted(gold)
    assert _streams(done) == gold
    _no_counters_left()
