"""Slot migration on the card (the ``cuda`` cases; they skip without one):
bf16, reduced llama3.2-3b, graphed.  A whole drain restored into the same
engine and into one of another geometry, or a partial drain, gives the
unpreempted streams; no graph is captured again and the split-KV counters
are left at zero.  The CPU tests against the JAX package are in
``tests/test_torch_migration.py``; this file imports no JAX."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import (get_model_config,  # noqa: E402
                                          get_run_config)
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

ARCH = "llama3.2-3b"
GEOM = {"g3": dict(batch_size=3, max_seq=32, decode_chunk=4),
        "g2": dict(batch_size=2, max_seq=48, decode_chunk=4)}
MIXED_PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [2, 4],
                 [9, 8, 7, 6, 5], [3, 1, 4, 1, 5, 9, 2, 6, 5]]
MIXED_NEW = [4, 6, 3, 5, 2]


def _reqs():
    return [Request(uid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(MIXED_PROMPTS, MIXED_NEW))]


def _streams(done):
    return {r.uid: list(r.generated) for r in done}


@pytest.fixture
def card():
    """The card, or a skip: decided here, never while the module is
    imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc to build the kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["whole", "partial"])
def test_round_trips_on_the_card(card, kind):
    cfg = reduced(get_model_config(ARCH))
    run = get_run_config(ARCH, remat="none")
    params = init_params(lm.model_decls(cfg),
                         torch.Generator().manual_seed(0), "cpu")

    def mk(geom):
        return ServeEngine(cfg, run, Ctx(run, "cuda"), params, **GEOM[geom])

    gold = _streams(mk("g3").generate(_reqs()))
    eng = mk("g3")
    eng.generate(_reqs())                  # captures every graph it needs
    graph, prefill = eng.graph, dict(eng.prefill_graphs)
    if kind == "whole":
        for target in ("same", "g2"):
            eng.start(_reqs())
            eng.step()
            snaps = eng.drain()
            dst = eng if target == "same" else mk(target)
            dst.restore(snaps)
            while dst.pending:
                dst.step()
            done = eng.finished + (dst.finished if dst is not eng else [])
            assert _streams(done) == gold, target
    else:
        eng.start(_reqs())
        eng.step()
        snaps = eng.drain(slots=eng.select_victims(1))
        assert len(snaps) == 1 and snaps[0].warm
        while eng.pending:
            eng.step()
        dst = mk("g2")
        dst.restore(snaps)
        while dst.pending:
            dst.step()
        assert _streams(eng.finished + dst.finished) == gold
    assert eng.graph is graph and eng.prefill_graphs == prefill
    for counters in tfa._counters.values():
        assert not counters.any()
