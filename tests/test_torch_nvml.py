"""The card's power backend on the CPU: ``NvmlBackend`` over a fake NVML
table and ``MeteredPowerManager`` with a fake meter and sync, the
launchers' power lines under ``--device cpu`` against the reference's
numbers, and (marked ``cuda``, skipped without a card) the real NVML."""

import atexit

import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_model_config as jget_cfg  # noqa: E402
from repro.power import PowerManager as JPowerManager  # noqa: E402
from repro.serving.engine import serve_phase_tasks as jserve_tasks  # noqa: E402
from repro.train.phases import training_phase_tasks as jtrain_tasks  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import (get_model_config,  # noqa: E402
                                          get_run_config)
from repro_torch.core.power_model import measure_sweep  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.hw.h100 import H100_SUPERCHIP  # noqa: E402
from repro_torch.power import LoggingBackend, PowerManager  # noqa: E402
from repro_torch.power import metered as metered_mod  # noqa: E402
from repro_torch.power import nvml as nvml_mod  # noqa: E402
from repro_torch.power.metered import MeteredPowerManager  # noqa: E402
from repro_torch.power.nvml import NvmlBackend, NvmlError  # noqa: E402
from repro_torch.serving.engine import (Request, ServeEngine,  # noqa: E402
                                        serve_phase_tasks)

BUS = "0000:3b:00.0"


class FakeNvml:
    """NVML's functions of ``nvml.SIGNATURES`` over a little state, each
    call logged; ``refuse`` makes limit writes return NO_PERMISSION and
    ``clamp`` makes the card keep a limit other than the one asked."""

    def __init__(self, limit_mw=700_000, refuse=False, clamp=None):
        self.limit_mw, self.default_mw = limit_mw, 700_000
        self.range_mw = (200_000, 700_000)
        self.energy = 1_000_000
        self.refuse, self.clamp = refuse, clamp
        self.log, self.bus = [], None

    def table(self):
        def ok(name):
            def f(*args):
                self.log.append(name)
                return 0
            return f

        def handle(bus, out):
            self.bus = bus
            out.contents.value = 42
            return 0

        def name(h, buf, n):
            buf.value = b"Fake H100"
            return 0

        def get(attr):
            def f(h, out):
                out.contents.value = getattr(self, attr)
                return 0
            return f

        def constraints(h, lo, hi):
            lo.contents.value, hi.contents.value = self.range_mw
            return 0

        def set_limit(h, mw):
            self.log.append(("set", mw.value))
            if self.refuse:
                return 4                      # NVML_ERROR_NO_PERMISSION
            self.limit_mw = self.clamp or mw.value
            return 0

        def energy(h, out):
            self.log.append("energy")
            out.contents.value = self.energy
            return 0

        return {"nvmlInit_v2": ok("init"), "nvmlShutdown": ok("shutdown"),
                "nvmlDeviceGetHandleByPciBusId_v2": handle,
                "nvmlDeviceGetName": name,
                "nvmlDeviceGetPowerManagementLimit": get("limit_mw"),
                "nvmlDeviceGetPowerManagementDefaultLimit": get("default_mw"),
                "nvmlDeviceGetPowerManagementLimitConstraints": constraints,
                "nvmlDeviceSetPowerManagementLimit": set_limit,
                "nvmlDeviceGetTotalEnergyConsumption": energy,
                "nvmlDeviceGetPowerUsage": get("power_mw")}

    power_mw = 123_456


def _backend(fake):
    return NvmlBackend(table=fake.table(), bus_id=BUS, transition_s=1e-3)


def test_nvml_absent_here():
    """This host has no ``libnvidia-ml.so.1``: not available, and a
    backend without a table says so."""
    assert not nvml_mod.available()
    assert nvml_mod.load_table() is None
    with pytest.raises(RuntimeError, match="libnvidia-ml.so.1 not found"):
        NvmlBackend(bus_id=BUS)


def test_table_covers_every_signature():
    assert set(FakeNvml().table()) == set(nvml_mod.SIGNATURES)


def test_handle_by_pci_bus_id_and_reads():
    fake = FakeNvml()
    b = _backend(fake)
    assert fake.bus == BUS.encode() and fake.log[0] == "init"
    assert b.name() == "Fake H100"
    assert b.limit_w() == 700.0 and b.default_limit_w() == 700.0
    assert b.limit_range_w() == (200.0, 700.0)
    assert b.energy_mj() == 1_000_000 and b.power_mw() == 123_456
    b.close()
    b.close()
    assert fake.log.count("shutdown") == 1


def test_cuda_bus_id_form(monkeypatch):
    props = type("P", (), dict(pci_domain_id=0, pci_bus_id=0x3B,
                               pci_device_id=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: props)
    assert nvml_mod.cuda_pci_bus_id(0) == "0000:3b:00.0"


def test_apply_writes_milliwatts_and_reads_back():
    fake = FakeNvml()
    b = _backend(fake)
    b.apply(262.5)
    assert ("set", 262_500) in fake.log
    assert b.current_cap == 262.5 and b.writes == 1
    assert b.transition_seconds < 1.0
    assert b.measure(None, 262.5) is None


def test_refused_write_counts_as_apply_failure():
    """NO_PERMISSION raises NvmlError (a RuntimeError naming the code),
    which the manager counts and survives; a clamped limit too."""
    fake = FakeNvml(refuse=True)
    b = _backend(fake)
    with pytest.raises(NvmlError, match="NVML_ERROR_NO_PERMISSION"):
        b.apply(300.0)
    tasks = serve_phase_tasks(reduced(get_model_config("llama3.2-3b")),
                              batch=2, prompt=32, new_tokens=4)
    pm = PowerManager(measure_sweep(tasks), tasks=tasks, backend=b)
    assert not pm.apply_cap(300.0)
    assert pm.apply_failures == 1 and pm.transitions == 0
    clamped = _backend(FakeNvml(clamp=450_000))
    pm = PowerManager(measure_sweep(tasks), tasks=tasks, backend=clamped)
    assert not pm.apply_cap(300.0) and pm.apply_failures == 1


@pytest.mark.parametrize("refuse", [False, True])
def test_probe_reports_and_restores(refuse):
    fake = FakeNvml(refuse=refuse)
    res = _backend(fake).probe(600.0)
    assert res.writable is not refuse
    assert res.code == ("NVML_ERROR_NO_PERMISSION" if refuse
                        else "NVML_SUCCESS")
    assert res.read_back_w == (700.0 if refuse else 600.0)
    assert fake.limit_mw == 700_000


@pytest.mark.parametrize("refuse", [False, True])
def test_open_card_session(refuse):
    """``open_card``: the spec takes NVML's limits, one probe write of the
    maximum less ``PROBE_BELOW_MAX_W`` decides the backend (NVML where it
    lands, a ``LoggingBackend`` where it is refused), and closing the
    stack puts the limit in force at the open back and shuts NVML."""
    import contextlib
    fake = FakeNvml(refuse=refuse)
    fake.range_mw = (250_000, 650_000)
    with contextlib.ExitStack() as stack:
        card = nvml_mod.open_card(stack, nvml=_backend(fake))
        assert card.limit_w == 700.0
        assert ("set", round(1e3 * (650.0 - nvml_mod.PROBE_BELOW_MAX_W))) \
            in fake.log
        assert card.writable is not refuse
        assert card.probe.code == ("NVML_ERROR_NO_PERMISSION" if refuse
                                   else "NVML_SUCCESS")
        assert (card.spec.limit_min, card.spec.limit_max,
                card.spec.p_default) == (250.0, 650.0, 700.0)
        assert card.spec.chip == H100_SUPERCHIP.chip
        if refuse:
            assert isinstance(card.backend, LoggingBackend)
        else:
            assert card.backend is card.nvml
            card.backend.apply(300.0)
    assert fake.limit_mw == 700_000 and fake.log[-1] == "shutdown"


def test_restore_limit_after_an_exception(monkeypatch):
    registered = []
    monkeypatch.setattr(atexit, "register", registered.append)
    monkeypatch.setattr(atexit, "unregister", registered.remove)
    fake = FakeNvml()
    b = _backend(fake)
    with pytest.raises(ValueError):
        with b.restore_limit_on_exit() as saved:
            assert saved == 700.0 and len(registered) == 1
            b.apply(250.0)
            raise ValueError("boom")
    assert fake.limit_mw == 700_000 and registered == []
    # an unchanged limit is not written again; the atexit hook restores
    with b.restore_limit_on_exit():
        pass
    assert fake.log.count(("set", 700_000)) == 1
    with b.restore_limit_on_exit():
        b.apply(300.0)
        registered[0]()               # as at interpreter exit
        assert fake.limit_mw == 700_000


def test_energy_counter_going_backwards_raises():
    fake = FakeNvml()
    b = _backend(fake)
    b.energy_mj()
    fake.energy -= 1
    with pytest.raises(RuntimeError, match="backwards"):
        b.energy_mj()


# ---------------------------------------------------------------------------
# MeteredPowerManager
# ---------------------------------------------------------------------------

class Meter:
    """A counter that advances ``step_mj`` per read, logging into
    ``events``."""

    def __init__(self, events, step_mj=1000):
        self.events, self.mj, self.step = events, 0, step_mj

    def energy_mj(self):
        self.events.append("read")
        self.mj += self.step
        return self.mj


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.5
        return self.t


def _metered(events, tasks, backend, **kw):
    return MeteredPowerManager(measure_sweep(tasks), tasks=tasks,
                               backend=backend, meter=Meter(events),
                               sync=lambda: events.append("sync"), **kw)


class _Backend(LoggingBackend):
    def __init__(self, events):
        super().__init__()
        self.events = events

    def apply(self, cap):
        self.events.append(("write", cap))
        super().apply(cap)


def test_boundary_order_and_renormalised_observe(monkeypatch):
    """Entry: sync, read, write (coalesced when unchanged); exit: sync,
    read.  The measurement is re-normalised to the task's call count
    before it is observed."""
    monkeypatch.setattr(metered_mod.time, "perf_counter", Clock())
    events = []
    tasks = serve_phase_tasks(reduced(get_model_config("llama3.2-3b")),
                              batch=2, prompt=32, new_tokens=16)
    pm = _metered(events, tasks, _Backend(events), ema_alpha=1.0)
    cap = pm.schedule.cap_for("decode")
    with pm.phase("decode", calls=4):
        events.append("body")
    assert events == ["sync", "read", ("write", cap), "body", "sync",
                      "read"]
    events.clear()
    with pm.phase("decode", calls=4):
        events.append("body")
    assert events == ["sync", "read", "body", "sync", "read"]
    # each phase: 0.5 s and 1 J on the fakes; decode's task has 16 calls
    row = pm.table.at("decode", cap)
    assert (row.runtime, row.energy) == (0.5 * 16 / 4, 1.0 * 16 / 4)
    assert pm.seconds == {"decode": 1.0} and pm.joules == {"decode": 2.0}
    assert pm.calls == {"decode": 8} and pm.entries == {"decode": 2}
    assert pm.syncs == 4 and pm.transitions == 1
    pm.reset()
    assert pm.seconds == {} and pm.syncs == 4


KW = dict(batch_size=2, max_seq=64, prefill_chunk=16, decode_chunk=4)


def _reqs():
    return [Request(uid=i, prompt=[(3 * i + j) % 97 + 1
                                   for j in range(5 + 7 * i)],
                    max_new_tokens=6) for i in range(3)]


class PhaseClock:
    """A hook without a counter: phases pass through."""

    def __init__(self):
        self.calls = {}

    def phase(self, name, calls=None):
        import contextlib
        self.calls[name] = self.calls.get(name, 0) + (calls or 1)
        return contextlib.nullcontext()


def test_engine_phases_sum_to_the_session_and_add_no_engine_sync():
    """The metered session on the engine: per-phase joules sum to the
    counter's total, its calls are the engine's chunks and steps, its
    syncs are its own (two a phase), and the engine's sync count and
    streams are those of a run with a counterless hook."""
    cfg = reduced(get_model_config("llama3.2-3b"))
    run = get_run_config("llama3.2-3b", remat="none")
    params = init_params(lm.model_decls(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    ctx = Ctx(run, "cpu")
    clock = PhaseClock()
    plain = ServeEngine(cfg, run, ctx, params, power=clock, **KW)
    want = {r.uid: r.generated for r in plain.generate(_reqs())}
    events = []
    tasks = serve_phase_tasks(cfg, batch=2, prompt=32, new_tokens=6)
    pm = _metered(events, tasks, _Backend(events))
    eng = ServeEngine(cfg, run, ctx, params, power=pm, **KW)
    got = {r.uid: r.generated for r in eng.generate(_reqs())}
    assert got == want and eng.sync_count == plain.sync_count
    reads = events.count("read")
    assert pm.total_joules() == pytest.approx(reads / 2 * 1.0)
    assert pm.calls == clock.calls
    assert pm.syncs == 2 * sum(pm.entries.values()) == events.count("sync")
    assert pm.apply_failures == 0


# ---------------------------------------------------------------------------
# the launchers under --device cpu: the reference's modelled session
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["sed", "ed", "edw"])
def test_serve_launcher_power_lines(metric, capsys):
    """The caps, the modelled step and the cap writes of a run that
    prefills three prompts and then decodes them in one chunk."""
    launch_serve.main(["--device", "cpu", "--requests", "3", "--new", "3",
                       "--max-seq", "32", "--power-metric", metric])
    out = capsys.readouterr().out
    jpm = JPowerManager(tasks=jserve_tasks(jget_cfg("llama3.2-3b"),
                                           batch=128, prompt=32768,
                                           new_tokens=3, chips=256),
                        metric=metric)
    caps = {k: round(v) for k, v in jpm.schedule.caps.items()}
    assert f"[caps:{metric}] {caps}" in out
    writes = 1 + (jpm.schedule.caps["prefill"]
                  != jpm.schedule.caps["decode"])
    e = jpm.account_step()
    assert (f"[energy] modeled step {e['energy_j']:.1f}J "
            f"(-{e['energy_saving_pct']:.1f}% vs uncapped); {writes} cap "
            f"writes ({writes * 2.0:.1f} mJ overhead)") in out


@pytest.mark.parametrize("metric", ["sed", "edw"])
def test_train_launcher_energy_column(metric, tmp_path, capsys):
    launch_train.main(["--device", "cpu", "--reduced", "--batch", "2",
                       "--seq", "32", "--steps", "2", "--power-metric",
                       metric, "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    jpm = JPowerManager(tasks=jtrain_tasks(jreduced(jget_cfg("llama3.2-3b")),
                                           batch=2, seq=32),
                        metric=metric, min_dwell_s=2e-4)
    e = jpm.account_step()
    col = f"E={e['energy_j']:.2f}J (-{e['energy_saving_pct']:.1f}%)"
    assert out.count(col) == 2 and "completed at step 2" in out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    """The card and NVML, or a skip: decided here, never while the module
    is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    if not nvml_mod.available():
        pytest.fail("a CUDA card without libnvidia-ml.so.1")
    return torch.device("cuda")


@pytest.mark.cuda
def test_nvml_on_the_card(card):
    """The real library: the handle matches the CUDA device, the limit
    lies in its range, the counter advances under work, and a metered
    phase measures it."""
    b = NvmlBackend(0)
    try:
        lo, hi = b.limit_range_w()
        assert lo <= b.limit_w() <= hi
        assert torch.cuda.get_device_name(0) in b.name() \
            or b.name() in torch.cuda.get_device_name(0)
        pm = MeteredPowerManager(tasks=[], backend=LoggingBackend(),
                                 meter=b, spec=H100_SUPERCHIP)
        x = torch.randn(4096, 4096, device="cuda")
        with pm.phase("work"):
            for _ in range(50):
                x = x @ x
                x = x / x.norm()
        assert pm.joules["work"] > 0 and pm.seconds["work"] > 0
        assert pm.syncs == 2
    finally:
        b.close()

