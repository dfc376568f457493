"""The card's power API: NVML over ``ctypes``, the counterpart of the
reference's ``HwmonBackend`` stub (``repro/power/backends.py:106-141``).

``NvmlBackend`` is a ``CapBackend``: ``apply(cap)`` sets the card's power
limit (``nvmlDeviceSetPowerManagementLimit``, in milliwatts) and reads it
back; it also reads the card's energy counter
(``nvmlDeviceGetTotalEnergyConsumption``, mJ since the driver loaded) and
its draw (``nvmlDeviceGetPowerUsage``, mW).  It cannot measure a task
(``measure`` returns None): measured seconds and joules per phase come
from ``power.metered.MeteredPowerManager``, which reads the counter.

The NVML handle is matched to the CUDA device by PCI bus id, not by
index, since ``CUDA_VISIBLE_DEVICES`` renumbers devices.  Every NVML
function is looked up once through one table (``load_table``), so tests
substitute a fake.  Where ``libnvidia-ml.so.1`` is absent ``available()``
is False.

Setting a limit needs privileges a host may not grant: a refused write
raises ``NvmlError`` (a ``RuntimeError`` naming the NVML code), which
``PowerManager.apply_cap`` counts in ``apply_failures``.  A limit this
process set is put back by ``restore_limit_on_exit()``, at the block's
end, on an exception and at interpreter exit: a card is never left
capped.
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
import dataclasses
import time
from typing import TYPE_CHECKING, Callable, Iterator, Optional

from repro_torch.core.tasks import Task, TaskMeasurement
from repro_torch.power.backends import TRANSITION_ENERGY_J

if TYPE_CHECKING:
    from repro_torch.hw.h100 import H100Spec
    from repro_torch.power.backends import CapBackend

LIBRARY = "libnvidia-ml.so.1"

NVML_SUCCESS = 0
#: NVML return codes by number (``nvml.h``), for error messages
NVML_ERRORS = {
    1: "NVML_ERROR_UNINITIALIZED", 2: "NVML_ERROR_INVALID_ARGUMENT",
    3: "NVML_ERROR_NOT_SUPPORTED", 4: "NVML_ERROR_NO_PERMISSION",
    5: "NVML_ERROR_ALREADY_INITIALIZED", 6: "NVML_ERROR_NOT_FOUND",
    7: "NVML_ERROR_INSUFFICIENT_SIZE", 8: "NVML_ERROR_INSUFFICIENT_POWER",
    9: "NVML_ERROR_DRIVER_NOT_LOADED", 10: "NVML_ERROR_TIMEOUT",
    12: "NVML_ERROR_LIBRARY_NOT_FOUND", 13: "NVML_ERROR_FUNCTION_NOT_FOUND",
    15: "NVML_ERROR_GPU_IS_LOST", 17: "NVML_ERROR_OPERATING_SYSTEM",
    19: "NVML_ERROR_IN_USE", 999: "NVML_ERROR_UNKNOWN",
}

_P = ctypes.POINTER
_DEV = ctypes.c_void_p                 # nvmlDevice_t
_UINT = ctypes.c_uint
#: name -> argtypes of every NVML function this module calls (each
#: returns an ``nvmlReturn_t``)
SIGNATURES = {
    "nvmlInit_v2": (),
    "nvmlShutdown": (),
    "nvmlDeviceGetHandleByPciBusId_v2": (ctypes.c_char_p, _P(_DEV)),
    "nvmlDeviceGetName": (_DEV, ctypes.c_char_p, _UINT),
    "nvmlDeviceGetPowerManagementLimit": (_DEV, _P(_UINT)),
    "nvmlDeviceGetPowerManagementDefaultLimit": (_DEV, _P(_UINT)),
    "nvmlDeviceGetPowerManagementLimitConstraints": (_DEV, _P(_UINT),
                                                     _P(_UINT)),
    "nvmlDeviceSetPowerManagementLimit": (_DEV, _UINT),
    "nvmlDeviceGetTotalEnergyConsumption": (_DEV, _P(ctypes.c_ulonglong)),
    "nvmlDeviceGetPowerUsage": (_DEV, _P(_UINT)),
}


class NvmlError(RuntimeError):
    """An NVML call returned something other than NVML_SUCCESS."""

    def __init__(self, func: str, code: int):
        self.func, self.code = func, code
        self.code_name = NVML_ERRORS.get(code, f"NVML error {code}")
        super().__init__(f"{func} failed: {self.code_name} ({code})")


def load_table(path: str = LIBRARY) -> Optional[dict[str, Callable]]:
    """The NVML functions of ``SIGNATURES`` from the shared library, or
    None where it cannot be loaded."""
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    table = {}
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        table[name] = fn
    return table


def available(path: str = LIBRARY) -> bool:
    """Whether the NVML library loads here."""
    return load_table(path) is not None


def cuda_pci_bus_id(index: int = 0) -> str:
    """The PCI bus id of CUDA device ``index`` in NVML's form
    (``0000:3B:00.0``; NVML also takes the 8-digit domain)."""
    import torch
    p = torch.cuda.get_device_properties(index)
    return f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:{p.pci_device_id:02x}.0"


@dataclasses.dataclass(frozen=True)
class ProbeResult:
    """One trial limit write: whether it landed, the NVML code, the
    call's seconds and the limit read back before the old one was put
    back."""

    writable: bool
    code: str
    seconds: float
    read_back_w: float


class NvmlBackend:
    """The card's ``CapBackend``: NVML limit writes, limit read-back and
    the energy counter, for one CUDA device.

    ``transition_seconds`` starts at ``transition_s`` (the set-limit
    call's latency measured on the card, ``hw/h100.py``) and becomes the
    latency of the last write this backend made; ``transition_energy_j``
    stays the reference's modelled 2 mJ (the write's energy is in what
    the counter reads).  ``table`` and ``bus_id`` are for tests; by
    default the library is loaded and the bus id is the CUDA device's."""

    transition_energy_j = TRANSITION_ENERGY_J

    def __init__(self, device: int = 0, *, table=None, bus_id=None,
                 transition_s: float | None = None):
        if table is None:
            table = load_table()
            if table is None:
                raise RuntimeError(f"{LIBRARY} not found: no NVML here")
        self._f = table
        self._call("nvmlInit_v2")
        self._open = True
        try:
            self.bus_id = bus_id if bus_id is not None \
                else cuda_pci_bus_id(device)
            handle = _DEV()
            self._call("nvmlDeviceGetHandleByPciBusId_v2",
                       self.bus_id.encode(), ctypes.pointer(handle))
        except BaseException:
            self.close()
            raise
        self._handle = handle
        if transition_s is None:
            from repro_torch.hw.h100 import NVML_SET_LIMIT_S
            transition_s = NVML_SET_LIMIT_S
        self.transition_seconds = transition_s
        self.current_cap: float | None = None
        self.writes = 0
        self._last_mj: int | None = None

    def _call(self, name: str, *args) -> None:
        rc = self._f[name](*args)
        if rc != NVML_SUCCESS:
            raise NvmlError(name, rc)

    def _read_uint(self, name: str) -> int:
        out = _UINT()
        self._call(name, self._handle, ctypes.pointer(out))
        return out.value

    # -- reads ---------------------------------------------------------------
    def name(self) -> str:
        buf = ctypes.create_string_buffer(96)
        self._call("nvmlDeviceGetName", self._handle, buf, 96)
        return buf.value.decode()

    def limit_w(self) -> float:
        """The power limit in force, W."""
        return self._read_uint("nvmlDeviceGetPowerManagementLimit") / 1e3

    def default_limit_w(self) -> float:
        return self._read_uint(
            "nvmlDeviceGetPowerManagementDefaultLimit") / 1e3

    def limit_range_w(self) -> tuple[float, float]:
        """(minimum, maximum) limit the card accepts, W."""
        lo, hi = _UINT(), _UINT()
        self._call("nvmlDeviceGetPowerManagementLimitConstraints",
                   self._handle, ctypes.pointer(lo), ctypes.pointer(hi))
        return lo.value / 1e3, hi.value / 1e3

    def energy_mj(self) -> int:
        """The card's energy counter, mJ.  A counter that goes backwards
        raises: every joule measured from it would be wrong."""
        out = ctypes.c_ulonglong()
        self._call("nvmlDeviceGetTotalEnergyConsumption", self._handle,
                   ctypes.pointer(out))
        if self._last_mj is not None and out.value < self._last_mj:
            raise RuntimeError(f"NVML energy counter went backwards: "
                               f"{self._last_mj} -> {out.value} mJ")
        self._last_mj = out.value
        return out.value

    def power_mw(self) -> int:
        """The card's draw, mW."""
        return self._read_uint("nvmlDeviceGetPowerUsage")

    # -- the CapBackend ------------------------------------------------------
    def _set_limit(self, cap: float) -> float:
        t0 = time.perf_counter()
        self._call("nvmlDeviceSetPowerManagementLimit", self._handle,
                   _UINT(round(cap * 1e3)))
        return time.perf_counter() - t0

    def apply(self, cap: float) -> None:
        """Set the limit to ``cap`` W, then read it back into
        ``current_cap`` (a limit the card clamps shows as a different
        value, which the manager counts as a failed write).  An NVML
        error raises ``NvmlError``."""
        self.transition_seconds = self._set_limit(cap)
        self.writes += 1
        self.current_cap = self.limit_w()

    def measure(self, task: Task, cap: float) -> Optional[TaskMeasurement]:
        return None  # write-only: measurements come from the counter

    def probe(self, cap: float) -> ProbeResult:
        """Try one write of ``cap`` W, read it back and put the limit in
        force before back.  Both outcomes are results: a refused write
        gives ``writable`` False and its NVML code."""
        before = self.limit_w()
        t0 = time.perf_counter()
        try:
            seconds = self._set_limit(cap)
        except NvmlError as e:
            return ProbeResult(False, e.code_name, time.perf_counter() - t0,
                               self.limit_w())
        read = self.limit_w()
        self._set_limit(before)
        return ProbeResult(read == round(cap * 1e3) / 1e3, "NVML_SUCCESS",
                           seconds, read)

    @contextlib.contextmanager
    def restore_limit_on_exit(self) -> Iterator[float]:
        """Read the limit on entry (yielded, W) and write it back when the
        block ends, normally or by an exception, and at interpreter exit
        if the block never ends; a limit already in force is not written
        again."""
        saved_mw = self._read_uint("nvmlDeviceGetPowerManagementLimit")

        def restore():
            if self._open and self._read_uint(
                    "nvmlDeviceGetPowerManagementLimit") != saved_mw:
                self._call("nvmlDeviceSetPowerManagementLimit",
                           self._handle, _UINT(saved_mw))
                self.current_cap = saved_mw / 1e3

        atexit.register(restore)
        try:
            yield saved_mw / 1e3
        finally:
            try:
                restore()
            finally:
                atexit.unregister(restore)

    def close(self) -> None:
        if self._open:
            self._open = False
            self._call("nvmlShutdown")


#: ``open_card``'s probe write: the maximum limit less this many watts
PROBE_BELOW_MAX_W = 100.0


@dataclasses.dataclass(frozen=True)
class CardPower:
    """A card's power session: its ``NvmlBackend``, the limit in force when
    it was opened (``limit_w``, put back when it closes), the H100 spec
    with the limits NVML reports (``spec``), the probe write's result,
    and the ``CapBackend`` that applies caps: the NVML backend where the
    card took the probe write, else a ``LoggingBackend`` (caps logged,
    not applied)."""

    nvml: NvmlBackend
    limit_w: float
    spec: H100Spec
    probe: ProbeResult
    backend: CapBackend

    @property
    def writable(self) -> bool:
        return self.probe.writable


def open_card(stack: contextlib.ExitStack, device: int = 0, *,
              nvml: NvmlBackend | None = None) -> CardPower:
    """Open NVML for CUDA device ``device`` (or take ``nvml``), closed and
    its limit put back when ``stack`` closes; probe one write of the
    maximum limit less PROBE_BELOW_MAX_W."""
    from repro_torch.hw.h100 import H100_SUPERCHIP
    from repro_torch.power.backends import LoggingBackend
    if nvml is None:
        nvml = NvmlBackend(device)
    stack.callback(nvml.close)
    limit = stack.enter_context(nvml.restore_limit_on_exit())
    lo, hi = nvml.limit_range_w()
    spec = dataclasses.replace(H100_SUPERCHIP, limit_min=lo, limit_max=hi,
                               limit_default=nvml.default_limit_w())
    probe = nvml.probe(hi - PROBE_BELOW_MAX_W)
    return CardPower(nvml, limit, spec, probe,
                     nvml if probe.writable else LoggingBackend())
