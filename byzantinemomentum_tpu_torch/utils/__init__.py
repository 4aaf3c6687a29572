"""Logging, user errors, the `key:value` argument language, the plugin
loader and the one-time latch: the port's own copies of what it needs from
`byzantinemomentum_tpu/utils/` (the port imports nothing of that package).
The grid runner, `Jobs`, is `utils/jobs.py`, as in the JAX package.
"""

import importlib
import pathlib
import sys
import threading

import numpy as np

__all__ = ["UserException", "UnavailableException", "Context", "NamedLock",
           "trace", "info", "warning", "error", "fatal", "fatal_unavailable",
           "parse_keyval", "import_directory", "resolve_device",
           "weak_scalar", "onetime"]


class UserException(RuntimeError):
    """An error caused by invalid user input, printed without a traceback."""


class UnavailableException(UserException):
    """An unknown name was requested from a registry."""

    def __init__(self, registry, name, what="entry"):
        avail = ", ".join(repr(k) for k in sorted(registry))
        super().__init__(f"Unknown {what} {name!r}, expected one of: {avail}")


_stack = []


class Context:
    """Nested `[name]` logging scope, rendered as a prefix on emitted lines."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _stack.append(self.name)
        return self

    def __exit__(self, *exc):
        _stack.pop()
        return False


def _emit(file, *args):
    prefix = "".join(f"[{name}] " for name in _stack)
    print(prefix + " ".join(str(a) for a in args), file=file, flush=True)


class NamedLock:
    """A `threading.Lock` with a name (the JAX package's
    `utils/locking.py::NamedLock` without its acquisition-edge recording,
    which serves the JAX package's lock-order checker)."""

    __slots__ = ("name", "_lock")

    def __init__(self, name):
        self.name = str(name)
        self._lock = threading.Lock()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False

    def __repr__(self):
        return f"NamedLock({self.name!r})"


def trace(*args):
    _emit(sys.stdout, *args)


def info(*args):
    _emit(sys.stdout, *args)


def warning(*args):
    _emit(sys.stderr, *args)


def error(*args):
    _emit(sys.stderr, *args)


def fatal(*args):
    """Raise a UserException (the driver prints it and exits 1)."""
    raise UserException(" ".join(str(a) for a in args))


def fatal_unavailable(registry, name, what="entry"):
    """Raise for an unknown registry name, listing the valid ones."""
    raise UnavailableException(registry, name, what=what)


def resolve_device(name="cuda"):
    """The `torch.device` an entry point runs on. CUDA is the default;
    'cpu' is only ever taken when asked for by name. With no card and no
    such request this raises: the port never carries on on the CPU by
    itself."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise UserException(
            f"Device {name!r} requested but no CUDA device is available; "
            f"pass '--device cpu' (or device='cpu') to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise UserException(f"Unsupported device {name!r}; expected "
                            f"'cuda', 'cuda:<index>' or 'cpu'")
    return device


def weak_scalar(x, dtype):
    """A Python scalar as the JAX package applies it to an operand of
    `dtype` (a weak-typed scalar): rounded to that dtype before the
    operation (through float32, as JAX without x64 holds a Python float;
    float64 keeps it whole), returned as a Python float that torch then
    carries exactly (`1.1 -> 1.1015625` in bfloat16). torch would
    otherwise apply the float32 scalar and round only the result. The
    rounding runs on the host's numbers (numpy's float32 and float16, and
    bfloat16 as the top half of the float32 bits rounded to nearest even,
    torch's own conversion), so a step that calls it reads no tensor."""
    import torch

    if dtype == torch.float64:
        return float(x)
    with np.errstate(over="ignore"):  # out of range rounds to +-inf
        x32 = np.float32(x)
        if dtype == torch.float16:
            return float(np.float16(x32))
    if dtype == torch.bfloat16 and not np.isnan(x32):
        bits = int(x32.view(np.uint32))
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
        return float(np.uint32(bits).view(np.float32))
    return float(x32)


def _auto_type(value):
    low = value.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    return value


def parse_keyval(entries):
    """Parse `key:value` strings into a dict with auto-typed values
    (bool, int, float, else str); a bare `key` maps to True."""
    parsed = {}
    for entry in entries or ():
        if ":" in entry:
            key, value = entry.split(":", 1)
            parsed[key] = _auto_type(value)
        else:
            parsed[entry] = True
    return parsed


def import_directory(package, path):
    """Import every public module of a directory so that plugin modules
    self-register in their package's registry."""
    for child in sorted(pathlib.Path(path).iterdir()):
        if child.name.startswith("_") or child.suffix != ".py":
            continue
        importlib.import_module(f"{package}.{child.stem}")


def onetime(callback):
    """Thread-safe one-time latch (`byzantinemomentum_tpu/utils/misc.py`):
    returns `(trigger, is_triggered)`, where `trigger()` runs `callback`
    (None for none) at most once; the driver's and the grid runner's
    SIGINT/SIGTERM latch. The lock is re-entrant: a signal handler that
    triggers runs on the main thread, which may hold it in
    `is_triggered`."""
    lock = threading.RLock()
    state = {"done": False}

    def trigger(*args, **kwargs):
        with lock:
            if state["done"]:
                return
            state["done"] = True
        if callback is not None:
            callback(*args, **kwargs)

    def is_triggered():
        with lock:
            return state["done"]

    return trigger, is_triggered
