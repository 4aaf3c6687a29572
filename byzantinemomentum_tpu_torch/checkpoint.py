"""Checkpoint/restore of the full training state
(`byzantinemomentum_tpu/checkpoint.py`), in the JAX package's file format
byte for byte, so a JAX checkpoint resumes in the port and the port's in
the JAX package.

The file is a msgpack map `{"data", "state", "version"}` (flax's
`msgpack_serialize` of the JAX `TrainState`'s `to_state_dict`): `state`
maps each JAX `TrainState` field to its state dict, `data` holds the
samplers' snapshots (`Dataset.get_state`). flax writes every map with
its keys sorted (it copies the tree through `jax.tree_util`), tuples as
maps `{"0": ..., "1": ...}` (so `()` as `{}`), an array as ext type 1
holding `msgpack((shape, dtype name, C-order bytes))` and a 0-d numpy
scalar as ext type 3. The port carries its own small coder for that
subset of msgpack (`packb`, `unpackb`), with the shortest forms
msgpack-python chooses; bfloat16 arrays travel as their 16-bit words.

The port's `TrainState` (`engine/state.py`) maps onto the JAX layout:
`net_state` `{"b1.mean": ...}` nests as `{"b1": {"mean": ...}}`; an
optimizer's state (`optim.py`: a tuple of dicts of optax's fields) as
flax writes optax's tuple of NamedTuples; `rng` (int64 words) is written
as uint32 `[2]` (and a load restarts the host's mirror of the key chain,
`TrainState.rng_host`, from the file's words); `steps`, `datapoints` (host
ints) and `past_count` (an i32 0-d tensor) as int32 0-d arrays, as is an
integer attack state (`alie-warmup`'s step counter, an i32 0-d tensor),
and each comes back as the template holds it (a tensor on the
template's device, or an int); the JAX `fault_buffer`, which the
port has no use for, as the empty `(0, d)` array a run without a fault
plan holds. Arrays above flax's chunk size (`MAX_CHUNK_SIZE` bytes),
which flax splits into chunks, are refused.

Crash safety, as in the JAX package: `save` writes atomically (tmp file,
fsync, `os.replace`, directory fsync) with a MAGIC + CRC32 footer
(`seal`); `find_latest_valid` walks a run's `checkpoint-<step>` files
newest first past torn or corrupt ones; a per-run manifest
(`checkpoints.json`) drives retention (`keep`) and counts restarts;
`mirror` lands the same bytes in a second directory. The environment
variable `BMT_CHAOS_TORN_CHECKPOINT_STEP=<step>` makes the save of that
step write half its bytes to the tmp file and kill the process (the
preemption stand-in the kill-and-resume tests use).
"""

import json
import os
import pathlib
import struct
import zlib

import numpy as np
import torch

from byzantinemomentum_tpu_torch import utils
from byzantinemomentum_tpu_torch.engine.state import TrainState

__all__ = ["VERSION", "MAGIC", "MANIFEST_NAME", "MAX_CHUNK_SIZE", "packb",
           "unpackb", "save", "load", "seal", "verify", "state_dict",
           "find_latest_valid", "find_latest_valid_any", "checkpoint_step",
           "read_manifest", "bump_restarts"]

VERSION = 2
MAGIC = b"BMTC"
_FOOTER = struct.Struct("<4sI")
MANIFEST_NAME = "checkpoints.json"
MAX_CHUNK_SIZE = 2**30  # flax's: bytes of an array leaf it writes whole

# The JAX `TrainState`'s fields, in its order
FIELDS = ("theta", "net_state", "opt_state", "momentum_server",
          "momentum_workers", "origin", "past_grads", "past_norms",
          "past_count", "steps", "datapoints", "rng", "fault_buffer",
          "attack_state")
_COUNTERS = ("past_count", "steps", "datapoints")
_ARRAYS = ("theta", "momentum_server", "momentum_workers", "origin",
           "past_grads", "past_norms")
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_TORCH_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int32: "int32", torch.int64: "int64",
                torch.uint8: "uint8", torch.bool: "bool"}


# --------------------------------------------------------------------------- #
# msgpack, the subset flax writes

def _pack_int(n, out):
    if -32 <= n < 128:
        out += struct.pack("b" if n < 0 else "B", n)
    elif n >= 0:
        for limit, code, fmt in ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"),
                                 (1 << 32, 0xCE, ">I"), (1 << 64, 0xCF, ">Q")):
            if n < limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} too large for msgpack")
    else:
        for limit, code, fmt in ((1 << 7, 0xD0, ">b"), (1 << 15, 0xD1, ">h"),
                                 (1 << 31, 0xD2, ">i"), (1 << 63, 0xD3, ">q")):
            if n >= -limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} too small for msgpack")


def _pack_header(n, out, fix, fix_limit, codes):
    """A length header: `fix | n` below `fix_limit`, else the first of
    `codes` ((code, bytes of the length)) that holds n."""
    if fix is not None and n < fix_limit:
        out.append(fix | n)
        return
    for code, width in codes:
        if n < 1 << (8 * width):
            out.append(code)
            out += n.to_bytes(width, "big")
            return
    raise OverflowError(f"msgpack length {n} too large")


def _array_ext(x):
    """ext type 1 of an array: `(shape, dtype name, C-order bytes)`."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        name = _TORCH_NAMES[x.dtype]
        if x.dtype == torch.bfloat16:
            data = x.view(torch.int16).numpy().tobytes()
        else:
            data = x.numpy().tobytes()
        shape = tuple(x.shape)
    else:
        name, data, shape = x.dtype.name, x.tobytes("C"), x.shape
    if len(data) > MAX_CHUNK_SIZE:
        raise ValueError(f"array of {len(data)} bytes exceeds flax's chunk "
                         f"size ({MAX_CHUNK_SIZE}); chunked arrays are not "
                         f"supported")
    return packb([list(shape), name, data])


def _pack(obj, out):
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.generic):
        # Before float: np.float64 subclasses float, and flax (strict
        # types) writes every numpy scalar as ext type 3
        _pack_ext(_EXT_NPSCALAR, _array_ext(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_header(len(data), out, 0xA0, 32,
                     ((0xD9, 1), (0xDA, 2), (0xDB, 4)))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _pack_header(len(obj), out, None, 0, ((0xC4, 1), (0xC5, 2), (0xC6, 4)))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_header(len(obj), out, 0x90, 16, ((0xDC, 2), (0xDD, 4)))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_header(len(obj), out, 0x80, 16, ((0xDE, 2), (0xDF, 4)))
        # flax copies the tree through jax.tree_util, which sorts keys
        for key in sorted(obj):
            _pack(key, out)
            _pack(obj[key], out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(_EXT_NDARRAY, _array_ext(obj), out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _pack_ext(code, data, out):
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_header(len(data), out, None, 0, ((0xC7, 1), (0xC8, 2), (0xC9, 4)))
    out += struct.pack("b", code)
    out += data


def packb(obj):
    """msgpack bytes of `obj` (None, bool, int, float, str, bytes, list
    or tuple, dict with its keys sorted, numpy or torch arrays as ext
    type 1, numpy scalars as ext type 3), as flax's
    `msgpack_serialize` writes them."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def uint(self, width):
        return int.from_bytes(self.take(width), "big")


_FIXED_EXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
         0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
          0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
          0xDC: ("array", 2), 0xDD: ("array", 4),
          0xDE: ("map", 2), 0xDF: ("map", 4),
          0xC7: ("ext", 1), 0xC8: ("ext", 2), 0xC9: ("ext", 4)}


def _unpack(r):
    code = r.uint(1)
    if code < 0x80:
        return code
    if code >= 0xE0:
        return code - 0x100
    if code <= 0x8F:
        return _unpack_map(r, code & 0x0F)
    if code <= 0x9F:
        return [_unpack(r) for _ in range(code & 0x0F)]
    if code <= 0xBF:
        return str(r.take(code & 0x1F), "utf-8")
    if code == 0xC0:
        return None
    if code in (0xC2, 0xC3):
        return code == 0xC3
    if code == 0xCA:
        return struct.unpack(">f", r.take(4))[0]
    if code == 0xCB:
        return struct.unpack(">d", r.take(8))[0]
    if code in _INTS:
        fmt = _INTS[code]
        return struct.unpack(fmt, r.take(struct.calcsize(fmt)))[0]
    if code in _FIXED_EXT:
        kind, n = "ext", _FIXED_EXT[code]
    elif code in _SIZED:
        kind, width = _SIZED[code]
        n = r.uint(width)
    else:
        raise ValueError(f"unsupported msgpack type byte 0x{code:02x}")
    if kind == "str":
        return str(r.take(n), "utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "array":
        return [_unpack(r) for _ in range(n)]
    if kind == "map":
        return _unpack_map(r, n)
    ext = struct.unpack("b", r.take(1))[0]
    return _unpack_ext(ext, bytes(r.take(n)))


def _unpack_map(r, n):
    out = {}
    for _ in range(n):
        key = _unpack(r)
        out[key] = _unpack(r)
    return out


def _unpack_ext(code, data):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, name, buffer = unpackb(data)
    if name == "bfloat16":
        arr = torch.from_numpy(np.frombuffer(buffer, np.int16).copy())
        arr = arr.view(torch.bfloat16).reshape(shape)
    else:
        arr = np.frombuffer(buffer, np.dtype(name)).reshape(shape).copy()
    return arr[()] if code == _EXT_NPSCALAR and isinstance(arr, np.ndarray) else arr


def unpackb(data):
    """The object of msgpack bytes written by `packb` or flax: maps as
    dicts, arrays as lists, ext type 1 as a numpy array (bfloat16 as a
    torch.bfloat16 tensor), ext type 3 as a numpy scalar."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


# --------------------------------------------------------------------------- #
# TrainState <-> the JAX state dict

def _nest(flat):
    """`{"b1.mean": x}` -> `{"b1": {"mean": x}}`."""
    out = {}
    for name, value in flat.items():
        node = out
        *parents, leaf = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


def _flatten(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = value
    return out


def _to_state_dict(value):
    """flax's `to_state_dict` of the port's containers: tuples and lists
    as `{"0": ...}`, an int leaf as an int32 0-d array."""
    if isinstance(value, (tuple, list)):
        return {str(i): _to_state_dict(v) for i, v in enumerate(value)}
    if isinstance(value, dict):
        return {key: _to_state_dict(v) for key, v in value.items()}
    if isinstance(value, int) and not isinstance(value, bool):
        return np.asarray(value, np.int32)
    return value


def _int32(value):
    """A counter (an int or a 0-d tensor) as the int32 0-d array the JAX
    file holds."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value, np.int32)


def state_dict(state):
    """The JAX `TrainState`'s state dict of a port `TrainState` (host
    arrays), as `save` writes it."""
    theta = state.theta.detach().cpu()
    out = {name: getattr(state, name).detach().cpu() for name in _ARRAYS}
    out.update({name: _int32(getattr(state, name)) for name in _COUNTERS})
    out["net_state"] = _nest({name: value.detach().cpu()
                              for name, value in state.net_state.items()})
    out["opt_state"] = _to_state_dict(state.opt_state)
    out["attack_state"] = _to_state_dict(state.attack_state)
    out["rng"] = state.rng.detach().cpu().numpy().astype(np.uint32)
    out["fault_buffer"] = theta.new_zeros((0, theta.shape[0]))
    return {name: out[name] for name in FIELDS}


def _fail(path, message):
    raise utils.UserException(f"Unable to load checkpoint {str(path)!r}: {message}")


def _tensor(value):
    """A decoded array (numpy, or a bfloat16 tensor) as a CPU tensor."""
    if isinstance(value, torch.Tensor):
        return value
    value = np.asarray(value)
    if value.dtype == np.uint32:
        value = value.astype(np.int64)
    # (`np.ascontiguousarray` would make a 0-d array 1-d)
    return torch.from_numpy(value.copy(order="C"))


def _restore_like(path, name, ref, value):
    """flax's `from_state_dict(ref, value)` for the port's containers:
    tuples from `{"0": ...}` maps, dicts (an optimizer's NamedTuple
    states) from maps of the same keys, an int from a 0-d array, a tensor
    cast to the reference's dtype and device (shapes must agree)."""
    if isinstance(ref, (tuple, list)):
        if not isinstance(value, dict) or len(value) != len(ref):
            _fail(path, f"field {name!r} does not match the run's layout")
        return type(ref)(_restore_like(path, name, r, value[str(i)])
                         for i, r in enumerate(ref))
    if isinstance(ref, dict):
        if not isinstance(value, dict) or sorted(value) != sorted(ref):
            _fail(path, f"field {name!r} does not match the run's layout")
        return {key: _restore_like(path, name, r, value[key])
                for key, r in ref.items()}
    if isinstance(ref, int) and not isinstance(ref, bool):
        if isinstance(value, (dict, list)) or np.asarray(value).shape != ():
            _fail(path, f"field {name!r} does not match the run's layout")
        return int(np.asarray(value))
    if isinstance(ref, torch.Tensor):
        t = _tensor(value)
        if tuple(t.shape) != tuple(ref.shape):
            _fail(path, f"field {name!r} has shape {tuple(t.shape)}, "
                        f"expected {tuple(ref.shape)}")
        return t.to(device=ref.device, dtype=ref.dtype)
    _fail(path, f"field {name!r} has an unsupported layout")


def _unseal(path, data):
    """Strip and check the integrity footer; a footer-less payload passes
    through (the JAX package's legacy checkpoints)."""
    if len(data) >= _FOOTER.size:
        magic, crc = _FOOTER.unpack(data[-_FOOTER.size:])
        if magic == MAGIC:
            payload = data[:-_FOOTER.size]
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                _fail(path, "integrity footer mismatch (torn or corrupt file)")
            return payload
    return data


def seal(data):
    """Append the integrity footer (MAGIC + CRC32 of the payload)."""
    return data + _FOOTER.pack(MAGIC, zlib.crc32(data) & 0xFFFFFFFF)


# --------------------------------------------------------------------------- #
# Save and load

def _fsync_directory(directory):
    """Durably record a rename in the directory (best effort)."""
    try:
        fd = os.open(str(directory), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write(path, data):
    """tmp + fsync + `os.replace` + directory fsync."""
    tmp = path.with_name(path.name + ".tmp")
    with tmp.open("wb") as fd:
        fd.write(data)
        fd.flush()
        os.fsync(fd.fileno())
    os.replace(tmp, path)
    _fsync_directory(path.parent)


def _chaos_torn_write(path, data, step):
    """With `BMT_CHAOS_TORN_CHECKPOINT_STEP=<step>`, the save of that step
    flushes half its bytes to the tmp file and kills the process."""
    target = os.environ.get("BMT_CHAOS_TORN_CHECKPOINT_STEP")
    if target is None or int(target) != step:
        return
    tmp = path.with_name(path.name + ".tmp")
    with tmp.open("wb") as fd:
        fd.write(data[:max(1, len(data) // 2)])
        fd.flush()
        os.fsync(fd.fileno())
    os._exit(137)


def save(path, state, *, data_state=None, keep=None, mirror=None):
    """Write `state` to `path` atomically with the integrity footer and
    register it in the run's manifest (the JAX `checkpoint.save`).
    `data_state`: the samplers' snapshots (`{"train": ..., "test": ...}`);
    `keep`: keep only this run's newest `keep` checkpoints (None or 0:
    all); `mirror`: a second directory that receives the same bytes."""
    path = pathlib.Path(path)
    step = int(state.steps)
    payload = {"version": VERSION, "state": state_dict(state)}
    if data_state is not None:
        payload["data"] = data_state
    data = seal(packb(payload))
    _chaos_torn_write(path, data, step)
    _atomic_write(path, data)
    _manifest_add(path.parent, path.name, step, len(data), keep=keep)
    if mirror is not None:
        mirror = pathlib.Path(mirror)
        mirror.mkdir(parents=True, exist_ok=True)
        _atomic_write(mirror / path.name, data)
        _manifest_add(mirror, path.name, step, len(data), keep=keep)
    return path


def load(path, template, *, return_data=False):
    """Read a checkpoint against a template `TrainState` (shapes, dtypes
    and devices from the template, values from the file), with the JAX
    package's validation: the version, every field present but for
    `fault_buffer` and `attack_state` (both cold-start at the template's
    value when absent), matching shapes and non-negative step and point
    counters. With `return_data=True` returns `(state, data_state)`
    (None for a checkpoint written without sampler snapshots)."""
    path = pathlib.Path(path)
    try:
        raw = unpackb(_unseal(path, path.read_bytes()))
    except (ValueError, TypeError, KeyError) as err:
        _fail(path, str(err))
    if not isinstance(raw, dict) or raw.get("version") != VERSION:
        version = raw.get("version") if isinstance(raw, dict) else None
        _fail(path, f"expected version {VERSION!r}, got {version!r}")
    stored = raw.get("state")
    if not isinstance(stored, dict):
        _fail(path, "missing state payload")
    out = {}
    for name in FIELDS:
        if name not in stored:
            if name in ("fault_buffer", "attack_state"):
                continue
            _fail(path, f"missing field {name!r}")
        value = stored[name]
        if name == "fault_buffer":
            # The port has no fault plan: only the empty buffer resumes
            _restore_like(path, name, template.theta.new_zeros(
                (0, template.theta.shape[0])), value)
        elif name == "net_state":
            if not isinstance(value, dict):
                _fail(path, "field 'net_state' is not a map")
            flat = _flatten(value)
            if sorted(flat) != sorted(template.net_state):
                _fail(path, f"field 'net_state' holds {sorted(flat)}, "
                            f"expected {sorted(template.net_state)}")
            out[name] = {key: _restore_like(path, f"net_state.{key}", ref,
                                            flat[key])
                         for key, ref in template.net_state.items()}
        elif name in _COUNTERS:
            count = np.asarray(value)
            if count.shape != ():
                _fail(path, f"field {name!r} has shape {count.shape}, "
                            f"expected ()")
            if name != "past_count" and int(count) < 0:
                _fail(path, f"invalid {name} counter {int(count)!r}")
            ref = getattr(template, name)
            out[name] = (torch.tensor(int(count), dtype=ref.dtype,
                                      device=ref.device)
                         if isinstance(ref, torch.Tensor) else int(count))
        elif name == "rng":
            key = _tensor(np.asarray(value).astype(np.uint32))
            if tuple(key.shape) != (2,):
                _fail(path, f"field 'rng' has shape {tuple(key.shape)}, "
                            f"expected (2,)")
            out[name] = key.to(template.rng.device)
            # The host's mirror of the key chain restarts from the file
            out["rng_host"] = tuple(int(word) for word in key.tolist())
        else:
            out[name] = _restore_like(path, name, getattr(template, name),
                                      value)
    state = TrainState(**{**template.__dict__, **out})
    if return_data:
        return state, raw.get("data")
    return state


# --------------------------------------------------------------------------- #
# Resume scanning

def verify(path):
    """Whether `path` holds a complete, CRC-consistent checkpoint of this
    version; never raises."""
    try:
        path = pathlib.Path(path)
        raw = unpackb(_unseal(path, path.read_bytes()))
    except (OSError, ValueError, TypeError, KeyError, utils.UserException):
        return False
    return (isinstance(raw, dict) and raw.get("version") == VERSION
            and isinstance(raw.get("state"), dict))


def checkpoint_step(path):
    """The step of a `checkpoint-<step>` file name (None otherwise)."""
    suffix = pathlib.Path(path).name.rsplit("-", 1)[-1]
    return int(suffix) if suffix.isdigit() else None


def find_latest_valid(directory, prefix="checkpoint-"):
    """The newest checkpoint of a run directory that verifies, walking
    past torn or corrupt ones (None if there is none). Names whose suffix
    is not a step number (the manifest, a `.tmp` left by a kill) are
    ignored."""
    directory = pathlib.Path(directory)
    if not directory.is_dir():
        return None
    candidates = []
    for entry in directory.iterdir():
        suffix = entry.name[len(prefix):]
        if entry.name.startswith(prefix) and entry.is_file() and suffix.isdigit():
            candidates.append((int(suffix), entry))
    for _, entry in sorted(candidates, key=lambda c: c[0], reverse=True):
        if verify(entry):
            return entry
        utils.warning(f"Skipping torn/corrupt checkpoint {entry.name}")
    return None


def find_latest_valid_any(directories, prefix="checkpoint-"):
    """The newest valid checkpoint over several directories (a run's and
    its mirror); a tie keeps the earlier directory's copy."""
    best, best_step = None, -1
    for directory in directories:
        if directory is None:
            continue
        found = find_latest_valid(directory, prefix=prefix)
        if found is None:
            continue
        step = checkpoint_step(found)
        step = -1 if step is None else step
        if step > best_step:
            best, best_step = found, step
    return best


# --------------------------------------------------------------------------- #
# Per-run manifest: retention and the restart counter

def read_manifest(directory):
    """The run's manifest (an empty one when absent or unreadable: the
    directory scan, not the manifest, is the authority)."""
    path = pathlib.Path(directory) / MANIFEST_NAME
    try:
        manifest = json.loads(path.read_text())
        if isinstance(manifest, dict):
            manifest.setdefault("version", 1)
            manifest.setdefault("checkpoints", [])
            manifest.setdefault("restarts", 0)
            return manifest
    except (OSError, ValueError):
        pass
    return {"version": 1, "checkpoints": [], "restarts": 0}


def _write_manifest(directory, manifest):
    path = pathlib.Path(directory) / MANIFEST_NAME
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(manifest, indent="\t"))
    os.replace(tmp, path)


def _manifest_add(directory, name, step, size, keep=None):
    """Register a saved checkpoint; with `keep`, delete this run's oldest
    checkpoints beyond the newest `keep`."""
    directory = pathlib.Path(directory)
    manifest = read_manifest(directory)
    entries = [e for e in manifest["checkpoints"]
               if isinstance(e, dict) and e.get("file") != name
               and (directory / str(e.get("file"))).exists()]
    entries.append({"file": name, "step": step, "bytes": size})
    entries.sort(key=lambda e: e.get("step", -1))
    if keep is not None and keep > 0:
        while len(entries) > keep:
            stale = entries.pop(0)
            try:
                (directory / str(stale["file"])).unlink()
            except OSError:
                pass
    manifest["checkpoints"] = entries
    _write_manifest(directory, manifest)


def bump_restarts(directory):
    """Increment and persist the run's restart counter; returns it."""
    manifest = read_manifest(directory)
    manifest["restarts"] = int(manifest.get("restarts", 0)) + 1
    _write_manifest(directory, manifest)
    return manifest["restarts"]
