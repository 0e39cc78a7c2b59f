"""Data-only binary codec for persisted artifacts and the microchain wire.

Replaces pickle (which executes attacker-controlled code on load) with a
closed-world serializer: only primitives, containers, numpy integer arrays
and an explicit registry of plain dataclasses can be encoded or decoded.
The reference uses bincode for the same reason (src/core/cli/microchain.rs,
proofs.rs); the format itself is implementation-defined.

Format: one tag byte per value, big-endian fixed ints for lengths.
Registered classes are encoded as (class name, field values in
dataclasses.fields order) and rebuilt via object.__new__ + setattr, so no
constructor logic ever runs on untrusted input.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict

import numpy as np

_REGISTRY: Dict[str, type] = {}
_FIELDS: Dict[str, list] = {}


def register(cls: type) -> type:
    """Mark a plain dataclass as serializable. Name collisions are bugs."""
    name = cls.__name__
    prev = _REGISTRY.get(name)
    assert prev is None or prev is cls, f"codec name collision: {name}"
    _REGISTRY[name] = cls
    _FIELDS[name] = [f.name for f in dataclasses.fields(cls)] \
        if dataclasses.is_dataclass(cls) else None
    return cls


def register_object(cls: type, fields: list) -> type:
    """Register a non-dataclass with an explicit field list."""
    _REGISTRY[cls.__name__] = cls
    _FIELDS[cls.__name__] = list(fields)
    return cls


_ENSURED = False


def _ensure_registered():
    """Import every module that registers codec classes (lazy: avoids
    import cycles at module-load time)."""
    global _ENSURED
    if _ENSURED:
        return
    from ..cli import data as _data        # noqa: F401
    from ..cli import microchain as _mc    # noqa: F401
    from ..stark import machine as _m      # noqa: F401
    from ..stark import pcs as _pcs        # noqa: F401
    from ..stark import fri as _fri        # noqa: F401
    from ..stark import merkle as _mk      # noqa: F401
    _ENSURED = True


class CodecError(Exception):
    pass


_NP_DTYPES = {
    "u4": np.uint32, "u8": np.uint64, "i4": np.int32, "i8": np.int64,
}


def _enc(obj: Any, out: bytearray):
    if obj is None:
        out.append(0x00)
    elif obj is True:
        out.append(0x01)
    elif obj is False:
        out.append(0x02)
    elif isinstance(obj, (int, np.integer)):
        v = int(obj)
        if -(1 << 63) <= v < (1 << 63):
            out.append(0x03)
            out += struct.pack(">q", v)
        else:
            b = v.to_bytes((v.bit_length() + 8) // 8, "big", signed=True)
            out.append(0x04)
            out += struct.pack(">I", len(b))
            out += b
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(0x05)
        out += struct.pack(">I", len(b))
        out += b
    elif isinstance(obj, bytes):
        out.append(0x06)
        out += struct.pack(">I", len(obj))
        out += obj
    elif isinstance(obj, list):
        if not _pack_run_seq(obj, False, out) \
                and not _pack_int_run(obj, False, out):
            out.append(0x07)
            out += struct.pack(">I", len(obj))
            for x in obj:
                _enc(x, out)
    elif isinstance(obj, tuple):
        if not _pack_run_seq(obj, True, out) \
                and not _pack_int_run(obj, True, out):
            out.append(0x08)
            out += struct.pack(">I", len(obj))
            for x in obj:
                _enc(x, out)
    elif isinstance(obj, dict):
        out.append(0x09)
        out += struct.pack(">I", len(obj))
        for k, v in obj.items():
            _enc(k, out)
            _enc(v, out)
    elif isinstance(obj, np.ndarray):
        code = {np.dtype(np.uint32): "u4", np.dtype(np.uint64): "u8",
                np.dtype(np.int32): "i4", np.dtype(np.int64): "i8"
                }.get(obj.dtype)
        if code is None:
            raise CodecError(f"unsupported ndarray dtype {obj.dtype}")
        out.append(0x0A)
        out += code.encode()
        out += struct.pack(">B", obj.ndim)
        for d in obj.shape:
            out += struct.pack(">Q", d)
        b = np.ascontiguousarray(obj).tobytes()
        out += struct.pack(">Q", len(b))
        out += b
    else:
        name = type(obj).__name__
        if name not in _REGISTRY or _REGISTRY[name] is not type(obj):
            raise CodecError(f"type not serializable: {type(obj)!r}")
        out.append(0x0B)
        nb = name.encode()
        out += struct.pack(">B", len(nb))
        out += nb
        for f in _FIELDS[name]:
            _enc(getattr(obj, f), out)


def _pack_int_run(seq, is_tuple: bool, out: bytearray) -> bool:
    """Homogeneous int sequences (>= 8 elements) encode as one packed
    run (tag 0x0C) instead of a tag byte + 8-byte int per element:
    proof payloads are almost entirely such runs (opened-value rows,
    Merkle paths, digests), and per-element _dec calls dominated cold
    verify (round-5 profile: 1.87M calls, ~2s of a 4-shard fib(100000)
    decode). Decode rebuilds the identical list/tuple of python ints via
    one struct.unpack, at C speed. bools are excluded (type-exact
    check), matching the scalar tags' round-trip semantics."""
    n = len(seq)
    if n < 8:
        return False
    lo = hi = None
    for x in seq:
        if type(x) is not int and not (isinstance(x, np.integer)
                                       and not isinstance(x, np.bool_)):
            return False
        v = int(x)
        if lo is None or v < lo:
            lo = v
        if hi is None or v > hi:
            hi = v
    if 0 <= lo and hi < (1 << 32):
        flags = 2 | (1 if is_tuple else 0)
        fmt = "I"
    elif -(1 << 63) <= lo and hi < (1 << 63):
        flags = 0 | (1 if is_tuple else 0)
        fmt = "q"
    else:
        return False
    out.append(0x0C)
    out.append(flags)
    out += struct.pack(">I", n)
    out += np.array([int(x) for x in seq], np.int64).astype(
        ">u4" if fmt == "I" else ">i8").tobytes()
    return True


def _pack_run_seq(seq, is_tuple: bool, out: bytearray) -> bool:
    """Sequences of equal-length homogeneous int runs (e.g. a Merkle path
    as a list of 8-int digest tuples) encode as ONE block (tag 0x0D)
    instead of one 0x0C run per element. A 4-shard fib(100000) proof holds
    ~147k such digest runs; decoding them one _dec call each dominated the
    cold-verify decode (round-5 profile). Decode is a single struct.unpack
    + a slicing comprehension. Only int elements qualify (bool excluded,
    matching _pack_int_run); min 2 runs of identical kind and length."""
    n = len(seq)
    if n < 2:
        return False
    first = seq[0]
    inner_tuple = type(first) is tuple
    if not inner_tuple and type(first) is not list:
        return False
    m = len(first)
    if m < 1 or m > 255:
        return False
    lo = hi = None
    for run in seq:
        if type(run) is not type(first) or len(run) != m:
            return False
        for x in run:
            if type(x) is not int and not (isinstance(x, np.integer)
                                           and not isinstance(x, np.bool_)):
                return False
            v = int(x)
            if lo is None or v < lo:
                lo = v
            if hi is None or v > hi:
                hi = v
    if 0 <= lo and hi < (1 << 32):
        flags = 4 | (1 if is_tuple else 0) | (2 if inner_tuple else 0)
        fmt = "I"
    elif -(1 << 63) <= lo and hi < (1 << 63):
        flags = 0 | (1 if is_tuple else 0) | (2 if inner_tuple else 0)
        fmt = "q"
    else:
        return False
    out.append(0x0D)
    out.append(flags)
    out += struct.pack(">I", n)
    out += struct.pack(">B", m)
    flat = [int(x) for run in seq for x in run]
    out += np.array(flat, np.int64).astype(
        ">u4" if fmt == "I" else ">i8").tobytes()
    return True


# decode threads a plain integer offset through struct.unpack_from calls
# instead of a reader object: the per-call method overhead (take/u8/u32)
# was ~half of a 4-shard fib(100000) proof decode (round-5 cold-verify
# profile). struct.unpack_from range-checks the tail for us (struct.error
# -> CodecError in decode()); explicit checks remain wherever a length is
# used for slicing or allocation.
_U32_AT = struct.Struct(">I").unpack_from
_U64_AT = struct.Struct(">Q").unpack_from
_I64_AT = struct.Struct(">q").unpack_from


def _dec(buf, pos: int, depth: int = 0):
    if depth > 200:
        raise CodecError("nesting too deep")
    if pos >= len(buf):
        raise CodecError("truncated input")
    tag = buf[pos]
    pos += 1
    if tag == 0x0C:
        if pos + 5 > len(buf):
            raise CodecError("truncated input")
        flags = buf[pos]
        if flags > 3:
            raise CodecError("bad packed-run flags")
        (n,) = _U32_AT(buf, pos + 1)
        if n > (1 << 28):
            raise CodecError("packed run too long")
        pos += 5
        end = pos + n * (4 if flags & 2 else 8)
        if end > len(buf):
            raise CodecError("truncated input")
        # np.frombuffer + tolist, not struct.unpack(f">{n}..."): the
        # varying-count format strings blow struct's format cache and
        # re-parsing them dominated decode (round-5 profile)
        vals = np.frombuffer(buf, ">u4" if flags & 2 else ">i8",
                             count=n, offset=pos).tolist()
        return (tuple(vals) if flags & 1 else vals), end
    if tag == 0x0D:
        if pos + 6 > len(buf):
            raise CodecError("truncated input")
        flags = buf[pos]
        if flags > 7:
            raise CodecError("bad run-seq flags")
        (n,) = _U32_AT(buf, pos + 1)
        m = buf[pos + 5]
        if m < 1 or n * m > (1 << 28):
            raise CodecError("run-seq too long")
        pos += 6
        end = pos + n * m * (4 if flags & 4 else 8)
        if end > len(buf):
            raise CodecError("truncated input")
        rows = np.frombuffer(buf, ">u4" if flags & 4 else ">i8",
                             count=n * m, offset=pos).reshape(n, m).tolist()
        if flags & 2:
            runs = list(map(tuple, rows))
        else:
            runs = rows
        return (tuple(runs) if flags & 1 else runs), end
    if tag == 0x03:
        v = _I64_AT(buf, pos)[0]
        return v, pos + 8
    if tag == 0x0B:
        _ensure_registered()
        nb = buf[pos] if pos < len(buf) else _trunc()
        name = bytes(buf[pos + 1:pos + 1 + nb]).decode()
        if len(name.encode()) != nb:
            raise CodecError("truncated input")
        pos += 1 + nb
        cls = _REGISTRY.get(name)
        if cls is None:
            raise CodecError(f"unknown class {name!r}")
        obj = object.__new__(cls)
        setattr_ = object.__setattr__
        for f in _FIELDS[name]:
            v, pos = _dec(buf, pos, depth + 1)
            setattr_(obj, f, v)
        return obj, pos
    if tag == 0x07:
        (n,) = _U32_AT(buf, pos)
        pos += 4
        out = []
        append = out.append
        for _ in range(n):
            v, pos = _dec(buf, pos, depth + 1)
            append(v)
        return out, pos
    if tag == 0x08:
        (n,) = _U32_AT(buf, pos)
        pos += 4
        out = []
        append = out.append
        for _ in range(n):
            v, pos = _dec(buf, pos, depth + 1)
            append(v)
        return tuple(out), pos
    if tag == 0x00:
        return None, pos
    if tag == 0x01:
        return True, pos
    if tag == 0x02:
        return False, pos
    if tag == 0x04:
        (n,) = _U32_AT(buf, pos)
        if n > (1 << 20):
            raise CodecError("bigint too large")
        pos += 4
        if pos + n > len(buf):
            raise CodecError("truncated input")
        return int.from_bytes(buf[pos:pos + n], "big", signed=True), pos + n
    if tag == 0x05:
        (n,) = _U32_AT(buf, pos)
        pos += 4
        if pos + n > len(buf):
            raise CodecError("truncated input")
        return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
    if tag == 0x06:
        (n,) = _U32_AT(buf, pos)
        pos += 4
        if pos + n > len(buf):
            raise CodecError("truncated input")
        return bytes(buf[pos:pos + n]), pos + n
    if tag == 0x09:
        (n,) = _U32_AT(buf, pos)
        pos += 4
        d = {}
        for _ in range(n):
            k, pos = _dec(buf, pos, depth + 1)
            if isinstance(k, (list, dict, np.ndarray)):
                raise CodecError("unhashable dict key")
            d[k], pos = _dec(buf, pos, depth + 1)
        return d, pos
    if tag == 0x0A:
        code = bytes(buf[pos:pos + 2]).decode()
        dt = _NP_DTYPES.get(code)
        if dt is None:
            raise CodecError(f"bad dtype code {code}")
        if pos + 3 > len(buf):
            raise CodecError("truncated input")
        ndim = buf[pos + 2]
        pos += 3
        if ndim > 8:
            raise CodecError("too many dims")
        shape = []
        for _ in range(ndim):
            shape.append(_U64_AT(buf, pos)[0])
            pos += 8
        (nb,) = _U64_AT(buf, pos)
        pos += 8
        # exact product in python ints: a uint64 np.prod can wrap for
        # attacker-chosen dims, letting a bogus shape pass the size check
        expected = np.dtype(dt).itemsize
        for d in shape:
            if d > (1 << 33):
                raise CodecError("dim too large")
            expected *= d
        if nb != expected or nb > (1 << 33):
            raise CodecError("ndarray size mismatch")
        if pos + nb > len(buf):
            raise CodecError("truncated input")
        arr = np.frombuffer(buf, dtype=dt, count=nb // np.dtype(dt).itemsize,
                            offset=pos).reshape(tuple(shape)).copy()
        return arr, pos + nb
    raise CodecError(f"bad tag byte {tag:#x}")


def _trunc():
    raise CodecError("truncated input")


def encode(obj: Any) -> bytes:
    out = bytearray()
    _enc(obj, out)
    return bytes(out)


def decode(buf: bytes) -> Any:
    try:
        obj, pos = _dec(buf, 0)
    except CodecError:
        raise
    except (ValueError, TypeError, OverflowError, struct.error,
            UnicodeDecodeError) as e:
        # malformed input must surface as CodecError, never as a stray
        # exception a network handler's narrow `except CodecError` misses
        raise CodecError(f"malformed input: {e}") from e
    if pos != len(buf):
        raise CodecError("trailing bytes")
    return obj
