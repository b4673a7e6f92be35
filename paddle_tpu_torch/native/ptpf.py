"""A read-only Python decoder of PTPF, the binary program format that
the JAX package's C++ core writes as ``__model__`` when that core is
built (``paddle_tpu/native/src/program.cc``: ``kMagic`` :437,
``ProgramDesc::serialize`` :621, ``deserialize`` :664, ``writeAttr`` /
``writeIo`` above them).

``from_bytes(raw)`` gives the same dict as that core's ``toJson``
(``program.cc`` :371), which ``Program.from_dict`` reads. The port writes
the JSON form of a model only, which both packages load.

Layout, little-endian: u32 magic "PTPF", u32 version 1, u32 block
count; per block i32 idx, i32 parent_idx, u32 var count, each var (str
name, u8 has_shape [u32 n, n x i64], str dtype, i32 lod_level, u8 flags
persistable|stop_gradient<<1|trainable<<2|is_data<<3, str type), u32 op
count, each op (str type, io inputs, io outputs, u32 attr count, each
str name + attr); then u32 parameter count, each a str. A str is u32
length + bytes; an io is u32 slot count, each str slot + u32 n + n strs.
An attr is a u8 tag, then by tag: 0 none, 1 bool u8, 2 int i64, 3 float
f64, 4 str, 5 bools (u32 n + n u8), 6 ints (u32 n + n i64), 7 floats (u32
n + n f64), 8 strs (u32 n + n strs), 9 block i32, 10 ndarray (str dtype,
u32 rank + i64 dims, u32 nbytes + payload; floats at their width,
integers as i64).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

MAGIC = b"PTPF"
VERSION = 1


class _Reader:
    def __init__(self, raw: bytes):
        self.raw = raw
        self.i = 0

    def take(self, fmt: str):
        size = struct.calcsize(fmt)
        if self.i + size > len(self.raw):
            raise ValueError("truncated or corrupt PTPF program")
        (v,) = struct.unpack_from(fmt, self.raw, self.i)
        self.i += size
        return v

    def u8(self) -> int:
        return self.take("<B")

    def u32(self) -> int:
        return self.take("<I")

    def i32(self) -> int:
        return self.take("<i")

    def i64(self) -> int:
        return self.take("<q")

    def f64(self) -> float:
        return self.take("<d")

    def blob(self) -> bytes:
        n = self.u32()
        if self.i + n > len(self.raw):
            raise ValueError("truncated or corrupt PTPF program")
        b = self.raw[self.i:self.i + n]
        self.i += n
        return b

    def str(self) -> str:
        return self.blob().decode()


def _nd_width(dtype: str) -> int:
    """Bytes an element of an ndarray attr takes (``ndElemSize``)."""
    if dtype in ("float64", "int64", "uint64"):
        return 8
    if dtype in ("float16", "bfloat16"):
        return 2
    if "float" in dtype:
        return 4
    return 8


def _bf16_to_float(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _nd_attr(r: _Reader) -> Dict:
    dtype = r.str()
    dims = [r.i64() for _ in range(r.u32())]
    data = r.blob()
    width = _nd_width(dtype)
    if "float" in dtype:
        if width == 8:
            flat = np.frombuffer(data, "<f8")
        elif width == 4:
            flat = np.frombuffer(data, "<f4")
        elif dtype == "bfloat16":
            flat = _bf16_to_float(np.frombuffer(data, "<u2"))
        else:
            flat = np.frombuffer(data, "<f2").astype(np.float32)
        values = [float(x) for x in flat.astype(np.float64)]
    else:
        values = [int(x) for x in np.frombuffer(data, "<i8")]
    return {"__ndarray__": values, "dtype": dtype, "shape": dims}


def _attr(r: _Reader):
    tag = r.u8()
    if tag == 0:
        return None
    if tag == 1:
        return r.u8() != 0
    if tag == 2:
        return r.i64()
    if tag == 3:
        return r.f64()
    if tag == 4:
        return r.str()
    if tag == 5:
        return [b != 0 for b in r.blob()]
    if tag == 6:
        return [r.i64() for _ in range(r.u32())]
    if tag == 7:
        return [r.f64() for _ in range(r.u32())]
    if tag == 8:
        return [r.str() for _ in range(r.u32())]
    if tag == 9:
        return {"__block__": r.i32()}
    if tag == 10:
        return _nd_attr(r)
    raise ValueError(f"PTPF: unknown attribute tag {tag}")


def _io(r: _Reader) -> Dict[str, List[str]]:
    out = {}
    for _ in range(r.u32()):
        slot = r.str()
        out[slot] = [r.str() for _ in range(r.u32())]
    return out


def _var(r: _Reader) -> Dict:
    name = r.str()
    shape = [r.i64() for _ in range(r.u32())] if r.u8() else None
    dtype = r.str() or None
    lod_level = r.i32()
    flags = r.u8()
    return {"name": name, "shape": shape, "dtype": dtype,
            "lod_level": lod_level, "persistable": bool(flags & 1),
            "stop_gradient": bool(flags & 2),
            "trainable": bool(flags & 4), "type": r.str(),
            "is_data": bool(flags & 8)}


def _op(r: _Reader) -> Dict:
    op_type = r.str()
    inputs = _io(r)
    outputs = _io(r)
    attrs = {}
    for _ in range(r.u32()):
        key = r.str()
        attrs[key] = _attr(r)
    return {"type": op_type, "inputs": inputs, "outputs": outputs,
            "attrs": attrs}


def is_ptpf(raw: bytes) -> bool:
    return raw[:4] == MAGIC


def from_bytes(raw: bytes) -> Dict:
    """The program dict of a PTPF blob (``Program.from_dict`` reads it).
    Raises ValueError on another format, version or a cut blob."""
    if not is_ptpf(raw):
        raise ValueError("bad magic (not a PTPF program)")
    r = _Reader(raw)
    r.u32()
    version = r.u32()
    if version != VERSION:
        raise ValueError(f"unsupported PTPF program version {version}")
    blocks = []
    for _ in range(r.u32()):
        idx, parent_idx = r.i32(), r.i32()
        variables = [_var(r) for _ in range(r.u32())]
        ops = [_op(r) for _ in range(r.u32())]
        blocks.append({"idx": idx, "parent_idx": parent_idx,
                       "vars": variables, "ops": ops})
    params = [r.str() for _ in range(r.u32())]
    return {"blocks": blocks, "parameters": params, "version": 1}


__all__: Tuple[str, ...] = ("from_bytes", "is_ptpf", "MAGIC")
