"""Read-only importer for the reference's serialized artifacts (the
port's copy of ``paddle_tpu/inference/proto_import.py``; struct and
numpy only):

* ``__model__`` files: a protobuf ``paddle.framework.proto.ProgramDesc``
  (reference framework.proto:184, written by
  ``python/paddle/fluid/io.py:865`` save_inference_model) is parsed
  into this package's ``Program``;
* parameter files: the reference's raw LoDTensor stream (reference
  framework/lod_tensor.cc:246 SerializeToStream /
  tensor_util.cc TensorToStream) is parsed into a numpy array.

The decoder is a hand-rolled proto2 wire-format reader over the field
numbers documented in framework.proto. Import is one-way by design.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from ..core.program import Program
from ..core.types import VarType

__all__ = ["parse_program_desc", "parse_lod_tensor",
           "parse_lod_tensors_concat", "is_program_desc",
           "feed_fetch_names"]

# framework.proto:91-134 VarType.Type values
_DTYPE = {0: "bool", 1: "int16", 2: "int32", 3: "int64", 4: "float16",
          5: "float32", 6: "float64", 19: "int64", 20: "uint8",
          21: "int8"}
_VARKIND = {7: VarType.LOD_TENSOR, 8: VarType.SELECTED_ROWS,
            11: VarType.STEP_SCOPES, 13: VarType.LOD_TENSOR_ARRAY,
            15: VarType.READER, 17: VarType.RAW}


# ---------------------------------------------------------------------------
# proto2 wire-format primitives
# ---------------------------------------------------------------------------
def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) triples. wire 0 ->
    varint int, 2 -> bytes, 1/5 -> fixed bytes."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 2:
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _signed(v: int, bits: int = 64) -> int:
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


def _repeated_varints(wt, v) -> List[int]:
    """A repeated integer field arrives unpacked (one varint per
    occurrence, proto2 default) or packed (one length-delimited run)."""
    if wt == 0:
        return [v]
    out = []
    i = 0
    while i < len(v):
        x, i = _varint(v, i)
        out.append(x)
    return out


def _f32(v) -> float:
    return struct.unpack("<f", v)[0]


# ---------------------------------------------------------------------------
# framework.proto message readers
# ---------------------------------------------------------------------------
def _read_tensor_desc(buf) -> Tuple[str, List[int]]:
    """VarType.TensorDesc: data_type=1, dims=2 (int64, may be -1)."""
    dtype, dims = None, []
    for field, wt, v in _fields(buf):
        if field == 1:
            dtype = _DTYPE.get(v)
        elif field == 2:
            dims += [_signed(x) for x in _repeated_varints(wt, v)]
    return dtype, dims


def _read_var_type(buf):
    """VarType: type=1; lod_tensor=3 {tensor=1, lod_level=2};
    selected_rows=2 (TensorDesc); tensor_array=4."""
    kind_num, dtype, dims, lod_level = None, None, None, 0
    for field, wt, v in _fields(buf):
        if field == 1:
            kind_num = v
        elif field == 2:  # selected_rows TensorDesc
            dtype, dims = _read_tensor_desc(v)
        elif field in (3, 4):  # LoDTensorDesc / LoDTensorArrayDesc
            for f2, w2, v2 in _fields(v):
                if f2 == 1:
                    dtype, dims = _read_tensor_desc(v2)
                elif f2 == 2:
                    lod_level = v2
    return kind_num, dtype, dims, lod_level


def _read_var_desc(buf) -> Dict:
    """VarDesc: name=1, type=2, persistable=3."""
    name, persistable = None, False
    kind_num, dtype, dims, lod_level = None, None, None, 0
    for field, wt, v in _fields(buf):
        if field == 1:
            name = v.decode()
        elif field == 2:
            kind_num, dtype, dims, lod_level = _read_var_type(v)
        elif field == 3:
            persistable = bool(v)
    kind = _VARKIND.get(kind_num, VarType.RAW)
    return {"name": name, "shape": dims, "dtype": dtype,
            "lod_level": lod_level, "persistable": persistable,
            "type": kind.value, "is_data": False}


def _read_op_var(buf) -> Tuple[str, List[str]]:
    """OpDesc.Var: parameter=1, arguments=2."""
    slot, args = None, []
    for field, wt, v in _fields(buf):
        if field == 1:
            slot = v.decode()
        elif field == 2:
            args.append(v.decode())
    return slot, args


def _read_attr(buf):
    """OpDesc.Attr: name=1, type=2 (AttrType), then the value field
    the type selects (framework.proto:45-60)."""
    name, atype = None, None
    fields: Dict[int, list] = {}
    for field, wt, v in _fields(buf):
        if field == 1:
            name = v.decode()
        elif field == 2:
            atype = v
        else:
            fields.setdefault(field, []).append((wt, v))

    def first(fnum, conv, default=None):
        if fnum not in fields:
            return default
        wt, v = fields[fnum][0]
        return conv(wt, v)

    def rep_ints(fnum, bits):
        out = []
        for wt, v in fields.get(fnum, []):
            out += [_signed(x, bits) for x in _repeated_varints(wt, v)]
        return out

    if atype == 0:    # INT
        return name, first(3, lambda w, v: _signed(v, 32), 0)
    if atype == 1:    # FLOAT
        return name, first(4, lambda w, v: _f32(v), 0.0)
    if atype == 2:    # STRING
        return name, first(5, lambda w, v: v.decode(), "")
    if atype == 3:    # INTS
        return name, rep_ints(6, 32)
    if atype == 4:    # FLOATS
        out = []
        for wt, v in fields.get(7, []):
            if wt == 5:
                out.append(_f32(v))
            else:  # packed
                out += [x[0] for x in struct.iter_unpack("<f", v)]
        return name, out
    if atype == 5:    # STRINGS
        return name, [v.decode() for wt, v in fields.get(8, [])]
    if atype == 6:    # BOOLEAN
        return name, bool(first(10, lambda w, v: v, 0))
    if atype == 7:    # BOOLEANS
        return name, [bool(x) for x in rep_ints(11, 64)]
    if atype == 8:    # BLOCK
        return name, {"__block__": first(12, lambda w, v: v, 0)}
    if atype == 9:    # LONG
        return name, first(13, lambda w, v: _signed(v, 64), 0)
    if atype == 10:   # BLOCKS
        return name, [{"__block__": x} for x in rep_ints(14, 32)]
    if atype == 11:   # LONGS
        return name, rep_ints(15, 64)
    return name, None


def _read_op_desc(buf) -> Dict:
    """OpDesc: inputs=1, outputs=2, type=3, attrs=4."""
    op = {"type": None, "inputs": {}, "outputs": {}, "attrs": {}}
    for field, wt, v in _fields(buf):
        if field == 1:
            slot, args = _read_op_var(v)
            op["inputs"][slot] = args
        elif field == 2:
            slot, args = _read_op_var(v)
            op["outputs"][slot] = args
        elif field == 3:
            op["type"] = v.decode()
        elif field == 4:
            name, val = _read_attr(v)
            if val is not None:
                op["attrs"][name] = val
    return op


def _read_block_desc(buf) -> Dict:
    """BlockDesc: idx=1, parent_idx=2, vars=3, ops=4."""
    blk = {"idx": 0, "parent_idx": -1, "vars": [], "ops": []}
    for field, wt, v in _fields(buf):
        if field == 1:
            blk["idx"] = v
        elif field == 2:
            blk["parent_idx"] = _signed(v, 32)
        elif field == 3:
            blk["vars"].append(_read_var_desc(v))
        elif field == 4:
            blk["ops"].append(_read_op_desc(v))
    return blk


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def is_program_desc(raw: bytes) -> bool:
    """Cheap sniff: a serialized ProgramDesc starts with field 1
    wire-type 2 (key byte 0x0A, the first BlockDesc)."""
    return bool(raw) and raw[0] == 0x0A


def parse_program_desc(raw: bytes) -> Program:
    """Parse a reference ``__model__`` protobuf into a Program.
    Feed/fetch ops and holder vars are kept (the Executor skips them),
    and feed-op outputs are flagged ``is_data``."""
    blocks = []
    for field, wt, v in _fields(raw):
        if field == 1:
            blocks.append(_read_block_desc(v))
    if not blocks:
        raise ValueError("no BlockDesc in the ProgramDesc payload")
    blocks.sort(key=lambda b: b["idx"])

    feed_outs = {n for blk in blocks for op in blk["ops"]
                 if op["type"] == "feed"
                 for ns in op["outputs"].values() for n in ns}
    params = []
    for blk in blocks:
        for vd in blk["vars"]:
            if vd["name"] in feed_outs:
                vd["is_data"] = True
            if vd["persistable"] and blk["idx"] == 0 \
                    and vd["type"] == VarType.LOD_TENSOR.value:
                params.append(vd["name"])
    return Program.from_dict({"blocks": blocks, "parameters": params})


def feed_fetch_names(program: Program) -> Tuple[List[str], List[str]]:
    """Recover the feed/fetch contract from the program's feed/fetch
    ops, ordered by their 'col' attr (reference io.py prepend_feed_ops
    / append_fetch_ops layout)."""
    feeds: List[Tuple[int, str]] = []
    fetches: List[Tuple[int, str]] = []
    for op in program.global_block.ops:
        col = op.attrs.get("col", 0)
        if op.type == "feed":
            for ns in op.outputs.values():
                feeds += [(col, n) for n in ns]
        elif op.type == "fetch":
            for ns in op.inputs.values():
                fetches += [(col, n) for n in ns]
    return ([n for _, n in sorted(feeds)],
            [n for _, n in sorted(fetches)])


def _parse_lod_tensor_at(raw: bytes, i: int) -> Tuple[np.ndarray, int]:
    """Parse one reference LoDTensor stream starting at offset ``i``
    (lod_tensor.cc:246): u32 version, u64 lod_level ( + per-level u64
    byte size + size_t offsets), u32 tensor version, i32 TensorDesc
    size, TensorDesc proto, raw data. Returns (array, next offset).
    LoD offsets are dropped: the port's runtime is padded-dense, not
    LoD."""
    (ver,) = struct.unpack_from("<I", raw, i)
    i += 4
    if ver != 0:
        raise ValueError(f"unsupported LoDTensor version {ver}")
    (lod_levels,) = struct.unpack_from("<Q", raw, i)
    i += 8
    for _ in range(lod_levels):
        (nbytes,) = struct.unpack_from("<Q", raw, i)
        i += 8 + nbytes
    (tver,) = struct.unpack_from("<I", raw, i)
    i += 4
    if tver != 0:
        raise ValueError(f"unsupported Tensor version {tver}")
    (desc_size,) = struct.unpack_from("<i", raw, i)
    i += 4
    dtype, dims = _read_tensor_desc(raw[i:i + desc_size])
    i += desc_size
    if dtype is None:
        raise ValueError("TensorDesc without data_type")
    count = int(np.prod(dims)) if dims else 0
    if not dims:
        raise ValueError("TensorDesc without dims")
    arr = np.frombuffer(raw, dtype=np.dtype(dtype), offset=i,
                        count=count)
    i += arr.nbytes
    return arr.reshape(dims).copy(), i


def parse_lod_tensor(raw: bytes) -> np.ndarray:
    """Parse a single reference LoDTensor stream (one param file)."""
    arr, _ = _parse_lod_tensor_at(raw, 0)
    return arr


def parse_lod_tensors_concat(raw: bytes) -> List[np.ndarray]:
    """Parse a reference COMBINED params file (save_combine_op:
    concatenated LoDTensor streams in the saved var-name order)."""
    out, i = [], 0
    while i < len(raw):
        arr, i = _parse_lod_tensor_at(raw, i)
        out.append(arr)
    return out
