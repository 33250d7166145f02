"""Reading and writing the safetensors format with numpy and torch alone.

A file is an 8-byte little-endian header length, a JSON header naming each
tensor's ``dtype``, ``shape`` and ``data_offsets`` (begin, end) into the
byte buffer that follows (an optional ``__metadata__`` entry maps strings
to strings; it is skipped), then the raw little-endian tensor bytes.
bfloat16 tensors are read as uint16 and viewed as ``torch.bfloat16``, bit
for bit; U16 holds the bf16 leaves of a native directory.

Tensors are read through a copy-on-write ``np.memmap``: a multi-gigabyte
file is paged in as its tensors are used, never held twice.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

# safetensors dtype -> (numpy dtype of the raw bytes, torch dtype)
_DTYPES = {
    "F64": (np.float64, torch.float64),
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "U16": (np.uint16, torch.uint16),
    "U32": (np.uint32, torch.uint32),
    "BOOL": (np.bool_, torch.bool),
}
_NAMES = {t: name for name, (_, t) in _DTYPES.items()}
_MAX_HEADER = 100 * 1024 * 1024


class SafetensorsError(ValueError):
    """A file that is not a well-formed safetensors file."""


def read_header(path: str) -> tuple[dict, int]:
    """(the tensor entries of the JSON header, the byte offset of the data
    buffer), checked against the file's size: every tensor's byte range
    lies inside the buffer, matches its dtype and shape, and no two
    overlap."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise SafetensorsError(f"{path}: truncated before the header length")
        (n,) = struct.unpack("<Q", raw)
        if n > _MAX_HEADER or 8 + n > size:
            raise SafetensorsError(
                f"{path}: header length {n} exceeds the file ({size} bytes)")
        try:
            header = json.loads(f.read(n))
        except ValueError as e:
            raise SafetensorsError(f"{path}: header is not JSON ({e})") from None
    if not isinstance(header, dict):
        raise SafetensorsError(f"{path}: header is not a JSON object")
    header.pop("__metadata__", None)
    start = 8 + n
    spans = []
    for name, e in header.items():
        if e.get("dtype") not in _DTYPES:
            raise SafetensorsError(f"{path}: {name}: dtype {e.get('dtype')!r}")
        begin, end = e["data_offsets"]
        want = int(np.prod(e["shape"], dtype=np.int64)) * np.dtype(
            _DTYPES[e["dtype"]][0]).itemsize
        if not 0 <= begin <= end or end - begin != want:
            raise SafetensorsError(
                f"{path}: {name}: offsets {begin}..{end} do not hold "
                f"{e['dtype']} {e['shape']} ({want} bytes)")
        if start + end > size:
            raise SafetensorsError(
                f"{path}: truncated: {name} ends at byte {start + end}, the "
                f"file has {size}")
        spans.append((begin, end, name))
    spans.sort()
    for (_, end0, a), (begin1, _, b) in zip(spans, spans[1:]):
        if begin1 < end0:
            raise SafetensorsError(f"{path}: {a} and {b} overlap")
    return header, start


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, as CPU tensors backed by a
    copy-on-write map of the file."""
    header, start = read_header(path)
    if not header:
        return {}
    buf = np.memmap(path, dtype=np.uint8, mode="c")
    out: dict[str, torch.Tensor] = {}
    for name, e in header.items():
        np_dtype = _DTYPES[e["dtype"]][0]
        begin, end = e["data_offsets"]
        arr = buf[start + begin:start + end]
        if arr.ctypes.data % np.dtype(np_dtype).itemsize:
            arr = arr.copy()  # a writer that did not align this tensor
        t = torch.from_numpy(arr.view(np_dtype).reshape(e["shape"]))
        out[name] = t.view(torch.bfloat16) if e["dtype"] == "BF16" else t
    return out


def _as_bytes(t) -> tuple[str, list[int], np.ndarray]:
    """(dtype name, shape, contiguous numpy array of the raw bytes)."""
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t))
    t = t.detach().cpu().contiguous()
    if t.dtype not in _NAMES:
        raise SafetensorsError(f"dtype {t.dtype} has no safetensors name")
    raw = t.view(torch.uint16) if t.dtype == torch.bfloat16 else t
    return _NAMES[t.dtype], list(t.shape), raw.numpy()


def save_file(tensors: dict, path: str) -> None:
    """Write ``{name: tensor or numpy array}`` as a safetensors file: the
    header padded with spaces to 8 bytes, then the tensors by falling item
    size and name, so that each starts aligned to its item size."""
    raw = {name: _as_bytes(t) for name, t in tensors.items()}
    entries, arrays, offset = {}, [], 0
    for name in sorted(raw, key=lambda n: (-raw[n][2].itemsize, n)):
        dtype, shape, arr = raw[name]
        entries[name] = {"dtype": dtype, "shape": shape,
                         "data_offsets": [offset, offset + arr.nbytes]}
        arrays.append(arr)
        offset += arr.nbytes
    header = json.dumps(entries, separators=(",", ":")).encode()
    header += b" " * (-len(header) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        for arr in arrays:
            if arr.size:
                f.write(memoryview(arr.reshape(-1).view(np.uint8)))
