"""A safetensors reader and writer in ``torch`` and ``json`` alone.

The format: an unsigned 64-bit little-endian header length ``n``, ``n``
bytes of JSON mapping each tensor's name to its ``dtype`` (``"F32"``,
``"BF16"``, ...), ``shape`` and ``data_offsets`` ``[begin, end)`` into the
byte buffer that follows, plus an optional ``"__metadata__"`` map of
strings (skipped here, written by other writers), then that buffer,
little-endian, row-major.

The writer pads the header with spaces to a multiple of 8 bytes and lays
the tensors out by descending element size, then name, as the reference
implementation does, so every tensor starts aligned to its element.  Files
read with the ``safetensors`` package, and files it writes read here.
"""

from __future__ import annotations

import json
import math
import os
import struct
import sys
from typing import Dict, Optional

import torch

__all__ = ["load_file", "save_file"]

_DTYPES = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
    torch.int64: "I64", torch.int32: "I32", torch.int16: "I16", torch.int8: "I8",
    torch.uint8: "U8", torch.bool: "BOOL",
    torch.float8_e4m3fn: "F8_E4M3", torch.float8_e5m2: "F8_E5M2",
}
_BY_NAME = {v: k for k, v in _DTYPES.items()}
_MAX_HEADER = 100 * 1024 * 1024

if sys.byteorder != "little":  # pragma: no cover - every supported host is little-endian
    raise ImportError("safetensors_io reads and writes little-endian hosts only")


def _bytes(t: torch.Tensor):
    """A writable numpy view of ``t``'s bytes (``t`` contiguous, on the CPU)."""
    return t.reshape(-1).view(torch.uint8).numpy()


def save_file(tensors: Dict[str, torch.Tensor], path: str, fsync: bool = False,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device; copied to the host one at a time) to
    ``path``, with ``metadata`` (strings) as the header's
    ``"__metadata__"``.  ``fsync`` flushes the file to disk before
    returning."""
    for name, t in tensors.items():
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header, offset = {}, 0
    for name in order:
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach()
            if t.device.type != "cpu" or not t.is_contiguous():
                t = t.to("cpu").contiguous()
            f.write(memoryview(_bytes(t)))
        f.flush()
        if fsync:
            os.fsync(f.fileno())


def _read_header(f, path: str):
    raw = f.read(8)
    if len(raw) != 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", raw)
    if n > _MAX_HEADER:
        raise ValueError(f"{path}: header length {n} is not plausible")
    blob = f.read(n)
    if len(blob) != n:
        raise ValueError(f"{path}: truncated header")
    return 8 + n, json.loads(blob)


def load_file(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of ``path``, read into freshly allocated host tensors
    and then moved to ``device``; raises ``ValueError`` on a malformed or
    truncated file."""
    size = os.path.getsize(path)
    out = {}
    with open(path, "rb") as f:
        base, header = _read_header(f, path)
        header.pop("__metadata__", None)
        spans = sorted((info["data_offsets"][0], name) for name, info in header.items())
        end = 0
        for _, name in spans:
            info = header[name]
            if info["dtype"] not in _BY_NAME:
                raise ValueError(f"{path}: {name} has unsupported dtype {info['dtype']}")
            dtype, shape = _BY_NAME[info["dtype"]], [int(d) for d in info["shape"]]
            begin, stop = (int(x) for x in info["data_offsets"])
            nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
            if begin != end or stop - begin != nbytes:
                raise ValueError(f"{path}: {name} has data_offsets {info['data_offsets']}, "
                                 f"expected to start at {end} and hold {shape} {dtype}")
            if base + stop > size:
                raise ValueError(f"{path}: truncated: {name} ends at byte {base + stop}, "
                                 f"the file has {size}")
            t = torch.empty(shape, dtype=dtype)
            f.seek(base + begin)
            if t.numel() and f.readinto(memoryview(_bytes(t))) != stop - begin:
                raise ValueError(f"{path}: short read of {name}")
            out[name] = t if torch.device(device).type == "cpu" else t.to(device)
            end = stop
        if base + end != size:
            raise ValueError(f"{path}: {size - base - end} bytes beyond the last tensor")
    return out
