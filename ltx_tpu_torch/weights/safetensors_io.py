"""The safetensors file format, read and written without the safetensors
package.

A file is an 8-byte little-endian header length, a JSON header (padded
with spaces to a multiple of 8 bytes) mapping each key to its dtype, shape
and [start, end) byte offsets into the data that follows, and an optional
"__metadata__" dict of strings; then the raw little-endian data.

`load` maps the file (mmap, private: a write into a tensor never reaches
the file) and returns `torch.frombuffer` views of it, so nothing is copied
until a tensor is used; bf16 data is a view of its 16-bit payload. The
views keep the mapping alive. Code that changes a loaded tensor's values
copies it first, so that the caller's tensors keep theirs. `save` writes
through a pid-unique temporary file and renames it into place.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ltx_tpu_torch.errors import WeightLoadingFailedError

DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "U8": torch.uint8, "I8": torch.int8, "U16": torch.uint16, "I32": torch.int32,
    "U32": torch.uint32, "I64": torch.int64, "BOOL": torch.bool,
}
_NAMES = {dtype: name for name, dtype in DTYPES.items()}

# a header larger than this is not a safetensors file (the format's own cap)
_MAX_HEADER = 100 * 2**20


def read_header(path) -> Tuple[dict, int]:
    """(the JSON header, the byte offset where the data starts)."""
    path = Path(path)
    size = path.stat().st_size
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise WeightLoadingFailedError(f"{path}: not a safetensors file")
        (n,) = struct.unpack("<Q", head)
        if n > min(_MAX_HEADER, size - 8):
            raise WeightLoadingFailedError(f"{path}: header of {n} bytes")
        try:
            header = json.loads(f.read(n))
        except ValueError as e:
            raise WeightLoadingFailedError(f"{path}: unreadable header ({e})") from e
    if not isinstance(header, dict):
        raise WeightLoadingFailedError(f"{path}: header is not a JSON object")
    return header, 8 + n


def metadata(path) -> Dict[str, str]:
    """The file's "__metadata__" dict ({} when it has none)."""
    return dict(read_header(path)[0].get("__metadata__") or {})


def _entries(path, header: dict, data_len: int):
    """(key, torch dtype, shape, start, end) of every tensor, validated
    against the data's length; raises on an unknown dtype."""
    for key, info in header.items():
        if key == "__metadata__":
            continue
        name = info.get("dtype")
        if name not in DTYPES:
            raise WeightLoadingFailedError(f"{path}: {key} has dtype {name}, which this "
                                           f"reader does not take ({sorted(DTYPES)})")
        dtype, shape = DTYPES[name], tuple(int(s) for s in info["shape"])
        start, end = (int(o) for o in info["data_offsets"])
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if not 0 <= start <= end <= data_len or end - start != nbytes:
            raise WeightLoadingFailedError(
                f"{path}: {key} {name}{list(shape)} at [{start}, {end}) does not fit "
                f"the {data_len} bytes of data")
        yield key, dtype, shape, start, end


def load(path) -> Dict[str, torch.Tensor]:
    """{key: CPU tensor} viewing a private map of the file (no copy; a
    tensor whose offset is not a multiple of its item size is copied)."""
    path = Path(path)
    header, base = read_header(path)
    size = path.stat().st_size
    entries = list(_entries(path, header, size - base))
    out: Dict[str, torch.Tensor] = {}
    if size == 0 or not entries:
        return out
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    for key, dtype, shape, start, end in entries:
        count = (end - start) // dtype.itemsize
        if count == 0:
            out[key] = torch.empty(shape, dtype=dtype)
            continue
        offset = base + start
        if offset % dtype.itemsize:
            raw = torch.frombuffer(mm, dtype=torch.uint8, count=end - start, offset=offset)
            out[key] = raw.clone().view(dtype).reshape(shape)
        else:
            out[key] = torch.frombuffer(mm, dtype=dtype, count=count,
                                        offset=offset).reshape(shape)
    return out


def _as_tensor(key: str, value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        tensor = value.detach()
    else:
        tensor = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
    if tensor.dtype not in _NAMES:
        raise ValueError(f"{key}: dtype {tensor.dtype} is not one this writer takes "
                         f"({sorted(DTYPES)})")
    return tensor


def save(tensors: Mapping[str, object], path,
         metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write {key: tensor or numpy array} (any device) to `path`, with
    `metadata` (strings) under "__metadata__", atomically."""
    header: dict = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    items, offset = [], 0
    for key, value in tensors.items():
        tensor = _as_tensor(key, value)
        nbytes = tensor.numel() * tensor.element_size()
        header[key] = {"dtype": _NAMES[tensor.dtype], "shape": list(tensor.shape),
                       "data_offsets": [offset, offset + nbytes]}
        items.append(tensor)
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    path = Path(path)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)
            for tensor in items:
                if tensor.numel():
                    data = tensor.cpu().contiguous().reshape(-1).view(torch.uint8)
                    f.write(memoryview(data.numpy()))
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
