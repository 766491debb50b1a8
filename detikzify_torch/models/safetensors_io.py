"""The safetensors file format, read and written without the
``safetensors`` package (the card's machine does not have it).

A file is an 8-byte little-endian header length, a JSON header of
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` (plus an
optional ``"__metadata__"`` of strings), and then the byte buffer; the
offsets count from the end of the header. ``load_file`` maps the file
copy-on-write and returns CPU tensors that are views of the mapping, so a
16 GB checkpoint is not copied on the host before it is used. A tensor
whose offset is not a multiple of its element size is copied, since a
dtype view needs that alignment. numpy has no bfloat16: ``BF16`` bytes are
viewed as uint16 and the tensor as ``torch.bfloat16``.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

#: safetensors dtype -> (torch dtype, numpy dtype that views its bytes)
DTYPES = {
    "F32": (torch.float32, np.float32),
    "F16": (torch.float16, np.float16),
    "BF16": (torch.bfloat16, np.uint16),
    "I8": (torch.int8, np.int8),
    "I32": (torch.int32, np.int32),
    "I64": (torch.int64, np.int64),
    "U8": (torch.uint8, np.uint8),
    "BOOL": (torch.bool, np.bool_),
}
_NAMES = {tdt: name for name, (tdt, _) in DTYPES.items()}


def read_header(path: str) -> Tuple[dict, int]:
    """(header, byte offset of the data buffer) of one file."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file")
        (n,) = struct.unpack("<Q", head)
        raw = f.read(n)
    if len(raw) != n:
        raise ValueError(f"{path}: header runs past the end of the file")
    return json.loads(raw), 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU tensors viewing a
    copy-on-write mapping of it (writes to them never reach the file)."""
    header, base = read_header(path)
    header.pop("__metadata__", None)
    size = os.path.getsize(path)
    buf = np.memmap(path, dtype=np.uint8, mode="c")
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"not one of {sorted(DTYPES)}")
        tdt, ndt = DTYPES[info["dtype"]]
        ndt = np.dtype(ndt)
        begin, end = (base + o for o in info["data_offsets"])
        shape = tuple(info["shape"])
        if end > size or end - begin != int(np.prod(shape)) * ndt.itemsize:
            raise ValueError(f"{path}: {name} {info} does not fit the file")
        raw = buf[begin:end]
        if begin % ndt.itemsize:        # unaligned: a dtype view needs a copy
            raw = np.array(raw)
        t = torch.from_numpy(raw.view(ndt).reshape(shape))
        out[name] = t.view(tdt) if tdt != t.dtype else t
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str) -> int:
    """Write ``tensors`` (on any device) to ``path``, one tensor on the host
    at a time; returns the bytes written. Tensors are laid out by element
    size, largest first, then by name, so every offset is aligned."""
    names = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: dict = {}
    offset = 0
    for k in names:
        t = tensors[k]
        if t.dtype not in _NAMES:
            raise ValueError(f"{k}: dtype {t.dtype} has no safetensors name "
                             f"here ({sorted(DTYPES)})")
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)     # the data buffer starts 8-aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for k in names:
            t = tensors[k].detach().to("cpu").contiguous().reshape(-1)
            f.write(t.view(torch.uint8).numpy().data)
    return 8 + len(blob) + offset
