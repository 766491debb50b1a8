"""First-party multi-volume (split) ZIP joiner (counterpart of
``detikzify_tpu/dataset/splitzip.py``).

The SciCap release ships split archives (``name.z01..zNN`` + ``name.zip``).
The reference shells out to ``zip -FF`` (scicap.py:63-73), which is
interactive-prompt-prone and whose ``-s 0`` conversions produce archives
Python's ``zipfile`` rejects ("overlapped entries"). This module parses
the central directory directly -- including ZIP64, which the multi-GB
SciCap volumes need -- resolves each entry's (disk, offset) to an absolute
position in the concatenated volume stream, and rewrites a clean
single-volume archive that any reader accepts. Pure Python + zlib; no zip
CLI, no prompts.
"""
from __future__ import annotations

import os
import struct
import zlib
import zipfile
from typing import List, Sequence

_EOCD_SIG = b"PK\x05\x06"
_EOCD64_LOC_SIG = b"PK\x06\x07"
_EOCD64_SIG = b"PK\x06\x06"
_CDH_SIG = b"PK\x01\x02"
_LFH_SIG = b"PK\x03\x04"


class _Volumes:
    """Read view over the concatenation of the split volumes."""

    def __init__(self, parts: Sequence[str]):
        self.parts = list(parts)
        self.sizes = [os.path.getsize(p) for p in self.parts]
        self.starts = []
        acc = 0
        for s in self.sizes:
            self.starts.append(acc)
            acc += s
        self.total = acc

    def abs_offset(self, disk: int, offset: int) -> int:
        return self.starts[disk] + offset

    def read(self, offset: int, size: int) -> bytes:
        out = bytearray()
        i = 0
        while i < len(self.parts) and offset >= self.starts[i] + self.sizes[i]:
            i += 1
        while size > 0 and i < len(self.parts):
            local = offset - self.starts[i]
            take = min(size, self.sizes[i] - local)
            with open(self.parts[i], "rb") as f:
                f.seek(local)
                out += f.read(take)
            offset += take
            size -= take
            i += 1
        return bytes(out)


def order_parts(parts: Sequence[str]) -> List[str]:
    """Volume order: name.z01, name.z02, ..., name.zip (last)."""

    def key(p):
        ext = p.rsplit(".", 1)[-1].lower()
        if ext == "zip":
            return (1, 0)
        assert ext.startswith("z") and ext[1:].isdigit(), \
            f"not a split-zip volume: {p}"
        return (0, int(ext[1:]))

    return sorted(parts, key=key)


def _find_eocd(vol: _Volumes):
    """Locate + parse the end-of-central-directory (ZIP64-aware).

    Returns (n_entries, cd_disk, cd_offset_in_disk, cd_size)."""
    tail_size = min(vol.total, 66000 + 20 + 56)
    tail = vol.read(vol.total - tail_size, tail_size)
    idx = tail.rfind(_EOCD_SIG)
    if idx < 0:
        raise zipfile.BadZipFile("no end-of-central-directory record")
    eocd = tail[idx:idx + 22]
    (_, _, cd_disk, n_disk, n_total, cd_size,
     cd_offset, _) = struct.unpack("<IHHHHIIH", eocd)

    need64 = 0xFFFF in (cd_disk, n_disk, n_total) or \
        0xFFFFFFFF in (cd_size, cd_offset)
    loc_idx = tail.rfind(_EOCD64_LOC_SIG, 0, idx)
    if need64 and loc_idx < 0:
        raise zipfile.BadZipFile("zip64 archive without EOCD64 locator")
    if loc_idx >= 0:
        _, eocd64_disk, eocd64_off, _ = struct.unpack(
            "<IIQI", tail[loc_idx:loc_idx + 20])
        rec = vol.read(vol.abs_offset(eocd64_disk, eocd64_off), 56)
        if rec[:4] != _EOCD64_SIG:
            raise zipfile.BadZipFile("bad EOCD64 record")
        (_, _, _, _, _, cd_disk, _, n_total, cd_size,
         cd_offset) = struct.unpack("<IQHHIIQQQQ", rec[:56])
    return n_total, cd_disk, cd_offset, cd_size


def _zip64_field(extra: bytes, need: List[int]) -> List[int]:
    """Pull the requested 0xFFFFFFFF-placeholder values from the zip64
    extra field (values appear in header order for each maxed field)."""
    pos = 0
    while pos + 4 <= len(extra):
        tag, size = struct.unpack("<HH", extra[pos:pos + 4])
        if tag == 0x0001:
            vals = []
            body = extra[pos + 4:pos + 4 + size]
            for i in range(0, len(body) - 7, 8):
                vals.append(struct.unpack("<Q", body[i:i + 8])[0])
            out = []
            vi = 0
            for v in need:
                if v in (0xFFFFFFFF, 0xFFFF) and vi < len(vals):
                    out.append(vals[vi])
                    vi += 1
                else:
                    out.append(v)
            return out
        pos += 4 + size
    return need


def join_split_zip(parts: Sequence[str], output: str) -> str:
    """Rewrite split volumes as one clean archive. Returns ``output``."""
    vol = _Volumes(order_parts(parts))
    n_entries, cd_disk, cd_off, cd_size = _find_eocd(vol)
    cd = vol.read(vol.abs_offset(cd_disk, cd_off), cd_size)

    with zipfile.ZipFile(output, "w", zipfile.ZIP_DEFLATED,
                         allowZip64=True) as out:
        pos = 0
        for _ in range(n_entries):
            if cd[pos:pos + 4] != _CDH_SIG:
                raise zipfile.BadZipFile("bad central directory entry")
            (_, _, _, flags, method, dtime, ddate, crc, csize, usize,
             name_len, extra_len, comment_len, disk_start, _, _,
             lfh_off) = struct.unpack("<IHHHHHHIIIHHHHHII",
                                      cd[pos:pos + 46])
            name = cd[pos + 46:pos + 46 + name_len]
            extra = cd[pos + 46 + name_len:
                       pos + 46 + name_len + extra_len]
            pos += 46 + name_len + extra_len + comment_len
            usize, csize, lfh_off, disk_start = _zip64_field(
                extra, [usize, csize, lfh_off, disk_start])

            abs_lfh = vol.abs_offset(disk_start, lfh_off)
            lfh = vol.read(abs_lfh, 30)
            if lfh[:4] != _LFH_SIG:
                raise zipfile.BadZipFile(
                    f"bad local header for {name!r}")
            lfh_name_len, lfh_extra_len = struct.unpack("<HH", lfh[26:30])
            data_off = abs_lfh + 30 + lfh_name_len + lfh_extra_len
            payload = vol.read(data_off, csize)
            if method == zipfile.ZIP_STORED:
                raw = payload
            elif method == zipfile.ZIP_DEFLATED:
                raw = zlib.decompress(payload, -15)
            else:
                raise zipfile.BadZipFile(
                    f"unsupported compression method {method}")
            if len(raw) != usize or (zlib.crc32(raw) & 0xFFFFFFFF) != crc:
                raise zipfile.BadZipFile(f"corrupt entry {name!r}")
            info = zipfile.ZipInfo(name.decode("utf-8", "replace"))
            info.compress_type = zipfile.ZIP_DEFLATED
            out.writestr(info, raw)
    return output
