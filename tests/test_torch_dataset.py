"""The port's dataset loaders (``detikzify_torch/dataset``) against the JAX
package's, on the CPU: both read the same synthetic archives and must give
the same rows, text and pixels. Mirrors ``tests/test_misc.py``'s
``test_paper2fig_iter`` and ``test_scicap_loader_end_to_end`` (the
multi-part case skips where the JAX one does, without the ``zip`` tool),
plus a ``splitzip.join_split_zip`` round trip. No test fetches anything.
"""
import io
import json
import shutil
import subprocess
import tarfile
import zipfile

import numpy as np
import pytest
from PIL import Image

from detikzify_tpu.dataset import paper2fig as j_paper2fig
from detikzify_tpu.dataset import scicap as j_scicap
from detikzify_tpu.dataset import splitzip as j_splitzip
from detikzify_torch.dataset import load_dataset, load_paper2fig, load_scicap
from detikzify_torch.dataset import paper2fig, scicap, splitzip


def _same_rows(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k == "image":
                assert g[k].size == w[k].size and g[k].mode == w[k].mode
                assert np.array_equal(np.asarray(g[k]), np.asarray(w[k]))
            else:
                assert g[k] == w[k], k


def _paper2fig_archive(path):
    rng = np.random.default_rng(3)
    meta = []
    with tarfile.open(path, "w") as tf:
        for i in range(3):
            meta.append({"figure_id": f"fig{i}",
                         "captions": [f"caption {i}", f"mention {i}"],
                         "ocr_result": {"ocr_result": [
                             {"text": f"label {i}"}, {"text": "axis"}]}})
            img = Image.fromarray(rng.integers(
                0, 256, (30 + 7 * i, 50, 3), np.uint8), "RGB")
            buf = io.BytesIO()
            img.save(buf, format="PNG")
            png = buf.getvalue()
            info = tarfile.TarInfo(f"figures/fig{i}.png")
            info.size = len(png)
            tf.addfile(info, io.BytesIO(png))
        # a figure without metadata is skipped
        info = tarfile.TarInfo("figures/orphan.png")
        info.size = len(png)
        tf.addfile(info, io.BytesIO(png))
        data = json.dumps(meta).encode()
        info = tarfile.TarInfo("meta.json")
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))


def test_paper2fig_iter(tmp_path):
    """Both builders read one synthetic Paper2Fig-style tar archive into
    the same rows: captions, mentions, OCR, padded square images."""
    archive = tmp_path / "p2f.tar"
    _paper2fig_archive(archive)
    got = list(paper2fig.iter_paper2fig(str(archive), size=64))
    want = list(j_paper2fig.iter_paper2fig(str(archive), size=64))
    _same_rows(got, want)
    assert [r["caption"] for r in got] == ["caption 0", "caption 1",
                                           "caption 2"]
    assert got[1]["ocr"] == ["label 1", "axis"]
    assert all(r["image"].size == (64, 64) for r in got)
    # the streaming builder, through the name shim
    _same_rows(list(load_dataset("paper2fig", str(archive), size=64,
                                 streaming=True)), want)
    _same_rows(list(load_paper2fig(str(archive), size=64, streaming=True)),
               want)


def _scicap_inputs(tmp_path):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    images, annots = [], []
    rng = np.random.default_rng(0)
    for i in range(3):
        # noise images: incompressible, so the zip exceeds the 64 KB
        # minimum volume size and actually splits
        im = Image.fromarray(
            rng.integers(0, 256, (200, 220 + 10 * i, 3), np.uint8), "RGB")
        im.save(img_dir / f"fig{i}.png")
        images.append({"id": i, "file_name": f"fig{i}.png",
                       "ocr": [f"ocr{i}"]})
        annots.append({"image_id": i, "caption_no_index": f"caption {i}",
                       "mention": [[f"Fig. {i}"]],
                       "paragraph": [f"para {i}"]})
    text_json = tmp_path / "ann.json"
    text_json.write_text(json.dumps(
        {"images": images, "annotations": annots}))
    whole = tmp_path / "imgs.zip"
    with zipfile.ZipFile(whole, "w") as zf:
        for i in range(3):
            zf.write(img_dir / f"fig{i}.png", f"share/fig{i}.png")
    return img_dir, text_json, whole


def test_scicap_loader_end_to_end(tmp_path):
    """SciCap: COCO-style json + (multi-part) image zip -> item stream,
    both packages on the same synthetic archives in the release's format
    (split zip volumes rejoined)."""
    img_dir, text_json, whole = _scicap_inputs(tmp_path)
    got = list(scicap.iter_scicap(str(text_json), str(whole), size=64))
    want = list(j_scicap.iter_scicap(str(text_json), str(whole), size=64))
    _same_rows(got, want)
    assert got[1]["caption"] == "caption 1" and got[1]["ocr"] == ["ocr1"]
    assert got[2]["image"].size == (64, 64)
    _same_rows(list(load_scicap(str(text_json), str(whole), size=64,
                                streaming=True)), want)
    with pytest.raises(ValueError, match="local text_json"):
        load_scicap(None, None)

    if shutil.which("zip") is None:
        pytest.skip("zip tool unavailable for the multi-part path")
    # a GENUINE multi-volume archive (zip -s), like the SciCap release
    split_dir = tmp_path / "split"
    split_dir.mkdir()
    subprocess.run(["zip", "-s", "64k", "-j", "-q",
                    str(split_dir / "imgs-split.zip")]
                   + [str(img_dir / f"fig{i}.png") for i in range(3)],
                   check=True)
    parts = sorted(str(p) for p in split_dir.iterdir())
    assert len(parts) >= 2, parts      # .z01(+) and .zip
    joined = str(tmp_path / "joined.zip")
    j_joined = str(tmp_path / "joined_jax.zip")
    scicap.rejoin_multipart_zip(parts, joined)
    j_scicap.rejoin_multipart_zip(parts, j_joined)
    _same_rows(list(scicap.iter_scicap(str(text_json), joined, size=64)),
               list(j_scicap.iter_scicap(str(text_json), j_joined,
                                         size=64)))
    _same_rows(list(load_scicap(str(text_json),
                                image_zip_parts=parts, size=64,
                                streaming=True)), want)


def _stored_split(tmp_path, payloads, volume: int):
    """A split archive written by hand: one stored (uncompressed) zip cut
    into volumes of ``volume`` bytes (``.z01``, ``.z02``, ..., ``.zip``
    last), the central directory's offsets rewritten to (disk, offset in
    disk) as a split writer does."""
    import struct

    whole = tmp_path / "whole.zip"
    with zipfile.ZipFile(whole, "w", zipfile.ZIP_STORED) as zf:
        for name, data in payloads.items():
            zf.writestr(name, data)
    raw = bytearray(whole.read_bytes())
    eocd = raw.rfind(b"PK\x05\x06")
    (_, _, _, _, n, cd_size, cd_off, _) = struct.unpack(
        "<IHHHHIIH", raw[eocd:eocd + 22])

    def split_at(off):
        return off // volume, off % volume

    pos = cd_off
    for _ in range(n):
        name_len, extra_len, comment_len = struct.unpack(
            "<HHH", raw[pos + 28:pos + 34])
        lfh = struct.unpack("<I", raw[pos + 42:pos + 46])[0]
        disk, off = split_at(lfh)
        raw[pos + 34:pos + 36] = struct.pack("<H", disk)
        raw[pos + 42:pos + 46] = struct.pack("<I", off)
        pos += 46 + name_len + extra_len + comment_len
    disk, off = split_at(cd_off)
    last = (len(raw) - 1) // volume
    raw[eocd + 4:eocd + 20] = struct.pack("<HHHHII", last, disk, n, n,
                                          cd_size, off)
    parts = []
    for i in range(last + 1):
        name = f"data.z{i + 1:02d}" if i < last else "data.zip"
        (tmp_path / name).write_bytes(bytes(raw[i * volume:
                                                (i + 1) * volume]))
        parts.append(str(tmp_path / name))
    return parts


def test_join_split_zip_round_trip(tmp_path):
    """``splitzip.join_split_zip`` rewrites split volumes (given in any
    order) as one archive holding every entry bit for bit, as the JAX
    joiner does; a volume that is not part of a split archive is
    refused."""
    rng = np.random.default_rng(1)
    payloads = {f"dir/file{i}.bin": rng.integers(
        0, 256, 3000 + 1000 * i, np.uint8).tobytes() for i in range(4)}
    payloads["empty.txt"] = b""
    parts = _stored_split(tmp_path, payloads, volume=4096)
    assert len(parts) >= 3
    assert splitzip.order_parts(parts[::-1]) == parts
    out = splitzip.join_split_zip(parts[::-1], str(tmp_path / "joined.zip"))
    j_out = j_splitzip.join_split_zip(parts, str(tmp_path / "jax.zip"))
    for path in (out, j_out):
        with zipfile.ZipFile(path) as zf:
            assert zf.testzip() is None
            assert {n: zf.read(n) for n in zf.namelist()} == payloads
    with pytest.raises(AssertionError, match="not a split-zip volume"):
        splitzip.order_parts([str(tmp_path / "whole.zip"),
                              str(tmp_path / "other.bin")])
