"""Dataset creation — readers and converters.

Reference analogue: `python/ray/data/read_api.py` (``range`` :118,
``from_items`` :93, ``read_parquet`` :542, ``read_csv``, ``read_json``,
``read_text``, ``read_binary_files``, ``from_numpy``, ``from_pandas``,
``from_arrow``).

Readers produce **read tasks** — closures that load one block inside a
ray_tpu_torch worker — so file bytes never pass through the driver and the read
fuses with downstream ``map_batches`` into a single task per block.
"""

from __future__ import annotations

import builtins
import os
from typing import Any, List, Optional, Union

import numpy as np

from ray_tpu_torch.data.block import VALUE_COL, BlockAccessor
from ray_tpu_torch.data.dataset import Dataset

DEFAULT_PARALLELISM = 16

# ``range`` below shadows the builtin inside this module.
builtins_range = builtins.range


def _put_blocks(blocks) -> Dataset:
    import ray_tpu_torch

    refs, metas = [], []
    for b in blocks:
        refs.append(ray_tpu_torch.put(b))
        metas.append(BlockAccessor.for_block(b).metadata())
    return Dataset.from_block_refs(refs, metas)


def range(n: int, *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    """Tabular dataset with one ``id`` column of [0, n)."""
    parallelism = max(1, min(parallelism, n or 1))
    per = n // parallelism
    rem = n % parallelism
    fns = []
    start = 0
    for i in builtins_range(parallelism):
        size = per + (1 if i < rem else 0)
        lo, hi = start, start + size
        fns.append(lambda lo=lo, hi=hi: {"id": np.arange(lo, hi)})
        start = hi
    return Dataset.from_read_fns(fns)


def from_items(items: List[Any], *,
               parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    parallelism = max(1, min(parallelism, len(items) or 1))
    per = len(items) // parallelism
    rem = len(items) % parallelism
    blocks = []
    start = 0
    for i in builtins_range(parallelism):
        size = per + (1 if i < rem else 0)
        blocks.append(BlockAccessor.rows_to_block(items[start:start + size]))
        start += size
    return _put_blocks(blocks)


def from_numpy(arr: np.ndarray, *,
               parallelism: int = DEFAULT_PARALLELISM,
               column: str = VALUE_COL) -> Dataset:
    parallelism = max(1, min(parallelism, len(arr) or 1))
    return _put_blocks([{column: part}
                        for part in np.array_split(arr, parallelism)
                        if len(part)])


def from_pandas(df, *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    block = {c: df[c].to_numpy() for c in df.columns}
    n = BlockAccessor.for_block(block).num_rows()
    parallelism = max(1, min(parallelism, n or 1))
    acc = BlockAccessor.for_block(block)
    per = n // parallelism
    rem = n % parallelism
    blocks, start = [], 0
    for i in builtins_range(parallelism):
        size = per + (1 if i < rem else 0)
        if size:
            blocks.append(acc.slice(start, start + size))
        start += size
    return _put_blocks(blocks)


def from_arrow(table, *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    block = {c: table[c].to_numpy(zero_copy_only=False)
             for c in table.column_names}
    import pandas as pd  # reuse the pandas splitter via a cheap frame

    return from_pandas(pd.DataFrame(block), parallelism=parallelism)


# --------------------------------------------------------------------------
# File readers


def _expand_paths(paths: Union[str, List[str]], suffix=None) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for name in sorted(os.listdir(p)):
                if suffix is None or name.endswith(suffix):
                    out.append(os.path.join(p, name))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no input files under {paths}")
    return out


def read_parquet(paths: Union[str, List[str]], *,
                 columns: Optional[List[str]] = None,
                 parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    """One read task per row-group cluster (reference: `read_api.py:542`)."""
    files = _expand_paths(paths, ".parquet")

    def make(fname):
        def read():
            import pyarrow.parquet as pq

            tbl = pq.read_table(fname, columns=columns)
            return {c: tbl[c].to_numpy(zero_copy_only=False)
                    for c in tbl.column_names}
        return read

    return Dataset.from_read_fns([make(f) for f in files])


def read_csv(paths: Union[str, List[str]], *,
             parallelism: int = DEFAULT_PARALLELISM, **pandas_kwargs) -> Dataset:
    files = _expand_paths(paths, ".csv")

    def make(fname):
        def read():
            import pandas as pd

            df = pd.read_csv(fname, **pandas_kwargs)
            return {c: df[c].to_numpy() for c in df.columns}
        return read

    return Dataset.from_read_fns([make(f) for f in files])


def read_json(paths: Union[str, List[str]], *,
              parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    files = _expand_paths(paths, None)

    def make(fname):
        def read():
            import json

            rows = []
            with open(fname) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        rows.append(json.loads(line))
            return BlockAccessor.rows_to_block(rows)
        return read

    return Dataset.from_read_fns([make(f) for f in files])


def read_text(paths: Union[str, List[str]], *,
              parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    files = _expand_paths(paths, None)

    def make(fname):
        def read():
            with open(fname) as f:
                lines = [ln.rstrip("\n") for ln in f]
            return {"text": np.asarray(lines, dtype=object)}
        return read

    return Dataset.from_read_fns([make(f) for f in files])


def read_binary_files(paths: Union[str, List[str]], *,
                      include_paths: bool = False,
                      parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    files = _expand_paths(paths, None)

    def make(fname):
        def read():
            with open(fname, "rb") as f:
                data = f.read()
            block = {"bytes": np.asarray([data], dtype=object)}
            if include_paths:
                block["path"] = np.asarray([fname], dtype=object)
            return block
        return read

    return Dataset.from_read_fns([make(f) for f in files])


_IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")


def read_images(paths: Union[str, List[str]], *,
                size: Optional[tuple] = None,
                mode: Optional[str] = None,
                include_paths: bool = False,
                parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    """Image-folder reader (reference: `python/ray/data/read_api.py:679`
    ``read_images``): one read task per file batch decodes via PIL into an
    ``image`` column of (H, W, C) uint8 arrays.

    ``size=(h, w)`` resizes at decode (so a folder of mixed sizes yields a
    stackable column); ``mode`` forces a PIL mode ("RGB", "L", ...)."""
    files = [f for f in _expand_paths(paths, None)
             if f.lower().endswith(_IMAGE_SUFFIXES)]
    if not files:
        raise FileNotFoundError(f"no image files under {paths}")
    parallelism = max(1, min(parallelism, len(files)))
    chunks = np.array_split(np.asarray(files, dtype=object), parallelism)

    def make(chunk):
        def read():
            from PIL import Image

            imgs, names = [], []
            for fname in chunk:
                with Image.open(fname) as im:
                    if mode is not None:
                        im = im.convert(mode)
                    elif im.mode not in ("RGB", "L"):
                        im = im.convert("RGB")
                    if size is not None:
                        im = im.resize((size[1], size[0]))
                    imgs.append(np.asarray(im))
                names.append(fname)
            same_shape = len({a.shape for a in imgs}) == 1
            if same_shape:
                col = np.stack(imgs)
            else:
                # np.asarray(.., object) broadcasts partially-matching
                # shapes (8x8x3 vs 8x9x3) into a ValueError — fill an
                # object array explicitly
                col = np.empty(len(imgs), dtype=object)
                col[:] = imgs
            block = {"image": col}
            if include_paths:
                block["path"] = np.asarray(names, dtype=object)
            return block
        return read

    return Dataset.from_read_fns([make(c) for c in chunks if len(c)])


# --------------------------------------------------------------------------
# TFRecords — dependency-free wire codec (framing + tf.train.Example proto)

_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    """CRC32-Castagnoli (the TFRecord checksum; zlib.crc32 uses the wrong
    polynomial).  Accelerated library when present; pure-python table
    loop as the dependency-free fallback (fine for test-scale files,
    ~10 MB/s for big ones)."""
    try:
        import crc32c as _c

        return _c.crc32c(data)
    except ImportError:
        pass
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in builtins_range(256):
            c = i
            for _ in builtins_range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _read_varint(buf: bytes, off: int):
    n = shift = 0
    while True:
        b = buf[off]
        off += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, off
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _ld(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _encode_feature(values) -> bytes:
    """tf.train.Feature: bytes_list=1 | float_list=2 | int64_list=3."""
    import struct as _struct

    if len(values) == 0:
        return _ld(1, b"")  # empty BytesList (decoder yields [])
    v0 = values[0]
    if isinstance(v0, (bytes, str)):
        payload = b"".join(
            _ld(1, v if isinstance(v, bytes) else v.encode()) for v in values)
        return _ld(1, payload)
    if isinstance(v0, (float, np.floating)):
        packed = _struct.pack(f"<{len(values)}f", *values)
        return _ld(2, _ld(1, packed))
    payload = b"".join(_varint(int(v) & (2 ** 64 - 1)) for v in values)
    return _ld(3, _ld(1, payload))


def _encode_example(row: dict) -> bytes:
    entries = []
    for k, v in row.items():
        if isinstance(v, np.ndarray):
            v = v.tolist()
        if not isinstance(v, (list, tuple)):
            v = [v]
        feature = _encode_feature(v)
        entries.append(_ld(1, _ld(1, k.encode()) + _ld(2, feature)))
    return _ld(1, b"".join(entries))  # Example.features


def _decode_fields(buf: bytes):
    """Yield (field_no, wire_type, value) over one message's bytes."""
    off = 0
    while off < len(buf):
        tag, off = _read_varint(buf, off)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, off = _read_varint(buf, off)
        elif wire == 2:
            ln, off = _read_varint(buf, off)
            val = buf[off:off + ln]
            off += ln
        elif wire == 5:
            val = buf[off:off + 4]
            off += 4
        elif wire == 1:
            val = buf[off:off + 8]
            off += 8
        else:
            raise ValueError(f"unsupported proto wire type {wire}")
        yield field, wire, val


def _decode_feature(buf: bytes):
    import struct as _struct

    for field, wire, val in _decode_fields(buf):
        if field == 1:  # BytesList
            return [v for f, _, v in _decode_fields(val) if f == 1]
        if field == 2:  # FloatList (packed or repeated)
            out = []
            for f, w, v in _decode_fields(val):
                if f != 1:
                    continue
                if w == 2:
                    out.extend(_struct.unpack(f"<{len(v) // 4}f", v))
                else:
                    out.append(_struct.unpack("<f", v)[0])
            return out
        if field == 3:  # Int64List (packed varints or repeated)
            out = []
            for f, w, v in _decode_fields(val):
                if f != 1:
                    continue
                if w == 2:
                    off = 0
                    while off < len(v):
                        n, off = _read_varint(v, off)
                        out.append(n - 2 ** 64 if n >= 2 ** 63 else n)
                else:
                    out.append(v - 2 ** 64 if v >= 2 ** 63 else v)
            return out
    return []


def _decode_example(buf: bytes) -> dict:
    row = {}
    for field, _, features in _decode_fields(buf):
        if field != 1:
            continue
        for f2, _, entry in _decode_fields(features):
            if f2 != 1:
                continue
            name, feat = None, None
            for f3, _, v in _decode_fields(entry):
                if f3 == 1:
                    name = v.decode()
                elif f3 == 2:
                    feat = v
            if name is not None and feat is not None:
                row[name] = _decode_feature(feat)
    return row


def _iter_tfrecord_frames(data: bytes):
    import struct as _struct

    off = 0
    while off < len(data):
        (length,) = _struct.unpack_from("<Q", data, off)
        off += 12  # u64 length + u32 length-crc
        yield data[off:off + length]
        off += length + 4  # payload + u32 data-crc


def read_tfrecords(paths: Union[str, List[str]], *,
                   parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    """TFRecord reader (reference: `python/ray/data/read_api.py`
    ``read_tfrecords``): parses the record framing and `tf.train.Example`
    protos with a built-in codec — no tensorflow dependency.  Scalar
    features become scalar columns; multi-value features become object
    columns of lists.  Directories are filtered to *.tfrecords? / *.tfrecord
    files so stray markers (_SUCCESS, READMEs) don't parse as framing."""
    if isinstance(paths, str) and os.path.isdir(paths):
        files = [f for f in _expand_paths(paths, None)
                 if f.endswith((".tfrecords", ".tfrecord"))]
        if not files:
            raise FileNotFoundError(f"no .tfrecord(s) files under {paths}")
    else:
        files = _expand_paths(paths, None)

    def make(fname):
        def read():
            with open(fname, "rb") as f:
                data = f.read()
            rows = [_decode_example(frame)
                    for frame in _iter_tfrecord_frames(data)]
            if not rows:
                return {}
            cols: dict = {}
            for key in rows[0]:
                vals = [r.get(key, []) for r in rows]
                if all(len(v) == 1 for v in vals):
                    flat = [v[0] for v in vals]
                    if isinstance(flat[0], bytes):
                        cols[key] = np.asarray(flat, dtype=object)
                    else:
                        cols[key] = np.asarray(flat)
                else:
                    cols[key] = np.asarray(vals, dtype=object)
            return cols
        return read

    return Dataset.from_read_fns([make(f) for f in files])
