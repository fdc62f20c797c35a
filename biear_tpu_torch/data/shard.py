"""Reader and writer of the ``.shard`` binary dataset format, in numpy.

A copy of the format of ``biear_tpu/data/native_loader.py`` (its C++
gather core is not used): little-endian

    magic u64 = 0x42494541525F4250, version u32 = 1, n_fields u32,
    n_rows u64,
    per field: dtype u32 (0 = f32, 1 = i16), row_elems u64,
    then per field, contiguously: n_rows * row_elems values.

i16 fields store round(x * 32767) clipped to int16 and decode with scale
1 / 32767. The reader maps the file and decodes only the rows asked for.

The card's machine has no ``h5py``, so there the splits are ``.shard``
files: ``python -m biear_tpu_torch.precompute_h5`` writes them directly
(an output path ending in ``.shard``), and ``python -m
biear_tpu_torch.h5_to_shard`` converts H5 splits where ``h5py`` is
installed (``data/h5io.py`` reads H5 there).
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 0x42494541525F4250
_HEAD = struct.Struct("<QII Q")
_FIELD = struct.Struct("<IQ")
_DTYPES = {0: np.dtype("<f4"), 1: np.dtype("<i2")}


def shard_shapes(cfg, passive: bool) -> list:
    """Per-row field shapes of a model config's ``.shard`` split: 4 active
    fields (wavL, wavR, x3, y) or 6 passive ones (x1..x5, y)."""
    if not passive:
        return [(cfg.fs,), (cfg.fs,), (cfg.n_bands,), (56,)]
    tb = (cfg.timesteps, cfg.n_bands)
    return [tb, tb, (cfg.n_bands,), tb, tb, (56,)]


def write_shard(path: str, arrays, dtypes=None) -> None:
    """arrays: (N, ...) numpy arrays with one N; dtypes[i] in {"f32",
    "i16"} (default all "f32")."""
    n = len(arrays[0])
    dtypes = dtypes or ["f32"] * len(arrays)
    if len(dtypes) != len(arrays):
        raise ValueError("one dtype per array")
    with open(path, "wb") as f:
        f.write(_HEAD.pack(MAGIC, 1, len(arrays), n))
        for a, d in zip(arrays, dtypes):
            if len(a) != n:
                raise ValueError("every array needs the same number of rows")
            if d not in ("f32", "i16"):
                raise ValueError(f"dtype must be 'f32' or 'i16', got {d!r}")
            elems = int(np.prod(a.shape[1:], dtype=np.int64))
            f.write(_FIELD.pack(1 if d == "i16" else 0, elems))
        for a, d in zip(arrays, dtypes):
            flat = np.ascontiguousarray(a).reshape(n, -1)
            if d == "i16":
                flat = np.clip(np.round(flat * 32767.0), -32768,
                               32767).astype("<i2")
            else:
                flat = flat.astype("<f4")
            f.write(flat.tobytes())


class ShardDataset:
    """A ``.shard`` file as a dataset: ``len()`` rows and ``rows(idx)`` ->
    one float32 array per field, (len(idx), *shape).

    shapes: optional per-field row shapes, checked against the file's
    element counts (default: flat rows). Rows outside [0, N) read as
    zeros, as the native gather returns them."""

    def __init__(self, path: str, shapes=None):
        with open(path, "rb") as f:
            head = f.read(_HEAD.size)
            if len(head) < _HEAD.size:
                raise ValueError(f"{path}: not a shard (too short)")
            magic, version, n_fields, n_rows = _HEAD.unpack(head)
            if magic != MAGIC or version != 1:
                raise ValueError(f"{path}: not a version-1 shard")
            desc = [_FIELD.unpack(f.read(_FIELD.size))
                    for _ in range(n_fields)]
        offset = _HEAD.size + n_fields * _FIELD.size
        self.length = int(n_rows)
        self._fields = []
        for dtype, elems in desc:
            if dtype not in _DTYPES:
                raise ValueError(f"{path}: unknown field dtype {dtype}")
            dt = _DTYPES[dtype]
            data = np.memmap(path, dtype=dt, mode="r", offset=offset,
                             shape=(self.length, int(elems)))
            self._fields.append((data, 1.0 / 32767.0 if dtype == 1 else 1.0))
            offset += self.length * int(elems) * dt.itemsize
        if shapes is not None:
            if len(shapes) != n_fields:
                raise ValueError(
                    f"{path}: shard has {n_fields} fields but {len(shapes)} "
                    "shapes were given (active is 4 fields, passive 6)")
            for i, shp in enumerate(shapes):
                want = int(np.prod(shp, dtype=np.int64))
                have = self._fields[i][0].shape[1]
                if want != have:
                    raise ValueError(
                        f"{path}: field {i} holds {have} elems per row, but "
                        f"shape {tuple(shp)} needs {want}: the shard's "
                        "geometry does not match the config")
        self.shapes = shapes
        self.n_fields = n_fields

    def __len__(self) -> int:
        return self.length

    def rows(self, idx) -> tuple:
        idx = np.asarray(idx, np.int64)
        ok = (idx >= 0) & (idx < self.length)
        out = []
        for i, (data, scale) in enumerate(self._fields):
            buf = np.zeros((len(idx), data.shape[1]), np.float32)
            buf[ok] = data[idx[ok]]
            if scale != 1.0:
                buf *= np.float32(scale)
            if self.shapes is not None:
                buf = buf.reshape((len(idx),) + tuple(self.shapes[i]))
            out.append(buf)
        return tuple(out)
