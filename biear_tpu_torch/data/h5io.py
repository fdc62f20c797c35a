"""Writers and readers of the reference's H5 schemas, a copy of
``biear_tpu/data/h5io.py``: active (x1, x2 waveforms, x3 CC, y labels) and
passive (x1, x2 magnitude planes, x3 CC, x4, x5 phase planes, y), every
dataset float32, chunked in blocks of 256 rows.

``h5py`` is imported at first use. Where it is missing (the card's machine
has none) the functions raise an ImportError that points to the
``.shard`` format: write the split with ``python -m
biear_tpu_torch.precompute_h5 ... --out-active x.shard`` (or convert an H5
split with ``python -m biear_tpu_torch.h5_to_shard``) and set
``DATA_FORMAT: shard``.
"""

from __future__ import annotations

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "h5py is not installed, so H5 splits cannot be read or written "
            "here: write .shard splits with 'python -m "
            "biear_tpu_torch.precompute_h5 --out-active x.shard' (or convert "
            "H5 splits where h5py is installed with 'python -m "
            "biear_tpu_torch.h5_to_shard') and set 'DATA_FORMAT: shard' in "
            "the run config") from e
    return h5py


def _save_h5(path, named, compress: bool, chunk_rows: int):
    h5py = _h5py()
    kw = dict(compression="gzip", compression_opts=4) if compress else {}
    with h5py.File(path, "w") as f:
        for name, arr in named:
            arr = np.asarray(arr, np.float32)
            chunks = (min(chunk_rows, len(arr)),) + arr.shape[1:]
            f.create_dataset(name, data=arr, chunks=chunks, **kw)


def save_active_h5(path, x1, x2, x3, y, compress: bool = False,
                   chunk_rows: int = 256):
    """Write the active 4-field schema."""
    _save_h5(path, (("x1", x1), ("x2", x2), ("x3", x3), ("y", y)),
             compress, chunk_rows)


def save_passive_h5(path, x1, x2, x3, x4, x5, y, compress: bool = False,
                    chunk_rows: int = 256):
    """Write the passive 6-field schema."""
    _save_h5(path, (("x1", x1), ("x2", x2), ("x3", x3), ("x4", x4),
                    ("x5", x5), ("y", y)), compress, chunk_rows)


def load_arrays_from_h5(path) -> tuple:
    """The whole file -> its arrays in schema order (x1, x2, x3[, x4, x5],
    y)."""
    with _h5py().File(path, "r") as f:
        keys = [k for k in ("x1", "x2", "x3", "x4", "x5", "y") if k in f]
        return tuple(f[k][:] for k in keys)


class _H5Dataset:
    """A reader of the fields KEYS. preload=True (default) reads the whole
    split into RAM once; preload=False keeps the file open and reads the
    rows asked for."""

    KEYS: tuple = ()

    def __init__(self, path: str, preload: bool = True):
        h5py = _h5py()
        self.path = path
        self.preload = preload
        with h5py.File(path, "r") as f:
            for k in self.KEYS:
                if k not in f:
                    raise KeyError(f"{path} missing dataset '{k}' "
                                   f"(expected schema {self.KEYS})")
            self.length = f[self.KEYS[0]].shape[0]
            self.shapes = {k: f[k].shape[1:] for k in self.KEYS}
            if preload:
                self._data = {k: f[k][:].astype(np.float32)
                              for k in self.KEYS}
        self._file = None

    def __len__(self) -> int:
        return self.length

    def rows(self, idx) -> tuple:
        idx = np.asarray(idx)
        if self.preload:
            return tuple(self._data[k][idx] for k in self.KEYS)
        if self._file is None:
            self._file = _h5py().File(self.path, "r", libver="latest",
                                      swmr=True)
        # h5py selections need sorted unique indices: read those, expand
        uniq, inverse = np.unique(idx, return_inverse=True)
        return tuple(self._file[k][uniq][inverse].astype(np.float32)
                     for k in self.KEYS)

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


class ActiveH5Dataset(_H5Dataset):
    """The (wavL, wavR, x3, y) reader."""
    KEYS = ("x1", "x2", "x3", "y")


class PassiveH5Dataset(_H5Dataset):
    """The (x1, x2, x3, x4, x5, y) reader."""
    KEYS = ("x1", "x2", "x3", "x4", "x5", "y")
