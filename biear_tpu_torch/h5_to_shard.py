#!/usr/bin/env python
"""Convert an H5 split of the reference's schemas into a ``.shard`` file.

    python -m biear_tpu_torch.h5_to_shard SPLIT.h5 SPLIT.shard [--no-wav-i16]

Counterpart of ``tools/h5_to_shard.py``: the active schema's waveform
fields (x1, x2) are stored as int16 (round(x * 32767), half the bytes;
``data/shard.py`` decodes them with the scale 1 / 32767) unless
--no-wav-i16 is given, every other field as float32. Host only; it needs
``h5py``, which the card's machine lacks: there ``precompute_h5`` writes
``.shard`` splits directly.
"""

from __future__ import annotations

import argparse
import os

from .data.h5io import load_arrays_from_h5
from .data.shard import write_shard


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("h5_path")
    ap.add_argument("shard_path")
    ap.add_argument("--wav-i16", action="store_true", default=True,
                    help="store waveform fields as int16 (default)")
    ap.add_argument("--no-wav-i16", dest="wav_i16", action="store_false")
    args = ap.parse_args(argv)

    arrays = load_arrays_from_h5(args.h5_path)
    dtypes = ["f32"] * len(arrays)
    if len(arrays) == 4 and args.wav_i16:
        dtypes[0] = dtypes[1] = "i16"
    write_shard(args.shard_path, list(arrays), dtypes)
    sizes = {os.path.basename(p): os.path.getsize(p)
             for p in (args.h5_path, args.shard_path)}
    print(f"wrote {args.shard_path} fields={len(arrays)} "
          f"dtypes={dtypes} sizes={sizes}")


if __name__ == "__main__":
    main()
