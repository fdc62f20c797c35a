"""NIST SPHERE audio reader (TIMIT's .WAV files), numpy only.

A copy of ``tools/sphere.py``. SPHERE is an ASCII header ("NIST_1A", a
declared header size, "name type value" lines up to "end_head") followed
by raw samples. Supported: 16-bit PCM in either byte order and 8-bit
mu-law; embedded-shorten compression raises (decompress with
``sph2pipe`` first).
"""

from __future__ import annotations

import numpy as np

_MAGIC = b"NIST_1A"


def _parse_header(fh):
    magic = fh.read(8)
    if not magic.startswith(_MAGIC):
        raise ValueError("not a NIST SPHERE file (bad magic)")
    try:
        header_size = int(fh.read(8).split()[0])
    except (ValueError, IndexError):
        raise ValueError("not a NIST SPHERE file (bad header size)")
    rest = fh.read(header_size - 16).decode("ascii", errors="replace")
    fields = {}
    for line in rest.splitlines():
        line = line.strip()
        if line == "end_head":
            break
        parts = line.split(None, 2)
        if len(parts) != 3:
            continue
        name, typ, value = parts
        if typ == "-i":
            fields[name] = int(value)
        elif typ == "-r":
            fields[name] = float(value)
        elif typ.startswith("-s"):
            fields[name] = value
    return fields, header_size


_ULAW_BIAS = 0x84


def _ulaw_decode(u8):
    """G.711 mu-law byte -> int16 (vectorised)."""
    u = ~u8.astype(np.int32) & 0xFF
    sign = u & 0x80
    exponent = (u >> 4) & 0x07
    mantissa = u & 0x0F
    sample = ((mantissa << 3) + _ULAW_BIAS) << exponent
    sample -= _ULAW_BIAS
    return np.where(sign, -sample, sample).astype(np.int16)


def read_sphere(path: str):
    """A NIST SPHERE file -> (sample_rate, samples): int16, (N,) mono or
    (N, C) multichannel."""
    with open(path, "rb") as fh:
        fields, header_size = _parse_header(fh)
        coding = str(fields.get("sample_coding", "pcm")).lower()
        if "shorten" in coding:
            raise ValueError(
                f"{path}: embedded-shorten SPHERE is compressed; run "
                "sph2pipe first")
        fs = int(fields.get("sample_rate", 16000))
        channels = int(fields.get("channel_count", 1))
        n_bytes = int(fields.get("sample_n_bytes", 2))
        count = fields.get("sample_count")
        fh.seek(header_size)
        raw = fh.read()

    if "ulaw" in coding or "mu-law" in coding or n_bytes == 1:
        data = _ulaw_decode(np.frombuffer(raw, np.uint8))
    elif n_bytes == 2:
        byte_format = str(fields.get("sample_byte_format", "01"))
        dtype = ">i2" if byte_format == "10" else "<i2"
        data = np.frombuffer(raw, dtype).astype(np.int16)
    else:
        raise ValueError(f"{path}: unsupported sample_n_bytes={n_bytes}")

    if count is not None:
        data = data[:int(count) * channels]
    if channels > 1:
        data = data[:len(data) // channels * channels]
        data = data.reshape(-1, channels)
    return fs, data
