"""NIST SPHERE (.sph) reader + segmenter, dependency-free.

Replaces the ``sphfile`` package used by the reference's TED-LIUM prep
(upstream scripts/tedlium_manifest.py:3,44-46). Supports the
SPHERE variants TED-LIUM ships: 16-bit PCM (either endianness) and u-law;
shorten-compressed files raise a clear error.

The port's own copy of gradtts_tpu/data/sph.py: the same numpy code, its
imports from gradtts_tpu_torch.
"""

import os
from typing import Optional, Tuple

import numpy as np


def read_sph_header(path: str) -> dict:
    with open(path, 'rb') as f:
        magic = f.readline().strip()
        if magic != b'NIST_1A':
            raise ValueError(f'{path}: not a NIST SPHERE file ({magic!r})')
        header_size = int(f.readline().strip())
        f.seek(0)
        head = f.read(header_size).decode('ascii', errors='replace')
    fields = {'header_size': header_size}
    for line in head.splitlines()[2:]:
        line = line.strip()
        if line == 'end_head' or not line:
            break
        parts = line.split(None, 2)
        if len(parts) != 3:
            continue
        key, typ, value = parts
        if typ.startswith('-i'):
            fields[key] = int(value)
        elif typ.startswith('-r'):
            fields[key] = float(value)
        else:
            fields[key] = value
    return fields


_ULAW_BIAS, _ULAW_CLIP = 0x84, 32635


def _ulaw_decode(u: np.ndarray) -> np.ndarray:
    u = ~u.astype(np.uint8)
    sign = u & 0x80
    exponent = (u >> 4) & 0x07
    mantissa = u & 0x0F
    sample = ((mantissa.astype(np.int32) << 3) + _ULAW_BIAS) << exponent
    sample = sample - _ULAW_BIAS
    return np.where(sign != 0, -sample, sample).astype(np.int16)


def read_sph(path: str, start: Optional[float] = None,
             end: Optional[float] = None) -> Tuple[np.ndarray, int]:
    """-> (float32 waveform in [-1, 1] of the [start, end) second window,
    sample_rate)."""
    h = read_sph_header(path)
    sr = int(h.get('sample_rate', 16000))
    n_bytes = int(h.get('sample_n_bytes', 2))
    n_channels = int(h.get('channel_count', 1))
    coding = str(h.get('sample_coding', 'pcm'))
    if 'shorten' in coding or 'embedded' in coding:
        raise ValueError(
            f'{path}: shorten-compressed SPHERE is not supported; '
            'decompress with sph2pipe first')

    frame_bytes = n_bytes * n_channels
    offset = h['header_size']
    total_frames = int(h.get('sample_count',
                             (os.path.getsize(path) - offset) // frame_bytes))
    f0 = 0 if start is None else max(0, int(round(start * sr)))
    f1 = total_frames if end is None else min(total_frames,
                                              int(round(end * sr)))
    count = max(0, f1 - f0)

    with open(path, 'rb') as f:
        f.seek(offset + f0 * frame_bytes)
        raw = f.read(count * frame_bytes)

    if coding.startswith('ulaw') or coding.startswith('mu-law'):
        data = _ulaw_decode(np.frombuffer(raw, np.uint8)).astype(np.float32) \
            / 32768.0
    elif n_bytes == 2:
        byte_format = str(h.get('sample_byte_format', '01'))
        dtype = '<i2' if byte_format == '01' else '>i2'
        data = np.frombuffer(raw, dtype).astype(np.float32) / 32768.0
    elif n_bytes == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f'{path}: unsupported sample_n_bytes={n_bytes}')
    if n_channels > 1:
        data = data.reshape(-1, n_channels)[:, 0]
    return data, sr


def sph_segment_to_wav(sph_path: str, wav_path: str, start: float,
                       end: float) -> None:
    """Cut [start, end) seconds into a PCM16 wav (parity surface:
    sphfile.SPHFile.write_wav, tedlium_manifest.py:46)."""
    data, sr = read_sph(sph_path, start, end)
    from scipy.io import wavfile
    wavfile.write(wav_path, sr, (np.clip(data, -1, 1) * 32767).astype(np.int16))
