"""Host-side WAV decode and encode.

Port of ``diffmst_tpu/data/audio_io.py``, the same bytes out: WAV decode
goes through scipy's memory-mapped reader (random access into long stems;
the dataset reads random offsets of multi-minute files), and compressed or
non-WAV files are refused with ``UnsupportedAudioFormat``, which names the
offline conversion.
"""

from __future__ import annotations

import os
import wave
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile

__all__ = ["audio_info", "read_audio", "write_audio", "UnsupportedAudioFormat"]


class UnsupportedAudioFormat(ValueError):
    """A recognizable compressed/non-WAV audio file reached the WAV decoder."""


# Magic bytes of formats the reference's soundfile backend reads but this
# WAV-only pipeline does not (dataloader.py:205 decodes FLAC/OGG too).
_COMPRESSED_MAGICS = (
    (0, b"fLaC", "FLAC"),
    (0, b"OggS", "OGG"),
    (0, b"ID3", "MP3"),
    (4, b"ftyp", "MP4/M4A"),
)


def _reject_compressed(path: str) -> None:
    """Fail loudly (not a silent skip) when a compressed file hits the decoder.

    The decode contract here is WAV-only; the offline preprocessor converts
    everything else. Raising a named error with the remedy beats the scipy
    ValueError the dataset's skip-unreadable path would otherwise swallow.
    """
    try:
        with open(path, "rb") as f:
            head = f.read(12)
    except OSError:
        return  # let the real decoder produce the I/O error
    if head[:4] == b"RIFF":
        # A RIFF container: let the wave decoder validate it. Bytes 4-8 are
        # the little-endian chunk size, which could coincidentally spell a
        # magic like "ftyp" — without this early return such a WAV would be
        # falsely rejected.
        return
    for off, magic, name in _COMPRESSED_MAGICS:
        if head[off : off + len(magic)] == magic:
            raise UnsupportedAudioFormat(
                f"{path!r} is a {name} file; this pipeline decodes WAV only. "
                "Convert your dataset first with `python scripts/datasets.py` "
                "(offline stereo-split/resample/transcode, mirroring the "
                "reference's scripts/datasets.py preprocessing)."
            )
    if len(head) >= 3 and head[0] == 0xFF and (head[1] & 0xE0) == 0xE0:
        raise UnsupportedAudioFormat(
            f"{path!r} looks like an MPEG audio stream; this pipeline decodes "
            "WAV only. Convert your dataset first with `python scripts/datasets.py`."
        )


def audio_info(path: str) -> Tuple[int, int, int]:
    """Return (num_frames, num_channels, sample_rate) without decoding."""
    _reject_compressed(path)
    with wave.open(path, "rb") as f:
        return f.getnframes(), f.getnchannels(), f.getframerate()


_PCM_SCALE = {
    np.dtype(np.int16): 1.0 / 32768.0,
    np.dtype(np.int32): 1.0 / 2147483648.0,
    np.dtype(np.uint8): 1.0 / 128.0,
}


def read_audio(
    path: str,
    start: int = 0,
    frames: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """Read a WAV file (or a slice of it) as float32 (channels, frames).

    Uses a memory map so random-offset reads of long stems do not decode the
    whole file. Integer PCM is scaled to [-1, 1); float PCM passes through.
    Compressed formats (FLAC/OGG/MP3/MP4) raise :class:`UnsupportedAudioFormat`
    naming the offline-preprocessing remedy instead of a generic scipy error.
    """
    _reject_compressed(path)
    sr, data = wavfile.read(path, mmap=True)
    if data.ndim == 1:
        data = data[:, None]
    stop = data.shape[0] if frames is None else min(start + frames, data.shape[0])
    chunk = np.array(data[start:stop])  # materialize only the slice
    if chunk.dtype in _PCM_SCALE:
        out = chunk.astype(np.float32) * _PCM_SCALE[chunk.dtype]
        if chunk.dtype == np.dtype(np.uint8):
            out = out - 1.0
    else:
        out = chunk.astype(np.float32)
    return out.T, int(sr)


def write_audio(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Write float32 (channels, frames) audio as 16-bit PCM WAV."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    x = np.clip(audio.T, -1.0, 1.0)
    wavfile.write(path, int(sample_rate), (x * 32767.0).astype(np.int16))
