"""ctypes bindings for the native data-loader core (``native/diffmst_native.cpp``).

Port of ``diffmst_tpu/data/native.py`` with a loader of its own: at first
use g++ builds the source into ``build/diffmst_native/`` at the repository
root (a name that carries a hash of the source and the flags, written to a
temporary file and renamed, so concurrent processes never load a half-written
library); nothing is written to, or loaded from, ``native/``. Every entry
point has a pure-Python path (scipy's WAV reader and the port's host
loudness) for a machine without g++; ``native_available()`` says which one
runs. ``MultitrackDataset`` uses the fused ``load_normalized_batch``: one
native call decodes, measures BS.1770 loudness and scales to the target, for
all of a song's stems on a C++ thread pool.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from diffmst_torch.data.audio_io import UnsupportedAudioFormat, audio_info, read_audio
from diffmst_torch.ops.loudness import integrated_loudness as py_loudness

__all__ = ["native_available", "wav_info", "wav_read", "integrated_loudness",
           "load_normalized", "load_normalized_batch", "BUILD_DIR"]

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "diffmst_native.cpp"
BUILD_DIR = _ROOT / "build" / "diffmst_native"
_FLAGS = ("-O3", "-std=c++17", "-pthread", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> Optional[Path]:
    """The library built from SOURCE (built now if missing), or None where
    there is no source or no g++, or g++ fails."""
    if not SOURCE.exists():
        return None
    tag = hashlib.sha256(" ".join(_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libdiffmst_native-{tag}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run([gxx, *_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=300)
    except (subprocess.SubprocessError, OSError):
        return None
    os.replace(tmp, out)
    return out


def _build_and_load() -> Optional[ctypes.CDLL]:
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None

    lib.dn_wav_info.restype = ctypes.c_int
    lib.dn_wav_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.dn_wav_read.restype = ctypes.c_int
    lib.dn_wav_read.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.dn_integrated_loudness.restype = ctypes.c_double
    lib.dn_integrated_loudness.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
        ctypes.c_double,
    ]
    lib.dn_load_normalized.restype = ctypes.c_int
    lib.dn_load_normalized.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_double,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double),
    ]
    lib.dn_load_normalized_batch.restype = None
    lib.dn_load_normalized_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long), ctypes.c_double,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int,
    ]
    return lib


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _LIB = _build_and_load()
            _TRIED = True
        return _LIB


def native_available() -> bool:
    """Whether the native library runs (else the pure-Python paths do)."""
    return _lib() is not None


def wav_info(path: str) -> Tuple[int, int, int]:
    """(num_frames, channels, sample_rate); native with Python fallback."""
    lib = _lib()
    if lib is not None:
        frames = ctypes.c_long()
        chs = ctypes.c_int()
        rate = ctypes.c_int()
        if lib.dn_wav_info(path.encode(), frames, chs, rate) == 0:
            return frames.value, chs.value, rate.value
    return audio_info(path)


def wav_read(path: str, start: int, frames: int) -> Tuple[np.ndarray, int]:
    """Decode a slice -> (channels, frames) float32 + sample rate."""
    lib = _lib()
    if lib is not None:
        n_frames, chs, rate = wav_info(path)
        frames = min(frames, n_frames - start)
        buf = np.empty(frames * chs, np.float32)
        rc = lib.dn_wav_read(
            path.encode(), start, frames,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc == 0:
            return buf.reshape(frames, chs).T.copy(), rate
    return read_audio(path, start, frames)


def integrated_loudness(audio: np.ndarray, sample_rate: float) -> float:
    """BS.1770 LUFS of (frames,) or (frames, channels) float audio."""
    lib = _lib()
    if lib is not None:
        if audio.ndim == 1:
            audio = audio[:, None]
        inter = np.ascontiguousarray(audio, np.float32)
        return lib.dn_integrated_loudness(
            inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            inter.shape[0], inter.shape[1], float(sample_rate),
        )
    return py_loudness(audio, sample_rate)


def load_normalized(
    path: str, start: int, frames: int, target_lufs: float
) -> Tuple[Optional[np.ndarray], float, int]:
    """Fused decode+measure+scale -> ((channels, frames), measured LUFS, sr).

    Returns (None, -inf, 0) on decode failure.
    """
    lib = _lib()
    if lib is not None:
        try:
            n_frames, chs, rate = wav_info(path)
        except UnsupportedAudioFormat:
            raise  # decode contract: fail loudly with the remedy
        except Exception:
            return None, float("-inf"), 0
        if start + frames > n_frames:
            return None, float("-inf"), 0
        buf = np.empty(frames * chs, np.float32)
        lufs = ctypes.c_double()
        rc = lib.dn_load_normalized(
            path.encode(), start, frames, target_lufs,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), lufs,
        )
        if rc == 0:
            return buf.reshape(frames, chs).T.copy(), lufs.value, rate
        return None, float("-inf"), 0
    try:
        audio, rate = read_audio(path, start, frames)
    except UnsupportedAudioFormat:
        raise
    except (OSError, ValueError):
        return None, float("-inf"), 0
    lufs = py_loudness(audio.T, rate)
    if np.isfinite(lufs):
        audio = audio * 10.0 ** ((target_lufs - lufs) / 20.0)
    return audio, lufs, rate


def load_normalized_batch(
    paths, starts, frames: int, target_lufs: float,
    num_threads: Optional[int] = None,
):
    """Threaded batch of fused decode+measure+normalize loads.

    One native call decodes, measures and scales all files on a C++ thread
    pool (``dn_load_normalized_batch``). Returns a list of
    ``(audio (channels, frames) | None, lufs, sample_rate)`` per input.
    """
    n = len(paths)
    if num_threads is None:
        num_threads = min(8, os.cpu_count() or 1)
    lib = _lib()
    if lib is None or n == 0:
        return [load_normalized(p, s, frames, target_lufs)
                for p, s in zip(paths, starts)]

    infos = []
    for p in paths:
        try:
            infos.append(wav_info(p))
        except UnsupportedAudioFormat:
            raise
        except Exception:
            infos.append(None)
    valid = [
        i for i, info in enumerate(infos)
        if info is not None and starts[i] + frames <= info[0] and info[1] > 0
    ]
    results = [(None, float("-inf"), 0)] * n
    if not valid:
        return results

    bufs = {i: np.empty(frames * infos[i][1], np.float32) for i in valid}
    m = len(valid)
    c_paths = (ctypes.c_char_p * m)(*[paths[i].encode() for i in valid])
    c_starts = (ctypes.c_long * m)(*[int(starts[i]) for i in valid])
    c_frames = (ctypes.c_long * m)(*[int(frames)] * m)
    c_outs = (ctypes.POINTER(ctypes.c_float) * m)(
        *[bufs[i].ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for i in valid]
    )
    c_lufs = (ctypes.c_double * m)()
    c_rcs = (ctypes.c_int * m)()
    lib.dn_load_normalized_batch(
        c_paths, c_starts, c_frames, float(target_lufs), c_outs, c_lufs,
        c_rcs, m, int(num_threads),
    )
    for j, i in enumerate(valid):
        if c_rcs[j] == 0:
            chs, rate = infos[i][1], infos[i][2]
            results[i] = (
                bufs[i].reshape(frames, chs).T.copy(), c_lufs[j], rate
            )
    return results
