"""Multitrack data pipeline: RAM-buffered datasets with LUFS normalization.

Port of ``diffmst_tpu/data/dataset.py`` (the reference's
``mst/dataloader.py``); the same batches for the same corpus and seed:

  * ``MultitrackDataset``: YAML song -> track -> instrument metadata per root
    dir; a RAM buffer refilled once per epoch: shuffle songs and cycle, a
    random offset at least 25 % into the song, reject wrong-length,
    more-than-2-channel and quieter-than-min-LUFS tracks, loudness-normalize
    each to ``target_track_lufs_db``, split stereo files into two mono
    tracks (``stereo_info`` marks the first), zero-pad to ``max_tracks``
    (``track_padding`` True), until the GB budget is met. A mix buffer holds
    real reference mixes normalized to -16 LUFS.
  * ``MultitrackDataModule``: train, val and test datasets, collated into
    NumPy batches; the Trainer puts them on the device.
  * ``MixDataset`` / ``MixDataModule``: stereo mixes only, for parameter
    estimation: a random file and offset per draw, files that are not
    stereo, too short or unreadable skipped, silence below -48 LUFS
    rejected within 32 tries, each mix normalized to -16 LUFS.

Distributed: song lists shard by (rank, world size) of ``torch.distributed``
when a process group is initialized, else (0, 1).

Determinism: all sampling flows from a seeded ``np.random.Generator``.
Each buffer reload prints one line: the songs and tracks loaded, their
bytes, its seconds and whether the native loader ran.
"""

from __future__ import annotations

import dataclasses
import os
import time
import wave
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import yaml

from diffmst_torch.data import native as _native
from diffmst_torch.data.audio_io import UnsupportedAudioFormat, audio_info, read_audio
from diffmst_torch.ops.loudness import integrated_loudness

# Skip-unreadable invariant (dataloader.py:205's soundfile failures become a
# silent skip): every decode error a damaged WAV can raise — wave.Error /
# EOFError from wave.open header parsing, OSError from I/O, ValueError from
# the scipy body decode, and the bare RuntimeError the stdlib chunk reader
# raises on a malformed chunk size (wave.py:158). UnsupportedAudioFormat (a
# ValueError subclass) must be re-raised BEFORE this tuple at every catch
# site: recognizable compressed formats fail loudly with the preprocessing
# remedy instead of being skipped.
_SKIP_DECODE_ERRORS = (OSError, EOFError, wave.Error, ValueError, RuntimeError)

__all__ = ["TrackExample", "MultitrackDataset", "MultitrackDataModule", "MixDataset", "MixDataModule"]


def _process_shard() -> Tuple[int, int]:
    """(rank, world size) of torch.distributed's group, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass
class TrackExample:
    """One buffered multitrack example (pre-padding)."""

    tracks: np.ndarray  # (num_tracks, length) float32, -48 LUFS each
    instrument_id: np.ndarray  # (num_tracks,) int32
    stereo_info: np.ndarray  # (num_tracks,) int32, 1 marks first of a pair
    song_name: str


def _load_metadata(metadata_files: Sequence[str], subset: str):
    """Parse the reference-format YAMLs: {split: {song_dir: {wav: instrument}}}."""
    songs = []
    for mf in metadata_files:
        with open(mf) as f:
            meta = yaml.safe_load(f)
        split = meta.get(subset, {}) or {}
        for song_dir, tracks in split.items():
            if tracks:
                songs.append((song_dir, dict(tracks)))
    return songs


class MultitrackDataset:
    """RAM-buffered multitrack stems + (optionally) real reference mixes."""

    def __init__(
        self,
        track_root_dirs: Sequence[str],
        metadata_files: Sequence[str],
        length: int = 262144,
        min_tracks: int = 8,
        max_tracks: int = 8,
        subset: str = "train",
        buffer_size_gb: float = 0.2,
        num_examples_per_epoch: int = 20000,
        target_track_lufs_db: float = -48.0,
        min_track_lufs_db: float = -48.0,
        mix_root_dirs: Sequence[str] = (),
        mix_metadata_files: Sequence[str] = (),
        target_mix_lufs_db: float = -16.0,
        randomize_ref_mix_gain: bool = False,
        instrument_name2id: Optional[Dict[str, int]] = None,
        seed: int = 42,
        process_index: int = 0,
        process_count: int = 1,
    ) -> None:
        self.track_root_dirs = list(track_root_dirs)
        self.length = length
        self.min_tracks = min_tracks
        self.max_tracks = max_tracks
        self.subset = subset
        self.buffer_size_gb = buffer_size_gb
        self.num_examples_per_epoch = num_examples_per_epoch
        self.target_track_lufs_db = target_track_lufs_db
        self.min_track_lufs_db = min_track_lufs_db
        self.target_mix_lufs_db = target_mix_lufs_db
        self.randomize_ref_mix_gain = randomize_ref_mix_gain
        self.instrument_name2id = instrument_name2id or {}
        self.rng = np.random.default_rng(seed + process_index)

        songs = _load_metadata(metadata_files, subset)
        # per-host shard of the song list (DistributedSampler semantics)
        self.songs = songs[process_index::process_count]
        if not self.songs:
            raise ValueError(f"no songs for subset={subset!r} in {metadata_files}")

        # Reference mixes: explicit metadata lists when given, else a
        # recursive **/*.wav glob of the mix roots (the reference's MixDataset
        # discovery, dataloader.py:25-26 — the Jamendo configs pass only a
        # root dir).
        self.mix_paths: List[str] = []
        for mf in mix_metadata_files:
            with open(mf) as f:
                meta = yaml.safe_load(f)
            for rel in meta.get(subset, []) or []:
                self.mix_paths.append(rel)
        self.mix_root_dirs = list(mix_root_dirs)
        if self.mix_root_dirs and not self.mix_paths:
            import glob as _glob

            for root in self.mix_root_dirs:
                for p in _glob.glob(
                    os.path.join(root, "**", "*.wav"), recursive=True
                ):
                    self.mix_paths.append(os.path.relpath(p, root))

        self.track_buffer: List[TrackExample] = []
        self.mix_buffer: List[np.ndarray] = []
        self.items_since_reload = 0
        self.reload_seconds = 0.0  # of the last track-buffer reload

    # ------------------------------------------------------------- helpers
    def _resolve(self, roots: Sequence[str], rel: str) -> Optional[str]:
        for root in roots:
            p = os.path.join(root, rel)
            if os.path.exists(p):
                return p
        return None

    def _load_song(self, song_dir: str, tracks_meta: Dict[str, str]):
        """Load one song's stems at a random offset; returns None on reject."""
        paths = []
        for wav, instrument in sorted(tracks_meta.items()):
            p = self._resolve(self.track_root_dirs, os.path.join(song_dir, wav))
            if p is not None:
                paths.append((p, instrument))
        if not paths:
            return None

        # random offset at least 25% into the song (dataloader.py:286)
        try:
            num_frames, _, sr = audio_info(paths[0][0])
        except UnsupportedAudioFormat:
            raise  # decode contract: fail loudly, remedy in the message
        except _SKIP_DECODE_ERRORS:
            return None
        if num_frames < self.length:
            return None
        lo = int(num_frames * 0.25)
        hi = max(lo + 1, num_frames - self.length)
        offset = int(self.rng.integers(lo, hi)) if hi > lo else lo
        offset = min(offset, num_frames - self.length)

        # fused native decode + BS.1770 measure + normalize on a C++ thread
        # pool — all candidate stems of the song in one call (falls back to
        # a sequential scipy+NumPy path without the compiled core). Load at
        # most 2*max_tracks candidates: rejections are the exception, so
        # this covers them without decoding a 30-stem song for 8 slots.
        candidates = paths[: 2 * self.max_tracks]
        loaded = _native.load_normalized_batch(
            [p for p, _ in candidates],
            [offset] * len(candidates),
            self.length,
            self.target_track_lufs_db,
        )

        out_tracks: List[np.ndarray] = []
        out_instr: List[int] = []
        out_stereo: List[int] = []
        for (p, instrument), (audio, lufs, _sr) in zip(candidates, loaded):
            if len(out_tracks) >= self.max_tracks:
                break
            if audio is None or audio.shape[-1] != self.length or audio.shape[0] > 2:
                continue
            if not np.isfinite(lufs) or lufs < self.min_track_lufs_db:
                continue  # too quiet (dataloader.py:311)
            iid = self.instrument_name2id.get(instrument, 0)
            if audio.shape[0] == 2:  # stereo -> two mono tracks
                out_tracks.append(audio[0])
                out_instr.append(iid)
                out_stereo.append(1)
                if len(out_tracks) < self.max_tracks:
                    out_tracks.append(audio[1])
                    out_instr.append(iid)
                    out_stereo.append(0)
            else:
                out_tracks.append(audio[0])
                out_instr.append(iid)
                out_stereo.append(0)

        if len(out_tracks) < self.min_tracks:
            return None
        return TrackExample(
            tracks=np.stack(out_tracks).astype(np.float32),
            instrument_id=np.asarray(out_instr, np.int32),
            stereo_info=np.asarray(out_stereo, np.int32),
            song_name=os.path.basename(song_dir),
        )

    def reload_track_buffer(self) -> None:
        """Refill the RAM buffer up to the GB budget (dataloader.py:251-382)."""
        t0 = time.perf_counter()
        self.track_buffer.clear()
        order = self.rng.permutation(len(self.songs))
        budget_bytes = self.buffer_size_gb * 1e9
        used = 0
        for idx in np.tile(order, 4):  # cycle the shuffled list
            ex = self._load_song(*self.songs[idx])
            if ex is None:
                continue
            self.track_buffer.append(ex)
            used += ex.tracks.nbytes
            if used >= budget_bytes:
                break
        if not self.track_buffer:
            raise RuntimeError("track buffer empty: no loadable songs")
        self.reload_seconds = time.perf_counter() - t0
        print(f"data: {self.subset} buffer reloaded: {len(self.track_buffer)} songs,"
              f" {sum(ex.tracks.shape[0] for ex in self.track_buffer)} tracks, {used} bytes"
              f" in {self.reload_seconds:.3f} s (native loader: {_native.native_available()})",
              flush=True)

    def reload_mix_buffer(self) -> None:
        """Refill real reference mixes normalized to -16 LUFS."""
        self.mix_buffer.clear()
        if not self.mix_paths:
            return
        order = self.rng.permutation(len(self.mix_paths))
        budget = self.buffer_size_gb * 1e9 / 4
        used = 0
        for idx in order:
            p = self._resolve(self.mix_root_dirs, self.mix_paths[idx])
            if p is None:
                continue
            try:
                num_frames, chs, _ = audio_info(p)
            except UnsupportedAudioFormat:
                raise  # decode contract: fail loudly, remedy in the message
            except _SKIP_DECODE_ERRORS:
                continue
            if chs != 2 or num_frames < self.length:
                continue
            lo = int(num_frames * 0.25)
            hi = max(lo + 1, num_frames - self.length)
            off = int(self.rng.integers(lo, hi)) if hi > lo else lo
            try:
                audio, _ = read_audio(p, start=off, frames=self.length)
            except UnsupportedAudioFormat:
                raise  # decode contract: fail loudly, remedy in the message
            except _SKIP_DECODE_ERRORS:
                continue
            lufs = integrated_loudness(audio.T, 44100.0)
            if not np.isfinite(lufs):
                continue
            audio = audio * 10.0 ** ((self.target_mix_lufs_db - lufs) / 20.0)
            self.mix_buffer.append(audio.astype(np.float32))
            used += audio.nbytes
            if used >= budget:
                break

    # ------------------------------------------------------------ item API
    def __len__(self) -> int:
        return self.num_examples_per_epoch

    def __getitem__(self, idx: int):
        """Uniform draw from the buffers; reload once per epoch
        (dataloader.py:384-419). Returns the reference's 6-tuple."""
        if self.items_since_reload == 0 or not self.track_buffer:
            self.reload_track_buffer()
            self.reload_mix_buffer()
        self.items_since_reload = (
            self.items_since_reload + 1
        ) % self.num_examples_per_epoch

        ex = self.track_buffer[int(self.rng.integers(len(self.track_buffer)))]
        n = ex.tracks.shape[0]
        tracks = np.zeros((self.max_tracks, self.length), np.float32)
        instr = np.zeros((self.max_tracks,), np.int32)
        stereo = np.zeros((self.max_tracks,), np.int32)
        padding = np.ones((self.max_tracks,), bool)
        tracks[:n] = ex.tracks[: self.max_tracks]
        instr[:n] = ex.instrument_id[: self.max_tracks]
        stereo[:n] = ex.stereo_info[: self.max_tracks]
        padding[:n] = False

        if self.mix_buffer:
            mix = self.mix_buffer[int(self.rng.integers(len(self.mix_buffer)))]
            if self.randomize_ref_mix_gain:  # dataloader.py:411-414
                mix = mix * np.float32(
                    10.0 ** (self.rng.uniform(-16.0, 12.0) / 20.0)
                )
        else:
            mix = np.zeros((2, self.length), np.float32)
        return tracks, stereo, instr, padding, mix, ex.song_name


class MultitrackDataModule:
    """Train/val/test datasets + batching iterator (dataloader.py:423-516).

    Batching is a simple host-side collate into NumPy arrays; device prefetch
    happens in the trainer (double-buffered device_put).
    """

    def __init__(
        self,
        track_root_dirs: Sequence[str],
        metadata_files: Sequence[str],
        length: int = 262144,
        min_tracks: int = 8,
        max_tracks: int = 8,
        batch_size: int = 4,
        num_workers: int = 0,  # accepted for config parity; loading is inline
        num_train_passes: int = 20,
        num_val_passes: int = 1,
        num_examples_per_pass: int = 1000,  # dataloader.py:140 fixes this at 1000
        train_buffer_size_gb: float = 2.0,
        val_buffer_size_gb: float = 0.5,
        test_buffer_size_gb: float = 0.5,
        target_track_lufs_db: float = -48.0,
        min_track_lufs_db: float = -48.0,
        mix_root_dirs: Sequence[str] = (),
        mix_metadata_files: Sequence[str] = (),
        target_mix_lufs_db: float = -16.0,
        randomize_ref_mix_gain: bool = False,
        instrument_name2id_json: Optional[str] = None,
        seed: int = 42,
        **_unused,
    ) -> None:
        import json

        name2id = None
        if instrument_name2id_json and os.path.exists(instrument_name2id_json):
            with open(instrument_name2id_json) as f:
                name2id = json.load(f)

        pidx, pcnt = _process_shard()

        common = dict(
            track_root_dirs=track_root_dirs,
            metadata_files=metadata_files,
            length=length,
            min_tracks=min_tracks,
            max_tracks=max_tracks,
            target_track_lufs_db=target_track_lufs_db,
            min_track_lufs_db=min_track_lufs_db,
            mix_root_dirs=mix_root_dirs,
            mix_metadata_files=mix_metadata_files,
            target_mix_lufs_db=target_mix_lufs_db,
            randomize_ref_mix_gain=randomize_ref_mix_gain,
            instrument_name2id=name2id,
            seed=seed,
            process_index=pidx,
            process_count=pcnt,
        )
        self.batch_size = batch_size
        self.train_dataset = MultitrackDataset(
            subset="train",
            buffer_size_gb=train_buffer_size_gb,
            num_examples_per_epoch=max(1, num_examples_per_pass * num_train_passes),
            **common,
        )
        self.val_dataset = MultitrackDataset(
            subset="val",
            buffer_size_gb=val_buffer_size_gb,
            num_examples_per_epoch=max(1, num_examples_per_pass * num_val_passes),
            **common,
        )
        # test split (dataloader.py:496-516) built lazily: the metadata files
        # may have no "test" subset (medley.yaml doesn't), and the reference
        # only constructs it when test_dataloader() is called.
        self._test_kwargs = dict(
            subset="test",
            buffer_size_gb=test_buffer_size_gb,
            num_examples_per_epoch=max(1, num_examples_per_pass * num_val_passes),
            **common,
        )
        self.test_dataset: Optional[MultitrackDataset] = None

    def _iterate(
        self, dataset: MultitrackDataset, batch_size: Optional[int] = None
    ) -> Iterator[Tuple]:
        bs = batch_size or self.batch_size
        items = []
        for i in range(len(dataset)):
            items.append(dataset[i])
            if len(items) == bs:
                yield self.collate(items)
                items = []

    @staticmethod
    def collate(items: List[Tuple]):
        tracks = np.stack([it[0] for it in items])
        stereo = np.stack([it[1] for it in items])
        instr = np.stack([it[2] for it in items])
        padding = np.stack([it[3] for it in items])
        mix = np.stack([it[4] for it in items])
        names = [it[5] for it in items]
        return tracks, stereo, instr, padding, mix, names

    def train_dataloader(self) -> Iterator[Tuple]:
        return self._iterate(self.train_dataset)

    def val_dataloader(self) -> Iterator[Tuple]:
        return self._iterate(self.val_dataset)

    def test_dataloader(self) -> Iterator[Tuple]:
        """Test-split loader, batch_size=1 like the reference
        (dataloader.py:512-516)."""
        if self.test_dataset is None:
            self.test_dataset = MultitrackDataset(**self._test_kwargs)
        return self._iterate(self.test_dataset, batch_size=1)


class MixDataset:
    """Mixes only, for parameter-estimation pretraining (dataloader.py:18-121;
    the silence-rejection loop, without the reference's debug overrides).
    Each try draws a path index, then an offset, from one NumPy generator,
    in JAX's order."""

    def __init__(
        self,
        root_dirs: Sequence[str],
        metadata_files: Sequence[str] = (),
        length: int = 262144,
        subset: str = "train",
        num_examples_per_epoch: int = 10000,
        target_lufs_db: float = -16.0,
        seed: int = 0,
    ) -> None:
        self.root_dirs = list(root_dirs)
        self.length = length
        self.num_examples_per_epoch = num_examples_per_epoch
        self.target_lufs_db = target_lufs_db
        self.rng = np.random.default_rng(seed)
        self.paths: List[str] = []
        for mf in metadata_files:
            with open(mf) as f:
                meta = yaml.safe_load(f)
            self.paths.extend(meta.get(subset, []) or [])
        if not self.paths:
            # the reference's discovery: a recursive wav glob (dataloader.py:25-26)
            import glob as _glob

            for root in self.root_dirs:
                for p in _glob.glob(os.path.join(root, "**", "*.wav"), recursive=True):
                    self.paths.append(os.path.relpath(p, root))
        if not self.paths:
            raise ValueError("no mixes in metadata or under root_dirs")

    def __len__(self) -> int:
        return self.num_examples_per_epoch

    def __getitem__(self, idx: int) -> np.ndarray:
        """A (2, length) float32 mix at ``target_lufs_db``."""
        for _ in range(32):
            rel = self.paths[int(self.rng.integers(len(self.paths)))]
            p = next((c for c in (os.path.join(r, rel) for r in self.root_dirs) if os.path.exists(c)), None)
            if p is None:
                continue
            try:
                frames, chs, _ = audio_info(p)
                if chs != 2 or frames < self.length:
                    continue
                off = int(self.rng.integers(0, frames - self.length + 1))
                audio, _ = read_audio(p, start=off, frames=self.length)
            except UnsupportedAudioFormat:
                raise  # decode contract: fail loudly, remedy in the message
            except _SKIP_DECODE_ERRORS:
                continue
            lufs = integrated_loudness(audio.T, 44100.0)
            if not np.isfinite(lufs) or lufs < -48.0:
                continue  # silence rejection
            return (audio * 10.0 ** ((self.target_lufs_db - lufs) / 20.0)).astype(np.float32)
        raise RuntimeError("could not draw a non-silent mix after 32 tries")


class MixDataModule:
    """Batches of mixes, (batch_size, 2, length) NumPy float32, for
    parameter-estimation pretraining (dataloader.py:423+)."""

    def __init__(
        self,
        root_dirs: Sequence[str] = (),
        metadata_files: Sequence[str] = (),
        length: int = 262144,
        batch_size: int = 4,
        num_examples_per_epoch: int = 10000,
        target_lufs_db: float = -16.0,
        seed: int = 0,
        root_dir: Optional[str] = None,  # the reference's singular name
        **_unused,
    ) -> None:
        if root_dir is not None:
            root_dirs = list(root_dirs) + [root_dir]
        self.batch_size = batch_size
        self.train_dataset = MixDataset(root_dirs, metadata_files, length, "train",
                                        num_examples_per_epoch, target_lufs_db, seed)
        self.val_dataset = MixDataset(root_dirs, metadata_files, length, "val",
                                      max(1, num_examples_per_epoch // 10), target_lufs_db, seed + 1)

    def _iterate(self, ds: MixDataset) -> Iterator[np.ndarray]:
        batch = []
        for i in range(len(ds)):
            batch.append(ds[i])
            if len(batch) == self.batch_size:
                yield np.stack(batch)
                batch = []

    def train_dataloader(self) -> Iterator[np.ndarray]:
        return self._iterate(self.train_dataset)

    def val_dataloader(self) -> Iterator[np.ndarray]:
        return self._iterate(self.val_dataset)
