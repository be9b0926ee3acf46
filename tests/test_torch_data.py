"""The PyTorch port's data pipeline and model keywords against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and its
counterpart in ``diffmst_torch`` on the CPU:

  * the encoder's BatchNorm keywords (``input_batchnorm`` on,
    ``encoder_batchnorm`` off), weights carried with ``state_dict_from_flax``:
    outputs within 1e-4 of their max-abs, the updated BatchNorm statistics
    within 1e-5;
  * the shipped ``configs/models/naive.yaml`` through the port's registry: it
    builds, and its state-dict names and shapes are those of the Flax model's
    (from ``jax.eval_shape``: shapes only, no full-width init in JAX);
  * ``MultitrackDataModule`` on a synthetic corpus (3 mono stems, 1 stereo
    stem and 1 silent stem a song, reference mixes) for the same seed: every
    batch of the train (two epochs), val and test loaders; tracks bitwise
    where both packages go through the native library, within 1e-6 where the
    port takes its pure-Python path; ids, stereo flags, padding, reference
    mixes and names equal;
  * WAV encode and decode across the packages, bitwise, and the same
    refusals of compressed and damaged files;
  * ``scripts/make_synth_corpus_torch.py`` against ``make_synth_corpus.py``
    at 2 songs of 1 s: identical WAV bytes and metadata.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

import diffmst_tpu.data as jdata
from diffmst_tpu.models import SpectrogramEncoder as JaxEncoder
from diffmst_tpu.utils.config import instantiate as jax_instantiate
from diffmst_torch import data as tdata
from diffmst_torch.data import native as tnative
from diffmst_torch.models import SpectrogramEncoder
from diffmst_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SR = 44100
LEN = 32768
ENC = dict(embed_dim=32, n_fft=2048, hop_length=128, cnn_base_width=4)


def _rel_err(port, ref) -> float:
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


# ------------------------------------------------------------ the encoder


@pytest.fixture(scope="module")
def bn_encoder():
    """A Flax encoder with an input BatchNorm and none in Cnn14, its
    variables drawn from a numpy seed at the shapes ``jax.eval_shape`` gives
    (He-scaled kernels, small biases, the input BatchNorm's statistics and
    affine parameters non-trivial), and a (3, 1, 16384) input."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 1, 16384)) * 0.1).astype(np.float32)
    enc = JaxEncoder(**ENC, input_batchnorm=True, encoder_batchnorm=False)
    shapes = jax.eval_shape(enc.init, jax.random.PRNGKey(0), jnp.asarray(x))

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":  # He scale over the fan-in
            return (rng.normal(size=s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    assert set(shapes["batch_stats"]) == {"bn"}  # Cnn14 has no BatchNorm here
    params["bn"] = {"scale": rng.uniform(0.5, 1.5, 1).astype(np.float32),
                    "bias": rng.normal(0.0, 0.1, 1).astype(np.float32)}
    stats = {"bn": {"mean": np.array([0.3], np.float32), "var": np.array([0.7], np.float32)}}
    return enc, params, stats, x


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_encoder_batchnorm_keywords_match_jax(bn_encoder, train):
    enc, params, stats, x = bn_encoder
    out = jax.jit(enc.apply, static_argnames=("train", "mutable"))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=train,
        mutable=("batch_stats",) if train else False)
    ref, new_stats = out if train else (out, None)

    sd = {}
    tckpt.encoder_state_dict(params, stats, "", sd)
    port = SpectrogramEncoder(**ENC, input_batchnorm=True, encoder_batchnorm=False)
    port.load_state_dict(sd, strict=True)
    assert not any(k.startswith("model.conv_block1.bn") for k in sd)
    got = port(torch.from_numpy(x), train=train)
    assert _rel_err(got, ref) <= 1e-4
    if train:
        nb = new_stats["batch_stats"]["bn"]
        assert _rel_err(port.bn.running_mean, nb["mean"]) <= 1e-5
        assert _rel_err(port.bn.running_var, nb["var"]) <= 1e-5
        assert float(port.bn.running_mean) != 0.3  # the statistics moved
    else:
        assert float(port.bn.running_mean) == pytest.approx(0.3)


def test_naive_yaml_builds_through_the_registry(monkeypatch):
    """The shipped model config builds the port's model at full width on the
    CPU, with the Flax model's state-dict names and shapes."""
    import main_torch
    from diffmst_tpu.utils.config import load_config as jax_load_config

    cfg = jax_load_config([str(REPO / "configs" / "models" / "naive.yaml")])
    system, datamodule, _ = main_torch.build_from_config(cfg, "cpu")
    assert datamodule is None
    model = system.model
    assert sum(p.numel() for p in model.parameters()) == 190_923_982
    assert not hasattr(model.track_encoder, "bn")  # input_batchnorm: false
    assert all(bool(torch.isfinite(v).all()) for v in model.state_dict().values())

    jmodel = jax_instantiate(cfg["model"]["init_args"]["model"])
    t = 65536  # 129 frames at hop 512: the least Cnn14 takes
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, t)), jnp.zeros((1, 2, t)), jnp.zeros((1, 2), bool)
    )
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    monkeypatch.setattr(tckpt, "_t", lambda a: torch.empty(np.shape(a), device="meta"))
    ref = tckpt.state_dict_from_flax(zeros)
    got = model.state_dict()
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(ref[k].shape), k


# -------------------------------------------------------------- the data


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Train (3 songs), val and test (1 each): 3 mono stems, 1 stereo stem
    and 1 silent stem a song, 3 x 32,768 samples; 2 reference mixes a split."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    song_len = LEN * 3
    meta = {"train": {}, "val": {}, "test": {}}
    mixes = {"train": [], "val": [], "test": []}
    for split, n in (("train", 3), ("val", 1), ("test", 1)):
        for s in range(n):
            song = f"{split}_song{s}"
            tracks = {}
            for t, inst in enumerate(["kick", "vocals", "bass"]):
                name = f"track{t}.wav"
                env = np.linspace(0.2, 1.0, song_len) ** (t + 1)
                audio = (rng.normal(size=(1, song_len)) * 0.1 * env).astype(np.float32)
                tdata.write_audio(str(root / song / name), audio, SR)
                tracks[name] = inst
            audio = (rng.normal(size=(2, song_len)) * 0.1).astype(np.float32)
            tdata.write_audio(str(root / song / "gtr_st.wav"), audio, SR)
            tracks["gtr_st.wav"] = "electric guitar"
            tdata.write_audio(str(root / song / "silent.wav"), np.zeros((1, song_len), np.float32), SR)
            tracks["silent.wav"] = "silence"
            meta[split][song] = tracks
        for m in range(2):
            rel = f"mixes/{split}_mix{m}.wav"
            tdata.write_audio(str(root / rel), (rng.normal(size=(2, song_len)) * 0.2).astype(np.float32), SR)
            mixes[split].append(rel)
    (root / "meta.yaml").write_text(yaml.safe_dump(meta))
    (root / "mixes.yaml").write_text(yaml.safe_dump(mixes))
    return root


def _datamodule_args(root):
    return dict(
        track_root_dirs=[str(root)], metadata_files=[str(root / "meta.yaml")],
        mix_root_dirs=[str(root)], mix_metadata_files=[str(root / "mixes.yaml")],
        instrument_name2id_json=str(REPO / "data" / "instrument_name2id.json"),
        length=LEN, min_tracks=2, max_tracks=6, batch_size=2, num_examples_per_pass=4,
        num_train_passes=2, num_val_passes=1, train_buffer_size_gb=0.001, val_buffer_size_gb=0.001,
        test_buffer_size_gb=0.001, randomize_ref_mix_gain=True, seed=3,
    )


def _batches(dm):
    out = []
    for _ in range(2):  # two epochs: the buffer reloads at each
        out += [("train", b) for b in dm.train_dataloader()]
    out += [("val", b) for b in dm.val_dataloader()]
    out += [("test", b) for b in dm.test_dataloader()]
    return out


@pytest.mark.parametrize("path", ["native", "python"])
def test_datamodule_matches_jax(corpus, monkeypatch, path):
    """Every batch the same as JAX's, for the same corpus and seed."""
    assert tnative.native_available() and jdata.dataset._native.native_available()
    if path == "python":
        monkeypatch.setattr(tnative, "_LIB", None)
        monkeypatch.setattr(tnative, "_TRIED", True)
        assert not tnative.native_available()
    ref = _batches(jdata.MultitrackDataModule(**_datamodule_args(corpus)))
    got = _batches(tdata.MultitrackDataModule(**_datamodule_args(corpus)))
    assert [s for s, _ in got] == [s for s, _ in ref]
    assert len(got) == 2 * 4 + 2 + 4  # batch 2; the test loader's batch is 1
    padded = 0
    for (split, g), (_, r) in zip(got, ref):
        tracks, stereo, instr, padding, mix, names = g
        if path == "native":
            np.testing.assert_array_equal(tracks, r[0])
        else:
            np.testing.assert_allclose(tracks, r[0], rtol=0, atol=1e-6)
        for a, b in zip((stereo, instr, padding, mix), r[1:5]):
            np.testing.assert_array_equal(a, b)
        assert names == r[5]
        # the silent stem is rejected: every track that is not padding sounds
        energy = np.abs(tracks).max(axis=-1)
        assert (energy[~padding] > 0).all() and (energy[padding] == 0).all()
        assert stereo.sum() == len(names)  # one stereo pair a song
        padded += int(padding.sum())
    assert padded > 0  # 5 tracks a song, padded to 6


def test_native_entry_points_match_jax(corpus):
    """The port's own build of the native library against the JAX package's:
    the same header, decode, loudness and fused load, bitwise."""
    from diffmst_tpu.data import native as jnative

    assert tnative.native_available() and jnative.native_available()
    assert tnative.BUILD_DIR in pathlib.Path(tnative._LIB._name).parents
    p = str(corpus / "train_song0" / "gtr_st.wav")
    assert tnative.wav_info(p) == jnative.wav_info(p)
    got, ref = tnative.wav_read(p, 1000, 5000), jnative.wav_read(p, 1000, 5000)
    assert got[1] == ref[1]
    np.testing.assert_array_equal(got[0], ref[0])
    assert tnative.integrated_loudness(got[0].T, SR) == jnative.integrated_loudness(ref[0].T, SR)
    got, ref = tnative.load_normalized(p, 100, LEN, -30.0), jnative.load_normalized(p, 100, LEN, -30.0)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1:] == ref[1:]


def test_dataset_shards_by_torch_distributed(corpus, monkeypatch):
    """With a process group, songs shard by host, as JAX's by process: the
    ranks of one host take every song; node i of n (torchrun's
    ``GROUP_RANK`` of ``WORLD_SIZE // LOCAL_WORLD_SIZE``) every n-th song
    from the i-th."""
    import torch.distributed as dist

    assert tdata.dataset._process_shard() == (0, 1)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.delenv("GROUP_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert tdata.dataset._process_shard() == (0, 1)  # two ranks of one host
    dm = tdata.MultitrackDataModule(**_datamodule_args(corpus))
    assert [s for s, _ in dm.train_dataset.songs] == ["train_song0", "train_song1", "train_song2"]
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")  # one rank a node, two nodes
    monkeypatch.setenv("GROUP_RANK", "1")
    assert tdata.dataset._process_shard() == (1, 2)
    with pytest.raises(ValueError, match="no songs for subset='val'"):
        tdata.MultitrackDataModule(**_datamodule_args(corpus))  # one val song, on node 0
    monkeypatch.setenv("GROUP_RANK", "0")
    dm = tdata.MultitrackDataModule(**_datamodule_args(corpus))
    assert [s for s, _ in dm.train_dataset.songs] == ["train_song0", "train_song2"]


# ----------------------------------------------------------- WAV and corpus


@pytest.mark.parametrize("dtype", ["int16", "int32", "uint8", "float32"])
def test_audio_io_matches_jax(tmp_path, dtype):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 3001)) * 0.3).astype(np.float32)
    if dtype == "int16":  # write_audio's own encoding, by both packages
        tdata.write_audio(str(tmp_path / "t.wav"), x, SR)
        jdata.write_audio(str(tmp_path / "j.wav"), x, SR)
        assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    else:
        pcm = {"int32": lambda a: (np.clip(a, -1, 1) * 2**31 * 0.999).astype(np.int32),
               "uint8": lambda a: (np.clip(a, -1, 1) * 127 + 128).astype(np.uint8),
               "float32": lambda a: a}[dtype](x.T)
        wavfile.write(str(tmp_path / "t.wav"), SR, pcm)
    p = str(tmp_path / "t.wav")
    if dtype == "float32":  # the wave module reads PCM headers only, in both
        for pkg in (tdata, jdata):
            with pytest.raises(Exception, match="unknown format: 3"):
                pkg.audio_info(p)
    else:
        assert tdata.audio_info(p) == jdata.audio_info(p)
    for start, frames in ((0, None), (100, 2000)):
        got, sr = tdata.read_audio(p, start, frames)
        ref, ref_sr = jdata.read_audio(p, start, frames)
        assert sr == ref_sr and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("head", [b"fLaC\0\0\0\0\0\0\0\0", b"OggS\0\0\0\0\0\0\0\0", b"ID3\3\0\0\0\0\0\0\0\0",
                                  b"\0\0\0\x18ftypM4A ", b"\xff\xfb\x90\x64\0\0\0\0\0\0\0\0",
                                  b"RIFF\x24\0\0\0WAVEfmt "],
                         ids=["flac", "ogg", "mp3", "m4a", "mpeg", "damaged"])
def test_audio_io_refuses_like_jax(tmp_path, head):
    p = tmp_path / "bad.wav"
    p.write_bytes(head + bytes(20))
    for fn in ("audio_info", "read_audio"):
        with pytest.raises(Exception) as ref:
            getattr(jdata, fn)(str(p))
        with pytest.raises(Exception) as got:
            getattr(tdata, fn)(str(p))
        assert type(got.value).__name__ == type(ref.value).__name__
        assert str(got.value) == str(ref.value)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synth_corpus_matches_jax_script(tmp_path):
    ref = tmp_path / "jax"
    got = tmp_path / "torch"
    _load_script("make_synth_corpus").make_corpus(str(ref), 1, 1, 1.0)
    _load_script("make_synth_corpus_torch").make_corpus(str(got), 1, 1, 1.0)
    files = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(got) for p in got.rglob("*") if p.is_file())
    assert len(files) == 2 * 10 + 1  # 2 songs of 10 stems, and meta.yaml
    for f in files:
        assert (got / f).read_bytes() == (ref / f).read_bytes(), f
