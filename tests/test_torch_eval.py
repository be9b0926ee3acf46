"""The PyTorch port's evaluation path against the JAX package's, on the CPU.

  * ``integrated_loudness_torch`` against ``integrated_loudness_jax`` at
    (2, 2, 44,100) and at a 0.2 s signal (one block): float32 within 1e-3
    LU; float64 within 1e-6 LU of the algorithm run in float64 NumPy, and
    within 3e-5 LU of JAX, whose float64 run keeps the K-weighting response
    in complex64, 1e-5 LU off (ROADMAP Queue 3); ``loudness_normalize``
    bitwise;
  * ``center_crop``, ``causal_crop`` and ``validate_normalized`` bitwise and
    with JAX's messages; ``fade_in_and_fade_out`` with its ramps within one
    float32 ulp of 1.0 of JAX's (XLA:CPU's code for ``jnp.linspace`` rounds
    some samples one ulp off the float32 formula that the port computes),
    its input untouched;
  * the device track cache: one upload for several calls on one array, a
    miss for a new array of the same shape and for a recycled ``id``,
    eviction past 4 songs, the device in the key, and mixes bitwise equal to
    the uncached render;
  * ``equal_loudness_sum`` and ``mix_features`` against the JAX script's at
    1e-5 relative (the stereo width and imbalance, ratios of near-equal
    energies, relative to 1);
  * the slice as a whole: ``scripts/eval_all_combo_torch.py``'s ``main`` on
    a 1-song, 2-section examples dir (3 stems of 140,000 samples, one
    silent, a 16-bit wav each) with a tiny model (embed 32, 1 layer, 8
    heads, Cnn14 width 4; window 65,536) whose weights are random values in
    its Flax tree (no init compiled), carried by ``state_dict_from_flax``
    into a port checkpoint: its CSV, column by column within 1e-4 relative
    (width and imbalance: of 1), the console's "fsm" smoother on both sides
    (the smoothers are held in tests/test_torch_console.py;
    tests/test_torch_export.py renders "auto"), against rows built here
    from JAX's ``run_diffmst``, ``loudness_normalize``, ``mix_features``,
    ``mrstft_distance`` and ``si_sdr`` on the same weights;
  * ``optimize_params``: 3 float64 iterations from JAX's raw draws against
    JAX's optax loop, ``AudioFeatureLoss``, the "fsm" smoother (the
    smoothers are held in tests/test_torch_console.py), within 1e-4 of each
    parameter group's max-abs;
  * each script's ``main`` on the CPU with ``--device cpu`` (the model's
    window cut to 65,536 by wrapping the script's ``run_diffmst``; the
    eval layout that ``make_eval_songs_torch.py`` writes), and without it
    (no card here): an error.

The JAX references jit with XLA's optimizations off (their compiles, not
their numbers, are what cost time here).
"""

import csv
import functools
import importlib
import itertools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from diffmst_tpu.console import AdvancedMixConsole as JaxAdvanced  # noqa: E402
from diffmst_tpu.console import ranges as jax_ranges  # noqa: E402
from diffmst_tpu.losses import mrstft_distance as jax_mrstft_distance  # noqa: E402
from diffmst_tpu.losses import si_sdr as jax_si_sdr  # noqa: E402
from diffmst_tpu.models import MixStyleTransferModel as JaxModel  # noqa: E402
from diffmst_tpu.ops import loudness as jax_loudness  # noqa: E402
from diffmst_tpu.utils import audio as jax_audio  # noqa: E402
from diffmst_tpu.utils.inference import run_diffmst as jax_run_diffmst  # noqa: E402
from diffmst_torch.console import AdvancedMixConsole  # noqa: E402
from diffmst_torch.console import ranges  # noqa: E402
from diffmst_torch.data import write_audio  # noqa: E402
from diffmst_torch.models import MixStyleTransferModel  # noqa: E402
from diffmst_torch.ops import loudness  # noqa: E402
from diffmst_torch.utils import audio  # noqa: E402
from diffmst_torch.utils import inference  # noqa: E402
from diffmst_torch.utils.checkpoint import state_dict_from_flax  # noqa: E402
from scripts import eval_all_combo as jax_eval  # noqa: E402
from scripts import online as jax_online  # noqa: E402

ev = importlib.import_module("scripts.eval_all_combo_torch")
online = importlib.import_module("scripts.online_torch")

torch.set_num_threads(1)

SR = 44100.0
TINY = dict(embed_dim=32, num_layers=1, cnn_base_width=4)  # 8 heads, hop 512: the scripts' model
TINY_ARGS = ["--embed_dim", "32", "--num_layers", "1", "--cnn_base_width", "4"]
SECTION = 65536
SONG_LEN = 140000


@pytest.fixture(scope="module")
def jax_fast():
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _scale(name: str, value: float) -> float:
    """What a feature's error is relative to: its own size, but 1 for the
    stereo width and imbalance, ratios of differences of near-equal energies
    (the sum baseline's are exactly 0)."""
    return 1.0 if name.endswith(("stereo_width", "stereo_imbalance")) else max(abs(value), 1e-6)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


# ---------------------------------------------------------------- loudness


def _loudness_f64(x: np.ndarray, sr: float) -> np.ndarray:
    """integrated_loudness_jax's algorithm in float64 NumPy throughout."""
    bs, chs, t = x.shape
    sos = np.asarray(jax_loudness.k_weighting_sos(sr), np.float32).astype(np.float64)
    h = np.prod(np.fft.rfft(sos[:, :3], n=t) / np.fft.rfft(sos[:, 3:], n=t), axis=0)
    w = np.fft.irfft(np.fft.rfft(x, n=t) * h, n=t)
    block = int(round(0.4 * sr))
    step = block // 4
    if t < block:
        z = np.mean(w**2, axis=-1, keepdims=True).transpose(0, 2, 1)
    else:
        csum = np.concatenate([np.zeros((bs, chs, 1)), np.cumsum(w**2, axis=-1)], axis=-1)
        starts = step * np.arange((t - block) // step + 1)
        z = ((csum[:, :, starts + block] - csum[:, :, starts]) / block).transpose(0, 2, 1)
    g = jax_loudness._CHANNEL_G[:chs]
    lufs = lambda p: -0.691 + 10.0 * np.log10(np.maximum(p, 1e-12))  # noqa: E731
    l_blk = lufs((z * g).sum(-1))

    def gated_mean(mask):
        m = mask[..., None].astype(np.float64)
        return (z * m).sum(1) / np.maximum(m.sum(1), 1.0)

    above = l_blk > -70.0
    gamma = lufs((gated_mean(above) * g).sum(-1)) - 10.0
    return lufs((gated_mean(above & (l_blk > gamma[:, None])) * g).sum(-1))


@pytest.mark.parametrize("t", [44100, 8820], ids=["1s", "0.2s"])
def test_integrated_loudness_torch_matches_jax(t, jax_fast):
    rng = np.random.default_rng(t)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * np.arange(t) / SR)
    x = rng.normal(size=(2, 2, t)) * env * np.array([0.1, 0.003])[:, None, None]
    x[1, 1] *= 1e-4  # one quiet channel: the gates drop blocks
    x32 = x.astype(np.float32)
    jax_lufs = jax.jit(jax_loudness.integrated_loudness_jax, static_argnums=1)
    got32 = loudness.integrated_loudness_torch(torch.from_numpy(x32), SR)
    want32 = np.asarray(jax_lufs(jnp.asarray(x32), SR))
    assert got32.dtype == torch.float32 and got32.shape == (2,)
    assert np.abs(got32.numpy() - want32).max() <= 1e-3
    got64 = loudness.integrated_loudness_torch(torch.from_numpy(x), SR).numpy()
    assert np.abs(got64 - _loudness_f64(x, SR)).max() <= 1e-6
    with jax.enable_x64(True):
        want64 = np.asarray(jax_lufs(jnp.asarray(x), SR))
    # JAX's complex64 response puts its float64 run 0.9e-5 to 1.0e-5 LU off
    # the float64 algorithm here, the port 1e-12
    assert np.abs(got64 - want64).max() <= 3e-5


def test_loudness_normalize_matches_jax():
    rng = np.random.default_rng(1)
    x = (0.05 * rng.normal(size=(20000, 2))).astype(np.float32)
    got = loudness.loudness_normalize(x, SR, -22.0)
    np.testing.assert_array_equal(got, jax_loudness.loudness_normalize(x, SR, -22.0))
    assert abs(loudness.integrated_loudness(got, SR) + 22.0) < 1e-4
    silent = np.zeros((20000, 2), np.float32)
    assert loudness.loudness_normalize(silent, SR, -22.0) is silent


# ------------------------------------------------------ crops, fade, ranges


@pytest.mark.parametrize("length", [1000, 999, 1001, 1])
def test_crops_match_jax(length):
    x = np.random.default_rng(2).normal(size=(2, 3, 1001)).astype(np.float32)
    for port, ref in ((audio.center_crop, jax_audio.center_crop), (audio.causal_crop, jax_audio.causal_crop)):
        got = port(torch.from_numpy(x), length).numpy()
        want = np.asarray(ref(jnp.asarray(x), length))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fade_ms", [10.0, 3.0])
def test_fade_matches_jax(fade_ms):
    x = np.random.default_rng(3).normal(size=(2, 2, 4000)).astype(np.float32)
    before = x.copy()
    xt = torch.from_numpy(x)
    got = audio.fade_in_and_fade_out(xt, fade_ms).numpy()
    want = np.asarray(jax_audio.fade_in_and_fade_out(jnp.asarray(x), fade_ms))
    np.testing.assert_array_equal(x, before)  # the input is not edited
    # the ramps within one float32 ulp of 1.0: |got - want| <= eps * |x|
    assert np.all(np.abs(got - want) <= np.finfo(np.float32).eps * np.abs(x))
    n = int(fade_ms * 1e-3 * SR)
    np.testing.assert_array_equal(got[..., n:-n], x[..., n:-n])
    assert got[..., 0].max() == 0.0 and got[..., -1].max() == 0.0


def test_validate_normalized_matches_jax():
    good = {"eq": {"gain": np.array([0.0, 0.5, 1.0], np.float32)}}
    ranges.validate_normalized({e: {k: torch.from_numpy(v) for k, v in p.items()} for e, p in good.items()})
    jax_ranges.validate_normalized(good)
    for bad in ({"compressor": {"ratio": np.array([0.2, 1.25], np.float32)}},
                {"eq": {"gain": np.array([0.5], np.float32)}, "fader": {"gain_db": np.array([-0.1, 0.3], np.float32)}}):
        with pytest.raises(ValueError) as want:
            jax_ranges.validate_normalized({e: {k: jnp.asarray(v) for k, v in p.items()} for e, p in bad.items()})
        with pytest.raises(ValueError) as got:
            ranges.validate_normalized({e: {k: torch.from_numpy(v) for k, v in p.items()} for e, p in bad.items()})
        assert str(got.value) == str(want.value)


# --------------------------------------------------------- the track cache


@pytest.fixture(scope="module")
def small_port_model():
    """tests/test_torch_inference.py's small model (hop 128: a 16,384-sample
    window)."""
    return MixStyleTransferModel.build(embed_dim=32, num_layers=1, nhead=4, n_fft=2048, hop_length=128,
                                       cnn_base_width=4, device="cpu", generator=torch.Generator().manual_seed(4))


def _song(seed, n=3, total=SONG_LEN, silent=None):
    rng = np.random.default_rng(seed)
    t = np.arange(total) / SR
    tracks = np.empty((1, n, total), np.float32)
    for k in range(n):
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.5, 3.0) * t)
        tracks[0, k] = rng.uniform(0.05, 0.3) * env * rng.normal(size=total)
    if silent is not None:
        tracks[0, silent] = 0.0
    ref = (0.1 * rng.normal(size=(1, 2, total))).astype(np.float32)
    return tracks, ref


def test_track_cache(small_port_model):
    inference.clear_track_cache()
    dev = torch.device("cpu")
    tracks, ref = _song(5, total=20000)
    console = AdvancedMixConsole(SR, device="cpu")

    def mix(t):
        return inference.run_diffmst(t, ref, small_port_model, console, analysis_len=16384, device="cpu")[0]

    before = inference.track_uploads
    first, second = mix(tracks), mix(tracks)
    assert inference.track_uploads - before == 1  # one upload for two calls on one array
    inference.clear_track_cache()
    uncached = mix(tracks)
    assert inference.track_uploads - before == 2
    np.testing.assert_array_equal(first, second)
    np.testing.assert_array_equal(first, uncached)

    # a new array of the same shape and values misses
    before = inference.track_uploads
    inference._device_tracks(tracks.copy(), 80000, 0, dev)
    inference._device_tracks(tracks, 80000, 0, dev)
    assert inference.track_uploads - before == 2
    # a recycled id: an entry under this array's id that holds another array
    fresh = tracks.copy()
    other = inference._device_tracks(tracks, 90000, 0, dev)
    key = (id(fresh), fresh.shape, 90000, 0, "cpu")
    inference._TRACK_CACHE[key] = (tracks, other)
    got = inference._device_tracks(fresh, 90000, 0, dev)
    assert got is not other and inference._TRACK_CACHE[key][0] is fresh
    # the device is in the key: a song cached for one device is not served to another
    before = inference.track_uploads
    on_meta = inference._device_tracks(tracks, 80000, 0, torch.device("meta"))
    on_cpu = inference._device_tracks(tracks, 80000, 0, dev)
    assert on_meta.device.type == "meta" and on_cpu.device.type == "cpu"
    assert inference.track_uploads - before == 1
    # eviction past _TRACK_CACHE_SONGS songs, least recently used first
    inference.clear_track_cache()
    songs = [tracks.copy() for _ in range(inference._TRACK_CACHE_SONGS + 1)]
    for s in songs:
        inference._device_tracks(s, 80000, 0, dev)
    assert len(inference._TRACK_CACHE) == inference._TRACK_CACHE_SONGS
    before = inference.track_uploads
    inference._device_tracks(songs[-1], 80000, 0, dev)
    assert inference.track_uploads == before  # the newest is kept
    inference._device_tracks(songs[0], 80000, 0, dev)
    assert inference.track_uploads == before + 1  # the oldest was evicted
    inference.clear_track_cache()


# -------------------------------------------------------- eval_all_combo


@pytest.fixture(scope="module")
def flax_tiny(jax_fast):
    """Random values in the Flax tree of the scripts' tiny model (BatchNorm
    variances in (0.5, 1.5), the rest 0.1 x N(0, 1)), its heads narrowed (as
    tests/test_torch_inference.py's fixture, so the mixes stay near full
    scale), as JAX's apply and as a port checkpoint's state dict."""
    jmodel = JaxModel.build(**TINY)
    x = jnp.zeros((1, 2, SECTION), jnp.float32)
    rng = np.random.default_rng(1)

    def fill(path, s):  # random values in the Flax tree: no init compiled
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(s.dtype)
        return (0.1 * rng.standard_normal(s.shape)).astype(s.dtype)

    variables = jax.tree_util.tree_map_with_path(fill, jax.eval_shape(jmodel.init, jax.random.PRNGKey(1), x, x))
    variables = {k: dict(v) for k, v in variables.items()}
    ctrl = variables["params"]["controller"] = dict(variables["params"]["controller"])
    for head in ("track_projection", "fx_bus_projection", "master_bus_projection"):
        ctrl[head] = {"kernel": ctrl[head]["kernel"] * 0.1, "bias": np.zeros_like(ctrl[head]["bias"])}
    ctrl["track_projection"]["bias"][0] = np.log(0.8 / 0.2)
    apply = jax.jit(jmodel.apply)
    return (lambda t, r: apply(variables, t, r)), state_dict_from_flax(variables)


def _window(monkeypatch, *scripts):
    """The scripts' ``run_diffmst`` at the tiny model's 65,536-sample window
    (the scripts take JAX's 262,144)."""
    for script in scripts:
        module = importlib.import_module(f"scripts.{script}")
        monkeypatch.setattr(module, "run_diffmst", functools.partial(inference.run_diffmst, analysis_len=SECTION))


def test_eval_all_combo_matches_jax(tmp_path, flax_tiny, monkeypatch, capsys):
    """The slice as a whole: the port's eval CSV against rows built from
    JAX's functions on the same song and weights."""
    apply, state = flax_tiny
    _window(monkeypatch, "eval_all_combo_torch")
    tracks, ref = _song(7, silent=2)
    song = tmp_path / "songs" / "song_00"
    for j in range(tracks.shape[1]):
        write_audio(str(song / "tracks" / f"stem_{j:02d}.wav"), np.stack([tracks[0, j]] * 2), int(SR))
    write_audio(str(song / "ref.wav"), ref[0], int(SR))
    ckpt = tmp_path / "model.pt"
    torch.save({"model": state}, ckpt)

    before = inference.track_uploads
    rows = ev.main(["--examples_dir", str(tmp_path / "songs"), "--output_dir", str(tmp_path / "out"),
                    "--ckpt", str(ckpt), "--section_len", str(SECTION), "--comp_smoother", "fsm", "--device", "cpu", *TINY_ARGS])
    assert inference.track_uploads - before == 1  # one upload for the song's four requests
    with open(tmp_path / "out" / "results.csv") as f:
        got = list(csv.DictReader(f))
    assert len(got) == len(rows) == 8
    assert (tmp_path / "out" / "song_00_t65536_r0_diffmst.wav").exists()

    j_tracks, j_ref = jax_eval.load_song(str(song))  # the wavs as JAX reads them
    console = JaxAdvanced(SR, comp_smoother="fsm")
    distance, sisdr = jax.jit(jax_mrstft_distance), jax.jit(jax_si_sdr)
    want = []
    for ti, ri in itertools.product([0, SECTION], [0, SECTION]):
        methods = {"sum": jax_eval.equal_loudness_sum(j_tracks)}
        methods["diffmst"] = jax_run_diffmst(j_tracks, j_ref, apply, console, track_start_idx=ti,
                                             ref_start_idx=ri, analysis_len=SECTION)[0]
        for method, mix in methods.items():
            mix = jax_loudness.loudness_normalize(np.asarray(mix[0]).T, SR, -22.0).T[None]
            row = {"song": "song_00", "method": method, "track_start": ti, "ref_start": ri}
            row.update({f"mix_{k}": v for k, v in jax_eval.mix_features(mix).items()})
            row.update({f"ref_{k}": v for k, v in jax_eval.mix_features(j_ref).items()})
            n = min(mix.shape[-1], j_ref.shape[-1])
            row["mrstft_to_ref"] = float(distance(jnp.asarray(mix[..., :n]), jnp.asarray(j_ref[..., :n])))
            row["sisdr_to_ref"] = float(sisdr(jnp.asarray(mix[..., :n]), jnp.asarray(j_ref[..., :n])))
            want.append(row)
    assert [list(r) for r in got] == [list(r) for r in want]  # the same columns, in order
    for g, w in zip(got, want):
        for k, v in w.items():
            if isinstance(v, str):
                assert g[k] == v
            else:
                assert abs(float(g[k]) - v) <= 1e-4 * _scale(k, v), (g["method"], k, g[k], v)
    # each track section is its own request: their mixes differ
    assert len({tuple(v for k, v in r.items() if k.startswith("mix_")) for r in got
                if r["method"] == "diffmst" and r["ref_start"] == "0"}) == 2


def test_equal_loudness_sum_and_features_match_jax():
    """On another song of the slice test's length (JAX's eager ops compiled
    there serve here)."""
    tracks, ref = _song(6, silent=2)
    got_sum = ev.equal_loudness_sum(tracks)
    want_sum = jax_eval.equal_loudness_sum(tracks)
    assert _rel(got_sum, want_sum) <= 1e-5
    for mix in (got_sum, ref):
        got, want = ev.mix_features(mix), jax_eval.mix_features(mix)
        assert list(got) == list(want)
        for k in got:
            assert abs(got[k] - want[k]) <= 1e-5 * _scale(k, want[k]), k


# ------------------------------------------------------------------ online


def test_optimize_params_matches_optax(jax_fast):
    """3 float64 Adam iterations of the online loop from JAX's raw draws."""
    rng = np.random.default_rng(8)
    tracks = 0.05 * rng.normal(size=(1, 3, 16384))
    ref = 0.1 * rng.normal(size=(1, 2, 16384))
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(True):
        k1, k2, k3 = jax.random.split(key, 3)
        init = {"track": 0.1 * jax.random.normal(k1, (1, 3, 27), jnp.float64),
                "fx": 0.1 * jax.random.normal(k2, (1, 25), jnp.float64),
                "master": 0.1 * jax.random.normal(k3, (1, 26), jnp.float64)}
        want = jax_online.optimize_params(jnp.asarray(tracks), jnp.asarray(ref),
                                          JaxAdvanced(SR, comp_smoother="fsm"), n_iters=3, lr=0.01, key=key)
        init = {k: np.asarray(v) for k, v in init.items()}
    got = online.optimize_params(torch.from_numpy(tracks), torch.from_numpy(ref),
                                 AdvancedMixConsole(SR, comp_smoother="fsm", device="cpu"),
                                 n_iters=3, lr=0.01, init_raw=init)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.float64
        assert _rel(g.numpy(), w) <= 1e-4
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)  # the losses logged: iterations 0 and 2
    assert got[3][-1] < got[3][0]


# ------------------------------------------------------------- the scripts


def test_make_eval_songs(tmp_path):
    """The eval layout: song_XX/tracks/stem_YY.wav (8 stems, peak -48 dBFS)
    and a peak-normalized ref.wav."""
    from diffmst_torch.data import read_audio

    dirs = importlib.import_module("scripts.make_eval_songs_torch").main(
        ["--out", str(tmp_path), "--n", "2", "--t", "8192", "--device", "cpu"])
    assert [Path(d).name for d in dirs] == ["song_00", "song_01"]
    stems = sorted((Path(dirs[0]) / "tracks").iterdir())
    assert [p.name for p in stems] == [f"stem_{j:02d}.wav" for j in range(8)]
    stem, _ = read_audio(str(stems[0]))
    ref, _ = read_audio(str(Path(dirs[0]) / "ref.wav"))
    assert stem.shape == ref.shape == (2, 8192)
    assert abs(np.abs(stem).max() - 10 ** (-48 / 20)) < 1e-4 and abs(np.abs(ref).max() - 1.0) < 1e-3


@pytest.fixture(scope="module")
def examples(tmp_path_factory):
    """One song of 70,000 samples (3 stems, the last silent) in the eval
    layout, and a port checkpoint of the tiny model."""
    root = tmp_path_factory.mktemp("examples")
    song = root / "songs" / "song_00"
    tracks, ref = _song(9, total=70000, silent=2)
    for j in range(tracks.shape[1]):
        write_audio(str(song / "tracks" / f"stem_{j:02d}.wav"), np.stack([tracks[0, j]] * 2), int(SR))
    write_audio(str(song / "ref.wav"), ref[0], int(SR))
    model = MixStyleTransferModel.build(**TINY, device="cpu", generator=torch.Generator().manual_seed(5))
    torch.save({"model": model.state_dict()}, root / "model.pt")
    return root, song


def test_scripts_run_on_the_cpu(examples, tmp_path, monkeypatch, capsys):
    root, song = examples
    ckpt = str(root / "model.pt")
    cpu = ["--device", "cpu", *TINY_ARGS]
    _window(monkeypatch, "run_torch", "eval_listen_torch", "eval_ablation_torch")

    mix = importlib.import_module("scripts.run_torch").main(
        ["--track_dir", str(song / "tracks"), "--ref", str(song / "ref.wav"), "--output", str(tmp_path / "r.wav"),
         "--ckpt", ckpt, *cpu])
    assert mix.shape == (1, 2, 70000) and np.isfinite(mix).all() and (tmp_path / "r.wav").exists()

    written = importlib.import_module("scripts.eval_listen_torch").main(
        ["--examples_dir", str(root / "songs"), "--output_dir", str(tmp_path / "listen"), "--ckpt", ckpt,
         "--levels", "-24", "-12", *cpu])
    assert [Path(w).name for w in written] == ["sec0_ref-24lufs.wav", "sec0_ref-12lufs.wav"]

    rows = importlib.import_module("scripts.eval_ablation_torch").main(
        ["--examples_dir", str(root / "songs"), "--output_dir", str(tmp_path / "abl"), "--ckpt", ckpt, *cpu])
    assert [r["ablation"] for r in rows] == ["full", "mono", "quiet", "lowpassed"]
    assert (tmp_path / "abl" / "ablation.csv").exists()

    gains = importlib.import_module("scripts.gain_testing_torch").main(
        ["--track_dir", str(song / "tracks"), "--length", "65536", "--ckpt", ckpt, *cpu])
    assert list(gains) == ["stem_00.wav", "stem_01.wav"]  # the silent stem is gated
    assert all(-48.0 <= g <= 48.0 for d in gains.values() for g in d.values())

    hist = online.main(["--track_dir", str(song / "tracks"), "--ref", str(song / "ref.wav"),
                        "--output", str(tmp_path / "o.wav"), "--n_iters", "2", "--block_len", "16384",
                        "--device", "cpu"])
    assert len(hist) == 2 and np.isfinite(hist).all() and (tmp_path / "o.wav").exists()


@pytest.mark.parametrize("script, argv", [
    ("eval_all_combo_torch", ["--examples_dir", "x", "--output_dir", "y"]),
    ("run_torch", ["--track_dir", "x", "--ref", "y", "--output", "z"]),
    ("eval_listen_torch", ["--examples_dir", "x", "--output_dir", "y", "--ckpt", "z"]),
    ("eval_ablation_torch", ["--examples_dir", "x", "--output_dir", "y", "--ckpt", "z"]),
    ("gain_testing_torch", ["--track_dir", "x"]),
    ("online_torch", ["--track_dir", "x", "--ref", "y", "--output", "z"]),
    ("make_eval_songs_torch", ["--out", "x"]),
])
def test_scripts_run_on_the_card_unless_told(script, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        importlib.import_module(f"scripts.{script}").main(argv)
