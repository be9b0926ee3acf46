"""The PyTorch port's full-song ``run_diffmst`` against the JAX package's.

Both render the same song (3 tracks of 40,000 samples, a length that fills
no whole number of windows, one track too quiet to pass the -80 LUFS gate)
with the same weights: a Flax model initialized from
``jax.random.PRNGKey(0)`` and carried into the port with
``state_dict_from_flax``. The port runs on the CPU, where its kernel wrappers
take their plain versions. Small size: analysis window 16,384, embed 32, one
layer, 4 heads, n_fft 2048, hop 128, Cnn14 width 4. Both render modes are
compared: "ola" with the default console, "streaming" (overlap-save) with
the causal console (``comp_smoother="decoupled"``, ``eq_method="scan"``).

Tolerance: max-abs <= 1e-4 on the float32 mix (BASELINE.md, "Numerical
parity") and at most 1 LSB on the pcm16 output; 1e-5 on the host renderers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmst_tpu.console import AdvancedMixConsole as JaxAdvanced
from diffmst_tpu.models import MixStyleTransferModel as JaxModel
from diffmst_tpu.utils.inference import overlap_add_render as jax_overlap_add_render
from diffmst_tpu.utils.inference import overlap_save_render as jax_overlap_save_render
from diffmst_tpu.utils.inference import run_diffmst as jax_run_diffmst
from diffmst_torch.console import AdvancedMixConsole
from diffmst_torch.kernels import comp_fused, iir_fused, scan1p
from diffmst_torch.models import MixStyleTransferModel
from diffmst_torch.utils.checkpoint import state_dict_from_flax
from diffmst_torch.utils.inference import overlap_add_render, overlap_save_render, run_diffmst
from test_torch_causal import jax_scan_twins

torch.set_num_threads(1)

ATOL = 1e-4
SR = 44100.0
ANALYSIS = 16384
SMALL = dict(embed_dim=32, num_layers=1, nhead=4, n_fft=2048, hop_length=128, cnn_base_width=4)
CAUSAL = dict(comp_smoother="decoupled", eq_method="scan")


def _song(seed=0, n_tracks=3, total=40000):
    rng = np.random.default_rng(seed)
    t = np.arange(total) / SR
    tracks = np.zeros((1, n_tracks, total), np.float32)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 1.5 * t)
    tracks[0, 0] = 0.3 * env * rng.normal(size=total)
    tracks[0, 1] = 0.2 * np.sin(2 * np.pi * 220.0 * t) * (1.0 - env)
    tracks[0, 2] = 1e-6 * rng.normal(size=total)  # about -120 LUFS: gated
    ref = (0.1 * rng.normal(size=(1, 2, 30000))).astype(np.float32)
    return tracks, ref


@pytest.fixture(scope="module")
def models():
    jmodel = JaxModel.build(**SMALL)
    tracks, ref = _song()
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(tracks[..., :ANALYSIS]), jnp.asarray(ref[..., :ANALYSIS])
    )
    variables = jax.tree.map(np.asarray, {k: dict(v) for k, v in variables.items()})
    # Random heads predict faders anywhere in +-48 dB and drive the mix far
    # past full scale, where float32 error grows with the level: on one such
    # window the jitted JAX console is 6.6e-3 off a float64 render at a peak
    # of 222, the port 1.5e-3 (tests/port_precision_probe.py). Narrow heads
    # with the track faders near +29 dB give a mix peaking near 0.6.
    ctrl = variables["params"]["controller"]
    for head in ("track_projection", "fx_bus_projection", "master_bus_projection"):
        ctrl[head] = {"kernel": ctrl[head]["kernel"] * 0.1, "bias": np.zeros_like(ctrl[head]["bias"])}
    ctrl["track_projection"]["bias"][0] = np.log(0.8 / 0.2)
    apply = jax.jit(jmodel.apply)
    port = MixStyleTransferModel.build(**SMALL, device="cpu")
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    return (lambda t, r: apply(variables, t, r)), port


@pytest.fixture(scope="module")
def jax_mixes(models):
    apply, _ = models
    tracks, ref = _song()
    console = JaxAdvanced(SR)
    out = {}
    for fmt in ("float32", "pcm16"):
        out[fmt] = jax_run_diffmst(
            tracks, ref, apply, console, analysis_len=ANALYSIS, output_format=fmt
        )
    return out


@pytest.mark.parametrize("smoother", ["auto", "scan"])
def test_run_diffmst_matches_jax(models, jax_mixes, smoother):
    _, port = models
    tracks, ref = _song()
    scan1p.onepole_core.launches = 0
    comp_fused.compressor_fused_gain.launches = 0
    console = AdvancedMixConsole(SR, comp_smoother=smoother, device="cpu")
    mix, td, fd, md = run_diffmst(tracks, ref, port, console, analysis_len=ANALYSIS, device="cpu")
    ref_mix, rtd, rfd, rmd = jax_mixes["float32"]
    assert mix.dtype == np.float32 and mix.shape == (1, 2, 40000)
    assert np.isfinite(mix).all() and 0.05 < np.abs(mix).max() < 2.0
    np.testing.assert_allclose(mix, ref_mix, rtol=0, atol=ATOL)
    # the gated track got no slot in the model call: two rows of parameters
    assert td["compressor"]["ratio"].shape == (1, 2)
    for group, ref_group in ((td, rtd), (fd, rfd), (md, rmd)):
        for effect, params in group.items():
            for name, v in params.items():
                np.testing.assert_allclose(
                    v.numpy(), np.asarray(ref_group[effect][name]), rtol=1e-5, atol=1e-5
                )
    # on the CPU the kernel wrappers took their plain versions
    assert scan1p.onepole_core.launches == 0
    assert comp_fused.compressor_fused_gain.launches == 0


def test_run_diffmst_pcm16_matches_jax(models, jax_mixes):
    _, port = models
    tracks, ref = _song()
    pcm, *_ = run_diffmst(
        tracks, ref, port, AdvancedMixConsole(SR, device="cpu"),
        analysis_len=ANALYSIS, output_format="pcm16", device="cpu",
    )
    ref_pcm = jax_mixes["pcm16"][0]
    assert pcm.dtype == np.int16 and pcm.shape == ref_pcm.shape == (1, 2, 40000)
    assert np.abs(pcm.astype(np.int32) - ref_pcm.astype(np.int32)).max() <= 1


def test_run_diffmst_short_song_and_identity_ola():
    """A song shorter than the window: the model sees the whole song, and
    with a pass-through console the Hann OLA gives the song back."""
    rng = np.random.default_rng(5)
    tracks = (0.1 * rng.normal(size=(1, 2, 20000))).astype(np.float32)
    ref = (0.1 * rng.normal(size=(1, 2, 20000))).astype(np.float32)
    seen = {}

    def model(t, r):
        seen["shape"] = tuple(t.shape)
        return torch.full((1, t.shape[1], 2), 0.5), torch.zeros(1, 0), torch.zeros(1, 0)

    class Identity:
        def __call__(self, wins, tp, fp, mp, use_fx_bus=False, noise=None):
            return type("Out", (), {"mix": torch.stack([wins[:, 0], wins[:, 1]], dim=1)})

        def param_dicts(self, tp, fp, mp):
            return {}, {}, {}

    mix, *_ = run_diffmst(tracks, ref, model, Identity(), analysis_len=32768, device="cpu")
    assert seen["shape"] == (1, 2, 20000)
    gains = [10.0 ** ((-48.0 - _lufs(tracks[0, i])) / 20.0) for i in range(2)]
    expect = tracks[0] * np.asarray(gains, np.float32)[:, None]
    np.testing.assert_allclose(mix[0], expect, rtol=0, atol=1e-6)


def _lufs(x):
    from diffmst_torch.ops.loudness import integrated_loudness

    return integrated_loudness(x, SR)


def test_run_diffmst_refuses_what_is_not_ported():
    tracks, ref = _song(total=20000)
    console = AdvancedMixConsole(SR, device="cpu")
    with pytest.raises(ValueError):
        run_diffmst(tracks, ref, None, console, analysis_len=ANALYSIS, render_mode="seamless", device="cpu")
    with pytest.raises(ValueError):
        run_diffmst(tracks, ref, None, console, analysis_len=ANALYSIS, output_format="mp3", device="cpu")
    silent = np.zeros_like(tracks)
    with pytest.raises(ValueError, match="gated"):
        run_diffmst(silent, ref, None, console, analysis_len=ANALYSIS, device="cpu")


def test_run_diffmst_defaults_to_cuda():
    """With no card, run_diffmst(device=None) raises instead of using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    tracks, ref = _song(total=20000)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_diffmst(tracks, ref, None, AdvancedMixConsole(SR, device="cpu"), analysis_len=ANALYSIS)


# ------------------------------------------------------------- streaming


@pytest.fixture(scope="module")
def jax_streaming(models):
    """JAX's streaming mixes of the song with the causal console, float32
    and pcm16 (one compile of its overlap-save render serves both, its scans
    traced as jitted calls: tests/test_torch_causal.py::jax_scan_twins)."""
    apply, _ = models
    tracks, ref = _song()
    console = JaxAdvanced(SR, **CAUSAL)
    with jax_scan_twins():
        return {
            fmt: jax_run_diffmst(tracks, ref, apply, console, analysis_len=ANALYSIS,
                                 render_mode="streaming", output_format=fmt)[0]
            for fmt in ("float32", "pcm16")
        }


def test_run_diffmst_streaming_matches_jax(models, jax_streaming):
    """run_diffmst(render_mode="streaming") with the causal console: eight
    blocks of 8,192 samples after 4,096 of context (five cover the song,
    rounded up to groups of four), against JAX's, float32 and pcm16; and
    ``return_device`` gives the same mix as a tensor."""
    _, port = models
    tracks, ref = _song()
    console = AdvancedMixConsole(SR, **CAUSAL, device="cpu")
    counters = (scan1p.release_min_scan, scan1p.onepole_core, iir_fused.sosfilt)
    for c in counters:
        c.launches = 0
    mix, td, _, _ = run_diffmst(tracks, ref, port, console, analysis_len=ANALYSIS,
                                render_mode="streaming", device="cpu")
    assert mix.dtype == np.float32 and mix.shape == (1, 2, 40000)
    assert np.isfinite(mix).all() and 0.05 < np.abs(mix).max() < 2.0
    np.testing.assert_allclose(mix, jax_streaming["float32"], rtol=0, atol=ATOL)
    assert td["compressor"]["ratio"].shape == (1, 2)  # the gated track got no slot
    assert [c.launches for c in counters] == [0, 0, 0]  # the plain versions ran

    pcm, *_ = run_diffmst(tracks, ref, port, console, analysis_len=ANALYSIS,
                          render_mode="streaming", output_format="pcm16", device="cpu")
    ref_pcm = jax_streaming["pcm16"]
    assert pcm.dtype == np.int16 and pcm.shape == ref_pcm.shape == (1, 2, 40000)
    assert np.abs(pcm.astype(np.int32) - ref_pcm.astype(np.int32)).max() <= 1

    on_dev, *_ = run_diffmst(tracks, ref, port, console, analysis_len=ANALYSIS,
                             render_mode="streaming", output_format="pcm16",
                             return_device=True, device="cpu")
    assert isinstance(on_dev, torch.Tensor) and on_dev.dtype == torch.float32
    np.testing.assert_array_equal(on_dev.numpy(), mix)


def test_host_renderers_match_jax():
    """overlap_add_render and overlap_save_render == JAX's, with the same
    render function written in each framework: one that weights every
    sample by its place in the window, so a window cut or placed wrongly
    shows. A ragged 20,000-sample song; groups of 4 windows."""
    rng = np.random.default_rng(8)
    tracks = (0.3 * rng.normal(size=(1, 3, 20000))).astype(np.float32)

    def renders(length):
        ramp = np.linspace(0.0, 1.0, length, dtype=np.float32)
        ramp_t = torch.from_numpy(ramp)
        port = lambda w: torch.stack([(w * ramp_t).sum(1), torch.tanh(w[:, 0])], dim=1)  # noqa: E731
        ref = lambda w: jnp.stack([(w * ramp).sum(1), jnp.tanh(w[:, 0])], axis=1)  # noqa: E731
        return port, ref

    port, ref = renders(4096)
    np.testing.assert_allclose(
        overlap_add_render(port, tracks, 4096, device="cpu"),
        jax_overlap_add_render(ref, tracks, 4096, render_bs=4), rtol=0, atol=1e-5,
    )
    port, ref = renders(3072)
    np.testing.assert_allclose(
        overlap_save_render(port, tracks, 2048, context_len=1024, device="cpu"),
        jax_overlap_save_render(ref, tracks, 2048, context_len=1024, render_bs=4), rtol=0, atol=1e-5,
    )


def test_streaming_render_matches_one_shot():
    """The port's overlap-save render == one render of the whole song in the
    interior (the compressor's and the causal EQ's state converge inside the
    context), within 1e-3 of the peak; the Hann OLA, which cross-fades
    renders that disagree, is an order of magnitude further off. The seam
    test of the JAX package (tests/test_utils.py::
    test_streaming_render_matches_one_shot), its inputs and geometry, with
    the causal console in place of its "scan" smoother and circular EQ."""
    console = AdvancedMixConsole(SR, **CAUSAL, device="cpu")
    key = jax.random.PRNGKey(0)  # the JAX test's inputs
    total = 98304
    tracks = np.array(jax.random.normal(key, (1, 3, total), jnp.float32) * 10 ** (-24 / 20))
    k1, k2, k3 = jax.random.split(key, 3)
    tp, fp, mp = (torch.from_numpy(np.array(jax.random.uniform(k, shape)))
                  for k, shape in ((k1, (1, 3, 27)), (k2, (1, 25)), (k3, (1, 26))))

    def render(wins):
        n = wins.shape[0]
        return console(wins, tp.expand(n, -1, -1), fp.expand(n, -1), mp.expand(n, -1), use_fx_bus=False).mix

    one = render(torch.from_numpy(tracks)).numpy()
    ols = overlap_save_render(render, tracks, block_len=16384, context_len=16384, device="cpu")
    ola = overlap_add_render(render, tracks, 32768, device="cpu")
    peak = np.abs(one).max()
    # past the first block: the one-shot render's own start differs (the
    # compressor's circular lookahead roll)
    err_ols = np.abs(ols - one)[..., 16384:].max() / peak
    err_ola = np.abs(ola - one)[..., 16384:].max() / peak
    assert err_ols < 1e-3, err_ols
    assert err_ols < 0.1 * err_ola, (err_ols, err_ola)

