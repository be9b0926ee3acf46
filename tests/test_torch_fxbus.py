"""The PyTorch port's fx bus (the send sum and the noise-shaped reverb), the
console and ``run_diffmst`` with it, and the knowledge-engineering (KE)
mixer, against the JAX package's.

The same numpy inputs, made from a seed, go through both packages on the
CPU. JAX draws the reverb's noise from its key (``ops/reverb.py``:
``jax.random.normal``); the port takes that draw as ``noise=``. The reverb
runs at 4,096 samples and 63 taps (the console's ``reverb_num_samples`` and
``reverb_num_taps``), the console at 2 x 3 x 8,192 with the compressor's
"fsm" smoother on both sides: this file holds the fx bus, and
``tests/test_torch_console.py`` holds the smoothers, whose JAX scans
compile for seconds each. ``run_diffmst`` renders a 40,000-sample song at
an analysis window of 16,384: its streaming context, 4,096 samples, is the
reverb's length, as 65,536 is at the shipped sizes.

Tolerances: the filterbank, the FFT length and ``sample_ke_params``
bitwise; outputs within 1e-4 of the max-abs (BASELINE.md, "Numerical
parity"); gradients in float64 on both sides within 1e-4 of each
cotangent's max-abs. JAX's references are jitted with XLA's optimization
passes off, which compiles them faster and computes the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmst_tpu.console import AdvancedMixConsole as JaxConsole
from diffmst_tpu.mixing import knowledge as jax_knowledge
from diffmst_tpu.ops import basic as jax_basic
from diffmst_tpu.ops import reverb as jax_reverb
from diffmst_tpu.utils.inference import run_diffmst as jax_run_diffmst
from diffmst_torch.console import AdvancedMixConsole
from diffmst_torch.mixing import knowledge
from diffmst_torch.ops import basic, reverb
from diffmst_torch.utils.inference import run_diffmst

torch.set_num_threads(1)

TOL = 1e-4
SR = 44100.0
N_IR, TAPS = 4096, 63
FX = dict(reverb_num_samples=N_IR, reverb_num_taps=TAPS, comp_smoother="fsm")
REVERB_NAMES = [f"band{i}_gain" for i in range(12)] + [f"band{i}_decay" for i in range(12)] + ["mix"]


@pytest.fixture(scope="module")
def jax_fast():
    """XLA's optimization passes off for the module's JAX references."""
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _rel(port, ref) -> float:
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def _jax_noise(key, bs, dtype=jnp.float32):
    """JAX's reverb draw for a (bs, 2, T) bus of ``dtype`` (``ops/reverb.py``;
    a float64 draw from a key differs from the float32 one)."""
    with jax.enable_x64(dtype == jnp.float64):
        return np.array(jax.random.normal(key, (bs, 2, 12, N_IR + TAPS - 1), dtype))


# ------------------------------------------------------------ the pieces


def test_fft_length_and_filterbank_are_bitwise_jax():
    for n in [*range(1, 2049), 67580, 69120, 196607, 327679]:
        assert reverb.next_fast_len(n) == jax_reverb.next_fast_len(n), n
    for taps, sr in ((63, 44100.0), (1023, 44100.0), (255, 48000.0)):
        assert np.array_equal(reverb.octave_band_filterbank(taps, sr),
                              jax_reverb.octave_band_filterbank(taps, sr))


@pytest.mark.parametrize("mode", ["causal", "full", "valid"])
def test_fft_convolve_matches_jax(mode):
    rng = np.random.default_rng(0)
    x, h = rng.normal(size=(2, 3, 1000)), rng.normal(size=(3, 37))
    with jax.enable_x64(True):
        ref = jax_reverb.fft_convolve(jnp.asarray(x), jnp.asarray(h), mode)
    got = reverb.fft_convolve(torch.from_numpy(x), torch.from_numpy(h), mode)
    assert _rel(got, ref) <= 1e-12
    with pytest.raises(ValueError, match="unknown mode"):
        reverb.fft_convolve(torch.from_numpy(x), torch.from_numpy(h), "same")


def test_stereo_bus_matches_jax():
    rng = np.random.default_rng(1)
    x, send = rng.normal(size=(2, 2, 3, 500)), rng.uniform(-80.0, 12.0, size=(2, 3))
    w = rng.normal(size=(2, 2, 500))
    with jax.enable_x64(True):
        ref, vjp = jax.vjp(lambda a, s: jax_basic.stereo_bus(a, SR, s), jnp.asarray(x), jnp.asarray(send))
        ref_grads = vjp(jnp.asarray(w))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, send)]
    out = basic.stereo_bus(leaves[0], SR, leaves[1])
    assert _rel(out, ref) <= 1e-12
    (out * torch.from_numpy(w)).sum().backward()
    for leaf, r in zip(leaves, ref_grads):
        assert _rel(leaf.grad, r) <= 1e-12


def _reverb_inputs(bs=2, t=8192):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(bs, 2, t)) * np.linspace(0.3, 0.0, t)
    params = rng.uniform(0.0, 1.0, size=(25, bs))
    return x, params, rng.normal(size=(bs, 2, t))


def test_reverb_matches_jax_on_its_noise(jax_fast):
    """The reverb on JAX's float64 draw, in float64 on both sides: the
    output, and the gradients by the bus, the 24 band parameters and the
    wet/dry mix (the console forces it to 1; here it varies); the port's
    float32 output on the same noise within 1e-4 too."""
    x, params, w = _reverb_inputs()
    key = jax.random.PRNGKey(3)
    kw = dict(num_samples=N_IR, num_bandpass_taps=TAPS)
    with jax.enable_x64(True):
        ref, vjp = jax.vjp(jax.jit(lambda a, p: jax_reverb.noise_shaped_reverberation(
            a, SR, **dict(zip(REVERB_NAMES, p)), key=key, **kw)), jnp.asarray(x), jnp.asarray(params))
        ref_grads = vjp(jnp.asarray(w))
    noise = torch.from_numpy(_jax_noise(key, 2, jnp.float64))
    got32 = reverb.noise_shaped_reverberation(
        torch.from_numpy(x).float(), SR, **dict(zip(REVERB_NAMES, torch.from_numpy(params).float())),
        noise=noise.float(), **kw)
    assert got32.dtype == torch.float32 and _rel(got32, ref) <= TOL
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, params)]
    out = reverb.noise_shaped_reverberation(leaves[0], SR, **dict(zip(REVERB_NAMES, leaves[1])), noise=noise, **kw)
    assert _rel(out, ref) <= TOL
    (out * torch.from_numpy(w)).sum().backward()
    for leaf, r in zip(leaves, ref_grads):
        assert _rel(leaf.grad, r) <= TOL


def test_reverb_noise_rule():
    """Drawn noise: the generator's state decides it (the same state, the
    same reverb; the default is a generator seeded 0), and a passed noise of
    the wrong shape is refused."""
    x, params, _ = _reverb_inputs(bs=1, t=2048)
    args = dict(zip(REVERB_NAMES, torch.from_numpy(params).float()))
    xt = torch.from_numpy(x).float()

    def run(**kw):
        return reverb.noise_shaped_reverberation(xt, SR, **args, num_samples=1024, num_bandpass_taps=31, **kw)

    a = run(generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, run(generator=torch.Generator().manual_seed(5)))
    assert not torch.equal(a, run(generator=torch.Generator().manual_seed(6)))
    assert torch.equal(run(), run(generator=torch.Generator().manual_seed(0)))
    noise = reverb.draw_reverb_noise(torch.Generator().manual_seed(5), reverb.reverb_noise_shape(1, 2, 1024, 31),
                                     torch.device("cpu"))
    assert torch.equal(a, run(noise=noise))
    with pytest.raises(ValueError, match="reverb noise of shape"):
        run(noise=noise[..., 1:])


# ------------------------------------------------------------ the console


def _console_inputs(seed=4, bs=2, n=3, t=8192):
    rng = np.random.default_rng(seed)
    env = np.abs(np.sin(np.linspace(0.0, 6.0 * np.pi, t)))
    tracks = rng.normal(size=(bs, n, t)) * 0.2 * env
    tp = rng.uniform(0.05, 0.95, size=(bs, n, 27))
    fp = rng.uniform(0.05, 0.95, size=(bs, 25))
    mp = rng.uniform(0.05, 0.95, size=(bs, 26))
    tp[..., 0] = rng.uniform(0.4, 0.6, size=(bs, n))  # faders within +-9.6 dB
    tp[..., 26] = rng.uniform(0.75, 0.95, size=(bs, n))  # sends of -11 to +7 dB
    mp[:, 24:] = rng.uniform(0.4, 0.6, size=(bs, 2))
    return tracks, tp, fp, mp


def test_console_with_fx_bus_matches_jax(jax_fast):
    """The console with the fx bus on JAX's float64 noise: the port's
    float32 stems and mix within 1e-4 of JAX's float64 ones; in float64 the
    gradients of sum(mix * w) by the stems and all three parameter vectors
    (the fx bus's through the reverb)."""
    tracks, tp, fp, mp = _console_inputs()
    w = np.random.default_rng(5).normal(size=(2, 2, tracks.shape[-1]))
    key = jax.random.PRNGKey(7)
    jc = JaxConsole(SR, **FX)
    with jax.enable_x64(True):
        (stems, mix), vjp = jax.vjp(jax.jit(lambda *a: tuple(jc(*a, key=key)[:2])),
                                    *(jnp.asarray(a) for a in (tracks, tp, fp, mp)))
        ref_grads = vjp((jnp.zeros_like(stems), jnp.asarray(w)))
    noise = torch.from_numpy(_jax_noise(key, 2, jnp.float64))
    out = AdvancedMixConsole(SR, **FX, device="cpu")(
        *(a.astype(np.float32) for a in (tracks, tp, fp, mp)), noise=noise.float())
    assert out.mix.dtype == torch.float32 and out.mix.shape == (2, 2, 8192)
    np.testing.assert_allclose(out.mixed_tracks.numpy(), np.asarray(stems), rtol=0, atol=TOL)
    np.testing.assert_allclose(out.mix.numpy(), np.asarray(mix), rtol=0, atol=TOL)
    dry = AdvancedMixConsole(SR, **FX, device="cpu")(
        *(a.astype(np.float32) for a in (tracks, tp, fp, mp)), use_fx_bus=False)
    assert float((out.mix - dry.mix).abs().max()) > 0.01 * float(dry.mix.abs().max())  # the reverb is heard

    leaves = [torch.from_numpy(a).requires_grad_() for a in (tracks, tp, fp, mp)]
    mix = AdvancedMixConsole(SR, **FX, device="cpu")(*leaves, noise=noise).mix
    (mix * torch.from_numpy(w)).sum().backward()
    for name, leaf, r in zip(("dtracks", "dtrack_params", "dfx_params", "dmaster_params"), leaves, ref_grads):
        assert _rel(leaf.grad, r) <= TOL, name


# ---------------------------------------------------------- run_diffmst


def _song(total=40000):
    rng = np.random.default_rng(6)
    t = np.arange(total) / SR
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 1.5 * t)
    tracks = np.stack([0.3 * env * rng.normal(size=total), 0.2 * np.sin(2 * np.pi * 220.0 * t) * (1 - env)])
    ref = 0.1 * rng.normal(size=(1, 2, 30000))
    return tracks[None].astype(np.float32), ref.astype(np.float32)


@pytest.mark.parametrize("render_mode", ["ola", "streaming"])
def test_run_diffmst_with_fx_bus_matches_jax(jax_fast, render_mode):
    """A 40,000-sample, 2-track song with fixed predicted parameters and the
    fx bus: the port's render on JAX's request noise (key 0, one draw for
    every window or block) within 1e-4 of JAX's; and the port's own draw
    from a generator is one draw a request too (two calls, one mix)."""
    tracks, ref = _song()
    _, tp, fp, mp = _console_inputs(seed=8, bs=1, n=2)
    analysis = 16384

    def jax_model(t, r):
        return jnp.asarray(tp, jnp.float32), jnp.asarray(fp, jnp.float32), jnp.asarray(mp, jnp.float32)

    def port_model(t, r):
        return tuple(torch.from_numpy(a).float() for a in (tp, fp, mp))

    kw = dict(analysis_len=analysis, use_fx_bus=True, render_mode=render_mode)
    want, *_ = jax_run_diffmst(tracks, ref, jax_model, JaxConsole(SR, **FX), key=jax.random.PRNGKey(0), **kw)
    console = AdvancedMixConsole(SR, **FX, device="cpu")
    got, *_ = run_diffmst(tracks, ref, port_model, console, device="cpu",
                          noise=torch.from_numpy(_jax_noise(jax.random.PRNGKey(0), 4)), **kw)
    assert got.shape == (1, 2, 40000) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    dry, *_ = run_diffmst(tracks, ref, port_model, console, device="cpu", **{**kw, "use_fx_bus": False})
    assert np.abs(got - dry).max() > 0.01 * np.abs(dry).max()
    drawn = [run_diffmst(tracks, ref, port_model, console, device="cpu",
                         generator=torch.Generator().manual_seed(9), **kw)[0] for _ in range(2)]
    np.testing.assert_array_equal(drawn[0], drawn[1])


# ------------------------------------------------------------------- KE


def _ke_dict():
    """A small KE dict of the vendored schema (the JAX tests' kind), with a
    stereo-capable class whose pan has candidates."""
    eq = {k: [0.0, 0.0] for k in ["eq_lowshelf_gain", "eq_band0_gain", "eq_band1_gain",
                                  "eq_band2_gain", "eq_band3_gain", "eq_highshelf_gain"]}
    eq.update({"eq_lowshelf_freq": [50, 200], "eq_lowshelf_q": [1.0, 2.0], "eq_band1_freq": [2000, 8000]})
    comp = {"threshold_db": [-23.0, -20.0], "ratio": [1.0, 4.0], "attack_ms": [10.0, 100.0],
            "release_ms": [10.0, 100.0], "knee_db": [3.0, 5.0], "makeup_gain_db": [2.0, 5.0]}
    return {
        "bass_drum": {"instruments": ["kick", "bass drum"], "gain": [-13.0, -11.0], "pan": [0.5],
                      "eq": eq, "compressor": comp},
        "gtr": {"instruments": ["electric guitar"], "gain": [-9.0, -6.0], "pan": [0.1, 0.3, 0.4],
                "eq": eq, "compressor": comp},
        "fx_bus": {"reverb_gain": {f"band_{i}": [0.0, 1.0] for i in range(12)},
                   "reverb_decay": {f"band_{i}": [0.0, 0.5] for i in range(12)},
                   "mix": [0.0, 1.0], "send_db": [-30.0, 0.0]},
        "master_bus": {"eq": eq, "compressor": comp, "fader": {"gain_db": [-10.0, 0.0]}},
    }


@pytest.mark.parametrize("ke", ["vendored", "small"])
def test_sample_ke_params_is_bitwise_jax(ke):
    """The same np.random.Generator and inputs: the three arrays bitwise
    JAX's, over every vendored class name and unknown names, with stereo
    pairs (mirrored pans) and a YAML without some sections."""
    ke_dict = knowledge.load_vendored_ke() if ke == "vendored" else _ke_dict()
    assert ke_dict == (jax_knowledge._load_vendored_ke() if ke == "vendored" else _ke_dict())
    names = [m for cls, spec in ke_dict.items() if isinstance(spec, dict) for m in spec.get("instruments", [])]
    names += ["unknown", "Electric Guitar (clean)", "theremin"]
    rng = np.random.default_rng(10)
    bs, n = 6, 8
    mdata = [[names[int(i)] for i in rng.integers(len(names), size=n)] for _ in range(bs)]
    stereo = (rng.uniform(size=(bs, n)) < 0.3).astype(np.int64)
    for console_kw in ({}, dict(min_send_db=-60.0, eq_max_gain_db=6.0)):
        got = knowledge.sample_ke_params(ke_dict, mdata, stereo, np.random.default_rng(11),
                                         AdvancedMixConsole(SR, **console_kw, device="cpu"))
        want = jax_knowledge.sample_ke_params(ke_dict, mdata, stereo, np.random.default_rng(11),
                                              JaxConsole(SR, **console_kw))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32 and np.array_equal(g, w)
    del ke_dict["fx_bus"], ke_dict["master_bus"]
    got = knowledge.sample_ke_params(ke_dict, mdata, stereo, np.random.default_rng(12),
                                     AdvancedMixConsole(SR, device="cpu"))
    want = jax_knowledge.sample_ke_params(ke_dict, mdata, stereo, np.random.default_rng(12), JaxConsole(SR))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert knowledge.instrument_metadata(np.array([[1, 2, 9]]), {"kick": 1, "bass": 2}) == [
        ["kick", "bass", "unknown"]]


def test_knowledge_engineering_mix_matches_jax(jax_fast):
    """The whole KE mix from a seed, with the fx bus on JAX's noise: the
    parameters bitwise, the denormalized dicts and the mix within 1e-4; no
    gradient; and a generator's state decides the port's own draw."""
    tracks = _console_inputs(seed=12, bs=2, n=4)[0].astype(np.float32)
    iid = np.array([[1, 2, 3, 3], [3, 3, 1, 9]])
    stereo = np.array([[0, 0, 1, 0], [1, 0, 0, 0]])
    lookup = {"kick": 1, "vocals": 2, "electric guitar": 3}
    kw = dict(instrument_id=iid, stereo_id=stereo, instrument_number_file=lookup, ke_dict=_ke_dict())
    key = jax.random.PRNGKey(13)
    jc = JaxConsole(SR, **FX)
    jitted = jax.jit(lambda *a: jc(*a, key=key))

    class JittedConsole:  # JAX's KE mix through the jitted console
        param_ranges = jc.param_ranges
        num_track_control_params = jc.num_track_control_params
        num_fx_bus_control_params = jc.num_fx_bus_control_params
        num_master_bus_control_params = jc.num_master_bus_control_params

        def __call__(self, *a, key=None, **flags):
            assert flags["use_fx_bus"]
            return jitted(*a)

    want = jax_knowledge.knowledge_engineering_mix(jnp.asarray(tracks), JittedConsole(), key, seed=14, **kw)
    port = AdvancedMixConsole(SR, **FX, device="cpu")
    got = knowledge.knowledge_engineering_mix(torch.from_numpy(tracks), port, seed=14,
                                              noise=torch.from_numpy(_jax_noise(key, 2)), **kw)
    for g, w in zip(got[5:], want[5:]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got.mix.numpy(), np.asarray(want.mix), rtol=0, atol=TOL)
    for group, ref_group in zip(got[2:5], want[2:5]):
        for effect, params in group.items():
            for name, v in params.items():
                np.testing.assert_allclose(v.numpy(), np.asarray(ref_group[effect][name]), rtol=1e-6, atol=1e-5)
    assert not got.mix.requires_grad and abs(float(got.mix.abs().max())) > 0
    drawn = [knowledge.knowledge_engineering_mix(torch.from_numpy(tracks), port, torch.Generator().manual_seed(s),
                                                 **kw) for s in (15, 15, 16)]
    assert torch.equal(drawn[0].mix, drawn[1].mix) and not torch.equal(drawn[0].mix, drawn[2].mix)
    assert knowledge.knowledge_engineering_mix.host_side
