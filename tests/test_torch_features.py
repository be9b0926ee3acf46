"""The PyTorch port's audio-feature loss, Bark filterbank and evaluation
metrics against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX functions and
their counterparts in ``diffmst_torch`` on the CPU. The feature inputs are
three 2 x 65,536 mixes: noise, L == R (the side channel exactly zero), and
a silent right channel (the ``maximum(., 1e-8)`` guards' floor).

Tolerances: the filterbank bitwise; values within 1e-4 of the reference's
max-abs (the port's float32 against JAX's float64); gradients in float64
on both sides within 1e-4 of each cotangent's max-abs (BASELINE.md and
ROADMAP Queue 3). JAX's references are jitted with XLA's optimization passes
off, which compiles them faster and computes the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmst_tpu.losses import eval_metrics as jax_eval
from diffmst_tpu.losses import features as jax_features
from diffmst_tpu.losses import filterbank as jax_filterbank
from diffmst_torch.losses import eval_metrics, features, filterbank

torch.set_num_threads(1)

TOL = 1e-4
FEATURES = ["rms", "crest_factor", "stereo_width", "stereo_imbalance", "barkspectrum", "melspectrum"]


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


def _mixes(seed=0, t=65536):
    """Noise, L == R and a silent right channel, float64."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 2, t)) * np.linspace(0.05, 0.3, t)
    x[1, 1] = x[1, 0]
    x[2, 1] = 0.0
    return x


# ------------------------------------------------------------- filterbank


@pytest.mark.parametrize("args", [
    (16385, 20.0, 20000.0, 24, 44100),  # the loss's, at 32,768 points
    (2049, 20.0, 20000.0, 24, 44100),
    (4097, 50.0, 16000.0, 40, 48000),
    (1025, 20.0, 8000.0, 16, 22050, "schroeder"),
    (1025, 20.0, 8000.0, 16, 22050, "wang"),
], ids=["loss", "n4096", "sr48k", "schroeder", "wang"])
def test_bark_filterbank_is_bitwise_jax(args):
    fb = filterbank.barkscale_fbanks(*args)
    ref = jax_filterbank.barkscale_fbanks(*args)
    assert fb.dtype == np.float32 and fb.shape == (args[0], args[3])
    assert np.array_equal(fb, ref)
    scale = args[5] if len(args) > 5 else "traunmuller"
    for f in (0.0, 20.0, 150.0, 1000.0, 19000.0):
        assert filterbank.hz_to_bark(f, scale) == jax_filterbank.hz_to_bark(f, scale)
    barks = np.linspace(-1.0, 25.0, 53)
    assert np.array_equal(filterbank.bark_to_hz(barks, scale), jax_filterbank.bark_to_hz(barks, scale))


# --------------------------------------------------------------- features


@pytest.fixture(scope="module")
def jax_feature_refs(jax_fast):
    """Each JAX feature in float64 on the six mixes: its value and the
    gradient of sum(feature * w) for a seeded cotangent w."""
    x = _mixes()
    rng = np.random.default_rng(1)
    refs = {}
    with jax.enable_x64(True):
        for name in FEATURES:
            fn = getattr(jax_features, f"compute_{name}")
            shape = jax.eval_shape(fn, jax.ShapeDtypeStruct(x.shape, jnp.float64)).shape
            w = rng.normal(size=shape)
            value, vjp = jax.vjp(jax.jit(fn), jnp.asarray(x))
            refs[name] = (np.asarray(value), w, np.asarray(vjp(jnp.asarray(w))[0]))
    return refs


@pytest.mark.parametrize("name", FEATURES)
def test_feature_and_gradient_match_jax(jax_feature_refs, name):
    """The feature in float32 against JAX's float64 value, and its float64
    gradient, on noise, on L == R and on a silent channel."""
    value, w, grad = jax_feature_refs[name]
    fn = getattr(features, f"compute_{name}")
    x = _mixes()
    assert _rel(fn(torch.from_numpy(x.astype(np.float32))), value) <= TOL
    x64 = torch.from_numpy(x).requires_grad_()
    (fn(x64) * torch.from_numpy(w)).sum().backward()
    assert torch.isfinite(x64.grad).all()
    assert _rel(x64.grad, grad) <= TOL
    if name in ("stereo_width", "barkspectrum"):
        # the mixes are independent: L == R and the silent channel carry
        # their own gradient, held here on its own
        for i in (1, 2):
            assert _rel(x64.grad[i], grad[i]) <= TOL


@pytest.fixture(scope="module")
def jax_loss_ref(jax_fast):
    """JAX's AudioFeatureLoss (the shipped weights) in float64 on a
    2 x 2 x 65,536 prediction (L == R, and a silent channel) against noise:
    each named term, and the gradient of their sum by pred."""
    x = _mixes()[1:]  # L == R, and a silent channel
    target = _mixes(seed=2)[:2]
    loss = jax_features.AudioFeatureLoss(sample_rate=44100, weights=(0.1, 0.001, 1.0, 1.0, 0.1))
    with jax.enable_x64(True):
        def total(p):
            terms = loss(p, jnp.asarray(target))
            return sum(terms.values()), terms

        (_, terms), grad = jax.jit(jax.value_and_grad(total, has_aux=True))(jnp.asarray(x))
        return x, target, {k: float(v) for k, v in terms.items()}, np.asarray(grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_audio_feature_loss_matches_jax(jax_loss_ref, dtype):
    """Every named term within 1e-4 of JAX's float64 one, in float32 and
    float64; the gradient of their sum in float64 within 1e-4 of its
    max-abs (float32: finite)."""
    x, target, ref_terms, ref_grad = jax_loss_ref
    loss = features.AudioFeatureLoss(sample_rate=44100, weights=[0.1, 0.001, 1.0, 1.0, 0.1])
    pred = torch.from_numpy(x).to(dtype).requires_grad_()
    terms = loss(pred, torch.from_numpy(target).to(dtype))
    assert list(terms) == [  # JAX's order; its jitted dict comes back sorted
        "mix-rms", "mix-crest_factor", "mix-stereo_width", "mix-stereo_imbalance", "mix-barkspectrum"]
    assert set(terms) == set(ref_terms)
    for k, v in terms.items():
        assert v.dtype == dtype and v.shape == ()
        assert abs(float(v) - ref_terms[k]) <= TOL * abs(ref_terms[k]), k
    sum(terms.values()).backward()
    assert torch.isfinite(pred.grad).all()
    if dtype == torch.float64:
        assert _rel(pred.grad, ref_grad) <= TOL


def test_audio_feature_loss_refuses_as_jax():
    with pytest.raises(ValueError, match="expected 5 weights"):
        features.AudioFeatureLoss(weights=(1.0, 1.0))
    with pytest.raises(NotImplementedError, match="CLAP"):
        features.AudioFeatureLoss(use_clap=True)
    with pytest.raises(ValueError, match="invalid mode"):
        features.compute_barkspectrum(torch.zeros(1, 2, 40000), mode="surround")
    loss = features.AudioFeatureLoss(barkspectrum_fft_size=4096)
    x = torch.from_numpy(_mixes(t=8192))
    assert all(float(v) == 0.0 for v in loss(x, x).values())


# ------------------------------------------------------- evaluation metrics


def test_si_sdr_and_mrstft_distance_match_jax(jax_fast):
    """The float32 value within 1e-4 of JAX's float64 one, the gradient by
    pred in float64 within 1e-4 of its max-abs, on (2, 2, 20,000) mixes: an
    estimate near the target and an unrelated one."""
    rng = np.random.default_rng(3)
    target = rng.normal(size=(2, 2, 20000)) * 0.2
    pred = target * 0.7 + rng.normal(size=target.shape) * np.array([0.05, 0.5])[:, None, None]
    for port_fn, jax_fn in ((eval_metrics.si_sdr, jax_eval.si_sdr),
                            (eval_metrics.mrstft_distance, jax_eval.mrstft_distance)):
        with jax.enable_x64(True):
            ref, ref_grad = jax.jit(jax.value_and_grad(jax_fn))(jnp.asarray(pred), jnp.asarray(target))
        got = float(port_fn(torch.from_numpy(pred).float(), torch.from_numpy(target).float()))
        assert abs(got - float(ref)) <= TOL * abs(float(ref)), port_fn.__name__
        p = torch.from_numpy(pred).requires_grad_()
        port_fn(p, torch.from_numpy(target)).backward()
        assert _rel(p.grad, ref_grad) <= TOL, port_fn.__name__
