"""The PyTorch port's STFT padding, inverse STFT and separators (HPSS, the
spectrogram U-Net, HDemucs and the band split) against the JAX package's.

The same numpy inputs, made from a seed, go through both packages on the
CPU. Tolerances: ``reflect_pad`` and ``median_filter`` bitwise; the STFT,
the inverse STFT, HPSS and the U-Net in float64 on both sides within 1e-6
of the peak; HDemucs in float32, against JAX's jitted ``hdemucs_apply`` on
the same synthetic torch-layout weights, within 1e-4 of the stems' max-abs
(BASELINE.md, "Numerical parity").

Where trouble is likely, and the test that holds it:

  * ``torch.stft`` cannot reflect a signal of n_fft // 2 samples or fewer,
    which ``jnp.pad`` reflects again and again (``test_stft_any_length``);
  * a Flax stride-2 "SAME" conv pads (0, 1) on an even size, and a Flax
    ``ConvTranspose`` correlates the dilated input with its kernel
    unflipped (``test_flax_conv_layers_carried_across``);
  * HDemucs's biased z-normalization, demucs's zero-then-reflect pad, the
    framed BLSTM and LocalState (``test_hdemucs_matches_jax``).

JAX's references are jitted with XLA's optimization passes off, which
compiles them faster and computes the same; the U-Net's float64 convs run
faster optimized.
"""

import contextlib
import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmst_tpu.models import hdemucs as jax_hdemucs
from diffmst_tpu.models import separator as jax_separator
from diffmst_tpu.train.param_system import band_split_separator as jax_band_split
from diffmst_tpu.utils.checkpoint import port_hdemucs_state_dict as jax_port_hdemucs
from diffmst_torch.models import separator
from diffmst_torch.models.hdemucs import HDemucs, make_hdemucs_separator, synthetic_hdemucs_state_dict
from diffmst_torch.train import band_split_separator
from diffmst_torch.utils import checkpoint

# the packages re-export the function stft: the modules by name
stft = importlib.import_module("diffmst_torch.ops.stft")
jax_stft = importlib.import_module("diffmst_tpu.ops.stft")

torch.set_num_threads(1)


@contextlib.contextmanager
def _xla_optimizations(off: bool):
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", off)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(scope="module")
def jax_fast():
    """XLA's optimization passes off for the module's JAX references: they
    compile faster and compute the same."""
    with _xla_optimizations(True):
        yield


def _rel(port, ref) -> float:
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


# ------------------------------------------------------------ the STFT


@pytest.mark.parametrize("t,left,right", [(5, 2, 4), (5, 5, 5), (5, 15, 15), (1, 3, 2), (2, 2, 2)],
                         ids=["shorter", "equal", "three_times", "one_sample", "two_samples"])
def test_reflect_pad_matches_jnp_pad(t, left, right):
    x = np.random.default_rng(t).normal(size=(2, 3, t))
    with jax.enable_x64(True):
        ref = np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (left, right)), mode="reflect"))
    got = stft.reflect_pad(torch.from_numpy(x), left, right).numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("t,n_fft,hop", [(1000, 2048, 512), (3, 8, 2), (4096, 512, 128)])
def test_stft_any_length(jax_fast, t, n_fft, hop):
    """The repaired STFT on signals of at most n_fft // 2 samples, where
    ``torch.stft`` raised, and on a long one (the fast path)."""
    x = np.random.default_rng(0).normal(size=(2, t))
    with jax.enable_x64(True):
        ref = jax.jit(jax_stft.stft, static_argnums=(1, 2))(jnp.asarray(x), n_fft, hop)
    got = stft.stft(torch.from_numpy(x), n_fft, hop)
    assert got.shape == ref.shape
    assert _rel(got, ref) <= 1e-6


@pytest.mark.parametrize("length", [16384, 16000, 1000])
def test_istft_matches_jax(jax_fast, length):
    rng = np.random.default_rng(length)
    frames = 1 + 16384 // 512
    X = rng.normal(size=(2, 1025, frames)) + 1j * rng.normal(size=(2, 1025, frames))
    with jax.enable_x64(True):
        ref = jax.jit(jax_stft.istft, static_argnums=(1, 2, 3))(jnp.asarray(X), 2048, 512, length)
    got = stft.istft(torch.from_numpy(X), 2048, 512, length)
    assert _rel(got, ref) <= 1e-6


# ------------------------------------------------------------ HPSS


@pytest.mark.parametrize("axis", [-1, -2])
def test_median_filter_matches_jax(axis):
    x = np.random.default_rng(1).normal(size=(2, 3, 40, 31))
    with jax.enable_x64(True):
        ref = np.asarray(jax_separator.median_filter(jnp.asarray(x), 17, axis))
    assert np.array_equal(separator.median_filter(torch.from_numpy(x), 17, axis).numpy(), ref)


def _mix(bs=2, t=16384, seed=2):
    """Stereo mixes with a low tone, a centre tone, clicks and noise."""
    rng = np.random.default_rng(seed)
    n = np.arange(t) / 44100.0
    x = 0.05 * rng.normal(size=(bs, 2, t))
    x += 0.3 * np.sin(2 * np.pi * 80.0 * n) + 0.2 * np.sin(2 * np.pi * 1000.0 * n)[None, None]
    x[..., ::4096] += 1.0
    return x


def test_hpss_separator_matches_jax(jax_fast):
    x = _mix()
    with jax.enable_x64(True):
        ref = jax.jit(jax_separator.hpss_separator)(jnp.asarray(x))
    got = separator.hpss_separator(torch.from_numpy(x))
    assert got.shape == (2, 4, 2, 16384)
    assert _rel(got, ref) <= 1e-6
    assert np.abs(got.sum(dim=1).numpy() - x).max() <= 1e-6 * np.abs(x).max()


def test_band_split_separator_matches_jax():
    x = _mix(t=5000)
    with jax.enable_x64(True):
        ref = jax_band_split(jnp.asarray(x))
    got = band_split_separator(torch.from_numpy(x))
    assert _rel(got, ref) <= 1e-12
    assert np.abs(got.sum(dim=1).numpy() - x).max() <= 1e-12 * np.abs(x).max()


# ------------------------------------------------------------ the U-Net


def test_flax_conv_layers_carried_across():
    """One Flax stride-2 "SAME" conv and one stride-2 "SAME" transposed conv
    on even and odd sizes, through the port's layers with the carried
    kernels (the U-Net's ``_conv`` and its cropped ``conv_transpose2d``)."""
    rng = np.random.default_rng(3)
    for hw in ((8, 6), (7, 5)):
        x = rng.normal(size=(2, *hw, 3))
        conv = fnn.Conv(4, (3, 3), strides=(2, 2), padding="SAME")
        deconv = fnn.ConvTranspose(4, (3, 3), strides=(2, 2), padding="SAME")
        with jax.enable_x64(True):
            cv = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
            dv = deconv.init(jax.random.PRNGKey(1), jnp.asarray(x))
            # the port's _conv ends in Flax's GELU
            ref_c = np.asarray(jax.nn.gelu(conv.apply(cv, jnp.asarray(x)))).transpose(0, 3, 1, 2)
            ref_d = np.asarray(deconv.apply(dv, jnp.asarray(x))).transpose(0, 3, 1, 2)
        sd = checkpoint.unet_state_dict_from_flax({"Conv_0": cv["params"], "ConvTranspose_0": dv["params"]})
        c, d = torch.nn.Conv2d(3, 4, 3, stride=2).double(), torch.nn.ConvTranspose2d(3, 4, 3, stride=2).double()
        c.load_state_dict({"weight": sd["convs.0.weight"], "bias": sd["convs.0.bias"]})
        d.load_state_dict({"weight": sd["deconvs.0.weight"], "bias": sd["deconvs.0.bias"]})
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        with torch.no_grad():
            got_c = separator.UNetSeparator._conv(c, xt)
            got_d = d(xt)[..., : 2 * hw[0], : 2 * hw[1]]
        assert _rel(got_c, ref_c) <= 1e-12
        assert _rel(got_d, ref_d) <= 1e-12


def test_unet_separator_matches_jax():
    """The default U-Net (4 levels, width 16) with JAX's weights: random
    values, from a seed, in the Flax model's parameter tree (its shapes by
    ``jax.eval_shape``, so no Flax init is compiled)."""
    x = _mix(bs=1, seed=4)
    model = jax_separator.UNetSeparator()
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros(x.shape, jnp.float32))
    rng = np.random.default_rng(5)
    variables = jax.tree_util.tree_map(lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    with jax.enable_x64(True), _xla_optimizations(False):  # its float64 convs run faster optimized
        ref = jax.jit(model.apply)(variables, jnp.asarray(x))
    port = separator.UNetSeparator().double()
    port.load_state_dict(checkpoint.unet_state_dict_from_flax(variables["params"]))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (1, 4, 2, 16384)
    assert _rel(got, ref) <= 1e-6


# ------------------------------------------------------------ HDemucs


def test_hdemucs_matches_jax(jax_fast):
    sd = synthetic_hdemucs_state_dict(channels=8)
    jax_sd = jax_hdemucs.synthetic_hdemucs_state_dict(channels=8)
    assert list(sd) == list(jax_sd) and all(np.array_equal(sd[k], jax_sd[k]) for k in sd)
    x = _mix(bs=1, t=22050, seed=5).astype(np.float32)
    ref = jax.jit(jax_hdemucs.hdemucs_apply)(jax_port_hdemucs(jax_sd), jnp.asarray(x))
    model = make_hdemucs_separator(sd, device="cpu", channels=8)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (1, 4, 2, 22050)
    assert _rel(got, ref) <= 1e-4


def test_hdemucs_state_dict_is_torchaudios_inventory(monkeypatch):
    """HDEMUCS_HIGH's keys and shapes (the module on the meta device, the
    synthetic dict's shapes without its 84 M draws), and a reduced width's
    values, are the synthetic dict's: a torchaudio file loads strictly."""
    with torch.device("meta"):
        full = HDemucs()

    class Zeros:
        def standard_normal(self, shape):
            return np.zeros(shape)

    with monkeypatch.context() as m:
        m.setattr(np.random, "default_rng", lambda seed: Zeros())
        want = {k: tuple(v.shape) for k, v in synthetic_hdemucs_state_dict().items()}
    assert {k: tuple(v.shape) for k, v in full.state_dict().items()} == want
    sd = synthetic_hdemucs_state_dict(channels=8, seed=1)
    model = HDemucs(channels=8)
    checkpoint.port_hdemucs_state_dict(sd, model)
    assert all(np.array_equal(v.numpy(), sd[k]) for k, v in model.state_dict().items())


def test_hdemucs_loaders_raise_on_a_missing_section(tmp_path):
    sd = synthetic_hdemucs_state_dict(channels=8)
    path = tmp_path / "hdemucs.pt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    model = checkpoint.load_hdemucs_checkpoint(str(path), channels=8)
    assert np.array_equal(model.encoder[0].conv.weight.detach().numpy(), sd["encoder.0.conv.weight"])
    for section in ("tdecoder", "encoder"):
        with pytest.raises(ValueError, match=section):
            checkpoint.port_hdemucs_state_dict({k: v for k, v in sd.items() if not k.startswith(section + ".")})
