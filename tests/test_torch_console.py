"""The PyTorch port's mix consoles against the JAX package's.

The same normalized parameter vectors, made from a numpy seed, go through the
JAX console and the port's console on the CPU (the compressor kernels' plain
versions). Tolerance: max-abs <= 1e-4 on the stems and the mix (BASELINE.md,
"Numerical parity").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmst_tpu.console import AdvancedMixConsole as JaxAdvanced
from diffmst_tpu.console import BasicMixConsole as JaxBasic
from diffmst_torch.console import AdvancedMixConsole, BasicMixConsole
from diffmst_torch.kernels import comp_fused, scan1p

torch.set_num_threads(1)

ATOL = 1e-4
SR = 44100.0


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=atol)


def _inputs(seed, bs=2, n=3, t=16384):
    rng = np.random.default_rng(seed)
    env = np.abs(np.sin(np.linspace(0.0, 6.0 * np.pi, t)))[None, None, :]
    tracks = (rng.normal(size=(bs, n, t)) * 0.2 * env).astype(np.float32)
    tp = rng.uniform(0.05, 0.95, size=(bs, n, 27)).astype(np.float32)
    fp = rng.uniform(0.05, 0.95, size=(bs, 25)).astype(np.float32)
    mp = rng.uniform(0.05, 0.95, size=(bs, 26)).astype(np.float32)
    # faders within +-9.6 dB, so that no stage drives the mix far past full
    # scale, where float32 spacing alone exceeds the tolerance
    tp[..., 0] = rng.uniform(0.4, 0.6, size=(bs, n))
    mp[:, 24:] = rng.uniform(0.4, 0.6, size=(bs, 2))
    return tracks, tp, fp, mp


_JAX_MIX = {}


def _jax_advanced(smoother):
    """The JAX console's output, computed once per smoother for the module."""
    if smoother not in _JAX_MIX:
        tracks, tp, fp, mp = _inputs(0)
        out = JaxAdvanced(SR, comp_smoother=smoother)(
            jnp.asarray(tracks), jnp.asarray(tp), jnp.asarray(fp), jnp.asarray(mp),
            use_fx_bus=False,
        )
        _JAX_MIX[smoother] = (np.asarray(out.mixed_tracks), np.asarray(out.mix), out)
    return _JAX_MIX[smoother]


@pytest.mark.parametrize(
    "port_smoother,jax_smoother",
    [("auto", "auto"), ("scan", "auto"), ("fused", "auto"), ("fsm", "fsm")],
)
def test_advanced_console_matches_jax(port_smoother, jax_smoother):
    """(2, 3, 16384), fx bus off: the port's "auto" (K2), "scan" (K1) and
    "fused" all equal the JAX "auto" (associative scan); "fsm" equals "fsm"."""
    tracks, tp, fp, mp = _inputs(0)
    stems_ref, mix_ref, jout = _jax_advanced(jax_smoother)
    out = AdvancedMixConsole(SR, comp_smoother=port_smoother, device="cpu")(
        tracks, tp, fp, mp, use_fx_bus=False
    )
    assert out.mix.shape == (2, 2, 16384) and out.mixed_tracks.shape == (2, 2, 3, 16384)
    _close(out.mixed_tracks, stems_ref)
    _close(out.mix, mix_ref)
    for group, ref_group in zip(out[2:], jout[2:]):
        for effect, params in group.items():
            for name, v in params.items():
                np.testing.assert_allclose(
                    v.numpy(), np.asarray(ref_group[effect][name]), rtol=1e-6, atol=1e-5
                )


_JAX_GRAD = {}


def _grad_inputs():
    tracks, tp, fp, mp = _inputs(6, bs=2, n=2, t=8192)
    w = np.random.default_rng(7).normal(size=(2, 2, 8192)).astype(np.float32)
    return tracks, tp, fp, mp, w


def _jax_console_grads(smoother):
    """jax.grad of sum(mix * w) by the stems and the track and master
    parameter vectors, computed in float64 (jitted), once per smoother."""
    if smoother not in _JAX_GRAD:
        tracks, tp, fp, mp, w = _grad_inputs()
        console = JaxAdvanced(SR, comp_smoother=smoother)
        with jax.enable_x64(True):
            f64 = [jnp.asarray(a, jnp.float64) for a in (tracks, tp, fp, mp, w)]

            def loss(tracks_, tp_, mp_):
                out = console(tracks_, tp_, f64[2], mp_, use_fx_bus=False)
                return jnp.sum(out.mix * f64[4])

            grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(f64[0], f64[1], f64[3])
            _JAX_GRAD[smoother] = [np.asarray(g) for g in grads]
    return _JAX_GRAD[smoother]


@pytest.mark.parametrize(
    "port_smoother,jax_smoother",
    [("auto", "auto"), ("scan", "auto"), ("fused", "auto"), ("fsm", "fsm")],
)
def test_advanced_console_grads_match_jax(port_smoother, jax_smoother):
    """(2, 2, 8192), fx bus off: the gradients of sum(mix * w) by the stems,
    the track parameters and the master-bus parameters. The port's "auto"
    and "fused" (K2's backward) and "scan" (K1's) equal jax.grad of the JAX
    "auto" (XLA's associative scan); "fsm" equals "fsm".

    The reference is the JAX console run in float64, and the tolerance is
    2e-4 of each gradient's max-abs, not 1e-4: the float32 console's own
    rounding reaches past 1e-4 here. JAX's float32 jitted console is 1.9e-4
    off its float64 run on the master-bus parameters ("auto"); the port's
    largest deviation, 1.3e-4, is the master EQ's high-shelf cutoff, whose
    gradient sums float32 products over the 8,192-sample render's spectrum.
    The compressor backward alone is held at 1e-4 in test_torch_ops.py."""
    tracks, tp, fp, mp, w = _grad_inputs()
    ref = _jax_console_grads(jax_smoother)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (tracks, tp, mp)]
    out = AdvancedMixConsole(SR, comp_smoother=port_smoother, device="cpu")(
        leaves[0], leaves[1], fp, leaves[2], use_fx_bus=False
    )
    (out.mix * torch.from_numpy(w)).sum().backward()
    for name, leaf, r in zip(("dtracks", "dtrack_params", "dmaster_params"), leaves, ref):
        err = np.abs(leaf.grad.numpy() - r).max()
        assert err <= 2e-4 * np.abs(r).max(), f"{name}: {err} vs max {np.abs(r).max()}"


@pytest.mark.parametrize(
    "flags",
    [
        dict(use_track_eq=False),
        dict(use_track_compressor=False, use_track_panner=False),
        dict(use_master_bus=False),
        dict(use_master_bus=False, use_output_fader=False, use_track_input_fader=False),
    ],
    ids=["no_track_eq", "no_comp_no_pan", "no_master", "faders_off"],
)
def test_advanced_console_toggles_match_jax(flags):
    tracks, tp, fp, mp = _inputs(1)
    ref = JaxAdvanced(SR)(
        jnp.asarray(tracks), jnp.asarray(tp), jnp.asarray(fp), jnp.asarray(mp),
        use_fx_bus=False, **flags,
    )
    out = AdvancedMixConsole(SR, device="cpu")(tracks, tp, fp, mp, use_fx_bus=False, **flags)
    _close(out.mix, ref.mix)


def test_basic_console_matches_jax():
    rng = np.random.default_rng(2)
    tracks = (rng.normal(size=(2, 4, 1000)) * 0.2).astype(np.float32)
    tp = rng.uniform(0.0, 1.0, size=(2, 4, 2)).astype(np.float32)
    ref = JaxBasic(SR)(jnp.asarray(tracks), jnp.asarray(tp))
    out = BasicMixConsole(SR, device="cpu")(tracks, tp)
    _close(out.mixed_tracks, ref.mixed_tracks)
    _close(out.mix, ref.mix)
    ref = JaxBasic(SR)(jnp.asarray(tracks), jnp.asarray(tp), use_track_panner=False)
    _close(BasicMixConsole(SR, device="cpu")(tracks, tp, use_track_panner=False).mix, ref.mix)


def test_console_counts_no_launch_on_cpu():
    scan1p.onepole_core.launches = 0
    comp_fused.compressor_fused_gain.launches = 0
    tracks, tp, fp, mp = _inputs(3, bs=1, n=2, t=4096)
    for smoother in ("auto", "scan"):
        out = AdvancedMixConsole(SR, comp_smoother=smoother, device="cpu")(tracks, tp, fp, mp, use_fx_bus=False)
        assert torch.isfinite(out.mix).all()
    assert scan1p.onepole_core.launches == 0
    assert comp_fused.compressor_fused_gain.launches == 0


def test_fx_bus_raises():
    """The fx bus runs (tests/test_torch_fxbus.py holds it to JAX's); it
    raises on reverb noise of the wrong shape."""
    tracks, tp, fp, mp = _inputs(4, bs=1, n=2, t=1024)
    console = AdvancedMixConsole(SR, reverb_num_samples=512, reverb_num_taps=31, device="cpu")
    assert torch.isfinite(console(tracks, tp, fp, mp, use_fx_bus=True).mix).all()
    with pytest.raises(ValueError, match="reverb noise of shape"):
        console(tracks, tp, fp, mp, use_fx_bus=True, noise=torch.zeros(1, 2, 12, 512))


def test_console_default_device_is_cuda():
    """With no card, a console built without device="cpu" raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    tracks, tp, fp, mp = _inputs(5, bs=1, n=2, t=1024)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdvancedMixConsole(SR)(tracks, tp, fp, mp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BasicMixConsole(SR)(tracks, tp[..., :2])
