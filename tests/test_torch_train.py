"""The PyTorch port's Method-1 training step against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX function and its
counterpart in ``diffmst_torch`` on the CPU (the compressor kernels' plain
forward and backward versions). The JAX step runs in float64, compiled once
for the module; the port's step runs in float64 and in float32, as shipped.

Small size: embed 32, one layer, 4 heads, n_fft 2048, hop 32 (129 frames on
4,096-sample halves, the least Cnn14 takes), Cnn14 width 4; batch 2 x 2
tracks x 8,192 samples, one track padded; MRSTFT at FFT sizes 512 and 2048
(the recipe's 8192 does not fit a 4,096-sample half).

Tolerances (relative to each tensor's max-abs): loss 1e-5, BatchNorm
statistics 1e-5, gradients and parameter updates 1e-4 per leaf, with one
exception. The float64 step holds the formulas: its worst gradient leaf is
1.4e-6 off JAX's. In float32 the gradients are held to 1e-2 per leaf:
Cnn14's leaves under BatchNorm's backward and the MRSTFT loss's L1 terms
are sums that nearly cancel, which float32 resolves only to a few 1e-3 of
their max-abs. JAX's own float32 step is up to 3.6e-3 off its float64 one
on these inputs, the port's 3.0e-3. A parameter update new - old also
carries the rounding of the new parameters, half a unit in the last place
on each side.
"""

import math
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffmst_tpu.console import AdvancedMixConsole as JaxConsole
from diffmst_tpu.losses import MultiResolutionSTFTLoss as JaxLoss
from diffmst_tpu.mixing import naive_random_mix as jax_naive_random_mix
from diffmst_tpu.models import MixStyleTransferModel as JaxModel
from diffmst_tpu.models.cnn14 import Cnn14 as JaxCnn14
from diffmst_tpu.train import Batch as JaxBatch
from diffmst_tpu.train import System as JaxSystem
from diffmst_tpu.train import SystemConfig as JaxConfig
from diffmst_tpu.utils.audio import batch_stereo_peak_normalize as jax_peak_normalize
from diffmst_tpu.utils.checkpoint import port_torch_state_dict
from diffmst_torch.console import AdvancedMixConsole
from diffmst_torch.kernels import comp_fused, scan1p
from diffmst_torch.losses import MultiResolutionSTFTLoss
from diffmst_torch.mixing import naive_random_mix
from diffmst_torch.models import Cnn14, MixStyleTransferModel
from diffmst_torch.train import Batch, EffectFlags, System, SystemConfig, lr_schedule
from diffmst_torch.utils.audio import batch_stereo_peak_normalize
from diffmst_torch.utils.checkpoint import _cnn14, state_dict_from_flax

torch.set_num_threads(1)

SR = 44100.0
SMALL = dict(embed_dim=32, num_layers=1, nhead=4, n_fft=2048, hop_length=32, cnn_base_width=4)
LOSS = dict(fft_sizes=(512, 2048), hop_sizes=(128, 512), win_lengths=(512, 2048))
BS, NT, T = 2, 2, 8192
CONFIG = dict(lr=1e-3, steps_per_epoch=10, max_epochs=10)


def _rel_err(port, ref) -> float:
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def _assert_grad_close(port, ref32, ref64, what=""):
    """A float32 gradient held against JAX's float64 one: within 1e-4 of its
    max-abs, or within four times the error of JAX's own float32 gradient,
    whichever is larger (float32 resolves such sums only so far; see the
    module docstring). Two float32 implementations that sum in different
    orders err by the same order, not by the same amount; the factor leaves
    room for that spread."""
    tol = max(1e-4, 4.0 * _rel_err(ref32, ref64))
    err = _rel_err(port, ref64)
    assert err <= tol, f"{what}: {err:.3g} > {tol:.3g}"
    return tol


def _assert_update_close(new, old, ref_update, rtol, what=""):
    """new - old within rtol of the reference update's max-abs, plus the
    rounding of the new parameters to their dtype on each side (half a unit
    in the last place of their size each)."""
    du = new.double() - old.double()
    err = float((du - ref_update).abs().max())
    bound = rtol * float(ref_update.abs().max()) + torch.finfo(new.dtype).eps * float(new.abs().max())
    assert err <= bound, f"{what}: {err:.3g} > {bound:.3g}"


def _batch_arrays():
    rng = np.random.default_rng(0)
    env = np.abs(np.sin(np.linspace(0.0, 5.0 * np.pi, T)))
    tracks = (rng.normal(size=(BS, NT, T)) * 0.1 * env).astype(np.float32)
    padding = np.zeros((BS, NT), bool)
    padding[1, 1] = True  # a padded track: it enters BatchNorm's statistics all the same
    ids = np.zeros((BS, NT), np.int32)
    return tracks, ids, ids, padding, np.zeros((BS, 2, T), np.float32)


def _port_model():
    """The small port model, seeded, with BatchNorm running statistics made
    non-trivial so that their update shows.

    The parameter heads are narrowed (weights x 0.1), so that the predicted
    faders sit within a few dB of 0 and the render peaks near 0.5. With the
    heads as drawn, a master fader near +35 dB drives the toy mix to a peak
    of 17, where JAX's own float32 loss is 2e-5 off its float64 one, past
    the 1e-5 the loss is held to."""
    model = MixStyleTransferModel.build(**SMALL, device="cpu", generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for head in ("track_projection", "fx_bus_projection", "master_bus_projection"):
            getattr(model.controller, head).weight.mul_(0.1)
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + 1.5 * torch.rand(buf.shape, generator=gen))
    return model


def _flax_variables(model):
    sd = {f"model.{k}": v.numpy() for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    return jax.tree.map(jnp.asarray, port_torch_state_dict(sd, embed_dim=SMALL["embed_dim"]))


def _jax_ref_params(key, console):
    """The reference-mix parameters JAX's step draws from ``key``: its own
    naive_random_mix, given a console that records them."""
    seen = {}

    def record(tracks, tp, fp, mp, **_):
        seen["params"] = (tp, fp, mp)
        z = jnp.zeros(())
        return types.SimpleNamespace(mixed_tracks=z, mix=z, track_param_dict={},
                                     fx_bus_param_dict={}, master_bus_param_dict={})

    for attr in ("num_track_control_params", "num_fx_bus_control_params",
                 "num_master_bus_control_params"):
        setattr(record, attr, getattr(console, attr))
    k_mix = jax.random.split(key, 3)[0]  # as System._common splits
    jax_naive_random_mix(jnp.zeros((BS, NT, T)), record, k_mix)
    return [np.array(p) for p in seen["params"]]


def _jax_sos_response(b, a, n_fft):
    """``diffmst_tpu/ops/biquad.py::sos_frequency_response``:79 with its
    frequency grid in b's dtype, as the port's, not in float32 (:111)."""
    k = jnp.arange(n_fft // 2 + 1, dtype=b.dtype)
    half_w = (math.pi / n_fft) * k
    sin_half = jnp.sin(half_w)
    cos_m1 = -2.0 * sin_half * sin_half
    sin_w = jnp.sin(2.0 * half_w)
    H = None
    for s in range(b.shape[-2]):
        b0, b1, b2 = b[..., s, 0:1], b[..., s, 1:2], b[..., s, 2:3]
        a0, a1, a2 = a[..., s, 0:1], a[..., s, 1:2], a[..., s, 2:3]
        num = jax.lax.complex((b0 + b1 + b2) + (b0 + b2) * cos_m1, (b0 - b2) * sin_w)
        den = jax.lax.complex((a0 + a1 + a2) + (a0 + a2) * cos_m1, (a0 - a2) * sin_w)
        H = num / den if H is None else H * (num / den)
    return H


@pytest.fixture(scope="module")
def jax_step():
    """One JAX Method-1 step in float64, on JAX's float32 draw of the
    reference-mix parameters (a float64 draw would differ): the loss, the
    gradients, the updated parameters and BatchNorm statistics, and the
    port's weights.

    JAX's EQ evaluates its frequency grid, and the sines on it, in float32
    even in a float64 run, and XLA's float32 sine differs from PyTorch's in
    the last place on some bins. The early blocks of the mix encoder amplify
    that to 1.7e-3 of their gradients' max-abs. So the step runs with the
    grid in float64 (``_jax_sos_response``); the port's grid takes the
    coefficients' dtype, float32 in a float32 run as in JAX."""
    model = _port_model()
    variables = _flax_variables(model)
    tracks, ids, stereo, padding, ref_mix = _batch_arrays()
    key = jax.random.PRNGKey(5)
    ref_params = _jax_ref_params(key, JaxConsole(SR))
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as patch:
        patch.setattr(sys.modules["diffmst_tpu.ops.eq"], "sos_frequency_response", _jax_sos_response)
        rp = [jnp.asarray(p, jnp.float64) for p in ref_params]

        def injected_mix(tracks_, console, _key, **flags):
            mix = console(tracks_, *rp, **flags)
            return types.SimpleNamespace(mix=jax.lax.stop_gradient(mix.mix), track_params=rp[0],
                                         fx_bus_params=rp[1], master_bus_params=rp[2])

        system = JaxSystem(JaxModel.build(**SMALL), JaxConsole(SR), JaxLoss(**LOSS),
                           JaxConfig(**CONFIG), mix_fn=injected_mix)
        batch = JaxBatch(jnp.asarray(tracks, jnp.float64), *map(jnp.asarray, (ids, stereo, padding)),
                         jnp.asarray(ref_mix, jnp.float64))
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        params, stats = v["params"], v["batch_stats"]

        def loss_fn(p):
            return system._common(p, stats, batch, key, system.effect_flags(0), train=True)

        (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        opt = system.optimizer
        updates, _ = jax.jit(opt.update)(grads, jax.jit(opt.init)(params), params)
        new_params = optax.apply_updates(params, updates)

        def as_sd(tree):
            return state_dict_from_flax(jax.tree.map(
                lambda a: np.asarray(a, np.float64), {"params": tree, "batch_stats": aux["batch_stats"]}
            ))

        return dict(weights=model.state_dict(), ref_params=ref_params, loss=float(loss),
                    grad_norm=float(optax.global_norm(grads)), grads=as_sd(grads),
                    new=as_sd(new_params), old=as_sd(params))


def _port_system(weights, dtype=torch.float32, **overrides):
    model = MixStyleTransferModel.build(**SMALL, device="cpu")
    model.load_state_dict(weights, strict=True)
    model.to(dtype)
    cfg = SystemConfig(**{**CONFIG, **overrides})
    return System(model, AdvancedMixConsole(SR, device="cpu"), MultiResolutionSTFTLoss(**LOSS), cfg,
                  device="cpu")


def _port_batch(dtype=torch.float32):
    tracks, ids, stereo, padding, ref_mix = map(torch.from_numpy, _batch_arrays())
    return Batch(tracks.to(dtype), ids, stereo, padding, ref_mix.to(dtype))


# The step's gradient tolerance per leaf, of its max-abs (see the module docstring)
GRAD_TOL = {torch.float64: 1e-4, torch.float32: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
def test_train_step_matches_jax(jax_step, dtype):
    """One whole step at the toy shape, reference-mix parameters injected
    from JAX's draw, against JAX's float64 step: the loss, grad_norm, every
    gradient leaf, the parameter update and the new BatchNorm statistics.

    Adam's first update is lr * g / (|g| + 1e-8), about lr * sign(g). The
    update is held to 1e-4 of its leaf's max-abs on the elements whose
    gradient is at least twice the gradient's tolerance (there no sign can
    flip), and to at most lr everywhere; a leaf the loss does not reach
    stays where it was. test_optimizer_update_matches_optax holds the
    optimizer alone to optax on every element."""
    system = _port_system(jax_step["weights"], dtype)
    old = {k: v.clone() for k, v in system.model.state_dict().items()}
    metrics = system.train_step(_port_batch(dtype), system.effect_flags(0),
                                ref_params=tuple(torch.from_numpy(p).to(dtype) for p in jax_step["ref_params"]))
    assert abs(float(metrics["loss"]) - jax_step["loss"]) <= 1e-5 * abs(jax_step["loss"])
    grad_norm = float(metrics["grad_norm"])
    assert abs(grad_norm - jax_step["grad_norm"]) <= 1e-4 * jax_step["grad_norm"]
    assert int(metrics["ref_mix_nonfinite"]) == 0 and int(metrics["pred_mix_nonfinite"]) == 0
    assert grad_norm > 10.0  # the clip is exercised
    assert system.step == 1 and system.updates == 1

    tol = GRAD_TOL[dtype]
    new = system.model.state_dict()
    for name, p in system.model.named_parameters():
        assert p.dtype == dtype, name
        g64 = jax_step["grads"][name]
        unclipped = p.grad.double() * (grad_norm / 10.0)
        assert _rel_err(unclipped, g64) <= tol, name
        dr = jax_step["new"][name] - jax_step["old"][name]
        if not g64.any():
            assert torch.equal(new[name], old[name]), name
            continue
        keep = g64.abs() >= 2.0 * tol * float(g64.abs().max())
        _assert_update_close(new[name][keep], old[name][keep], dr[keep], 1e-4, name)
        assert float((new[name] - old[name]).abs().max()) <= CONFIG["lr"] * (1.0 + 1e-3), name
    for name, v in new.items():
        if name.endswith(("running_mean", "running_var")):
            assert _rel_err(v, jax_step["new"][name]) <= 1e-5, name
            assert not torch.equal(v, old[name]), name


def test_optimizer_update_matches_optax(jax_step):
    """JAX's gradients, rounded to float32, through the port's clip and
    Adam on the float32 parameters give optax's float64 update, every
    element, within 1e-5 of each leaf's max-abs (and the parameters'
    float32 rounding)."""
    ref = jax_step
    system = _port_system(jax_step["weights"])
    named = dict(system.model.named_parameters())
    with torch.no_grad():
        for name, p in named.items():
            p.grad = ref["grads"][name].float()
        system.apply_gradients(torch.tensor(ref["grad_norm"], dtype=torch.float32))
    for name, p in named.items():
        _assert_update_close(p.detach(), ref["old"][name], ref["new"][name] - ref["old"][name],
                             1e-5, name)


def test_eval_step_leaves_state_alone(jax_step):
    system = _port_system(jax_step["weights"])
    before = {k: v.clone() for k, v in system.model.state_dict().items()}
    metrics, outputs = system.eval_step(_port_batch(), system.effect_flags(0),
                                        ref_params=tuple(map(torch.from_numpy, jax_step["ref_params"])))
    assert np.isfinite(float(metrics["loss"]))
    assert outputs["pred_mix_b"].shape == (BS, 2, T // 2)
    for k, v in system.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert system.step == 0


# ------------------------------------------------------------- the pieces


def test_mrstft_loss_and_grad_match_jax():
    """The recipe's loss (FFT sizes 512, 2048, 8192) on (2, 2, 10000)
    mixes: the value within 1e-5 of JAX's; the gradient against JAX's
    float64 one, as the module docstring says."""
    rng = np.random.default_rng(1)
    pred = (rng.normal(size=(2, 2, 10000)) * 0.2).astype(np.float32)
    target = (rng.normal(size=(2, 2, 10000)) * 0.2).astype(np.float32)
    ref = {}
    for dtype in (jnp.float32, jnp.float64):
        with jax.enable_x64(dtype == jnp.float64):
            val, grad = jax.jit(jax.value_and_grad(JaxLoss()))(
                jnp.asarray(pred, dtype), jnp.asarray(target, dtype))
            ref[dtype] = (float(val), np.asarray(grad, np.float64))
    tp = torch.from_numpy(pred).requires_grad_()
    val = MultiResolutionSTFTLoss()(tp, torch.from_numpy(target))
    val.backward()
    assert abs(float(val.detach()) - ref[jnp.float32][0]) <= 1e-5 * abs(ref[jnp.float32][0])
    _assert_grad_close(tp.grad.double(), ref[jnp.float32][1], ref[jnp.float64][1], "dpred")


def test_cnn14_batchnorm_train_mode_matches_flax():
    """Cnn14 (width 4) with BatchNorm on batch statistics: the output (1e-5),
    the running mean and variance after the update (Flax: momentum 0.9,
    biased variance; 1e-5), and the gradients by the input and every
    parameter against Flax's float64 ones, as the module docstring says."""
    rng = np.random.default_rng(2)
    x = rng.uniform(0.0, 1.0, size=(3, 1, 1025, 129)).astype(np.float32)
    w = rng.normal(size=(3, 8)).astype(np.float32)
    jmodel = JaxCnn14(num_classes=8, base_width=4)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                         variables["batch_stats"])

    def port_sd(params_, batch_stats):
        sd = {}
        _cnn14(jax.tree.map(np.asarray, params_), jax.tree.map(np.asarray, batch_stats), "", sd)
        return sd

    ref = {}
    for dtype in (jnp.float32, jnp.float64):
        with jax.enable_x64(dtype == jnp.float64):
            cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)  # noqa: E731

            def f(p, x_):
                out, upd = jmodel.apply({"params": p, "batch_stats": cast(stats)}, x_, train=True,
                                        mutable=["batch_stats"])
                return jnp.sum(out * w), (out, upd["batch_stats"])

            (_, (out, new_stats)), (grads, dx) = jax.jit(
                jax.value_and_grad(f, argnums=(0, 1), has_aux=True)
            )(cast(params), jnp.asarray(x, dtype))
            ref[dtype] = dict(out=np.asarray(out), dx=np.asarray(dx, np.float64),
                              grads={k: v.double() for k, v in port_sd(grads, new_stats).items()},
                              stats=port_sd(params, new_stats))

    port = Cnn14(8, base_width=4)
    port.load_state_dict(port_sd(params, stats), strict=True)
    tx = torch.from_numpy(x).requires_grad_()
    out = port(tx, train=True)
    (out * torch.from_numpy(w)).sum().backward()
    r32, r64 = ref[jnp.float32], ref[jnp.float64]
    assert _rel_err(out, r32["out"]) <= 1e-5
    _assert_grad_close(tx.grad.double(), r32["dx"], r64["dx"], "dx")
    for name, p in port.named_parameters():
        _assert_grad_close(p.grad.double(), r32["grads"][name], r64["grads"][name], name)
    for name, v in port.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            assert _rel_err(v, r32["stats"][name]) <= 1e-5, name
    # eval mode reads the running statistics and updates nothing
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        port(tx)
    assert all(torch.equal(v, before[k]) for k, v in port.state_dict().items())


def test_batch_stereo_peak_normalize_matches_jax():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(3, 2, 500)) * [[[0.1]], [[4.0]], [[0.0]]]).astype(np.float32)
    out = batch_stereo_peak_normalize(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_peak_normalize(jnp.asarray(x))),
                               rtol=1e-6, atol=0)


def test_naive_random_mix_draw_is_uniform():
    """The torch draw: uniform on (0, 1), of the console's shapes, from the
    generator alone (the same seed draws the same mix), without gradients."""
    console = AdvancedMixConsole(SR, device="cpu")
    tracks = torch.from_numpy(_batch_arrays()[0][..., :1024])
    mix = naive_random_mix(tracks, console, torch.Generator().manual_seed(7))
    assert mix.track_params.shape == (BS, NT, 27)
    assert mix.fx_bus_params.shape == (BS, 25) and mix.master_bus_params.shape == (BS, 26)
    assert mix.mix.shape == (BS, 2, 1024) and not mix.mix.requires_grad
    again = naive_random_mix(tracks, console, torch.Generator().manual_seed(7))
    assert torch.equal(mix.mix, again.mix)

    from diffmst_torch.mixing.naive import draw_mix_params

    big = torch.zeros(256, 8, 1)
    u = torch.cat([p.reshape(-1) for p in draw_mix_params(big, console, torch.Generator().manual_seed(8))])
    assert u.numel() == 256 * (8 * 27 + 25 + 26)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    deciles = torch.histc(u, bins=10, min=0.0, max=1.0) / u.numel()
    assert float((deciles - 0.1).abs().max()) < 0.01  # 5 sigma at 68,352 draws


def test_train_step_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    model = MixStyleTransferModel.build(**SMALL, device="cpu")
    system = System(model, AdvancedMixConsole(SR, device="cpu"), MultiResolutionSTFTLoss(**LOSS))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        system.train_step(_port_batch(), system.effect_flags(0))


def test_effect_flags_follow_the_curriculum():
    system = System(torch.nn.Linear(2, 2), None, None,
                    SystemConfig(active_eq_epoch=2, active_master_bus_epoch=1), device="cpu")
    assert system.effect_flags(0) == EffectFlags(False, True, False, False)
    assert system.effect_flags(2) == EffectFlags(True, True, False, True)


@pytest.mark.parametrize("schedule", ["step", "cosine", "none"])
def test_lr_schedule_matches_optax(schedule):
    cfg = SystemConfig(lr=3e-4, max_epochs=4, steps_per_epoch=25, schedule=schedule)
    total = 100
    if schedule == "step":
        ref = optax.piecewise_constant_schedule(3e-4, {85: 0.1, 95: 0.1})
    elif schedule == "cosine":
        ref = optax.cosine_decay_schedule(3e-4, total)
    else:
        ref = optax.constant_schedule(3e-4)
    lr = lr_schedule(cfg)
    for count in (0, 1, 50, 84, 85, 86, 94, 95, 99, 100, 150):
        # optax's schedule is float32: its cosine is 7e-8 of lr near the end
        assert lr(count) == pytest.approx(float(ref(count)), rel=1e-5, abs=1e-7 * 3e-4), count


def _optax_reference(cfg, grads_seq, w0):
    """optax's chain as the JAX System builds it, on one (4,) leaf."""
    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip),
                     optax.adam(lr_schedule(cfg)(0), b1=cfg.adam_b1, b2=cfg.adam_b2))
    if cfg.accumulate_grad_batches > 1:
        tx = optax.MultiSteps(tx, cfg.accumulate_grad_batches)
    if cfg.skip_nonfinite_updates > 0:
        tx = optax.apply_if_finite(tx, cfg.skip_nonfinite_updates)
    w = jnp.asarray(w0)
    state = tx.init(w)
    out = []
    for g in grads_seq:
        upd, state = tx.update(jnp.asarray(g), state, w)
        w = optax.apply_updates(w, upd)
        out.append(np.asarray(w))
    return out


@pytest.mark.parametrize(
    "overrides",
    [dict(accumulate_grad_batches=3), dict(skip_nonfinite_updates=1),
     dict(accumulate_grad_batches=2, skip_nonfinite_updates=2)],
    ids=["accumulate", "skip_nonfinite", "both"],
)
def test_accumulation_and_nonfinite_skipping_match_optax(overrides):
    """optax.MultiSteps and optax.apply_if_finite around clip + Adam, on a
    sequence of gradients with large, small and (when skipping) non-finite
    ones: a NaN, then an infinity, which one allowed skip lets through."""
    cfg = SystemConfig(lr=1e-2, schedule="none", **overrides)
    rng = np.random.default_rng(9)
    grads = [rng.normal(size=4).astype(np.float32) * s for s in (30.0, 0.5, 2.0, 20.0, 1.0, 3.0, 0.2)]
    if cfg.skip_nonfinite_updates:
        grads[2][1] = np.nan
        grads[3][0] = np.inf
    w0 = rng.normal(size=4).astype(np.float32)
    ref = _optax_reference(cfg, grads, w0)

    layer = torch.nn.Linear(4, 1, bias=False)
    with torch.no_grad():
        layer.weight.view(-1).copy_(torch.from_numpy(w0))
    system = System(layer, None, None, cfg, device="cpu")
    for i, g in enumerate(grads):
        layer.weight.grad = torch.from_numpy(g).reshape(1, 4).clone()
        system.apply_gradients(torch.linalg.vector_norm(layer.weight.grad))
        np.testing.assert_allclose(layer.weight.detach().numpy().reshape(-1), ref[i],
                                   rtol=1e-5, atol=1e-7, err_msg=f"step {i}")


def test_step_counts_no_kernel_launch_on_cpu(jax_step):
    for counter in (scan1p.onepole_core, scan1p.onepole_core_backward,
                    comp_fused.compressor_fused_gain, comp_fused.compressor_fused_backward):
        counter.launches = 0
    system = _port_system(jax_step["weights"])
    system.train_step(_port_batch(), system.effect_flags(0))  # the torch draw
    assert system.step == 1
    for counter in (scan1p.onepole_core, scan1p.onepole_core_backward,
                    comp_fused.compressor_fused_gain, comp_fused.compressor_fused_backward):
        assert counter.launches == 0
