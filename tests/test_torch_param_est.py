"""The PyTorch port's parameter-estimation pretraining (the FXencoder, the
ParameterProjector, the Remixer, ParameterEstimationSystem and the
mixes-only data) against the JAX package's.

The same numpy inputs, made from a seed, go through both packages on the
CPU. JAX draws the remix's parameters and the reverb's noise from its key
(``train/param_system.py:66-85``); the port takes those draws as ``tp``,
``fp``, ``mp`` and ``noise``. The console runs the compressor's "fsm"
smoother on both sides and the reverb at 4,096 samples and 63 taps (the
smoothers are held in ``tests/test_torch_console.py``, the reverb at its
shipped size in ``chip_smoke.py``).

Tolerances: the models, the step's gradients and the updated weights in
float64 on both sides within 1e-6 of the max-abs, the gradients 1e-4
(BASELINE.md, "Numerical parity"); the remix within 1e-4 of its peak; the
learning rate and the data bitwise.

Where trouble is likely, and the test that holds it:

  * the FXencoder on mono input: block 0's first conv maps 1 channel to 2
    and its residual broadcasts; at 65,536 samples its strides leave 2
    samples before a kernel-5 conv, whose reflection pad (2, 2) is longer
    than the signal (``test_fx_encoder_matches_jax``);
  * train-mode BatchNorm over the combined 4 x bs batch, and Flax's
    momentum 0.9 as torch's 0.1 (``test_train_step_matches_jax``);
  * the stems' (bs, 4, 2, T) -> (bs, 8, T) order and the tanh clip
    (``test_remixer_matches_jax``);
  * the group scales, 27 + 8 for the tracks, 25 and 26
    (``test_train_step_matches_jax``'s losses);
  * optax's piecewise schedule, whose scales compound to 0.01
    (``test_lr_schedule_matches_optax``);
  * ``MixDataset``'s draws, a path index then an offset a try, the skips
    of mono and unreadable files and the silence rejection
    (``test_mix_data_module_is_bitwise_jax``).

JAX's references are jitted with XLA's optimization passes off, which
compiles them faster and computes the same; the step's float64 convs run
faster optimized. Their weights are random values
from a seed in the Flax models' parameter trees (shapes by
``jax.eval_shape``), so no Flax init is compiled.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffmst_tpu.console import AdvancedMixConsole as JaxConsole
from diffmst_tpu.data.dataset import MixDataModule as JaxMixDataModule
from diffmst_tpu.models import FXencoder as JaxFXencoder
from diffmst_tpu.models import ParameterProjector as JaxProjector
from diffmst_tpu.models import SpectrogramEncoder as JaxEncoder
from diffmst_tpu.train.param_system import ParameterEstimationSystem as JaxSystem
from diffmst_tpu.train.param_system import ParamTrainState
from diffmst_tpu.train.param_system import Remixer as JaxRemixer
from diffmst_tpu.train.param_system import band_split_separator as jax_band_split
from diffmst_torch.console import AdvancedMixConsole
from diffmst_torch.data import MixDataModule, write_audio
from diffmst_torch.models import FXencoder, ParameterProjector, SpectrogramEncoder, default_fx_encoder_config
from diffmst_torch.train import ParameterEstimationSystem, Remixer, band_split_separator
from diffmst_torch.utils import checkpoint

torch.set_num_threads(1)

SR = 44100.0
N_IR, TAPS = 4096, 63
CONSOLE = dict(reverb_num_samples=N_IR, reverb_num_taps=TAPS, comp_smoother="fsm")
P_T, P_F, P_M = 27, 25, 26


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


def _rel(port, ref, floor=1e-30) -> float:
    """max |port - ref| over max(max |ref|, floor)."""
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), floor))


def _variables(module, seed, *example):
    """Flax variables of ``module`` for ``example``: N(0, 0.1) parameters,
    running means N(0, 0.1) and variances U(0.5, 1.5), float64."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *example)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        return 0.1 * rng.standard_normal(s.shape)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _mixes(bs=2, t=16384, seed=0):
    rng = np.random.default_rng(seed)
    n = np.arange(t) / SR
    return 0.1 * rng.normal(size=(bs, 2, t)) + 0.2 * np.sin(2 * np.pi * rng.uniform(60, 600, (bs, 2, 1)) * n)


# ------------------------------------------------------------ the models


FX_CFG = {**default_fx_encoder_config(), "channels": [c // 16 for c in default_fx_encoder_config()["channels"]]}


def test_fx_encoder_matches_jax(jax_fast):
    """The upstream kernels, strides and dilations at a sixteenth of the
    channels, on 2 x 1 x 65,536 mono signals, in eval and in train mode (the
    output and the updated batch statistics)."""
    x = _mixes(t=65536)[:, :1]
    jax_enc = JaxFXencoder(FX_CFG)
    with jax.enable_x64(True):
        v = _variables(jax_enc, 1, jnp.zeros(x.shape))
        ref_eval = jax.jit(lambda v, x: jax_enc.apply(v, x))(v, jnp.asarray(x))
        ref_train, upd = jax.jit(lambda v, x: jax_enc.apply(v, x, train=True, mutable=["batch_stats"]))(
            v, jnp.asarray(x))
    enc = FXencoder(FX_CFG, n_inputs=1).double()
    assert enc.blocks[0].conv1.conv.weight.shape == (2, 1, 25)  # mono in, the stereo width out
    enc.load_state_dict(checkpoint.fx_encoder_state_dict_from_flax(v["params"], v["batch_stats"]))
    with torch.no_grad():
        assert _rel(enc(torch.from_numpy(x)), ref_eval) <= 1e-6
        assert _rel(enc(torch.from_numpy(x), train=True), ref_train) <= 1e-6
    want = checkpoint.fx_encoder_state_dict_from_flax(v["params"], upd["batch_stats"])
    for name, buf in enc.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert _rel(buf, want[name]) <= 1e-6, name


def test_parameter_projector_matches_jax():
    z = np.random.default_rng(2).normal(size=(3, 32))
    jax_proj = JaxProjector(embed_dim=32, num_tracks=8, num_track_control_params=P_T,
                            num_fx_bus_control_params=P_F, num_master_bus_control_params=P_M)
    with jax.enable_x64(True):
        v = _variables(jax_proj, 3, jnp.zeros(z.shape))
        ref = jax_proj.apply(v, jnp.asarray(z))
    proj = ParameterProjector(32, 8, P_T, P_F, P_M).double()
    proj.load_state_dict(checkpoint.projector_state_dict_from_flax(v["params"]))
    got = proj(torch.from_numpy(z))
    assert [tuple(g.shape) for g in got] == [(3, 8, P_T), (3, P_F), (3, P_M)]
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-12


# ------------------------------------------------------------ the Remixer


def _jax_draws(key, bs):
    """JAX's Remixer draws from ``key`` in float64 (param_system.py:74-77),
    and the reverb's noise from the fourth key (ops/reverb.py)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    with jax.enable_x64(True):
        return [np.array(a) for a in (
            jax.random.uniform(k1, (bs, 8, P_T)), jax.random.uniform(k2, (bs, P_F)),
            jax.random.uniform(k3, (bs, P_M)),
            jax.random.normal(k4, (bs, 2, 12, N_IR + TAPS - 1), jnp.float64))]


def test_remixer_matches_jax(jax_fast):
    """JAX's separator output, parameters and reverb noise fed to the port's
    Remixer at 2 x 2 x 16,384."""
    x = _mixes(seed=1)
    stems = np.random.default_rng(4).normal(size=(2, 4, 2, 16384)) * np.linspace(1.0, 0.2, 16384)
    key = jax.random.PRNGKey(7)
    with jax.enable_x64(True):
        remixer = JaxRemixer(SR, separator=lambda _: jnp.asarray(stems))
        ref = jax.jit(lambda x, k: remixer(x, JaxConsole(SR, **CONSOLE), k))(jnp.asarray(x), key)
    tp, fp, mp, noise = _jax_draws(key, 2)
    assert all(np.array_equal(a, np.asarray(r)) for a, r in zip((tp, fp, mp), ref[1:]))
    port = Remixer(SR, separator=lambda _: torch.from_numpy(stems))
    remix, *params = port(torch.from_numpy(x), AdvancedMixConsole(SR, device="cpu", **CONSOLE),
                          tp=torch.from_numpy(tp), fp=torch.from_numpy(fp), mp=torch.from_numpy(mp),
                          noise=torch.from_numpy(noise))
    assert _rel(remix, ref[0]) <= 1e-4
    assert float(remix.abs().max()) <= 4.0
    assert all(np.array_equal(p.numpy(), a) for p, a in zip(params, (tp, fp, mp)))


# ------------------------------------------------------------ the system


@pytest.fixture(scope="module")
def jax_step(jax_fast):
    """One float64 ``make_train_step`` with test_cli's toy encoder (Cnn14 at
    width 4, n_fft 2,048, hop 128) and the band-split separator, then
    ``make_eval_step`` on the new state. The gradients are Adam's first
    moment after one step over 1 - b1."""
    x = _mixes(seed=2)
    enc = JaxEncoder(embed_dim=16, n_fft=2048, hop_length=128, cnn_base_width=4)
    proj = JaxProjector(embed_dim=32, num_tracks=8, num_track_control_params=P_T,
                        num_fx_bus_control_params=P_F, num_master_bus_control_params=P_M)
    console = JaxConsole(SR, **CONSOLE)
    system = JaxSystem(enc, proj, console, remixer=JaxRemixer(SR, separator=jax_band_split),
                       max_epochs=2, steps_per_epoch=2)
    key = jax.random.PRNGKey(11)
    with jax.enable_x64(True), _xla_optimizations(False):  # Cnn14's float64 convs run faster optimized
        ev = _variables(enc, 5, jnp.zeros((2, 1, 16384)))
        pv = _variables(proj, 6, jnp.zeros((2, 32)))
        params = {"encoder": {"params": ev["params"], "batch_stats": ev["batch_stats"]},
                  "projector": {"params": pv["params"]}}
        trainable = {"encoder": ev["params"], "projector": pv["params"]}
        state = ParamTrainState(params, ev["batch_stats"], system.optimizer.init(trainable),
                                jnp.zeros((), jnp.int32))
        new_state, metrics = system.make_train_step()(state, jnp.asarray(x), key)
    remix = _mixes(seed=3)
    draws = _jax_draws(jax.random.split(key)[0], 2)
    with jax.enable_x64(True):
        ev_metrics = system.make_eval_step()(new_state, jnp.asarray(x), jnp.asarray(remix),
                                             *map(jnp.asarray, draws[:3]))
    mu = new_state.opt_state[0].mu
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, mu)

    def as_sd(p, stats):
        return checkpoint.param_est_state_dict_from_flax(
            {"encoder": {"params": p["encoder"], "batch_stats": stats}, "projector": {"params": p["projector"]}})

    return dict(x=x, remix=remix, draws=draws, old=as_sd(trainable, ev["batch_stats"]),
                grads=as_sd(grads, ev["batch_stats"]),
                new=as_sd({"encoder": new_state.params["encoder"]["params"],
                           "projector": new_state.params["projector"]["params"]}, new_state.batch_stats),
                metrics={k: float(v) for k, v in metrics.items()},
                eval_metrics={k: float(v) for k, v in ev_metrics.items()})


def _port_system(weights):
    enc = SpectrogramEncoder(embed_dim=16, n_fft=2048, hop_length=128, cnn_base_width=4).double()
    proj = ParameterProjector(32, 8, P_T, P_F, P_M).double()
    enc.load_state_dict(weights["encoder"])
    proj.load_state_dict(weights["projector"])
    return ParameterEstimationSystem(enc, proj, AdvancedMixConsole(SR, device="cpu", **CONSOLE),
                                     remixer=Remixer(SR, separator=band_split_separator), max_epochs=2,
                                     steps_per_epoch=2, device="cpu")


def test_train_step_matches_jax(jax_step):
    """The losses; each gradient leaf within 1e-4 of its max-abs; Adam's
    update and the BatchNorm statistics after the step.

    Adam's first update is lr * g / (|g| + 1e-8), about lr * sign(g). As in
    ``tests/test_torch_train.py``, the update is held to 1e-4 of its leaf's
    max-abs where the gradient is at least twice the gradient's tolerance
    (no sign can flip there), and to at most lr everywhere."""
    system = _port_system(jax_step["old"])
    tp, fp, mp, noise = map(torch.from_numpy, jax_step["draws"])
    m = system.train_step(torch.from_numpy(jax_step["x"]), tp=tp, fp=fp, mp=mp, noise=noise)
    for k, v in jax_step["metrics"].items():
        assert abs(float(m[k]) - v) <= 1e-6 * abs(v), (k, float(m[k]), v)
    lr = 3e-4
    for part, module in (("encoder", system.encoder), ("projector", system.projector)):
        old = jax_step["old"][part]
        for name, p in module.named_parameters():
            g = jax_step["grads"][part][name]
            # the encoder head's bias gets no gradient: the embeddings enter
            # as differences, so it is 0 in JAX and rounding (1e-17) here
            assert _rel(p.grad, g, floor=1e-12) <= 1e-4, (part, name)
            step, ref_step = (p - old[name]).detach(), jax_step["new"][part][name] - old[name]
            keep = g.abs() >= 2e-4 * float(g.abs().max())
            if g.any():
                assert _rel(step[keep], ref_step[keep]) <= 1e-4, (part, name)
            assert float(step.abs().max()) <= lr * (1.0 + 1e-6), (part, name)
        for name, buf in module.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                assert _rel(buf, jax_step["new"][part][name]) <= 1e-6, (part, name)
    assert system.step == 1
    state = system.state_dict()
    assert set(state) == {"encoder", "projector", "optimizer", "step", "generator"}

    # eval_step on a frozen (input, remix, parameters), twice, against JAX's
    args = [torch.from_numpy(a) for a in (jax_step["x"], jax_step["remix"], *jax_step["draws"][:3])]
    e1, e2 = system.eval_step(*args), system.eval_step(*args)
    for k, v in jax_step["eval_metrics"].items():
        assert float(e1[k]) == float(e2[k])
        assert abs(float(e1[k]) - v) <= 1e-6 * abs(v), (k, float(e1[k]), v)


def test_system_runs_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParameterEstimationSystem(torch.nn.Linear(1, 1), torch.nn.Linear(1, 1), AdvancedMixConsole(SR, device="cpu"))


@pytest.mark.parametrize("schedule", ["step", "cosine", "none"])
def test_lr_schedule_matches_optax(schedule):
    """At the boundaries int(0.85 total) and int(0.95 total), one step
    either side, and at the ends."""
    lr, epochs, steps = 3e-4, 7, 13
    total = epochs * steps
    system = ParameterEstimationSystem(torch.nn.Linear(1, 1), torch.nn.Linear(1, 1),
                                       AdvancedMixConsole(SR, device="cpu"), lr=lr, max_epochs=epochs,
                                       steps_per_epoch=steps, schedule=schedule, device="cpu")
    ref = {"step": optax.piecewise_constant_schedule(lr, {int(total * 0.85): 0.1, int(total * 0.95): 0.1}),
           "cosine": optax.cosine_decay_schedule(lr, total)}.get(schedule, lambda count: lr)
    counts = [0, total, *(b + d for b in (int(total * 0.85), int(total * 0.95)) for d in (-1, 0, 1))]
    with jax.enable_x64(True):  # optax's arithmetic in float64
        for count in counts:
            assert system.lr_at(count) == pytest.approx(float(ref(count)), rel=1e-12), count
    if schedule == "step":
        assert system.lr_at(total) == pytest.approx(lr * 0.01)


# ------------------------------------------------------------ the data


def test_mix_data_module_is_bitwise_jax(tmp_path):
    """Train and val batches on 3 stereo mixes, 1 mono file and 1 silent
    stereo file: the same draws from one NumPy generator, the mono and the
    silent files never drawn."""
    rng = np.random.default_rng(8)
    t = 3 * 44100
    for i in range(3):
        write_audio(str(tmp_path / f"mix{i}.wav"), (0.1 * rng.normal(size=(2, t))).astype(np.float32), 44100)
    write_audio(str(tmp_path / "mono.wav"), (0.1 * rng.normal(size=(1, t))).astype(np.float32), 44100)
    write_audio(str(tmp_path / "silent.wav"), np.zeros((2, t), np.float32), 44100)
    kw = dict(root_dirs=[str(tmp_path)], length=65536, batch_size=2, num_examples_per_epoch=20, seed=3)
    port, ref = MixDataModule(**kw), JaxMixDataModule(**kw)
    assert port.train_dataset.paths == ref.train_dataset.paths  # MixDataset's discovery
    for loader in ("train_dataloader", "val_dataloader"):
        got, want = list(getattr(port, loader)()), list(getattr(ref, loader)())
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == (2, 2, 65536)
            assert np.array_equal(g, w)
            assert np.all(np.abs(g).max(axis=(1, 2)) > 0)  # the silent file was never drawn
