"""The PyTorch port's device mesh (``diffmst_torch/parallel``) on the CPU.

Ranks are processes started by the port's own launcher
(``parallel.launch``: spawned, a ``FileStore`` in a temporary directory,
gloo), one thread each; their functions are in ``tests/_torch_mesh_ranks.py``,
which imports no JAX. The launches run in a background thread while this
process computes the single-process and JAX references. JAX's meshes run on
the 8 virtual CPU devices that ``tests/conftest.py`` forces.

  * ``make_mesh``: rank r at (r // mp, r % mp), its dp and mp groups, and
    JAX's errors; ``assert_mesh_divisible`` at the console, System and
    ``shard_batch`` sites (``tests/test_train.py:375-407``);
  * the Method-1 step of ``tests/test_torch_train.py`` (the same weights,
    2 x 2 x 8,192 batch, reference-mix parameters and JAX's reverb noise
    injected, float64) at dp = 2 and at dp = 1 x mp = 2 (the fx bus off and
    on) against the port's single-process step: the loss terms, every
    gradient leaf and the BatchNorm running statistics within 1e-9 of each
    tensor's max-abs (only the order of the sums differs); and against
    JAX's mesh step on the same inputs (``make_mesh(dp=2)``; ``make_mesh(
    dp=1, mp=2)`` with ``bn_axis_name=("dp", "mp")``, the console on the
    mesh) at ``tests/test_torch_train.py``'s float64 bounds: loss 1e-5,
    gradients 1e-4 of each leaf's max-abs. At mp = 2 the track encoder's
    gradient is not mp times the single-process one;
  * BatchNorm over dp = 2: float32 channels far off zero mean keep
    float32's digits, and the encoder's input BatchNorm reduces over the
    mesh;
  * ``Trainer(mesh=, fused_steps=2)`` over dp = 2 and over dp = 2 x mp = 2
    (4 ranks) against the single-process Trainer, in float64 at lr 1e-4, at
    JAX's mesh-test bounds (losses rtol 1e-3; parameters rtol 1e-4, atol
    8e-6; ``tests/test_train.py:1032-1170``) and on each parameter's change
    and Adam's first moment; rank 0 alone writes checkpoints, and a mesh fit's
    checkpoint resumes in one process;
  * ``main_torch.py`` with ``trainer.devices: 2`` and with ``trainer.mesh:
    {dp: 1, mp: 2}`` (``--device cpu``: CPU ranks on gloo), the mesh going
    to the Trainer alone, as JAX's ``main.py`` passes it;
  * two ranks of one host read the same songs.
"""

import concurrent.futures
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import yaml

import main_torch
from diffmst_torch import parallel
from diffmst_torch.console import AdvancedMixConsole
from diffmst_torch.data import dataset as tdataset
from diffmst_torch.models import MixStyleTransferModel
from diffmst_torch.train import Batch, Trainer
from tests import _torch_mesh_ranks as ranks
from tests.test_torch_data import _datamodule_args, corpus  # noqa: F401 (fixture)
from tests.test_torch_train import (
    CONFIG,
    LOSS,
    SMALL,
    _batch_arrays,
    _flax_variables,
    _jax_ref_params,
    _jax_sos_response,
    _port_model,
)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SR = 44100.0
KEY = 5  # the JAX step's key: its reference-mix draw and its reverb noise
assert (ranks.SMALL, ranks.LOSS, ranks.CONFIG) == (SMALL, LOSS, CONFIG)


def _rel(port, ref) -> float:
    port = port.detach().double().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = ref.detach().double().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    assert port.shape == ref.shape
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


# ------------------------------------------------------------------ inputs


def _global_batch() -> Batch:
    tracks, ids, stereo, padding, ref_mix = map(torch.from_numpy, _batch_arrays())
    return Batch(tracks.double(), ids, stereo, padding, ref_mix.double())


def _jax_draws(fx: bool):
    """The global batch's reference-mix parameters (JAX's draw from KEY)
    and, with the fx bus, JAX's float64 reverb noise of the reference and
    the predicted render (keys k_mix and k_render of ``System._common``), as
    float64 tensors."""
    key = jax.random.PRNGKey(KEY)
    params = tuple(torch.from_numpy(p).double() for p in _jax_ref_params(key, _console()))
    if not fx:
        return params, None
    bs = _batch_arrays()[0].shape[0]
    c = _console()
    shape = (bs, 2, 12, c.reverb_num_samples + c.reverb_num_taps - 1)
    k_mix, _, k_render = jax.random.split(key, 3)
    with jax.enable_x64(True):
        noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float64))) for k in (k_mix, k_render))
    return params, noise


def _console():
    from diffmst_tpu.console import AdvancedMixConsole as JaxConsole

    return JaxConsole(SR, **ranks.REVERB)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The ranks' runs, started one after the other in a background thread
    while the tests compute their references: two ranks (the dp = 2 step,
    the dp = 1 x mp = 2 steps with the fx bus off and on, the dp = 2 fit),
    then four (the dp = 2 x mp = 2 fit). Futures of each launch's per-rank
    results; the single-process references, computed once."""
    weights = _port_model().state_dict()
    batch = _global_batch()
    draws = {fx: _jax_draws(fx) for fx in (False, True)}
    ckpts = {name: str(tmp_path_factory.mktemp(f"ckpt_{name}")) for name in ("dp2", "dp2mp2")}
    pool = concurrent.futures.ThreadPoolExecutor(1)
    runs = {
        "two": pool.submit(parallel.launch, ranks.two_ranks, 2, (weights, batch, draws, ckpts["dp2"]), device="cpu"),
        "four": pool.submit(parallel.launch, ranks.mesh_fit, 4, (2, 2, ckpts["dp2mp2"]), device="cpu"),
    }
    yield types.SimpleNamespace(runs=runs, weights=weights, batch=batch, draws=draws, ckpts=ckpts, single={})
    pool.shutdown(wait=True)


def _two(launched, key: str) -> list:
    return [r[key] for r in launched.runs["two"].result()]


def _settled(launched) -> None:
    """Wait for the background launches: a test that joins a process group
    in this process, or patches its environment or ``torch.distributed``,
    runs with no launch in flight."""
    for run in launched.runs.values():
        run.result()


def _single_step(launched, fx: bool) -> dict:
    """The port's single-process float64 step on the global batch."""
    if fx not in launched.single:
        system = ranks.step_system(launched.weights, torch.float64, fx=fx)
        metrics = system.gradients(launched.batch, system.effect_flags(0), *launched.draws[fx])
        launched.single[fx] = ranks.step_result(system, metrics)
    return launched.single[fx]


@pytest.fixture(scope="module")
def jax_steps(launched):
    """JAX's float64 Method-1 steps over ``make_mesh(dp=2)``, and over
    ``make_mesh(dp=1, mp=2)`` (the track-parallel System, model and console)
    with the fx bus off and on, the reference-mix parameters injected: each
    step's loss and gradients as a port state dict, by (dp, mp, fx). The
    three compile one at a time, with XLA's optimization passes on: each
    compiles in about the same time as without them and then runs in under
    a second, not ten seconds on every core, which the test workers beside
    this one share. JAX's EQ grid is float64 (``_jax_sos_response``)."""
    from diffmst_tpu.ops import reverb as jax_reverb

    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", False)
    try:
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(sys.modules["diffmst_tpu.ops.eq"], "sos_frequency_response", _jax_sos_response)
            # JAX's reverb takes the FFT of its float32 filterbank in float32
            # even in a float64 run (ops/reverb.py:180, :108); the port in the
            # noise's dtype. The same float32 taps, in float64 here.
            bank = jax_reverb.octave_band_filterbank
            patch.setattr(jax_reverb, "octave_band_filterbank", lambda *a: bank(*a).astype(np.float64))
            return {c: _jax_mesh_step(launched, *c) for c in [(2, 1, False), (1, 2, False), (1, 2, True)]}
    finally:
        jax.config.update("jax_disable_most_optimizations", before)


def _jax_mesh_step(launched, dp: int, mp: int, fx: bool) -> dict:
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from diffmst_tpu.console import AdvancedMixConsole as JaxConsole
    from diffmst_tpu.losses import MultiResolutionSTFTLoss as JaxLoss
    from diffmst_tpu.models import MixStyleTransferModel as JaxModel
    from diffmst_tpu.parallel import make_mesh
    from diffmst_tpu.train import Batch as JaxBatch
    from diffmst_tpu.train import System as JaxSystem
    from diffmst_tpu.train import SystemConfig as JaxConfig
    from diffmst_torch.utils.checkpoint import state_dict_from_flax

    variables = _flax_variables(_port_model())
    tracks, ids, stereo, padding, ref_mix = _batch_arrays()
    mesh = make_mesh(dp=dp, mp=mp, devices=jax.devices()[: dp * mp])
    on = mesh if mp > 1 else None
    key = jax.random.PRNGKey(KEY)
    with jax.enable_x64(True):
        rp = [jnp.asarray(p.numpy(), jnp.float64) for p in launched.draws[fx][0]]

        def injected_mix(tracks_, console, key_, **flags):
            mix = console(tracks_, *rp, key=key_, **flags)
            return types.SimpleNamespace(mix=jax.lax.stop_gradient(mix.mix), track_params=rp[0],
                                         fx_bus_params=rp[1], master_bus_params=rp[2])

        system = JaxSystem(JaxModel.build(**SMALL, bn_axis_name=("dp", "mp") if on else None),
                           JaxConsole(SR, mesh=on, **ranks.REVERB), JaxLoss(**LOSS),
                           JaxConfig(**CONFIG, active_fx_bus_epoch=0 if fx else 1000), mix_fn=injected_mix, mesh=on)
        spec = NamedSharding(mesh, P("dp"))
        batch = JaxBatch(*(jax.device_put(jnp.asarray(a, jnp.float64 if a.dtype == np.float32 else a.dtype), spec)
                           for a in (tracks, ids, stereo, padding, ref_mix)))
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        params, stats = v["params"], v["batch_stats"]

        def loss_fn(p):
            return system._common(p, stats, batch, key, system.effect_flags(0), train=True)

        (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        grads = state_dict_from_flax(jax.tree.map(lambda a: np.asarray(a, np.float64),
                                                  {"params": grads, "batch_stats": aux["batch_stats"]}))
        return dict(loss=float(loss), grads=grads)


def _assert_matches_single(got: dict, ref: dict, what: str) -> None:
    """Loss terms, gradients and BatchNorm statistics within 1e-9 of each
    tensor's max-abs."""
    for k, v in ref["metrics"].items():
        assert abs(got["metrics"][k] - v) <= 1e-9 * max(abs(v), 1e-30), (what, k)
    for name, g in ref["grads"].items():
        assert _rel(got["grads"][name], g) <= 1e-9, (what, name)
    for name, b in ref["buffers"].items():
        assert _rel(got["buffers"][name], b) <= 1e-9, (what, name)


def _assert_matches_jax(got: dict, jax_ref: dict, what: str) -> None:
    assert abs(got["metrics"]["loss"] - jax_ref["loss"]) <= 1e-5 * abs(jax_ref["loss"]), what
    grad_norm = got["metrics"]["grad_norm"]
    for name, g in jax_ref["grads"].items():
        if name.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        # the port's .grad after gradients() is the unclipped gradient
        assert _rel(got["grads"][name], g) <= 1e-4, (what, name, grad_norm)


# ------------------------------------------------------------------- tests


def test_mesh_divisibility_guards():
    """A track axis that does not split over mp, and a global batch that
    does not split over dp, raise JAX's ValueError naming the fix: at the
    console's chain, the System's encoders and ``shard_batch``; and an
    mp-sharded train step of a model built without ``bn_axis_name``."""
    mesh = types.SimpleNamespace(shape={"dp": 2, "mp": 2}, coordinate=(0, 0), axis_names=("dp", "mp"))
    console = AdvancedMixConsole(SR, device="cpu", mesh=mesh)
    tracks = torch.zeros(2, 3, 4096)
    with pytest.raises(ValueError, match="console track chain: track axis 3 not divisible by mp=2"):
        console(tracks, torch.full((2, 3, 27), 0.5), torch.full((2, 25), 0.5), torch.full((2, 26), 0.5),
                use_fx_bus=False)
    with pytest.raises(ValueError, match="shard_batch: global batch 3 not divisible by dp=2"):
        parallel.shard_batch(Batch(torch.zeros(3, 2, 8), torch.zeros(3, 2), torch.zeros(3, 2),
                                   torch.zeros(3, 2, dtype=torch.bool), torch.zeros(3, 2, 8)), mesh)
    model = MixStyleTransferModel.build(**SMALL, device="cpu")
    system = ranks.step_system(model.state_dict(), torch.float32)
    system.mesh = mesh
    with pytest.raises(ValueError, match="mp-sharded encoders: track axis 3 not divisible by mp=2"):
        system._apply_model_mp(torch.zeros(1, 3, 8192), torch.zeros(1, 2, 8192), torch.zeros(1, 3, dtype=torch.bool),
                               False)
    with pytest.raises(ValueError, match=r"bn_axis_name=\('dp', 'mp'\)"):
        system._apply_model_mp(torch.zeros(1, 2, 8192), torch.zeros(1, 2, 8192), torch.zeros(1, 2, dtype=torch.bool),
                               True)


def test_dp_step_matches_one_process_and_jax(launched, jax_steps):
    """dp = 2: each rank's step (its row of the batch) equals the
    single-process step on the global batch, and JAX's dp = 2 step."""
    ref = _single_step(launched, False)
    jax_ref = jax_steps[2, 1, False]
    for r in _two(launched, "dp"):
        _assert_matches_single(r[False], ref, f"dp rank {r['rank']}")
        _assert_matches_jax(r[False], jax_ref, f"dp rank {r['rank']}")
    assert ref["metrics"]["grad_norm"] > 10.0  # the clip would be exercised


def test_dp_batchnorm_running_statistics(launched):
    """After a dp = 2 step the running statistics are the single-process
    ones, Flax's: 0.9 * old + 0.1 * the global batch's mean and biased
    variance (``torch.nn.SyncBatchNorm`` would move the variance by the
    unbiased one)."""
    ref = _single_step(launched, False)
    old = launched.weights
    got = _two(launched, "dp")[1][False]["buffers"]
    moved = 0
    for name, b in ref["buffers"].items():
        assert _rel(got[name], b) <= 1e-9, name
        if name.endswith("running_var"):
            moved += not torch.equal(b.float(), old[name])
    assert moved >= 12  # every BatchNorm of both encoders


@pytest.mark.parametrize("fx", [False, True], ids=["fx_off", "fx_on"])
def test_mp_step_matches_one_process_and_jax(launched, jax_steps, fx):
    """dp = 1 x mp = 2 (one track a rank in the track encoder and the
    console's chain, both encoders' BatchNorm over the mesh): the
    single-process step, and JAX's mp step with the console on the mesh."""
    ref = _single_step(launched, fx)
    jax_ref = jax_steps[1, 2, fx]
    for r in _two(launched, "mp"):
        _assert_matches_single(r[fx], ref, f"mp rank {r['rank']}")
        _assert_matches_jax(r[fx], jax_ref, f"mp rank {r['rank']}")


def test_mp_track_encoder_gradient_is_not_scaled_by_mp(launched):
    """The track encoder's gradient at mp = 2 is the single-process one,
    not twice it: the gather's backward takes this rank's slice, and the
    partial gradients are summed once."""
    ref = _single_step(launched, False)["grads"]
    got = _two(launched, "mp")[0][False]["grads"]
    names = [n for n in ref if n.startswith("track_encoder.") and ref[n].abs().max() > 0]
    assert len(names) >= 20
    for n in names:
        assert _rel(got[n], ref[n]) <= 1e-9, n
        assert _rel(got[n], 2.0 * ref[n]) >= 0.49, n


def test_group_batchnorm_keeps_float32_digits_off_a_zero_mean(launched):
    """dp = 2: ``batch_norm`` on float32 channels whose mean is a thousand
    times their spread. Each rank's output, input gradient and running
    statistics are the single-process ones and the float64 truth's, to
    float32's reach: the variance is taken in two passes (a one-pass
    E[x^2] - mean^2 puts it 12% off here, ``scripts/mesh_precision_torch.py``).
    The weight's and bias's gradients are the ranks' sum. The mean of float32 values near 10
    is off by some ulps of 10 (9.5e-7 each), about 1e-4 of the spread,
    which the normalized output and the weight's gradient carry: 1e-3 of
    their max-abs."""
    ref = ranks.batchnorms()
    x = ref["x"].double().requires_grad_(True)
    y = torch.nn.functional.batch_norm(x, None, None, torch.ones(3, dtype=torch.float64),
                                       torch.zeros(3, dtype=torch.float64), True, 0.0, 1e-5)
    y.backward(ref["dy"].double())
    var, mean = torch.var_mean(x.detach(), dim=(0, 2, 3), unbiased=False)
    got = _two(launched, "bn")
    for r, part in zip(got, (slice(0, 2), slice(2, 4))):
        for name, truth in (("y", y[part]), ("dx", x.grad[part])):
            assert _rel(r[name], truth) <= 1e-3, name
            assert _rel(r[name], ref[name][part]) <= 1e-3, name
        assert _rel(r["bn"]["running_var"], 0.1 * var) <= 1e-6
        assert _rel(r["bn"]["running_mean"], 0.1 * mean) <= 1e-6
        assert _rel(r["bn"]["running_var"], ref["bn"]["running_var"]) <= 1e-6
    for i in range(2):
        assert _rel(got[0]["bn_grads"][i] + got[1]["bn_grads"][i], ref["bn_grads"][i]) <= 1e-3


def test_input_batchnorm_over_the_mesh(launched):
    """dp = 2: the float64 ``SpectrogramEncoder`` with its input BatchNorm
    on and ``bn_axis_name=("dp", "mp")`` gives each rank its rows of the
    single-process output, the same running statistics (the input
    BatchNorm's too), and gradients that sum to the single-process ones,
    within 1e-9 of each tensor's max-abs."""
    ref = ranks.batchnorms()
    got = _two(launched, "bn")
    for r, part in zip(got, (slice(0, 2), slice(2, 4))):
        assert _rel(r["out"], ref["out"][part]) <= 1e-9
        for name, b in ref["enc_buffers"].items():
            assert _rel(r["enc_buffers"][name], b) <= 1e-9, name
    assert not torch.equal(ref["enc_buffers"]["bn.running_var"], torch.ones(2, dtype=torch.float64))
    for name, g in ref["enc_grads"].items():
        assert _rel(got[0]["enc_grads"][name] + got[1]["enc_grads"][name], g) <= 1e-9, name


def test_make_mesh_layout_and_errors(launched):
    """Rank r at (r // mp, r % mp) with its dp column and mp row as groups,
    as JAX's ``reshape(dp, mp)``; JAX's errors without a process group of
    the right size."""
    dp2 = _two(launched, "dp")
    assert [(r["coordinate"], r["dp_group"], r["mp_group"]) for r in dp2] == [
        ((0, 0), [0, 1], [0]), ((1, 0), [0, 1], [1])]
    mp2 = _two(launched, "mp")
    assert [(r["coordinate"], r["dp_group"], r["mp_group"]) for r in mp2] == [
        ((0, 0), [0], [0, 1]), ((0, 1), [1], [0, 1])]

    _settled(launched)
    with pytest.raises(RuntimeError, match="needs a process group"):
        parallel.make_mesh()
    assert parallel.launch(_one_rank_mesh, 1, device="cpu") == [((0, 0), {"dp": 1, "mp": 1})]
    assert not dist.is_initialized()


def _one_rank_mesh():
    with pytest.raises(ValueError, match=r"dp\*mp = 2\*1 != device count 1"):
        parallel.make_mesh(dp=2)
    with pytest.raises(ValueError, match=r"dp\*mp = 1\*2 != device count 1"):
        parallel.make_mesh(mp=2, dp=1)
    mesh = parallel.make_mesh()
    return mesh.coordinate, mesh.shape


def _single_fit(tmp_path, max_epochs=1, resume=None):
    """The single-process Trainer's fit."""
    system = ranks.trainer_system()
    trainer = Trainer(system, ranks.Data(), ckpt_dir=str(tmp_path), **{**ranks.TRAINER, "max_epochs": max_epochs})
    trainer.fit(resume=resume)
    return system, trainer


_INITIAL = {}


def _initial_state() -> dict:
    """The seeded Trainer System's state before any step."""
    if not _INITIAL:
        _INITIAL.update(ranks.trainer_system().model.state_dict())
    return _INITIAL


def _assert_fit_close(state, moments, system, history, ref_history) -> None:
    """JAX's mesh-test bounds: losses rtol 1e-3, parameters rtol 1e-4 and
    atol 8e-6; BatchNorm statistics as parameters. And the update itself:
    each leaf's change from the seeded state within 1e-3 of the
    reference's change (max-abs; a gradient element near Adam's eps turns
    a 1e-7 difference into 1e-4 of its step), every weight moved by more
    than that atol, and Adam's first moment, the global gradients'
    record, within 1e-6 of each leaf's max-abs; the logged gradient norm
    (before the clip, which would hide a gradient scaled as a whole)
    within 1e-6."""
    assert [h["loss"] for h in history] == pytest.approx([h["loss"] for h in ref_history], rel=1e-3)
    assert [h["grad_norm"] for h in history] == pytest.approx([h["grad_norm"] for h in ref_history], rel=1e-6)
    initial = _initial_state()
    for k, v in system.model.state_dict().items():
        if v.is_floating_point():
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-4, atol=8e-6, err_msg=k)
            assert _rel(state[k] - initial[k], v - initial[k]) <= 1e-3, k
    ref_moments = ranks.adam_moments(system)
    assert moments.keys() == ref_moments.keys() and len(moments) >= 20
    for k, m in ref_moments.items():
        assert _rel(moments[k], m) <= 1e-6, k
        assert (state[k] - initial[k]).abs().max() > 8e-6 or not m.any(), k  # no gradient, no step


@pytest.mark.parametrize("name", ["dp2", "dp2mp2"])
def test_fused_trainer_over_a_mesh(launched, tmp_path, name):
    """``Trainer(mesh=, fused_steps=2)`` (a group of 2 steps, staged and run
    eagerly on the CPU, and a validation pass) over dp = 2, and over dp = 2
    x mp = 2 with the track-parallel System: every rank ends with the same
    state, within JAX's bounds of the single-process Trainer's."""
    system, trainer = _single_fit(tmp_path)
    results = _two(launched, "fit") if name == "dp2" else launched.runs["four"].result()
    if name == "dp2mp2":
        assert [r["coordinate"] for r in results] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in results:
        assert r["step"] == system.step == 2
        for k, v in r["state"].items():
            assert torch.equal(v, results[0]["state"][k]), (r["rank"], k)
        assert torch.equal(r["generator"], system.generator.get_state())
        assert [h["loss"] for h in r["history"]] == [h["loss"] for h in results[0]["history"]]
        for k, m in r["moments"].items():
            assert torch.equal(m, results[0]["moments"][k]), (r["rank"], k)
    _assert_fit_close(results[0]["state"], results[0]["moments"], system, results[0]["history"], trainer.history)


def test_mesh_checkpoint_resumes_in_one_process(launched, tmp_path):
    """Rank 0 alone wrote the dp = 2 fit's checkpoints; resumed in one
    process for a second epoch, it takes the steps of a single-process run
    that never stopped."""
    results = _two(launched, "fit")
    assert results[0]["saves"] == ["last", "best"] and results[1]["saves"] == []
    resumed, res_trainer = _single_fit(tmp_path / "resumed", max_epochs=2,
                                       resume=str(pathlib.Path(launched.ckpts["dp2"]) / "last"))
    straight, trainer = _single_fit(tmp_path / "straight", max_epochs=2)
    assert resumed.step == straight.step == 4
    assert torch.equal(resumed.generator.get_state(), straight.generator.get_state())
    state = {k: v for k, v in resumed.model.state_dict().items()}
    _assert_fit_close(state, ranks.adam_moments(resumed), straight, res_trainer.history, trainer.history[1:])


def _overlay(path, root, **trainer):
    enc = {"embed_dim": 32, "n_fft": 2048, "hop_length": 128, "cnn_base_width": 2}
    path.write_text(yaml.safe_dump({
        "trainer": {"max_epochs": 1, "log_every_n_steps": 1, "default_root_dir": str(path.parent / "ckpts"),
                    "num_sanity_val_steps": 0, **trainer},
        "model": {"init_args": {
            "model": {"init_args": {"track_encoder": {"init_args": enc}, "mix_encoder": {"init_args": enc},
                                    "controller": {"init_args": {"embed_dim": 32, "num_layers": 1, "nhead": 4}}}},
            "loss": {"init_args": {"fft_sizes": [512], "hop_sizes": [256], "win_lengths": [512]}}}},
        "data": {"init_args": {
            "track_root_dirs": [str(root)], "metadata_files": [str(root / "meta.yaml")],
            "instrument_name2id_json": str(REPO / "data" / "instrument_name2id.json"),
            "length": 32768, "min_tracks": 2, "max_tracks": 4, "batch_size": 2,
            "num_examples_per_pass": 2, "num_train_passes": 1, "train_buffer_size_gb": 0.001,
            "val_buffer_size_gb": 0.001, "test_buffer_size_gb": 0.001}},
    }))
    shipped = ["configs/config.yaml", "configs/optimizer.yaml", "configs/data/synthetic-8.yaml",
               "configs/models/naive.yaml"]
    return [a for c in shipped + [str(path)] for a in ("-c", str(REPO / c))]


def test_cli_devices_fits_over_dp(tmp_path, corpus, monkeypatch):  # noqa: F811
    """``trainer.devices: 2`` with ``--device cpu``: two CPU ranks on a dp
    mesh fit one tiny epoch to step 1 (JAX's ``tests/test_cli.py:266-289``);
    rank 0 alone logs."""
    monkeypatch.chdir(tmp_path)
    out = main_torch.main(["fit", *_overlay(tmp_path / "dp.yaml", corpus, devices=2), "--device", "cpu"])
    assert [(r["rank"], r["coordinate"], r["mesh"], r["step"], r["system_mesh"]) for r in out] == [
        (0, (0, 0), {"dp": 2, "mp": 1}, 1, False), (1, (1, 0), {"dp": 2, "mp": 1}, 1, False)]
    assert out[0]["history"][0]["loss"] == out[1]["history"][0]["loss"]
    assert np.isfinite(out[0]["history"][0]["loss"])
    assert (tmp_path / "logs" / "metrics.csv").exists() and (tmp_path / "ckpts" / "last").exists()


def test_cli_mesh_builds_no_mp_system(tmp_path, corpus):  # noqa: F811
    """``trainer.mesh: {dp: 1, mp: 2}`` asks for two ranks; each builds its
    Trainer on the mesh and its System and console without it, as JAX's
    ``main.py`` builds them, so the mp ranks replicate each dp row's step
    (ROADMAP Queue 3). Rank 1 prints nothing."""
    from diffmst_torch.utils.config import load_config

    cfg = load_config(_overlay(tmp_path / "mp.yaml", corpus, mesh={"dp": 1, "mp": 2})[1::2])
    assert main_torch.mesh_request(cfg["trainer"], torch.device("cpu")) == (1, 2)
    mesh = types.SimpleNamespace(shape={"dp": 1, "mp": 2}, coordinate=(0, 1), rank=1, axis_names=("dp", "mp"))
    system, _, trainer = main_torch.build_from_config(cfg, "cpu", mesh=mesh)
    assert trainer.mesh is system.data_mesh is mesh and not trainer.is_main
    assert system.mesh is None and system.mix_console.mesh is None and not system.mp_sharded
    assert all(getattr(m, "bn_axis_name", None) is None for m in system.model.modules())


def test_cli_mesh_request(launched, monkeypatch):
    """What ``trainer.devices`` and ``trainer.mesh`` ask for
    (``main.py:59-77``): more devices than cards raise JAX's SystemExit
    and start nothing; ``auto`` takes every card (one rank on the CPU); a
    mesh spans every card."""
    _settled(launched)
    cpu, card = torch.device("cpu"), torch.device("cuda")
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="trainer.devices=2 but only 1 present"):
        main_torch.mesh_request({"devices": 2}, card)
    assert main_torch.mesh_request({"devices": "auto"}, card) == (1, 1)
    assert main_torch.mesh_request({"devices": -1}, cpu) == (1, 1)
    assert main_torch.mesh_request({"devices": 1}, card) is None
    assert main_torch.mesh_request({}, cpu) is None
    assert main_torch.mesh_request({"devices": 3}, cpu) == (3, 1)
    assert main_torch.mesh_request({"mesh": {"dp": 1}}, card) == (1, 1)
    assert main_torch.mesh_request({"mesh": {"mp": 2, "dp": 2}}, cpu) == (2, 2)
    with pytest.raises(ValueError, match=r"dp\*mp = 1\*2 != device count 1"):
        main_torch.mesh_request({"mesh": {"dp": 1, "mp": 2}}, card)


def test_ranks_of_one_host_read_the_same_songs(launched, corpus, monkeypatch):  # noqa: F811
    """Two ranks of one host (``LOCAL_WORLD_SIZE`` 2) take every song, the
    same global batches; the ranks shard songs by host only."""
    _settled(launched)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    songs = []
    for rank in range(2):
        monkeypatch.setattr(dist, "get_rank", lambda r=rank: r)
        monkeypatch.setenv("RANK", str(rank))
        assert tdataset._process_shard() == (0, 1)
        dm = tdataset.MultitrackDataModule(**_datamodule_args(corpus))
        songs.append([s for s, _ in dm.train_dataset.songs])
    assert songs[0] == songs[1] == ["train_song0", "train_song1", "train_song2"]
