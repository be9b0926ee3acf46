"""The Trainer's ``fused_steps`` in the PyTorch port, on the CPU.

On the CPU a group of K steps runs the staged steps of ``train/fused.py``
eagerly (on the card they are one CUDA graph replay;
``tests/test_torch_kernels_cuda.py`` holds that against eager steps):

  * (a) ``Trainer(fused_steps=2)`` against ``fused_steps=1`` on Method 1,
    the lr on a cosine over exactly the run's steps (each step its own
    lr), for ``torch.optim.Adam``, a bf16 first moment, the flattened
    update, accumulation over 2 batches, and the fx bus turned on in a
    second epoch (two reverb noises a step drawn from the group's staged
    seeds; a new group of steps for the new flags, the old one released):
    the logged losses, parameters,
    BatchNorm statistics, optimizer state, generator state, ``step`` and
    ``updates`` bitwise equal, or within 1e-6 of each tensor's max-abs;
  * (b) the port's ``Trainer(fused_steps=2).fit`` on Method 2 against JAX's
    on the same batches from the same weights (random values in JAX's
    Flax tree, carried across by ``state_dict_from_flax``), at
    ``tests/test_train.py``'s tolerances: losses rtol 1e-3, parameters rtol
    1e-4 and atol 8e-6 at lr 1e-6;
  * (c) the refusals: batches left over (``ValueError``, as JAX), a KE mix
    (``ValueError``, as JAX's ``make_train_step``); what JAX takes
    (``skip_nonfinite_updates``, an accumulation that does not divide K)
    built;
  * (d) log and checkpoint points by JAX's block arithmetic, and a resume
    from a fused run's checkpoint in a sequential run and the other way
    round;
  * (e) the updates the device decides (``System._apply_on_device``):
    ``Trainer(fused_steps=2)`` against ``fused_steps=1`` with batches
    poisoned by a NaN under ``skip_nonfinite_updates=2`` (one, and three
    in a row, the third of which updates), an accumulation of 3, and both
    at once with ``torch.optim.Adam`` and with a bf16 first moment; groups
    that start inside an accumulation, and groups of shape A, B, then A
    (a staged set of buffers a shape), against eager steps: bitwise or
    within 1e-6 of each tensor's max-abs, NaN where the sequential run has
    NaN (the BatchNorm statistics of a poisoned step, kept as JAX keeps
    them); and the port's fused Method-2 fit with both options against
    JAX's on poisoned batches, at (b)'s tolerances.

Sizes: a 1-layer, embed-32, Cnn14-width-2 model (n_fft 2048, hop 32) on 1 x 2
x 8,192 samples (Method 1; (e) mostly 1 x 1 x 8,192) and 1 x 2 x 4,096
(Method 2).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmst_torch.console import AdvancedMixConsole
from diffmst_torch.losses import MultiResolutionSTFTLoss
from diffmst_torch.mixing import knowledge_engineering_mix
from diffmst_torch.models import MixStyleTransferModel
from diffmst_torch.train import Batch, System, SystemConfig, Trainer
from diffmst_torch.train.fused import FusedSteps
from diffmst_torch.utils.checkpoint import state_dict_from_flax
from tests.test_torch_tpu_recipe import _random_variables

torch.set_num_threads(1)

SR = 44100.0
TINY = dict(embed_dim=32, num_layers=1, nhead=4, n_fft=2048, hop_length=32, cnn_base_width=2)
TINY_LOSS = dict(fft_sizes=(512,), hop_sizes=(256,), win_lengths=(512,))
BS, NT = 1, 2


def _raw_batches(n, t, seed=0, nt=NT):
    """n collated host batches (tracks, stereo, instr, padding, mix, names)
    of ``nt`` tracks, each with its own envelope (so each step has its own
    loss) and a real reference mix for Method 2."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        env = np.abs(np.sin(np.linspace(0.0, (3 + i) * np.pi, t)))
        tracks = (rng.normal(size=(BS, nt, t)) * 0.1 * env).astype(np.float32)
        mix = (rng.normal(size=(BS, 2, t)) * 0.1 * env).astype(np.float32)
        ids = np.zeros((BS, nt), np.int32)
        out.append((tracks, ids, ids, np.zeros((BS, nt), bool), mix, [f"s{i}"] * BS))
    return out


class _Data:
    def __init__(self, n_train=4, t=8192, poison=(), nt=NT):
        self.train = _raw_batches(n_train, t, nt=nt)
        for i in poison:  # a NaN in the first track (tests/test_train.py's poisoned batch)
            self.train[i][0][0, 0, 0] = np.nan

    def train_dataloader(self):
        return iter(self.train)

    def val_dataloader(self):
        return iter(self.train[:1])


def _system(seed=0, mix_fn=None, **config):
    model = MixStyleTransferModel.build(**TINY, device="cpu", generator=torch.Generator().manual_seed(seed))
    cfg = dict(lr=1e-3, steps_per_epoch=4, max_epochs=1, schedule="cosine")
    cfg.update(config)
    extra = {} if mix_fn is None else {"mix_fn": mix_fn}
    return System(model, AdvancedMixConsole(SR, device="cpu"), MultiResolutionSTFTLoss(**TINY_LOSS),
                  SystemConfig(**cfg), device="cpu", **extra)


def _fit(k, ckpt_dir, config=None, resume=None, max_epochs=1, saves=None, n_train=4, data=None, **trainer):
    """A fit of ``fused_steps=k`` over ``n_train`` batches an epoch (or
    ``data``'s); ``saves`` (a list) records each checkpoint's (name,
    step)."""
    data = data if data is not None else _Data(n_train)
    tr = Trainer(_system(**(config or {})), data, max_epochs=max_epochs, ckpt_dir=str(ckpt_dir),
                 log_every_n_steps=1, seed=7, check_val_every_n_epoch=100, fused_steps=k, **trainer)
    if saves is not None:
        save = tr._save
        tr._save = lambda name, next_epoch: (saves.append((name, tr.system.step)), save(name, next_epoch))
    tr.fit(resume=resume)
    return tr


def _assert_same(a, b, what="", nan_equal=False):
    """Nests of tensors and numbers: equal, a tensor bitwise or within 1e-6
    of its max-abs; with ``nan_equal``, a float tensor's NaNs where the
    other's are and the rest so."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for key in a:
            _assert_same(a[key], b[key], f"{what}/{key}", nan_equal)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]", nan_equal)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        if nan_equal and a.is_floating_point():
            assert torch.equal(a.isnan(), b.isnan()), f"{what}: NaN in other places"
            a, b = a.nan_to_num(0.0), b.nan_to_num(0.0)
        if not torch.equal(a, b):
            err = float((a.double() - b.double()).abs().max())
            assert err <= 1e-6 * float(b.double().abs().max()), f"{what}: {err:.3g}"
    else:
        assert a == b, f"{what}: {a} != {b}"


def _assert_runs_equal(seq: Trainer, fused: Trainer) -> None:
    a, b = seq.system, fused.system
    # the fused run logs once a group (JAX's blocks), the group's last step
    assert [h["loss"] for h in fused.history] == [h["loss"] for h in seq.history][1::2]
    _assert_same(a.state_dict(), b.state_dict(), "state")
    assert (a.step, a.updates) == (b.step, b.updates) == (4, 4 // a.config.accumulate_grad_batches)


@pytest.fixture(scope="module")
def adam_runs(tmp_path_factory):
    """The sequential and the fused fit with ``torch.optim.Adam`` (shared by
    (a) and (d)): checkpoints every 3 steps, with the (name, step) of
    each save."""
    runs = {}
    for k in (1, 2):
        saves = []
        d = tmp_path_factory.mktemp(f"adam{k}")
        runs[k] = (_fit(k, d, saves=saves, ckpt_every_n_steps=3), d, saves)
    return runs


CASES = {"bf16_mu": {"adam_mu_dtype": "bfloat16"}, "flatten": {"flatten_optimizer": True},
         "accumulate2": {"accumulate_grad_batches": 2},
         # two epochs of one group; epoch 1 turns the fx bus on
         "fx_bus": {"active_fx_bus_epoch": 1}}


@pytest.mark.parametrize("name", ["torch_adam", *CASES])
def test_fused_fit_equals_sequential(name, adam_runs, tmp_path, monkeypatch):
    """(a) Two groups of two steps equal four sequential steps."""
    epochs = 2 if name == "fx_bus" else 1
    released = []
    release = FusedSteps.release
    monkeypatch.setattr(FusedSteps, "release", lambda self: (released.append(self.flags), release(self)))
    if name == "torch_adam":
        seq, fused = adam_runs[1][0], adam_runs[2][0]
    else:
        seq, fused = (_fit(k, tmp_path / str(k), CASES[name], max_epochs=epochs, n_train=4 // epochs,
                           enable_checkpointing=False) for k in (1, 2))
    lrs = [seq.system.lr_at(u) for u in range(4)]
    assert len(set(lrs)) == 4  # each update its own learning rate
    _assert_runs_equal(seq, fused)
    if name == "fx_bus":
        assert [f.use_fx_bus for f in released] == [False]  # epoch 0's steps, when epoch 1's came
        assert fused.system.effect_flags(1).use_fx_bus


@pytest.fixture(scope="module")
def jax_fused_fit(tmp_path_factory):
    """JAX's ``Trainer(fused_steps=2).fit`` on Method 2: its initial
    variables, its final ones, its logged losses and its step."""
    from diffmst_tpu.console import AdvancedMixConsole as JaxConsole
    from diffmst_tpu.losses import MultiResolutionSTFTLoss as JaxLoss
    from diffmst_tpu.models import MixStyleTransferModel as JaxModel
    from diffmst_tpu.train import System as JaxSystem
    from diffmst_tpu.train import SystemConfig as JaxConfig
    from diffmst_tpu.train import Trainer as JaxTrainer
    from diffmst_tpu.train.system import TrainState

    system = JaxSystem(JaxModel.build(**TINY), JaxConsole(SR), JaxLoss(**TINY_LOSS),
                       JaxConfig(**METHOD2))
    seen = {}
    host = lambda tree: jax.tree.map(np.array, tree)  # noqa: E731 (copies: the fit donates the state)

    def seeded_init(key, example):
        """JAX's ``System.init`` with seeded random variables in the model's
        Flax tree (``jax.eval_shape``: no init compiled)."""
        v = _random_variables(system.model, 0, example.tracks[:1], example.ref_mix[:1],
                              example.track_padding[:1])
        seen["init"] = v
        params, stats = (jax.tree.map(jnp.asarray, v[c]) for c in ("params", "batch_stats"))
        return TrainState(params, stats, system.optimizer.init(params), jnp.zeros((), jnp.int32))

    system.init = seeded_init
    trainer = JaxTrainer(system, _Data(t=4096), max_epochs=1, ckpt_dir=str(tmp_path_factory.mktemp("jax")),
                         log_every_n_steps=2, check_val_every_n_epoch=100, fused_steps=2,
                         enable_checkpointing=False, seed=0)
    state = trainer.fit()
    end = {"params": host(state.params), "batch_stats": host(state.batch_stats)}
    return seen["init"], end, [h["loss"] for h in trainer.history], int(jnp.asarray(state.step))


METHOD2 = dict(generate_mix=False, lr=1e-6, steps_per_epoch=4, max_epochs=1)


def test_fused_method2_fit_matches_jax(jax_fused_fit, tmp_path):
    """(b) The port's fused Method-2 fit against JAX's, from the same weights."""
    start, end, jax_losses, jax_step = jax_fused_fit
    model = MixStyleTransferModel.build(**TINY, device="cpu")
    model.load_state_dict(state_dict_from_flax(start), strict=False)
    system = System(model, AdvancedMixConsole(SR, device="cpu"), MultiResolutionSTFTLoss(**TINY_LOSS),
                    SystemConfig(**METHOD2), device="cpu")
    trainer = Trainer(system, _Data(t=4096), max_epochs=1, ckpt_dir=str(tmp_path), log_every_n_steps=2,
                      check_val_every_n_epoch=100, fused_steps=2, enable_checkpointing=False, seed=0)
    trainer.fit()
    assert system.step == jax_step == 4
    losses = [h["loss"] for h in trainer.history]
    assert len(losses) == len(jax_losses) == 2
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-3)
    want = state_dict_from_flax(end)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4, atol=8e-6,
                                   err_msg=name)


def test_fused_refusals_match_jax(tmp_path):
    """(c) What JAX refuses, refused with its error types; what JAX takes
    (non-finite skipping, an accumulation that does not divide K), taken."""
    from diffmst_tpu.mixing import knowledge_engineering_mix as jax_ke
    from diffmst_tpu.train import System as JaxSystem

    with pytest.raises(ValueError, match="fused_steps"):  # one batch left over, no step run
        Trainer(_system(), _Data(n_train=1), max_epochs=1, ckpt_dir=str(tmp_path), fused_steps=2,
                check_val_every_n_epoch=100).fit()
    flags = _system().effect_flags(0)
    with pytest.raises(ValueError, match="host-side mix_fn"):
        FusedSteps(_system(mix_fn=knowledge_engineering_mix), flags, 2)
    with pytest.raises(ValueError, match="host-side mix_fn"):
        JaxSystem(None, None, None, mix_fn=jax_ke).make_train_step(flags, donate=False)
    FusedSteps(_system(mix_fn=knowledge_engineering_mix, generate_mix=False), flags, 2)  # Method 2: no draw
    FusedSteps(_system(skip_nonfinite_updates=1), flags, 2)
    FusedSteps(_system(accumulate_grad_batches=3), flags, 2)
    FusedSteps(_system(accumulate_grad_batches=2), flags, 4)


def test_fused_log_checkpoint_points_and_resume(adam_runs, tmp_path):
    """(d) The log and checkpoint points of JAX's blocks: a fused run logs
    after each group and saves after the group that passes step 3; the
    sequential run saves at step 3. A fused run's checkpoint resumed in a
    sequential run equals a sequential run's resumed in a fused run."""
    (seq, seq_dir, seq_saves), (fused, fused_dir, fused_saves) = adam_runs[1], adam_runs[2]
    assert [h["epoch"] for h in seq.history] == [0] * 4 and len(fused.history) == 2
    assert seq_saves == [("last", 3), ("last", 4)]
    assert fused_saves == [("last", 4), ("last", 4)]
    for d in (seq_dir, fused_dir):
        assert json.loads((d / "last.meta.json").read_text()) == {
            "next_epoch": 1, "step": 4, "steps_per_epoch": 4}
    cfg = {"steps_per_epoch": 8}  # the cosine over both epochs
    seq_then = _fit(1, tmp_path / "a", cfg, resume=str(fused_dir / "last"), max_epochs=2,
                    enable_checkpointing=False)
    fused_then = _fit(2, tmp_path / "b", cfg, resume=str(seq_dir / "last"), max_epochs=2,
                      enable_checkpointing=False)
    assert seq_then.system.step == fused_then.system.step == 8
    assert [h["epoch"] for h in fused_then.history] == [1, 1]
    _assert_same(seq_then.system.state_dict(), fused_then.system.state_dict(), "resumed")
    assert [h["loss"] for h in fused_then.history] == [h["loss"] for h in seq_then.history][1::2]


def test_load_state_dict_restores_in_place():
    """``System.load_state_dict`` copies into the tensors the System holds
    (parameters, statistics, Adam's moments and steps, the accumulated
    gradients), which a captured graph keeps reading."""
    system = _system(accumulate_grad_batches=2)
    flags = system.effect_flags(0)
    batches = [Batch(*map(torch.from_numpy, raw[:5])) for raw in _raw_batches(3, 8192)]
    for b in batches[:2]:
        system.train_step(b, flags)
    tensors = FusedSteps(system, flags, 2)._state_tensors()
    assert system._acc is not None and len(tensors) > len(system.params)
    saved = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in system.state_dict().items()}
    saved = {**saved, "model": {k: v.clone() for k, v in saved["model"].items()},
             "optimizer": {"state": {i: {k: v.clone() for k, v in st.items()}
                                     for i, st in saved["optimizer"]["state"].items()},
                           "param_groups": saved["optimizer"]["param_groups"]},
             "acc": [a.clone() for a in saved["acc"]]}
    system.train_step(batches[2], flags)
    system.load_state_dict(saved)
    assert [t.data_ptr() for t in FusedSteps(system, flags, 2)._state_tensors()] == [t.data_ptr() for t in tensors]
    _assert_same(system.state_dict(), saved, "restored")


# ------------------------------------------------ the device decides (e)

# (config, batches, the poisoned ones)
MASKED = {
    "skip2": ({"skip_nonfinite_updates": 2}, 4, (1,)),
    # the third in a row updates (optax's apply_if_finite): NaN parameters
    "skip2_three_in_a_row": ({"skip_nonfinite_updates": 2}, 4, (1, 2, 3)),
    # groups start 0 and 2 steps into an accumulation
    "accumulate3": ({"accumulate_grad_batches": 3}, 4, ()),
    # the poisoned step inside an accumulation, the next one updates
    "both_bf16_mu": ({"skip_nonfinite_updates": 2, "accumulate_grad_batches": 3, "adam_mu_dtype": "bfloat16"},
                     4, (1,)),
    "both_torch_adam": ({"skip_nonfinite_updates": 2, "accumulate_grad_batches": 3}, 4, (1,)),
}


def _history(tr, key):
    return np.array([h.get(key, -1.0) for h in tr.history])


@pytest.mark.parametrize("name", list(MASKED))
def test_fused_device_decided_updates_equal_sequential(name, tmp_path):
    """(e) ``Trainer(fused_steps=2).fit`` against ``fused_steps=1`` where
    the device decides which steps update: the logged losses and
    non-finite counts, parameters, BatchNorm statistics (NaN after a
    poisoned step on both sides), optimizer state, generator state and
    counters."""
    config, n, poison = MASKED[name]
    config = {**config, "steps_per_epoch": n}
    seq, fused = (_fit(k, tmp_path / str(k), config, data=_Data(n, poison=poison, nt=1), enable_checkpointing=False)
                  for k in (1, 2))
    for key in ("loss", "notfinite_count"):
        np.testing.assert_array_equal(_history(fused, key), _history(seq, key)[1::2], err_msg=key)
    a, b = seq.system, fused.system
    assert b.counters is not None  # the device held the counters
    _assert_same(a.state_dict(), b.state_dict(), "state", nan_equal=True)
    counters = [(s.step, s.updates, s.notfinite_count, s._mini_step) for s in (a, b)]
    assert counters[0] == counters[1], counters
    skipped = a.config.skip_nonfinite_updates and poison
    if name == "skip2_three_in_a_row":
        assert counters[0][1:3] == (2, 3) and any(p.isnan().any() for p in b.params)
    elif skipped:
        assert counters[0][2] == 0 and not any(p.isnan().any() for p in b.params)
        assert any(buf.isnan().any() for buf in b.model.buffers())  # the poisoned step's statistics
    if "accumulate_grad_batches" in config:
        assert counters[0][1] == (n - bool(skipped)) // 3


def _batches(n, poison=(), nt=NT):
    return [Batch(*map(torch.from_numpy, raw[:5])) for raw in _Data(n, poison=poison, nt=nt).train]


def _eager(system, batches, flags):
    return [float(system.train_step(b, flags)["loss"]) for b in batches]


@pytest.mark.parametrize("accumulate", [2, 3], ids=["host_decides", "device_decides"])
def test_fused_group_starts_inside_an_accumulation(accumulate):
    """(e) One eager step, then two groups of two that start one step into
    an accumulation (with an accumulation of 3, at offsets 1 and 0: the
    device decides), against five eager steps."""
    config = dict(accumulate_grad_batches=accumulate, steps_per_epoch=5)
    batches = _batches(5, nt=1)
    seq, fused = _system(**config), _system(**config)
    flags = seq.effect_flags(0)
    want = _eager(seq, batches, flags)
    got = _eager(fused, batches[:1], flags)
    steps = FusedSteps(fused, flags, 2)
    assert steps.on_device == (accumulate == 3)
    for group in (batches[1:3], batches[3:5]):
        got += [float(m["loss"]) for m in steps(group)]
    assert got == want
    _assert_same(seq.state_dict(), fused.state_dict(), "state")
    assert (seq.updates, seq._mini_step) == (fused.updates, fused._mini_step) == divmod(5, accumulate)


def test_fused_groups_of_new_shapes():
    """(e) Groups of two batches of two tracks, then of one (the second
    group, with a poisoned batch: non-finite skipping, the device
    decides), then of two again, against eager steps: each shape its own
    staged buffers, the counters learned across them. A group of mixed
    shapes raises, as JAX's ``jnp.stack`` does."""
    config = dict(skip_nonfinite_updates=2, steps_per_epoch=6)
    two = _batches(6, poison=(3,))
    one = [b._replace(tracks=b.tracks[:, :1], instrument_id=b.instrument_id[:, :1],
                      stereo_info=b.stereo_info[:, :1], track_padding=b.track_padding[:, :1]) for b in two[2:4]]
    groups = [two[:2], one, two[4:]]
    seq, fused = _system(**config), _system(**config)
    flags = seq.effect_flags(0)
    want = np.array([x for g in groups for x in _eager(seq, g, flags)])
    steps = FusedSteps(fused, flags, 2)
    got = np.array([float(m["loss"]) for g in groups for m in steps(g)])
    np.testing.assert_array_equal(got, want)
    assert len(steps._groups) == 2
    _assert_same(seq.state_dict(), fused.state_dict(), "state", nan_equal=True)
    assert (seq.updates, seq.notfinite_count) == (fused.updates, fused.notfinite_count) == (5, 0)
    with pytest.raises(ValueError, match="shapes"):
        steps([two[0], one[0]])


@pytest.fixture(scope="module")
def jax_masked_fit(tmp_path_factory):
    """JAX's ``Trainer(fused_steps=2).fit`` on Method 2 with
    ``skip_nonfinite_updates=2`` and ``accumulate_grad_batches=2``, batch 1
    of 4 poisoned: its initial variables, its final parameters, its logged
    losses."""
    from diffmst_tpu.console import AdvancedMixConsole as JaxConsole
    from diffmst_tpu.losses import MultiResolutionSTFTLoss as JaxLoss
    from diffmst_tpu.models import MixStyleTransferModel as JaxModel
    from diffmst_tpu.train import System as JaxSystem
    from diffmst_tpu.train import SystemConfig as JaxConfig
    from diffmst_tpu.train import Trainer as JaxTrainer
    from diffmst_tpu.train.system import TrainState

    system = JaxSystem(JaxModel.build(**TINY), JaxConsole(SR), JaxLoss(**TINY_LOSS), JaxConfig(**METHOD2_MASKED))
    seen = {}

    def seeded_init(key, example):
        v = _random_variables(system.model, 0, example.tracks[:1], example.ref_mix[:1], example.track_padding[:1])
        seen["init"] = v
        params, stats = (jax.tree.map(jnp.asarray, v[c]) for c in ("params", "batch_stats"))
        return TrainState(params, stats, system.optimizer.init(params), jnp.zeros((), jnp.int32))

    system.init = seeded_init
    trainer = JaxTrainer(system, _Data(t=4096, poison=(1,)), max_epochs=1,
                         ckpt_dir=str(tmp_path_factory.mktemp("jax_masked")), log_every_n_steps=2,
                         check_val_every_n_epoch=100, fused_steps=2, enable_checkpointing=False, seed=0)
    state = trainer.fit()
    return seen["init"], jax.tree.map(np.array, state.params), [h["loss"] for h in trainer.history]


METHOD2_MASKED = dict(METHOD2, skip_nonfinite_updates=2, accumulate_grad_batches=2)


def test_fused_device_decided_fit_matches_jax(jax_masked_fit, tmp_path):
    """(e) The port's fused Method-2 fit with non-finite skipping and an
    accumulation of 2 against JAX's, on the same poisoned batches: the
    poisoned step skipped, the update of steps 0 and 2 taken, as optax's
    ``apply_if_finite(MultiSteps(...))`` takes them."""
    start, end, jax_losses = jax_masked_fit
    model = MixStyleTransferModel.build(**TINY, device="cpu")
    model.load_state_dict(state_dict_from_flax(start), strict=False)
    system = System(model, AdvancedMixConsole(SR, device="cpu"), MultiResolutionSTFTLoss(**TINY_LOSS),
                    SystemConfig(**METHOD2_MASKED), device="cpu")
    trainer = Trainer(system, _Data(t=4096, poison=(1,)), max_epochs=1, ckpt_dir=str(tmp_path),
                      log_every_n_steps=2, check_val_every_n_epoch=100, fused_steps=2,
                      enable_checkpointing=False, seed=0)
    trainer.fit()
    assert (system.step, system.updates, system.notfinite_count, system._mini_step) == (4, 1, 0, 1)
    losses = [h["loss"] for h in trainer.history]
    assert np.isnan(losses[0]) and np.isnan(jax_losses[0])  # the poisoned step
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-3)
    want, before = state_dict_from_flax({**start, "params": end}), state_dict_from_flax(start)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4, atol=8e-6,
                                   err_msg=name)
    assert any(not torch.equal(p.detach(), before[name]) for name, p in model.named_parameters())  # it updated
