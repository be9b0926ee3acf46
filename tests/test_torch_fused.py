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
    (``ValueError``, as JAX's ``make_train_step``), and what ROADMAP item
    12d records: ``skip_nonfinite_updates`` and an accumulation that does
    not divide K;
  * (d) log and checkpoint points by JAX's block arithmetic, and a resume
    from a fused run's checkpoint in a sequential run and the other way
    round.

Sizes: a 1-layer, embed-32, Cnn14-width-2 model (n_fft 2048, hop 32) on 1 x 2
x 8,192 samples (Method 1) and 1 x 2 x 4,096 (Method 2).
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


def _raw_batches(n, t, seed=0):
    """n collated host batches (tracks, stereo, instr, padding, mix, names),
    each with its own envelope (so each step has its own loss) and a real
    reference mix for Method 2."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        env = np.abs(np.sin(np.linspace(0.0, (3 + i) * np.pi, t)))
        tracks = (rng.normal(size=(BS, NT, t)) * 0.1 * env).astype(np.float32)
        mix = (rng.normal(size=(BS, 2, t)) * 0.1 * env).astype(np.float32)
        ids = np.zeros((BS, NT), np.int32)
        out.append((tracks, ids, ids, np.zeros((BS, NT), bool), mix, [f"s{i}"] * BS))
    return out


class _Data:
    def __init__(self, n_train=4, t=8192):
        self.train = _raw_batches(n_train, t)

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


def _fit(k, ckpt_dir, config=None, resume=None, max_epochs=1, saves=None, n_train=4, **trainer):
    """A fit of ``fused_steps=k`` over ``n_train`` batches an epoch;
    ``saves`` (a list) records each checkpoint's (name, step)."""
    tr = Trainer(_system(**(config or {})), _Data(n_train), max_epochs=max_epochs, ckpt_dir=str(ckpt_dir),
                 log_every_n_steps=1, seed=7, check_val_every_n_epoch=100, fused_steps=k, **trainer)
    if saves is not None:
        save = tr._save
        tr._save = lambda name, next_epoch: (saves.append((name, tr.system.step)), save(name, next_epoch))
    tr.fit(resume=resume)
    return tr


def _assert_same(a, b, what=""):
    """Nests of tensors and numbers: equal, a tensor bitwise or within 1e-6
    of its max-abs."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for key in a:
            _assert_same(a[key], b[key], f"{what}/{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, what
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
    """(c) What JAX refuses, refused with its error types; and what ROADMAP
    item 12d records."""
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
    with pytest.raises(NotImplementedError, match="item 12d"):
        FusedSteps(_system(skip_nonfinite_updates=1), flags, 2)
    with pytest.raises(NotImplementedError, match="item 12d"):
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
