"""The rank side of ``tests/test_torch_mesh.py``: functions that
``diffmst_torch.parallel.launch`` runs in each spawned rank.

This module imports no JAX (each spawned rank imports it by name), and each
rank computes with one thread.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from diffmst_torch import parallel
from diffmst_torch.console import AdvancedMixConsole
from diffmst_torch.losses import MultiResolutionSTFTLoss
from diffmst_torch.models import MixStyleTransferModel
from diffmst_torch.train import Batch, System, SystemConfig, Trainer
from diffmst_torch.utils.device import use_full_float32

SR = 44100.0
# tests/test_torch_train.py's toy step: the JAX step compiles at these sizes
SMALL = dict(embed_dim=32, num_layers=1, nhead=4, n_fft=2048, hop_length=32, cnn_base_width=4)
LOSS = dict(fft_sizes=(512, 2048), hop_sizes=(128, 512), win_lengths=(512, 2048))
CONFIG = dict(lr=1e-3, steps_per_epoch=10, max_epochs=10)
# the fx bus's reverb at tests/test_torch_fxbus.py's sizes
REVERB = dict(reverb_num_samples=4096, reverb_num_taps=63)
# the Trainer's: Cnn14 width 2, one MRSTFT resolution, 2 x 2 x 8,192 a batch,
# float64 (see trainer_system)
TINY = dict(SMALL, cnn_base_width=2)
TINY_LOSS = dict(fft_sizes=(512,), hop_sizes=(256,), win_lengths=(512,))
TRAIN_BS, TRAIN_NT, TRAIN_T = 2, 2, 8192
TRAINER = dict(max_epochs=1, log_every_n_steps=1, check_val_every_n_epoch=1, fused_steps=2)


def step_system(weights, dtype, mesh=None, mp_sharded=False, fx=False, device="cpu", **config) -> System:
    """The toy System from ``weights`` on ``device``: with ``mp_sharded``,
    its model built with ``bn_axis_name=("dp", "mp")`` and System and
    console on ``mesh``; else the System of one process, which
    ``distribute`` can put on a mesh."""
    model = MixStyleTransferModel.build(**SMALL, device=device,
                                        bn_axis_name=("dp", "mp") if mp_sharded else None)
    model.load_state_dict(weights, strict=True)
    model.to(dtype)
    on = mesh if mp_sharded else None
    cfg = SystemConfig(**{**CONFIG, "active_fx_bus_epoch": 0 if fx else 1000, **config})
    return System(model, AdvancedMixConsole(SR, device=str(device), mesh=on, **REVERB),
                  MultiResolutionSTFTLoss(**LOSS), cfg, device=device, mesh=on)


def step_result(system: System, metrics) -> dict:
    """A step's metrics, gradients and BatchNorm statistics, on the host."""
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                grads={n: p.grad.detach().cpu().clone() for n, p in system.model.named_parameters()},
                buffers={n: b.detach().cpu().clone() for n, b in system.model.named_buffers()})


def two_ranks(weights, batch: Batch, draws: dict, ckpt_dir: str) -> dict:
    """What the tests run on two ranks: the dp = 2 step (fx bus off), the
    dp = 1 x mp = 2 steps (off and on), the dp = 2 BatchNorms and the
    dp = 2 fit."""
    torch.set_num_threads(1)
    return dict(dp=mesh_step(weights, batch, {False: draws[False]}, 2, 1, False),
                mp=mesh_step(weights, batch, draws, 1, 2, True),
                bn=batchnorms(parallel.make_mesh(2, 1)),
                fit=mesh_fit(2, 1, ckpt_dir))


# ------------------------------------------------------------- BatchNorm

BN_OFFSET = 10.0  # the float32 channels' mean, a thousand times their spread


def batchnorms(mesh=None) -> dict:
    """Two train-mode BatchNorms, forward and backward, on this rank's rows
    of a seeded global batch of 4 (every row without ``mesh``): Cnn14's
    ``batch_norm`` on float32 channels of mean ``BN_OFFSET`` and spread
    0.01; and the float64 ``SpectrogramEncoder`` with its input BatchNorm on
    (magnitude spectrograms, whose mean is far off zero too) and
    ``bn_axis_name=("dp", "mp")``. Outputs, input and weight gradients
    (this rank's part of the sum) and running statistics."""
    from diffmst_torch.models.cnn14 import batch_norm
    from diffmst_torch.models.encoders import SpectrogramEncoder

    rng = np.random.default_rng(7)
    x = torch.from_numpy((BN_OFFSET + 0.01 * rng.normal(size=(4, 3, 8, 16))).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    wave = torch.from_numpy(rng.normal(size=(4, 2, 8192)) * 0.1)
    dout = torch.from_numpy(rng.normal(size=(4, 8)))
    rows = slice(None) if mesh is None else parallel.batch_rows(mesh, 4 // mesh.shape["dp"])[1]
    bn = torch.nn.BatchNorm2d(3)
    bn.running_var.zero_()  # the moved statistics alone: 0.1 * the batch's
    with torch.random.fork_rng():  # the encoder's default init, seeded; the caller's RNG left alone
        torch.manual_seed(0)
        enc = SpectrogramEncoder(embed_dim=8, n_fft=2048, hop_length=64, n_inputs=2, cnn_base_width=2,
                                 input_batchnorm=True, bn_axis_name=("dp", "mp")).double()
    xs = x[rows].clone().requires_grad_(True)
    with parallel.bound(mesh):
        y = batch_norm(bn, xs, True)
        y.backward(dy[rows])
        out = enc(wave[rows], train=True)
        out.backward(dout[rows])
    return dict(x=x, dy=dy, y=y.detach(), dx=xs.grad, bn={n: t.detach().clone() for n, t in bn.state_dict().items()},
                bn_grads=[bn.weight.grad, bn.bias.grad], out=out.detach(),
                enc_grads={n: p.grad.clone() for n, p in enc.named_parameters()},
                enc_buffers={n: b.clone() for n, b in enc.named_buffers()})


def mesh_step(weights, batch: Batch, draws: dict, dp: int, mp: int, mp_sharded: bool,
              dtype=torch.float64) -> dict:
    """One Method-1 step (forward, backward, the gradients reduced) over a
    (dp, mp) mesh on this rank's device, for each ``draws`` entry (fx bus
    off or on: the global batch's reference-mix parameters and reverb
    noise)."""
    mesh = parallel.make_mesh(dp, mp)
    device = parallel.rank_device()
    use_full_float32()  # on the card: no TF32, whose rounding follows the batch's shape
    torch.backends.cudnn.deterministic = True  # and a step's sums in one order
    out = {"coordinate": mesh.coordinate, "rank": mesh.rank,
           "dp_group": torch.distributed.get_process_group_ranks(mesh.group(("dp",))),
           "mp_group": torch.distributed.get_process_group_ranks(mesh.group(("mp",)))}
    for fx, (ref_params, noise) in draws.items():
        system = step_system(weights, dtype, mesh, mp_sharded, fx, device)
        if not mp_sharded:
            system.distribute(mesh)
        system.check_replicas()
        draw = (None if ref_params is None else tuple(p.to(device, dtype) for p in ref_params),
                None if noise is None else tuple(n.to(device, dtype) for n in noise))
        metrics = system.gradients(parallel.shard_batch(batch, mesh), system.effect_flags(0), *draw)
        out[fx] = step_result(system, metrics)
    return out


# ------------------------------------------------------------ the Trainer


def raw_batches(n: int, seed: int):
    """n collated global host batches (tracks, stereo, instr, padding, mix,
    names), each with its own envelope."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        env = np.abs(np.sin(np.linspace(0.0, (3 + i) * np.pi, TRAIN_T)))
        tracks = rng.normal(size=(TRAIN_BS, TRAIN_NT, TRAIN_T)) * 0.1 * env
        padding = np.zeros((TRAIN_BS, TRAIN_NT), bool)
        padding[1, 1] = i % 2 == 1
        ids = np.zeros((TRAIN_BS, TRAIN_NT), np.int32)
        out.append((tracks, ids, ids, padding, np.zeros((TRAIN_BS, 2, TRAIN_T)), [f"s{i}"] * TRAIN_BS))
    return out


class Data:
    """An in-memory data module of global batches: every rank reads the same."""

    def __init__(self, n_train: int = 2, n_val: int = 1):
        self.train, self.val = raw_batches(n_train, 0), raw_batches(n_val, 1)

    def train_dataloader(self):
        return iter(self.train)

    def val_dataloader(self):
        return iter(self.val)


def trainer_system(mesh=None) -> System:
    """The tiny System seeded 0, in float64; on ``mesh`` (track-parallel
    where its mp > 1). In float32 this toy step's gradients are
    ill-conditioned: two evaluations as exact as each other (ATen's
    BatchNorm and the mesh's, each layer within 3.1e-6 of float64 on its
    own inputs) land 6.7e-4 and 1.3e-2 off the float64 gradients
    (``scripts/mesh_precision_torch.py``), and Adam's first steps, about
    lr * sign(g), move their small elements either way. In
    float64 they agree to 1e-7 over a mesh, so the learning rate can be
    1e-4: two steps move the weights 2e-4, past JAX's atol of 8e-6."""
    sharded = mesh is not None and mesh.shape["mp"] > 1
    model = MixStyleTransferModel.build(**TINY, device="cpu", generator=torch.Generator().manual_seed(0),
                                        bn_axis_name=("dp", "mp") if sharded else None).double()
    on = mesh if sharded else None
    return System(model, AdvancedMixConsole(SR, device="cpu", mesh=on), MultiResolutionSTFTLoss(**TINY_LOSS),
                  SystemConfig(lr=1e-4, steps_per_epoch=2, max_epochs=4), device="cpu", mesh=on)


def mesh_fit(dp: int, mp: int, ckpt_dir: str) -> dict:
    """``Trainer(mesh=, fused_steps=2).fit()`` for one epoch of the global
    batches, checkpoints into ``ckpt_dir``: the final state and generator,
    the logged history and the checkpoints this rank wrote."""
    from diffmst_torch.train import trainer as trainer_module

    torch.set_num_threads(1)
    mesh = parallel.make_mesh(dp, mp)
    saves = []
    save_state = trainer_module.save_state

    def counted(path, system, meta=None):
        saves.append(os.path.basename(path))
        return save_state(path, system, meta=meta)

    trainer_module.save_state = counted
    try:
        system = trainer_system(mesh)
        trainer = Trainer(system, Data(), ckpt_dir=ckpt_dir, mesh=mesh, **TRAINER)
        trainer.fit()
    finally:
        trainer_module.save_state = save_state
    return dict(rank=mesh.rank, coordinate=mesh.coordinate, saves=saves, history=trainer.history,
                state={k: v.clone() for k, v in system.model.state_dict().items()}, step=system.step,
                generator=system.generator.get_state(), moments=adam_moments(system))


def adam_moments(system: System) -> dict:
    """Adam's first moment of each parameter, by name: after two steps
    0.1 * (0.9 * g1 + g2), the global gradients' record, whatever the
    learning rate."""
    state = system.optimizer.state
    return {n: state[p]["exp_avg"].clone() for n, p in system.model.named_parameters() if p in state}
