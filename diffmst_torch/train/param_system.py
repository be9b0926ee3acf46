"""Self-supervised parameter-estimation pretraining: the Remixer and the
parameter regressor.

Port of ``diffmst_tpu/train/param_system.py`` (the reference's
``mst/param_system.py`` and ``Remixer``, modules.py:490-554). A step:
separate real mixes into 4 stereo stems -> 8 mono tracks at -48 dB ->
render a remix through the console with random parameters (no output
fader, the fx bus on) and soft-clip it (tanh at 4.0) -> embed the four
mono channels of (input, remix) in one encoder call -> the embedding
differences go to the ``ParameterProjector`` -> MSE per parameter group
scaled by its parameter count -> Adam.

The separator is any (bs, 2, T) -> (bs, 4, 2, T) callable:
``models.separator.hpss_separator`` (the default), ``UNetSeparator``,
``models.hdemucs.HDemucs`` or ``band_split_separator``. It runs under
``no_grad``, JAX's ``stop_gradient``.

As in ``train.system``, JAX's jitted pure step becomes a stateful object:
the encoder and the projector hold the parameters and BatchNorm statistics,
``torch.optim.Adam`` its moments, and ``state_dict()`` what JAX's
``ParamTrainState`` holds. JAX splits one key into the remix's track,
fx-bus and master parameters and the reverb's key; the port draws the same
four from a ``torch.Generator`` in that order (the reverb's noise by
``ops.reverb.draw_reverb_noise``'s rule), or takes them as overrides.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from diffmst_torch.mixing.naive import draw_mix_params
from diffmst_torch.models.separator import hpss_separator
from diffmst_torch.train.system import SystemConfig, lr_schedule
from diffmst_torch.utils.device import DeviceLike, resolve_device

__all__ = ["band_split_separator", "Remixer", "ParameterEstimationSystem"]

_ADAM_EPS = 1e-8  # optax.adam's and torch.optim.Adam's default


def band_split_separator(x: torch.Tensor) -> torch.Tensor:
    """Split a stereo mix into 4 'stems' by frequency band (0-200, 200-1k,
    1k-5k, 5k+ Hz at 44.1 kHz); they sum to x."""
    t = x.shape[-1]
    X = torch.fft.rfft(x, dim=-1)
    freqs = np.fft.rfftfreq(t, 1.0 / 44100.0)
    edges = ((0.0, 200.0), (200.0, 1000.0), (1000.0, 5000.0), (5000.0, 1e9))
    masks = np.stack([(freqs >= lo) & (freqs < hi) for lo, hi in edges])
    masks = torch.from_numpy(masks).to(x.device, x.real.dtype)[None, :, None, :]
    return torch.fft.irfft(X[:, None] * masks, n=t, dim=-1)  # (bs, 4, 2, t)


@dataclasses.dataclass(frozen=True)
class Remixer:
    """Separate -> random console parameters -> remix (modules.py:502-554)."""

    sample_rate: float = 44100.0
    separator: Callable = hpss_separator
    headroom_db: float = -48.0
    clip_level: float = 4.0

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, mix_console, generator: Optional[torch.Generator] = None,
                 tp=None, fp=None, mp=None, noise=None):
        """(remix (bs, 2, T), tp, fp, mp). The parameters are drawn from
        ``generator`` (default: a CPU generator seeded 0) unless given, and
        the reverb's noise after them unless given as ``noise``."""
        bs, _, seq_len = x.shape
        sources = self.separator(x)  # (bs, 4, 2, t)
        tracks = sources.reshape(bs, 8, seq_len) * 10.0 ** (self.headroom_db / 20.0)  # 4 stereo -> 8 mono
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        drawn = draw_mix_params(tracks, mix_console, generator) if tp is None else (tp, fp, mp)
        tp, fp, mp = (p.to(tracks.device, tracks.dtype) for p in drawn)
        # the reference renders with use_output_fader=False only (modules.py:540-546):
        # the fx bus stays on, so its 25 parameters shape the remix
        out = mix_console(tracks, tp, fp, mp, use_output_fader=False, generator=generator, noise=noise)
        remix = torch.tanh(out.mix / self.clip_level) * self.clip_level
        return remix, tp, fp, mp


class ParameterEstimationSystem:
    """Encoder-per-channel embedding differences -> ParameterProjector,
    trained one step at a time in place on ``device`` (None: the CUDA
    device, which the encoder and the projector move to)."""

    def __init__(
        self,
        encoder: torch.nn.Module,
        projector: torch.nn.Module,
        mix_console,
        remixer: Optional[Remixer] = None,
        lr: float = 3e-4,
        max_epochs: int = 500,
        steps_per_epoch: int = 1000,
        schedule: str = "step",
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
        **_unused,
    ) -> None:
        """``schedule``: "step" (x 0.1 at 0.85 and again at 0.95 of
        ``max_epochs * steps_per_epoch`` updates), "cosine", or anything else
        for a constant rate, as JAX's system takes it."""
        self.device = resolve_device(device)
        self.encoder = encoder.to(self.device)
        self.projector = projector.to(self.device)
        self.mix_console = mix_console
        self.remixer = remixer or Remixer(mix_console.sample_rate)
        self.generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self.lr_at = lr_schedule(SystemConfig(lr=lr, max_epochs=max_epochs, steps_per_epoch=steps_per_epoch,
                                              schedule=schedule if schedule in ("step", "cosine") else "none"))
        self.params = [*self.encoder.parameters(), *self.projector.parameters()]
        self.optimizer = torch.optim.Adam(self.params, lr=lr, eps=_ADAM_EPS)
        self.step = 0  # train steps taken: the schedule's count

    # ------------------------------------------------------------ state
    def state_dict(self) -> Dict:
        """What JAX's ``ParamTrainState`` holds: the encoder's parameters and
        BatchNorm statistics, the projector's, Adam's state and the step;
        and the generator. The tensors are the live ones."""
        return {
            "encoder": self.encoder.state_dict(),
            "projector": self.projector.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "generator": self.generator.get_state(),
        }

    def load_state_dict(self, state: Dict) -> None:
        self.encoder.load_state_dict(state["encoder"])
        self.projector.load_state_dict(state["projector"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])

    # ---------------------------------------------------------- forward
    def forward(self, input_mix: torch.Tensor, output_mix: torch.Tensor, train: bool):
        """(tp, fp, mp) predicted from the embedding differences
        (param_system.py:37-60). The four mono signals (input L, R, output
        L, R) go through the encoder in one call, so train-mode BatchNorm
        normalizes over the combined 4 * bs batch, as JAX's does."""
        bs = input_mix.shape[0]
        sigs = torch.cat([input_mix[:, 0:1], input_mix[:, 1:2], output_mix[:, 0:1], output_mix[:, 1:2]])
        z_in_l, z_in_r, z_out_l, z_out_r = self.encoder(sigs, train=train).split(bs)
        return self.projector(torch.cat([z_out_l - z_in_l, z_out_r - z_in_r], dim=-1))

    @staticmethod
    def group_losses(preds, tp, fp, mp) -> Dict[str, torch.Tensor]:
        """MSE per group scaled by its parameter count (param_system.py:100-105):
        the tracks by parameters + tracks (27 + 8)."""
        tp_hat, fp_hat, mp_hat = preds
        tl = torch.mean(torch.square(tp_hat - tp)) * (tp.shape[-1] + tp.shape[-2])
        fl = torch.mean(torch.square(fp_hat - fp)) * fp.shape[-1]
        ml = torch.mean(torch.square(mp_hat - mp)) * mp.shape[-1]
        return {"loss": tl + fl + ml, "track_param_loss": tl, "fx_bus_param_loss": fl, "master_bus_param_loss": ml}

    # ---------------------------------------------------------- the steps
    def train_step(self, input_mix: torch.Tensor, generator: Optional[torch.Generator] = None,
                   tp=None, fp=None, mp=None, noise=None) -> Dict[str, torch.Tensor]:
        """One step in place (JAX ``make_train_step``): remix ``input_mix``
        (bs, 2, T) with parameters drawn from ``generator`` (default
        ``self.generator``) or given as ``tp``, ``fp``, ``mp`` and the
        reverb's ``noise``; BatchNorm in training mode; Adam at the
        schedule's rate. Returns the four losses."""
        input_mix = input_mix.to(self.device)
        generator = generator if generator is not None else self.generator
        remix, tp, fp, mp = self.remixer(input_mix, self.mix_console, generator, tp, fp, mp, noise)
        for p in self.params:
            p.grad = None
        metrics = self.group_losses(self.forward(input_mix, remix, train=True), tp, fp, mp)
        metrics["loss"].backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_at(self.step)
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(self, input_mix, remix, tp, fp, mp) -> Dict[str, torch.Tensor]:
        """The losses of the current weights on a frozen (input, remix,
        parameters) tuple, BatchNorm on its running statistics (JAX
        ``make_eval_step``)."""
        dev = self.device
        preds = self.forward(input_mix.to(dev), remix.to(dev), train=False)
        return self.group_losses(preds, tp.to(dev), fp.to(dev), mp.to(dev))
