"""16-track training demo of the PyTorch port, with the fx bus on.

The port's counterpart of ``scripts/train_demo_16track_tpu.py``: the
stretch configuration, batch 1 x (2-16) tracks x 262,144 samples, with the
whole console chain including the fx bus's 12-band noise reverb sends
(configs/data/medley+cambridge-16.yaml's shape). The port's ``Trainer``
runs it at 16 tracks, where the padding mask marks the unused slots of the
variable-count contract (a pool of 16, 12, 16 and 10 real tracks), on
synthetic stems at the bf16 recipe, and records the smoothed loss and the
steps/s.

``DEMO_FUSED_STEPS`` (8) steps run as one unit (``Trainer(fused_steps=)``:
on the card one CUDA graph replay); with 1 the steps run one by one and
the summary goes to the other file. The pool is placed on the device before
``fit``. ``DEMO_DEVICE`` as ``--device``.

Writes logs/train_demo_16track_torch.json (``DEMO_FUSED_STEPS=1``) or
logs/train_demo_16track_fused_torch.json under the working directory. Runs
on the CUDA device, or on the CPU with ``--device cpu``:

    python3 scripts/train_demo_16track_torch.py [steps_per_epoch] [epochs] [--device cpu] [--toy]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from diffmst_torch.losses import MultiResolutionSTFTLoss  # noqa: E402
from diffmst_torch.train import Trainer  # noqa: E402
from diffmst_torch.utils.device import resolve_device, use_full_float32  # noqa: E402

from train_demo_torch import (TOY_MODEL, TOY_T, build_system, card, on_device, parse,  # noqa: E402
                              trail_summary)

BS, NT, T = 1, 16, 262144
REAL_TRACKS = (16, 12, 16, 10)  # real tracks of the pool's batches; the rest padded


class Synthetic16DM:
    """A pool of batch-1 x 16-track batches, NumPy's draws of
    ``train_demo_16track_tpu.py`` from the same seed; the trailing tracks
    past each batch's real count are zeros marked padded
    (``track_padding``). ``device``: where the pool lives (None: the
    card)."""

    def __init__(self, n_train, n_val=2, seed=0, pool_size=4, device=None, shape=None):
        self.shape = shape or (BS, NT, T)
        self.batch_size = self.shape[0]
        rng = np.random.default_rng(seed)
        dev = resolve_device(device)
        self.pool = [on_device(self._make(rng, n_real), dev) for n_real in REAL_TRACKS[:pool_size]]
        self.n_train = n_train
        self.n_val = n_val

    def _make(self, rng, n_real):
        bs, nt, t = self.shape
        tracks = (rng.normal(size=(bs, nt, t)) * 10 ** (-48 / 20)).astype(np.float32)
        padding = np.zeros((bs, nt), bool)
        tracks[:, n_real:] = 0.0
        padding[:, n_real:] = True
        return (tracks, np.zeros((bs, nt), np.int32), np.zeros((bs, nt), np.int32), padding,
                (rng.normal(size=(bs, 2, t)) * 0.1).astype(np.float32), ["synthetic-16"] * bs)

    def _iter(self, n):
        for i in range(n):
            yield self.pool[i % len(self.pool)]

    def train_dataloader(self):
        return self._iter(self.n_train)

    def val_dataloader(self):
        return self._iter(self.n_val)


def build(dev, steps_per_epoch, epochs, model=None, **config):
    """The demo's System: Method 1 with MRSTFT and the fx bus from epoch 0
    (the stretch point: the whole chain including the reverb), lr 1e-4."""
    cfg = dict(steps_per_epoch=steps_per_epoch, max_epochs=epochs, lr=1e-4, active_fx_bus_epoch=0)
    cfg.update(config)
    return build_system(dev, MultiResolutionSTFTLoss(), model, **cfg)


def main(argv=None):
    args = parse(argv, __doc__.splitlines()[0], 200, 1)
    steps_per_epoch, epochs = args.steps_per_epoch, args.epochs
    dev = resolve_device(args.device)
    use_full_float32()
    name, smi = card(dev)
    print("device:", dev, name, smi, flush=True)
    fused = int(os.environ.get("DEMO_FUSED_STEPS", "8"))
    system = build(dev, steps_per_epoch, epochs, TOY_MODEL if args.toy else None)
    dm = Synthetic16DM(steps_per_epoch, device=dev, shape=(1, 16, TOY_T) if args.toy else None)
    trainer = Trainer(system, dm, max_epochs=epochs, ckpt_dir="logs/train_demo_16t_ckpt_torch",
                      log_every_n_steps=max(10, fused), check_val_every_n_epoch=epochs + 1, fused_steps=fused)
    t0 = time.time()
    trainer.fit()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0

    summary = {
        "backend": name,
        "power_limit": smi,
        "shape": "x".join(map(str, dm.shape)),
        "recipe": ("16-track stretch (medley+cambridge-16.yaml shape), fx bus ON, bf16 compute, Adam mu "
                   "bf16; pool mixes 10/12/16 real tracks via the padding mask"),
        "batch_residency": "device",
        "fused_steps_per_dispatch": fused,
        "distinct_batches": len(dm.pool),
        "steps": int(system.step),
        "wall_s": round(wall, 1),
        **trail_summary(trainer),
        "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    os.makedirs("logs", exist_ok=True)
    # the sequential run is the convergence record (a loss a logged step),
    # the fused run the replayed one
    out = "logs/train_demo_16track_torch.json" if fused == 1 else "logs/train_demo_16track_fused_torch.json"
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
