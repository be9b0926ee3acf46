"""Method-2 training demo of the PyTorch port: unpaired reference + AudioFeatureLoss.

The port's counterpart of ``scripts/train_demo_method2_tpu.py``. Method 2
(``generate_mix: false``): the batch's own reference mix is both the
model's style input and the loss target, and the loss is the five-feature
``AudioFeatureLoss`` (configs/models/unpaired+feat.yaml) instead of MRSTFT.
The port's ``Trainer`` runs it on synthetic stems and structured reference
mixes (each a fixed gain and pan render of the same song's stems, so a
mapping from the reference's features to console parameters exists to be
learned), at the bf16 recipe, with micro-batches of 2 and
``accumulate_grad_batches=2`` (the reference's effective batch of 4), and
records the smoothed loss trajectory and the steps/s.

``DEMO_FUSED_STEPS`` (6) steps run as one unit (``Trainer(fused_steps=)``:
on the card one CUDA graph replay); the pool of 4 batches is placed on the
device before ``fit``. ``DEMO_DEVICE`` as ``--device``.

Writes logs/train_demo_method2_torch.json under the working directory.
Runs on the CUDA device, or on the CPU with ``--device cpu``:

    python3 scripts/train_demo_method2_torch.py [steps_per_epoch] [epochs] [--device cpu] [--toy]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from diffmst_torch.losses import AudioFeatureLoss  # noqa: E402
from diffmst_torch.train import Trainer  # noqa: E402
from diffmst_torch.utils.device import resolve_device, use_full_float32  # noqa: E402

from train_demo_torch import (SR, TOY_MODEL, TOY_T, build_system, card, on_device, parse,  # noqa: E402
                              trail_summary)

# Method 2 runs the whole 262,144-sample segment through the model, the
# console and the loss (no Method-1 halves): micro-batches of 2 with an
# accumulation of 2 keep the reference's effective batch of 4
# (configs/data/medley+cambridge-8.yaml:11), as the JAX demo does
BS, NT, T = 2, 8, 262144
ACCUM = 2
FEATURE_WEIGHTS = (0.1, 0.001, 1.0, 1.0, 0.1)  # rms, crest, width, imbalance, bark (naive+feat.yaml:63-69)


class SyntheticUnpairedDM:
    """A pool of (stems, reference mix) batches for Method 2, NumPy's draws
    of ``train_demo_method2_tpu.py`` from the same seed.

    The reference is a render of the same stems (a gain in [-12, 0] dB and
    a constant-power pan a track, peak-normalized): a stereo mix whose
    features the model must match, standing in for the Jamendo mixes.
    ``device``: where the pool lives (None: the card).
    """

    def __init__(self, n_train, n_val=2, seed=0, pool_size=4, device=None, shape=None):
        self.shape = shape or (BS, NT, T)
        self.batch_size = self.shape[0]
        rng = np.random.default_rng(seed)
        dev = resolve_device(device)
        self.pool = [on_device(self._make(rng), dev) for _ in range(pool_size)]
        self.n_train = n_train
        self.n_val = n_val

    def _make(self, rng):
        bs, nt, t = self.shape
        tracks = (rng.normal(size=(bs, nt, t)) * 10 ** (-48 / 20)).astype(np.float32)
        gains = 10.0 ** (rng.uniform(-12.0, 0.0, size=(bs, nt, 1)) / 20.0)
        pan = rng.uniform(0.0, 1.0, size=(bs, nt, 1)).astype(np.float32)
        left = np.sum(tracks * gains * np.cos(pan * np.pi / 2), axis=1)
        right = np.sum(tracks * gains * np.sin(pan * np.pi / 2), axis=1)
        ref = np.stack([left, right], axis=1).astype(np.float32)
        peak = np.maximum(np.abs(ref).max(axis=(1, 2), keepdims=True), 1e-8)
        ref = ref / peak
        return (tracks, np.zeros((bs, nt), np.int32), np.zeros((bs, nt), np.int32), np.zeros((bs, nt), bool),
                ref, ["synthetic-unpaired"] * bs)

    def _iter(self, n):
        for i in range(n):
            yield self.pool[i % len(self.pool)]

    def train_dataloader(self):
        return self._iter(self.n_train)

    def val_dataloader(self):
        return self._iter(self.n_val)


def build(dev, steps_per_epoch, epochs, model=None, **config):
    """The demo's System: Method 2 with ``AudioFeatureLoss`` at the bf16
    recipe, lr 1e-4, the accumulation of ``ACCUM``."""
    loss = AudioFeatureLoss(sample_rate=int(SR), weights=FEATURE_WEIGHTS)
    cfg = dict(steps_per_epoch=steps_per_epoch, max_epochs=epochs, lr=1e-4, generate_mix=False,
               accumulate_grad_batches=ACCUM)
    cfg.update(config)
    return build_system(dev, loss, model, **cfg)


def main(argv=None):
    args = parse(argv, __doc__.splitlines()[0], 300, 1)
    steps_per_epoch, epochs = args.steps_per_epoch, args.epochs
    dev = resolve_device(args.device)
    use_full_float32()
    name, smi = card(dev)
    print("device:", dev, name, smi, flush=True)
    # 6 steps a unit divides the default 300 steps an epoch
    fused = int(os.environ.get("DEMO_FUSED_STEPS", "6"))
    system = build(dev, steps_per_epoch, epochs, TOY_MODEL if args.toy else None)
    dm = SyntheticUnpairedDM(steps_per_epoch, device=dev, shape=(1, 2, TOY_T) if args.toy else None)
    trainer = Trainer(system, dm, max_epochs=epochs, ckpt_dir="logs/train_demo_m2_ckpt_torch",
                      log_every_n_steps=max(10, fused), check_val_every_n_epoch=epochs + 1, fused_steps=fused)
    t0 = time.time()
    trainer.fit()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0

    trail = trail_summary(trainer, digits=5)
    summary = {
        "backend": name,
        "power_limit": smi,
        "method": "2 (unpaired ref + AudioFeatureLoss, generate_mix=false)",
        "shape": "x".join(map(str, dm.shape)),
        "recipe": ("bf16 compute, Adam mu bf16, unpaired+feat.yaml loss; micro-batch 2 x 2-step grad "
                   "accumulation = effective batch 4 (Method 2 runs the full segment)"),
        "effective_batch": dm.batch_size * ACCUM,
        "batch_residency": "device",
        "fused_steps_per_dispatch": fused,
        "distinct_batches": len(dm.pool),
        "steps": int(system.step),
        "wall_s": round(wall, 1),
        **trail,
        "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    os.makedirs("logs", exist_ok=True)
    with open("logs/train_demo_method2_torch.json", "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
