"""CLI of the PyTorch port: train, validate, test and predict from overlaid YAML configs.

The counterpart of ``main.py`` for ``diffmst_torch``, with the reference's
LightningCLI surface:

    python main_torch.py fit -c configs/config.yaml -c configs/optimizer.yaml \
        -c configs/data/synthetic-8.yaml -c configs/models/naive.yaml

The shipped YAMLs load unchanged: their class paths (``mst.*``,
``auraloss.*``, ``diffmst_tpu.*``) resolve to the port
(``diffmst_torch/utils/config.py``). Trainer flags come from the
``trainer:`` section; of the ``optimizer:`` section only ``lr`` is read.
Everything runs on the CUDA device unless ``--device cpu`` is given; without
a card and without it, the command raises. Float32 is computed in full
float32, TF32 off (``utils/device.py::use_full_float32``). Run it from the
repository root: the configs' relative paths
(``./data/instrument_name2id.json``) and the CSV log (``logs/metrics.csv``)
are relative to the working directory.

``export`` writes the serving graph of the config's model and console
(``diffmst_torch/utils/export.py``; ``--num_tracks``, ``--analysis_len``,
``--render_bs``, the weights from ``--ckpt_path``) into ``--output``, by
default ``serving_export``. ``trainer.fused_steps`` K runs K steps as one
replay of a CUDA graph on the card (``diffmst_torch/train/fused.py``). More
than one device is not ported yet (ROADMAP Queue 1, item 12e).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def build_from_config(cfg: dict, device=None):
    """(system, datamodule, trainer) from a merged config, on ``device``
    (None: the CUDA device).

    The model is allocated once, on the device, and initialized from a CPU
    generator seeded ``seed_everything``, so the same seed gives the same
    weights on any device (``MixStyleTransferModel.init``).
    """
    clock = _Clock()
    from diffmst_torch.callbacks import CSVLogger
    from diffmst_torch.train import System, Trainer
    from diffmst_torch.utils.config import NotPortedError, instantiate
    from diffmst_torch.utils.device import resolve_device

    dev = resolve_device(device)
    seed = cfg.get("seed_everything", 42)
    trainer_cfg = dict(cfg.get("trainer", {}))
    _check_ported(trainer_cfg, dev)

    clock.lap("imports")
    model, mix_console, init_args = _build_model(cfg, dev, seed, clock)
    loss = instantiate(init_args.pop("loss"))
    mix_fn = instantiate(init_args.pop("mix_fn", "mst.mixing.naive_random_mix"))
    clock.lap("console and loss", dev)

    opt_cfg = cfg.get("optimizer", {}).get("init_args", {})
    if "lr" in opt_cfg:
        init_args.setdefault("lr", opt_cfg["lr"])
    if "max_epochs" in trainer_cfg:
        init_args.setdefault("max_epochs", trainer_cfg["max_epochs"])
    if "accumulate_grad_batches" in trainer_cfg:
        init_args.setdefault("accumulate_grad_batches", trainer_cfg["accumulate_grad_batches"])

    system = System(model, mix_console, loss, mix_fn=mix_fn, device=dev, **init_args)
    clock.lap("system", dev)

    data_cfg = cfg.get("data")
    datamodule = instantiate(data_cfg) if data_cfg else None
    clock.lap("datamodule")

    callbacks = [CSVLogger()]
    for cb in trainer_cfg.get("callbacks", []) or []:
        try:
            callbacks.append(instantiate(cb))
        except NotPortedError:
            raise  # a callback of the JAX package that the port lacks is not dropped unsaid
        except (ImportError, AttributeError, TypeError):
            pass  # reference-only callbacks (ModelSummary etc.) are cosmetic

    trainer = Trainer(
        system,
        datamodule,
        max_epochs=trainer_cfg.get("max_epochs"),
        ckpt_dir=trainer_cfg.get("default_root_dir") or "checkpoints",
        log_every_n_steps=trainer_cfg.get("log_every_n_steps", 50),
        check_val_every_n_epoch=trainer_cfg.get("check_val_every_n_epoch", 1),
        callbacks=callbacks,
        seed=seed,
        ckpt_every_n_steps=trainer_cfg.get("ckpt_every_n_steps", 500),
        fused_steps=trainer_cfg.get("fused_steps", 1),
        enable_checkpointing=trainer_cfg.get("enable_checkpointing", True),
        deterministic_val=trainer_cfg.get("deterministic_val", False),
        # Lightning's pre-fit sanity check; the reference pins 2
        num_sanity_val_steps=trainer_cfg.get("num_sanity_val_steps", 2),
    )
    n_params = sum(p.numel() for p in model.parameters())
    print(f"built: {n_params / 1e6:.1f} M parameters in {clock.total():.3f} s ({clock.laps()})",
          flush=True)
    return system, datamodule, trainer


def _build_model(cfg: dict, dev: torch.device, seed: int, clock: "_Clock"):
    """(model, console, the model section's other init_args) from a merged
    config: the model allocated once on ``dev`` and initialized from a CPU
    generator seeded ``seed``, in eval mode."""
    from diffmst_torch.utils.config import instantiate

    model_cfg = cfg.get("model", {})
    init_args = dict(model_cfg.get("init_args", model_cfg))
    node = init_args.pop("model")
    if node.get("class_path", "").endswith(".build"):
        # the factory (configs/models/naive+tpu.yaml) allocates nothing on "meta"
        model = instantiate(node, device="meta")
    else:
        with torch.device("meta"):
            model = instantiate(node)
    model = model.to_empty(device=dev)
    clock.lap("model allocated", dev)
    model = model.init(torch.Generator().manual_seed(seed)).eval()
    clock.lap("model init", dev)
    mix_console = instantiate(init_args.pop("mix_console"), device=str(dev))
    return model, mix_console, init_args


class _Clock:
    """Wall seconds of the parts of ``build_from_config``; a lap on a CUDA
    device waits for the card first."""

    def __init__(self) -> None:
        self.start = self.last = time.perf_counter()
        self.parts = []

    def lap(self, name: str, dev=None) -> None:
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        self.parts.append((name, now - self.last))
        self.last = now

    def total(self) -> float:
        return time.perf_counter() - self.start

    def laps(self) -> str:
        return ", ".join(f"{name} {sec:.3f} s" for name, sec in self.parts)


def _check_ported(trainer_cfg: dict, dev: torch.device) -> None:
    """Refuse the trainer settings the port lacks: more than one device
    (``trainer.mesh``, ``devices`` > 1)."""
    devices = trainer_cfg.get("devices", 1)
    if devices in ("auto", -1):
        devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    if trainer_cfg.get("mesh") or (isinstance(devices, int) and devices > 1):
        raise NotImplementedError(
            "training on more than one device is not ported to diffmst_torch yet: "
            "ROADMAP Queue 1, item 12e"
        )


def main(argv=None):
    parser = argparse.ArgumentParser(description="diffmst_torch trainer")
    parser.add_argument("command", choices=["fit", "validate", "test", "predict", "export"])
    parser.add_argument(
        "-c", "--config", action="append", required=True,
        help="YAML config (repeatable; later files overlay earlier)",
    )
    parser.add_argument("--ckpt_path", default=None,
                        help="resume checkpoint; predict and export: the weights")
    parser.add_argument(
        "--device", default=None,
        help="torch device to run on (default: the CUDA device; 'cpu' to run on the CPU)",
    )
    # export: the serving graph (diffmst_torch/utils/export.py)
    parser.add_argument("--num_tracks", type=int, default=8,
                        help="export: static track count of the serving graph")
    parser.add_argument("--analysis_len", type=int, default=262144,
                        help="export: analysis and render window in samples")
    parser.add_argument("--render_bs", type=int, default=8,
                        help="export: windows a call of the serving render graph")
    # predict: full-song style transfer over a stem directory
    parser.add_argument("--track_dir", default=None, help="predict: stem dir")
    parser.add_argument("--ref", default=None, help="predict: reference mix wav")
    parser.add_argument("--output", default="pred_mix.wav",
                        help="predict: output wav; export: output directory (default serving_export)")
    parser.add_argument(
        "--render_mode", default="ola", choices=["ola", "streaming"],
        help="predict: OLA (reference) or seam-free streaming rendering",
    )
    args = parser.parse_args(argv)

    from diffmst_torch.utils.config import load_config
    from diffmst_torch.utils.device import resolve_device, use_full_float32

    dev = resolve_device(args.device)
    use_full_float32()
    cfg = load_config(args.config)
    if dev.type == "cuda":
        print(f"device: {dev} ({torch.cuda.get_device_name(dev)}); TF32: cuDNN"
              f" {torch.backends.cudnn.allow_tf32}, matmul {torch.backends.cuda.matmul.allow_tf32}",
              flush=True)
    else:
        print(f"device: {dev}", flush=True)
    if args.command == "export":
        return _export(cfg, dev, args)
    system, datamodule, trainer = build_from_config(cfg, dev)

    if args.command == "predict":
        result = _predict(system, args)
    elif datamodule is None:
        raise SystemExit("config has no `data:` section")
    elif args.command == "fit":
        result = trainer.fit(resume=args.ckpt_path)
    elif args.command == "validate":
        result = trainer.validate(resume=args.ckpt_path)
        print(f"validate: {result}")
    else:
        result = trainer.test(resume=args.ckpt_path)
        print(f"test: {result}")
    if dev.type == "cuda":
        print(f"peak card memory: {torch.cuda.max_memory_allocated(dev)} bytes"
              " (max_memory_allocated)", flush=True)
    return result


def _load_weights(model, ckpt_path) -> None:
    """``ckpt_path`` into ``model``: a reference Lightning ``.ckpt``, or a
    checkpoint of ``fit``; with none, the seeded random weights stay."""
    from diffmst_torch.utils.checkpoint import load_reference_checkpoint, restore_model

    if ckpt_path and ckpt_path.endswith(".ckpt"):
        load_reference_checkpoint(ckpt_path, model)
    elif ckpt_path:
        t0 = time.perf_counter()
        restore_model(ckpt_path, model)
        print(f"checkpoint: restored {ckpt_path} in {time.perf_counter() - t0:.3f} s", flush=True)
    else:
        print("warning: no --ckpt_path; using random init")


def _export(cfg: dict, dev: torch.device, args):
    """Export the serving graph of the config's model and console, with the
    weights of ``--ckpt_path``, into ``--output`` (default
    ``serving_export``): the counterpart of ``main.py export``."""
    from diffmst_torch.utils.export import save_inference_export

    clock = _Clock()
    model, mix_console, _ = _build_model(cfg, dev, cfg.get("seed_everything", 42), clock)
    _load_weights(model, args.ckpt_path)
    built_s = clock.total()
    out_dir = args.output if args.output != "pred_mix.wav" else "serving_export"
    t0 = time.perf_counter()
    manifest = save_inference_export(
        out_dir, model, mix_console, num_tracks=args.num_tracks,
        analysis_len=args.analysis_len, render_bs=args.render_bs,
    )
    seconds = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(out_dir, f)) for f in os.listdir(out_dir))
    print(f"export: wrote {out_dir} ({manifest['device']}, {size} bytes) in {seconds:.3f} s;"
          f" the model built and its weights loaded in {built_s:.3f} s", flush=True)
    return manifest


def _predict(system, args):
    """Full-song inference with the config's model and console, the weights
    from ``--ckpt_path`` (a checkpoint of ``fit``, or a reference Lightning
    ``.ckpt``), else the seeded random ones."""
    from diffmst_torch.data import read_audio, write_audio
    from diffmst_torch.utils.inference import run_diffmst

    if not args.track_dir or not args.ref:
        raise SystemExit("predict requires --track_dir and --ref")

    stems = []
    for f in sorted(os.listdir(args.track_dir)):
        if f.endswith(".wav"):
            a, _ = read_audio(os.path.join(args.track_dir, f))
            stems.append(a.mean(axis=0))
    if not stems:
        raise SystemExit(f"no .wav stems in {args.track_dir}")
    total = min(s.shape[-1] for s in stems)
    tracks = np.stack([s[:total] for s in stems])[None]
    ref, _ = read_audio(args.ref)

    model = system.model
    _load_weights(model, args.ckpt_path)

    @torch.no_grad()
    def apply(t, r):
        return model(t, r)

    mix, *_ = run_diffmst(
        tracks, ref[None], apply, system.mix_console,
        render_mode=args.render_mode, device=system.device,
    )
    write_audio(args.output, mix[0] / max(np.abs(mix).max(), 1e-8), 44100)
    print(f"predict: wrote {args.output}")
    return mix


if __name__ == "__main__":
    main()
