"""The PyTorch port's checkpoints, Trainer, registry and CLI on the CPU.

  * a reference Lightning ``.ckpt`` that the test writes, loaded by the port
    and by JAX's ``port_torch_checkpoint``: the two models' forwards within
    1e-4;
  * a save and restore in the middle of gradient accumulation, with
    ``skip_nonfinite_updates`` on: the next step equals that of the System
    that never stopped, bitwise;
  * the Trainer against a hand loop of ``System.train_step`` over the same
    batches and generator (with mid-epoch saves on): bitwise equal
    parameters, and the tags and keys of JAX's ``_log``;
  * ``num_sanity_val_steps`` 0 and 2: bitwise equal parameters; two
    ``deterministic_val`` passes: equal metrics;
  * ``main_torch.py`` ``fit``, ``fit --ckpt_path last``, ``validate``,
    ``test`` and ``predict`` with ``--device cpu`` on the shipped configs
    with an overlay of paths and sizes (embed 32, n_fft 2048, hop 128, Cnn14
    width 4, 1 layer, 4 heads, MRSTFT at 512, length 32,768), in full
    float32 (TF32 off), and without ``--device`` (no card here): an error;
  * what the port lacks (more than one device) refused, naming its ROADMAP
    item; the trainer flags of the YAML (``fused_steps`` among them)
    reaching the Trainer;
  * the config registry's class paths, ``System``'s flat keywords and the
    CSV sink against the JAX package's.

No test runs JAX's Trainer or CLI; ``tests/test_torch_train.py`` holds the
step itself to JAX's. The System and Trainer cases run at hop 32 on 8,192
samples (129 frames on the model's 4,096-sample halves).
"""

import csv
import dataclasses
import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import main_torch
from diffmst_torch.callbacks import CSVLogger
from diffmst_torch.console import AdvancedMixConsole
from diffmst_torch.data import read_audio
from diffmst_torch.losses import MultiResolutionSTFTLoss
from diffmst_torch.models import MixStyleTransferModel
from diffmst_torch.train import Batch, System, SystemConfig, Trainer
from diffmst_torch.train.trainer import _prefetch
from diffmst_torch.utils import checkpoint as tckpt
from diffmst_torch.utils import config as tconfig
from tests.test_torch_data import corpus  # noqa: F401 (fixture)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SR = 44100.0
TINY = dict(embed_dim=32, num_layers=1, nhead=4, n_fft=2048, hop_length=32, cnn_base_width=4)
TINY_LOSS = dict(fft_sizes=(512,), hop_sizes=(256,), win_lengths=(512,))
BS, NT, T = 2, 2, 8192

# The keys JAX's Trainer hands _log, by tag (diffmst_tpu/train/trainer.py).
STEP_KEYS = ["loss", "ref_mix_nonfinite", "pred_mix_nonfinite"]
TRAIN_KEYS = STEP_KEYS + ["grad_norm", "epoch", "steps_per_sec", "realtime_factor"]
EVAL_KEYS = STEP_KEYS + ["epoch"]
EPOCH_KEYS = ["epoch", "steps", "epoch_seconds"] + [f"val/{k}" for k in STEP_KEYS]


def _system(seed=0, **config):
    model = MixStyleTransferModel.build(**TINY, device="cpu", generator=torch.Generator().manual_seed(seed))
    return System(model, AdvancedMixConsole(SR, device="cpu"), MultiResolutionSTFTLoss(**TINY_LOSS),
                  SystemConfig(lr=1e-3, steps_per_epoch=4, max_epochs=4, **config), device="cpu")


def _raw_batches(n, seed=0):
    """n collated host batches (tracks, stereo, instr, padding, mix, names)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        env = np.abs(np.sin(np.linspace(0.0, (3 + i) * np.pi, T)))
        tracks = (rng.normal(size=(BS, NT, T)) * 0.1 * env).astype(np.float32)
        padding = np.zeros((BS, NT), bool)
        padding[1, 1] = i % 2 == 1
        ids = np.zeros((BS, NT), np.int32)
        out.append((tracks, ids, ids, padding, np.zeros((BS, 2, T), np.float32), [f"s{i}"] * BS))
    return out


class _Data:
    """An in-memory data module: fixed train and val batches."""

    def __init__(self, n_train=2, n_val=2):
        self.train, self.val = _raw_batches(n_train), _raw_batches(n_val, seed=1)

    def train_dataloader(self):
        return iter(self.train)

    def val_dataloader(self):
        return iter(self.val)


def _state_equal(a: System, b: System) -> None:
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k


def _logged(out: str):
    """(tag, [keys]) of each ``[tag] k=v ...`` line."""
    lines = [ln for ln in out.splitlines() if ln.startswith("[")]
    return [(ln[1:ln.index("]")], [kv.split("=")[0] for kv in ln[ln.index("]") + 2:].split(" ")])
            for ln in lines]


# ------------------------------------------------------------- checkpoints


def test_reference_checkpoint_loads_like_jax(tmp_path):
    """A Lightning-style checkpoint (``state_dict`` with ``model.*`` keys and
    other entries) into the port and into JAX: forwards within 1e-4."""
    from diffmst_tpu.models import MixStyleTransferModel as JaxModel
    from diffmst_tpu.utils.checkpoint import port_torch_checkpoint

    small = dict(TINY, hop_length=128)
    src = MixStyleTransferModel.build(**small, device="cpu", generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for name, buf in src.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    sd = {f"model.{k}": v for k, v in src.state_dict().items()}
    sd["mix_console.unused"] = torch.zeros(1)
    path = tmp_path / "ref.ckpt"
    torch.save({"state_dict": sd, "epoch": 3}, path)

    port = MixStyleTransferModel.build(**small, device="cpu", generator=torch.Generator().manual_seed(7))
    tckpt.load_reference_checkpoint(str(path), port)
    rng = np.random.default_rng(8)
    tracks = (rng.normal(size=(1, 3, 16384)) * 0.1).astype(np.float32)
    ref = (rng.normal(size=(1, 2, 16384)) * 0.1).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(tracks), torch.from_numpy(ref))
    variables = port_torch_checkpoint(str(path), embed_dim=small["embed_dim"])
    want = jax.jit(JaxModel.build(**small).apply)(variables, jnp.asarray(tracks), jnp.asarray(ref))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)

    torch.save({"state_dict": {k: v for k, v in sd.items() if "fc." not in k}}, tmp_path / "short.ckpt")
    with pytest.raises(KeyError, match="lacks"):
        tckpt.load_reference_checkpoint(str(tmp_path / "short.ckpt"), port)


def test_resume_mid_accumulation_is_bitwise(tmp_path):
    """Steps 1-4 of a run (accumulating 2; step 4 non-finite and skipped,
    after one update and one accumulated step), saved and restored into a
    System of other weights: step 5 equals that of the System that never
    stopped, bitwise, and so does its whole state."""
    batch = Batch(*map(torch.from_numpy, _raw_batches(1)[0][:5]))
    ref_params = [torch.rand(s, generator=torch.Generator().manual_seed(9)) for s in ((BS, NT, 27), (BS, 25), (BS, 26))]
    cfg = dict(accumulate_grad_batches=2, skip_nonfinite_updates=2)
    a = _system(0, **cfg)
    flags = a.effect_flags(0)
    real_loss = a.loss
    for i in range(4):
        a.loss = (lambda p, t: real_loss(p, t) * float("nan")) if i == 3 else real_loss
        m = a.train_step(batch, flags, ref_params)
    a.loss = real_loss
    assert (a.step, a.updates, a.notfinite_count, a._mini_step) == (4, 1, 1, 1)
    assert a._acc is not None and int(m["notfinite_count"]) == 1
    assert (tckpt.save_state(str(tmp_path / "last"), a, meta={"next_epoch": 1}) ==
            (tmp_path / "last").stat().st_size)
    assert tckpt.load_meta(str(tmp_path / "last")) == {"next_epoch": 1}
    assert tckpt.load_meta(str(tmp_path / "none")) == {}

    b = _system(1, **cfg)
    b.generator.manual_seed(123)
    tckpt.restore_state(str(tmp_path / "last"), b)
    assert (b.step, b.updates, b.notfinite_count, b._mini_step) == (4, 1, 1, 1)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    ma, mb = (s.train_step(batch, flags, ref_params) for s in (a, b))
    assert all(torch.equal(torch.as_tensor(ma[k]), torch.as_tensor(mb[k])) for k in ma)
    _state_equal(a, b)
    assert a.updates == b.updates == 2
    for sa, sb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


# ----------------------------------------------------------------- Trainer


def test_trainer_matches_hand_loop(tmp_path, capsys):
    data = _Data()
    trainer = Trainer(_system(0), data, max_epochs=1, ckpt_dir=str(tmp_path), log_every_n_steps=1,
                      seed=7, ckpt_every_n_steps=1)
    trainer.fit()
    hand = _system(0)
    hand.generator = torch.Generator().manual_seed(7)
    for raw in data.train:
        hand.train_step(Batch(*map(torch.from_numpy, raw[:5])), hand.effect_flags(0))
    _state_equal(trainer.system, hand)
    assert trainer.system.step == 2

    out = capsys.readouterr().out
    # "last" after every step (ckpt_every_n_steps), then "last" and "best"
    assert out.count("checkpoint: saved") == 2 + 2
    logged = _logged(out)
    assert [t for t, _ in logged] == ["train"] * 2 + ["val", "epoch"]
    assert all(keys == TRAIN_KEYS for t, keys in logged if t == "train")
    assert logged[-2][1] == EVAL_KEYS and logged[-1][1] == EPOCH_KEYS
    meta = json.loads((tmp_path / "best.meta.json").read_text())
    assert meta == {"next_epoch": 1, "step": 2, "steps_per_epoch": 4}
    assert json.loads((tmp_path / "last.meta.json").read_text()) == meta


def test_sanity_leaves_training_alone_and_val_is_deterministic(capsys):
    systems, val_lines = [], []
    for sanity in (0, 2):
        trainer = Trainer(_system(0), _Data(), max_epochs=1, enable_checkpointing=False,
                          log_every_n_steps=2, seed=7, deterministic_val=True,
                          num_sanity_val_steps=sanity)
        trainer.fit()
        systems.append(trainer.system)
        out = capsys.readouterr().out
        assert ("[sanity]" in out) == bool(sanity)
        val_lines.append([ln for ln in out.splitlines() if ln.startswith("[val]")])
    _state_equal(*systems)
    assert val_lines[0] == val_lines[1]  # the same draws on the same weights
    again = [trainer.validate(), trainer.validate()]
    assert again[0] == again[1]
    assert _logged(capsys.readouterr().out) == [("val", EVAL_KEYS)] * 2


def test_prefetch_order_errors_and_early_stop():
    raws = _raw_batches(3)
    got = list(_prefetch(iter(raws), torch.device("cpu")))
    assert len(got) == 3 and all(torch.equal(g.tracks, torch.from_numpy(r[0])) for g, r in zip(got, raws))

    def failing():
        yield raws[0]
        raise OSError("disk")

    with pytest.raises(OSError, match="disk"):
        list(_prefetch(failing(), torch.device("cpu")))
    it = _prefetch(iter(raws * 10), torch.device("cpu"), depth=1)
    next(it)
    it.close()  # the producer stops without draining the loader


def test_trainer_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="item 12"):
        Trainer(_system(0), _Data(), mesh=object())


# ------------------------------------------------------------------- CLI

SHIPPED = ["configs/config.yaml", "configs/optimizer.yaml", "configs/data/synthetic-8.yaml",
           "configs/models/naive.yaml"]


def _overlay(path, root, **trainer):
    enc = {"embed_dim": 32, "n_fft": 2048, "hop_length": 128, "cnn_base_width": 4}
    path.write_text(yaml.safe_dump({
        "trainer": {"max_epochs": 1, "log_every_n_steps": 1, "default_root_dir": str(path.parent / "ckpts"),
                    **trainer},
        "model": {"init_args": {
            "model": {"init_args": {"track_encoder": {"init_args": enc}, "mix_encoder": {"init_args": enc},
                                    "controller": {"init_args": {"embed_dim": 32, "num_layers": 1, "nhead": 4}}}},
            "loss": {"init_args": {"fft_sizes": [512], "hop_sizes": [256], "win_lengths": [512]}}}},
        "data": {"init_args": {
            "track_root_dirs": [str(root)], "metadata_files": [str(root / "meta.yaml")],
            "instrument_name2id_json": str(REPO / "data" / "instrument_name2id.json"),
            "length": 32768, "min_tracks": 2, "max_tracks": 4, "batch_size": 2,
            "num_examples_per_pass": 4, "num_train_passes": 1, "train_buffer_size_gb": 0.001,
            "val_buffer_size_gb": 0.001, "test_buffer_size_gb": 0.001}},
    }))
    return [a for c in SHIPPED + [str(path)] for a in ("-c", str(REPO / c))]


def test_cli_fit_resume_validate_test_predict(tmp_path, corpus, monkeypatch, capsys):  # noqa: F811
    monkeypatch.chdir(tmp_path)  # logs/metrics.csv lands here
    cfg = _overlay(tmp_path / "small.yaml", corpus)
    ckpts = tmp_path / "ckpts"

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    main_torch.main(["fit", *cfg, "--device", "cpu"])
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    out = capsys.readouterr().out
    parts = re.search(r"^built: [0-9.]+ M parameters in [0-9.]+ s \((.*)\)$", out, re.M).group(1)
    assert re.findall(r"([a-z][a-z ]*) [0-9.]+ s", parts) == [
        "imports", "model allocated", "model init", "console and loss", "system", "datamodule"]
    logged = _logged(out)
    assert [t for t, _ in logged] == ["sanity", "train", "train", "val", "epoch"]
    assert [k for _, k in logged] == [EVAL_KEYS, TRAIN_KEYS, TRAIN_KEYS, EVAL_KEYS, EPOCH_KEYS]
    for name in ("last", "best"):
        meta = json.loads((ckpts / f"{name}.meta.json").read_text())
        assert meta == {"next_epoch": 1, "step": 2, "steps_per_epoch": 5000}

    resume = _overlay(tmp_path / "resume.yaml", corpus, max_epochs=2)
    system = main_torch.main(["fit", *resume, "--ckpt_path", str(ckpts / "last"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"checkpoint: restored {ckpts / 'last'}" in out
    assert [ln.split("epoch=")[1].split()[0] for ln in out.splitlines() if ln.startswith("[train]")] == ["1", "1"]
    assert system.step == 4 and system.updates == 4
    assert json.loads((ckpts / "last.meta.json").read_text())["next_epoch"] == 2

    for command in ("validate", "test"):
        metrics = main_torch.main([command, *cfg, "--ckpt_path", str(ckpts / "last"), "--device", "cpu"])
        out = capsys.readouterr().out
        tag = "val" if command == "validate" else "test"
        assert (tag, EVAL_KEYS) in _logged(out) and f"{command}: {metrics}" in out
        assert np.isfinite(metrics["loss"]) and "[epoch]" not in out

    song = corpus / "val_song0"
    mix = main_torch.main(["predict", *cfg, "--ckpt_path", str(ckpts / "last"), "--device", "cpu",
                           "--track_dir", str(song), "--ref", str(song / "gtr_st.wav"),
                           "--output", str(tmp_path / "pred.wav")])
    wav, _ = read_audio(str(tmp_path / "pred.wav"))
    assert mix.shape == (1, 2, 3 * 32768) and wav.shape == (2, 3 * 32768)
    assert np.isfinite(wav).all() and np.abs(wav).max() > 0.9  # peak-normalized

    rows = list(csv.DictReader(open(tmp_path / "logs" / "metrics.csv")))
    assert [r["tag"] for r in rows].count("train") == 4


def test_cli_runs_on_the_card_unless_told(tmp_path, corpus):  # noqa: F811
    """No card here: without --device the CLI raises before building, for
    ``fit`` and for ``export`` (ported since; tests/test_torch_export.py
    runs it with ``--device cpu``)."""
    cfg = _overlay(tmp_path / "small.yaml", corpus)
    for command in ("fit", "export"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main_torch.main([command, *cfg])


@pytest.mark.parametrize("trainer", [{"devices": 2}, {"mesh": {"data": 2}}], ids=["devices", "mesh"])
def test_cli_refuses_what_is_not_ported(trainer):
    with pytest.raises(NotImplementedError, match="item 12"):
        main_torch.build_from_config({"trainer": trainer}, "cpu")
    main_torch._check_ported({"devices": 1, "fused_steps": 2}, torch.device("cpu"))


def test_cli_trainer_flag_passthrough():
    """trainer.{enable_checkpointing, deterministic_val, fused_steps,
    num_sanity_val_steps} of the YAML reach the Trainer, as JAX's
    (``tests/test_cli.py::test_cli_trainer_flag_passthrough``); unset, the
    sanity check takes Lightning's 2."""
    cfg = {"model": {"init_args": {
        "model": {"class_path": "diffmst_tpu.models.MixStyleTransferModel.build", "init_args": TINY},
        "mix_console": {"class_path": "mst.modules.AdvancedMixConsole", "init_args": {}},
        "loss": {"class_path": "auraloss.freq.MultiResolutionSTFTLoss"}}}}
    flags = dict(enable_checkpointing=False, deterministic_val=True, fused_steps=2, num_sanity_val_steps=0)
    trainer = main_torch.build_from_config({**cfg, "trainer": flags}, "cpu")[2]
    assert {k: getattr(trainer, k) for k in flags} == flags
    trainer = main_torch.build_from_config(cfg, "cpu")[2]
    assert (trainer.fused_steps, trainer.num_sanity_val_steps) == (1, 2)


def test_registry_model_follows_the_seed():
    """The model a YAML builds is ``MixStyleTransferModel.build``'s for the
    generator seeded ``seed_everything``, on any call."""
    enc = {"class_path": "mst.modules.SpectrogramEncoder", "init_args": dict(
        embed_dim=32, n_fft=2048, hop_length=32, cnn_base_width=4)}
    cfg = {"seed_everything": 11, "model": {"init_args": {
        "model": {"class_path": "mst.modules.MixStyleTransferModel", "init_args": {
            "track_encoder": enc, "mix_encoder": enc,
            "controller": {"class_path": "mst.modules.TransformerController", "init_args": dict(
                embed_dim=32, num_track_control_params=27, num_fx_bus_control_params=25,
                num_master_bus_control_params=26, num_layers=1, nhead=4)}}},
        "mix_console": {"class_path": "mst.modules.AdvancedMixConsole", "init_args": {}},
        "loss": {"class_path": "auraloss.freq.MultiResolutionSTFTLoss"},
        "lr": 3e-4, "active_eq_epoch": 2, "not_a_field": 1}}}
    a, b = (main_torch.build_from_config(cfg, "cpu")[0] for _ in range(2))
    ref = MixStyleTransferModel.build(**TINY, device="cpu", generator=torch.Generator().manual_seed(11))
    _state_equal(a, b)
    for k, v in ref.state_dict().items():
        assert torch.equal(a.model.state_dict()[k], v), k
    assert a.config.lr == 3e-4 and a.config.active_eq_epoch == 2
    assert a.mix_console.device == "cpu"


# ------------------------------------------------ registry, keywords, CSV


def _class_paths():
    from diffmst_tpu.utils.config import CLASS_ALIASES

    paths = set(CLASS_ALIASES)
    for p in (REPO / "configs").rglob("*.yaml"):
        text = p.read_text()
        paths |= {ln.split("class_path:")[1].strip() for ln in text.splitlines() if "class_path:" in ln}
    return sorted(p for p in paths if not p.startswith("optax."))


@pytest.mark.parametrize("class_path", _class_paths())
def test_registry_resolves_or_names_the_item(class_path):
    """Every class path of the reference's aliases and of configs/: the port's
    object of the same name, or NotPortedError naming its ROADMAP item."""
    try:
        obj = tconfig.resolve(class_path)
    except tconfig.NotPortedError as e:
        assert "ROADMAP Queue 1, item" in str(e)
        return
    assert obj.__module__.startswith("diffmst_torch.")
    assert obj.__name__ == class_path.rsplit(".", 1)[1]


def test_deep_merge_and_load_config_match_jax(tmp_path):
    from diffmst_tpu.utils.config import load_config

    files = []
    for i, doc in enumerate(({"a": {"b": 1, "c": [1, 2]}, "d": 1}, {"a": {"c": [3], "e": {"f": 2}}}, None)):
        p = tmp_path / f"{i}.yaml"
        p.write_text(yaml.safe_dump(doc) if doc is not None else "")
        files.append(str(p))
    files += [str(REPO / c) for c in SHIPPED]
    assert tconfig.load_config(files) == load_config(files)


def test_system_flat_keywords_match_jax():
    from diffmst_tpu.train import System as JaxSystem

    kwargs = dict(generate_mix=False, active_eq_epoch=3, lr=2e-4, max_epochs=7, steps_per_epoch=11,
                  accumulate_grad_batches=2, unknown_key="ignored")
    ref = dataclasses.asdict(JaxSystem(None, None, None, **kwargs).config)
    got = dataclasses.asdict(_system_config(**kwargs))
    assert got == {k: ref[k] for k in got}


def _system_config(**kwargs):
    model = torch.nn.Linear(1, 1)
    return System(model, None, None, device="cpu", **kwargs).config


def test_csvlogger_matches_jax(tmp_path):
    from diffmst_tpu.callbacks import CSVLogger as JaxCSVLogger

    rows = [("train", {"loss": 1.0, "steps_per_sec": 2.0}), ("train", {"loss": 0.5, "steps_per_sec": 2.1}),
            ("epoch", {"epoch": 0, "epoch_seconds": 12.5}), ("train", {"loss": 0.4, "steps_per_sec": 2.2})]
    for cls, name in ((CSVLogger, "t.csv"), (JaxCSVLogger, "j.csv")):
        lg = cls(str(tmp_path / name))
        for tag, m in rows:
            lg.on_log(tag, m)
        cls(str(tmp_path / name)).on_log("val", {"loss": 0.3})  # reopened, appends
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    got = list(csv.DictReader(open(tmp_path / "t.csv")))
    assert got[2]["epoch_seconds"] == "12.5" and got[2]["loss"] == "" and got[4]["tag"] == "val"
