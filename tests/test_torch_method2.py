"""The PyTorch port's train step with the audio-feature loss, Method 2 and
knowledge-engineering (KE) mixes with the fx bus, the config overlay rule,
and ``main_torch.py fit`` on the feature-loss configs, against the JAX
package where it has a counterpart.

The step runs at toy widths: batch 2 x 3 tracks x 8,192 samples, the
audio-feature loss's Bark STFT at 2,048 points (its 32,768 does not fit a
4,096-sample half), the reverb at 4,096 samples and 63 taps, the "fsm"
smoother, the track EQ left out (``SETUPS``); the model is a probe: the three parameter vectors are sigmoids of
learned offsets plus learned multiples of each track's and the reference's
log RMS, so that the gradients reach the model's inputs and parameters
through every stage of the step. ``tests/test_torch_train.py`` holds the
real model's step to JAX's. Three setups, each from the same numpy inputs:

  * Method 1 with ``AudioFeatureLoss``: reference-mix parameters injected
    (a seeded numpy draw) into both steps;
  * Method 2 (``generate_mix=False``): the batch's real reference mix;
  * KE with the fx bus on: the port samples the KE parameters
    on the host from its generator, and JAX's step takes the same ones
    (its ``ke_params``); both renders take JAX's reverb draws.

Tolerances: JAX's step in float64 (jitted, XLA's optimization passes off,
its EQ's frequency grid in float64 as the port's; ROADMAP Queue 3) against
the port's in float64: the loss and each named term within 1e-5 (as
``tests/test_torch_train.py``), every gradient within 1e-4 of its max-abs;
the port's float32 step: the loss and each term within 1e-4 of the loss,
the gradients within 1e-2 of their max-abs (``tests/test_torch_train.py``'s
float32 bound). Every setup takes the feature loss, whose gradients are
smooth: under MRSTFT's L1 terms the KE step's mixes, 2e-7 apart in float64
(JAX's and the port's consoles differ by 8e-8 of the peak with the fx bus
off), flip the sign of near-equal bins and moved one fx-bus gradient by
3.2e-4 of its max-abs.
"""

import itertools
import json
import pathlib
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import main_torch
from diffmst_tpu.console import AdvancedMixConsole as JaxConsole
from diffmst_tpu.losses import AudioFeatureLoss as JaxFeatureLoss
from diffmst_tpu.mixing import knowledge as jax_knowledge
from diffmst_tpu.train import Batch as JaxBatch
from diffmst_tpu.train import System as JaxSystem
from diffmst_tpu.train import SystemConfig as JaxConfig
from diffmst_tpu.utils import config as jax_config
from diffmst_torch.console import AdvancedMixConsole
from diffmst_torch.losses import AudioFeatureLoss
from diffmst_torch.mixing import knowledge_engineering_mix, naive_random_mix
from diffmst_torch.mixing.knowledge import instrument_metadata
from diffmst_torch.train import Batch, System, SystemConfig
from diffmst_torch.utils import config as tconfig
from tests.test_torch_data import corpus  # noqa: F401 (fixture)
from tests.test_torch_train import _jax_sos_response

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SR = 44100.0
BS, NT, T = 2, 3, 8192
N_IR, TAPS = 4096, 63
CONSOLE = dict(reverb_num_samples=N_IR, reverb_num_taps=TAPS, comp_smoother="fsm")
FEATURE_LOSS = dict(barkspectrum_fft_size=2048)
HEADS = (("track", 27), ("track_scale", 27), ("fx", 25), ("fx_scale", 25), ("master", 26), ("master_scale", 26))
# Each setup's curriculum stage leaves the track EQ out (active_eq_epoch 1):
# tracing JAX's six-band EQ in every render took a fifth of the module's
# time, and tests/test_torch_train.py's step holds the track EQ.
SETUPS = {
    "method1_features": dict(generate_mix=True, active_eq_epoch=1),
    "method2": dict(generate_mix=False, active_eq_epoch=1),
    "ke_fx_bus": dict(generate_mix=True, active_eq_epoch=1, active_fx_bus_epoch=0),
}


class JaxProbe(fnn.Module):
    """The probe model (see the module docstring), in Flax."""

    @fnn.compact
    def __call__(self, tracks, ref, padding, train=False):
        p = {k: self.param(k, fnn.initializers.zeros, (n,)) for k, n in HEADS}
        lvl = jnp.log(jnp.sqrt(jnp.mean(tracks**2, axis=-1)) + 1e-3)  # (bs, n)
        ref_lvl = jnp.log(jnp.sqrt(jnp.mean(ref**2, axis=(1, 2))) + 1e-3)[:, None]  # (bs, 1)
        return (jax.nn.sigmoid(p["track"] + p["track_scale"] * lvl[..., None]),
                jax.nn.sigmoid(p["fx"] + p["fx_scale"] * ref_lvl),
                jax.nn.sigmoid(p["master"] + p["master_scale"] * ref_lvl))


class Probe(torch.nn.Module):
    """The probe model, in PyTorch, from the same weights."""

    def __init__(self, weights):
        super().__init__()
        for k, v in weights.items():
            self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))

    def forward(self, tracks, ref, padding, train=False):
        lvl = torch.log(torch.sqrt(torch.mean(tracks**2, dim=-1)) + 1e-3)
        ref_lvl = torch.log(torch.sqrt(torch.mean(ref**2, dim=(1, 2))) + 1e-3)[:, None]
        return (torch.sigmoid(self.track + self.track_scale * lvl[..., None]),
                torch.sigmoid(self.fx + self.fx_scale * ref_lvl),
                torch.sigmoid(self.master + self.master_scale * ref_lvl))


def _inputs():
    """Probe weights, the batch (float64 numpy) and the injected
    reference-mix parameters of Method 1."""
    rng = np.random.default_rng(0)
    weights = {k: rng.normal(size=n) * 0.3 for k, n in HEADS}
    weights["track"][0] = weights["master"][24:] = 0.0  # faders near 0 dB
    env = np.abs(np.sin(np.linspace(0.0, 5.0 * np.pi, T)))
    tracks = rng.normal(size=(BS, NT, T)) * 0.1 * env
    ids = np.array([[9, 2, 2], [1, 9, 999]], np.int32)  # data/instrument_name2id.json; an unknown id
    stereo = np.array([[0, 1, 0], [1, 0, 0]], np.int32)  # stereo pairs from track 1 and track 0
    padding = np.zeros((BS, NT), bool)
    ref_mix = rng.normal(size=(BS, 2, T)) * np.array([0.05, 0.2])[:, None, None]
    ref_params = (rng.uniform(0.1, 0.9, size=(BS, NT, 27)), rng.uniform(0.1, 0.9, size=(BS, 25)),
                  rng.uniform(0.1, 0.9, size=(BS, 26)))
    return weights, (tracks, ids, stereo, padding, ref_mix), ref_params


def _jax_noise(key):
    return np.array(jax.random.normal(key, (BS, 2, 12, N_IR + TAPS - 1), jnp.float64))


@pytest.fixture(scope="module")
def jax_steps():
    """Each setup's JAX step in float64: the loss, the metrics and the
    gradients, with what the port's step must take to match it."""
    weights, arrays, ref_params = _inputs()
    lookup = json.loads((REPO / "data" / "instrument_name2id.json").read_text())
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    out, lowered = {}, {}
    try:
        with jax.enable_x64(True), pytest.MonkeyPatch.context() as patch:
            # JAX's EQ keeps a float32 frequency grid in float64 runs
            # (ROADMAP Queue 3): a float64 one, as the port's
            patch.setattr(sys.modules["diffmst_tpu.ops.eq"], "sos_frequency_response", _jax_sos_response)
            batch = JaxBatch(*(jnp.asarray(a) for a in arrays))
            params = {k: jnp.asarray(v) for k, v in weights.items()}
            key = jax.random.PRNGKey(21)
            k_mix, _, k_render = jax.random.split(key, 3)
            for name, setup in SETUPS.items():
                console = JaxConsole(SR, **CONSOLE)
                loss = JaxFeatureLoss(**FEATURE_LOSS)
                ke_params = reverb_noise = None
                if name == "ke_fx_bus":
                    mix_fn = jax_knowledge.knowledge_engineering_mix
                    # the port's host sampler: its seed is one 31-bit draw from
                    # the System's generator (seeded 22 below)
                    seed = int(torch.randint(0, 2**31 - 1, (), generator=torch.Generator().manual_seed(22)))
                    mdata = instrument_metadata(arrays[1], lookup)
                    ke_params = tuple(jnp.asarray(a, jnp.float64) for a in jax_knowledge.sample_ke_params(
                        jax_knowledge._load_vendored_ke(), mdata, arrays[2], np.random.default_rng(seed), console))
                    reverb_noise = (_jax_noise(k_mix), _jax_noise(k_render))
                else:
                    rp = tuple(jnp.asarray(p) for p in ref_params)

                    def mix_fn(tracks, console_, _key, **flags):
                        mix = console_(tracks, *rp, **flags)
                        return type("Ref", (), dict(mix=jax.lax.stop_gradient(mix.mix), track_params=rp[0],
                                                    fx_bus_params=rp[1], master_bus_params=rp[2]))
                system = JaxSystem(JaxProbe(), console, loss, JaxConfig(**setup), mix_fn=mix_fn)
                if name == "ke_fx_bus":
                    assert system.instrument_number_lookup == lookup

                def f(p, system=system, ke_params=ke_params):
                    return system._common(p, {}, batch, key, system.effect_flags(0), train=True,
                                          ke_params=ke_params)

                lowered[name] = jax.jit(jax.value_and_grad(f, has_aux=True)).lower(params)
                out[name] = dict(ref_params=None if name == "ke_fx_bus" else ref_params,
                                 reverb_noise=reverb_noise, ke_params=ke_params)
            for name, lw in lowered.items():
                (_, aux), grads = lw.compile()(params)
                out[name].update(metrics={k: float(v) for k, v in aux["metrics"].items()},
                                 grads={k: np.asarray(v) for k, v in grads.items()})
    finally:
        jax.config.update("jax_disable_most_optimizations", before)
    return weights, arrays, out


def _port_system(name, weights, dtype):
    mix_fn = knowledge_engineering_mix if name == "ke_fx_bus" else naive_random_mix
    return System(Probe(weights).to(dtype), AdvancedMixConsole(SR, **CONSOLE, device="cpu"),
                  AudioFeatureLoss(**FEATURE_LOSS), SystemConfig(lr=1e-3, **SETUPS[name]), mix_fn=mix_fn,
                  generator=torch.Generator().manual_seed(22), device="cpu")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("name", list(SETUPS))
def test_train_step_matches_jax(jax_steps, name, dtype):
    weights, arrays, ref = jax_steps[0], jax_steps[1], jax_steps[2][name]
    system = _port_system(name, weights, dtype)
    tracks, ids, stereo, padding, ref_mix = arrays
    batch = Batch(torch.from_numpy(tracks).to(dtype), torch.from_numpy(ids), torch.from_numpy(stereo),
                  torch.from_numpy(padding), torch.from_numpy(ref_mix).to(dtype))
    ref_params = None if ref["ref_params"] is None else tuple(torch.from_numpy(p).to(dtype)
                                                                for p in ref["ref_params"])
    noise = None if ref["reverb_noise"] is None else tuple(torch.from_numpy(n) for n in ref["reverb_noise"])
    metrics = system.gradients(batch, system.effect_flags(0), ref_params, noise)
    loss_tol, grad_tol = (1e-5, 1e-4) if dtype == torch.float64 else (1e-4, 1e-2)
    assert set(metrics) == set(ref["metrics"]) | {"grad_norm"}
    for k, v in ref["metrics"].items():
        # float64: each term within 1e-5 of itself; float32: within 1e-4 of
        # the loss (a small term, such as the crest factor's MSE of two
        # near dB values, keeps float32's error of the values it subtracts)
        scale = abs(v) if dtype == torch.float64 else abs(ref["metrics"]["loss"])
        assert abs(float(metrics[k]) - v) <= loss_tol * scale, k
    for k, p in system.model.named_parameters():
        g = ref["grads"][k]
        assert np.abs(p.grad.double().numpy() - g).max() <= grad_tol * np.abs(g).max(), k
    if name == "ke_fx_bus":  # the port sampled JAX's KE parameters on the host
        resampled = torch.Generator().manual_seed(22)
        system.generator = resampled
        tp, fx, mp = system._host_sample_ke(batch)
        assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in zip((tp, fx, mp), ref["ke_params"]))
    before = {k: p.detach().clone() for k, p in system.model.named_parameters()}
    system.apply_gradients(metrics["grad_norm"])
    for k, p in system.model.named_parameters():  # the fx heads take no gradient with the fx bus off
        assert torch.equal(p, before[k]) == (not ref["grads"][k].any()), k


def test_ke_step_draws_from_the_generator(jax_steps):
    """Without injected noise the KE step samples and renders from its
    generator alone: the same seed takes the same step, another seed
    another."""
    weights, arrays = jax_steps[0], jax_steps[1]
    batch = Batch(*(torch.from_numpy(a) for a in arrays))

    def loss(seed):
        system = _port_system("ke_fx_bus", weights, torch.float64)
        system.generator = torch.Generator().manual_seed(seed)
        _, metrics, _ = system.forward(batch, system.effect_flags(0), True)
        return float(metrics["loss"])

    assert loss(5) == loss(5) != loss(6)


# ------------------------------------------------------------------ configs


def _config_files():
    return sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.yaml"))


def _switches_class(files) -> bool:
    nodes = [yaml.safe_load((REPO / f).read_text()) or {} for f in files]

    def paths(node, prefix=""):
        if isinstance(node, dict):
            if "class_path" in node:
                yield prefix, tconfig._port_path(node["class_path"])
            for k, v in node.items():
                yield from paths(v, f"{prefix}/{k}")

    seen = {}
    for node in nodes:
        for where, cls in paths(node):
            if seen.setdefault(where, cls) != cls:
                return True
            seen[where] = cls
    return False


def test_overlays_without_a_class_switch_match_jax():
    """Every pair of shipped YAMLs, in ``configs/``'s order, that changes
    no node's class merges as JAX's ``load_config`` does."""
    pairs = [p for p in itertools.combinations(_config_files(), 2) if not _switches_class(p)]
    assert len(pairs) > 90
    for pair in pairs:
        files = [str(REPO / f) for f in pair]
        assert tconfig.load_config(files) == jax_config.load_config(files), pair


@pytest.mark.parametrize("overlay", ["naive+feat.yaml", "unpaired+feat.yaml"])
def test_overlay_switching_the_loss_drops_its_arguments(overlay):
    """naive.yaml then a feature-loss YAML: the loss node is the overlay's
    alone, so it builds; JAX's merge keeps MRSTFT's arguments, which
    AudioFeatureLoss does not take (ROADMAP Queue 3)."""
    files = [str(REPO / "configs/models" / f) for f in ("naive.yaml", overlay)]
    node = tconfig.load_config(files)["model"]["init_args"]["loss"]
    assert node == {"class_path": "diffmst_tpu.losses.AudioFeatureLoss",
                    "init_args": {"sample_rate": 44100, "weights": [0.1, 0.001, 1.0, 1.0, 0.1]}}
    assert isinstance(tconfig.instantiate(node), AudioFeatureLoss)
    jax_node = jax_config.load_config(files)["model"]["init_args"]["loss"]
    assert set(jax_node["init_args"]) == {"fft_sizes", "hop_sizes", "win_lengths", "sample_rate", "weights"}
    with pytest.raises(TypeError):
        jax_config.instantiate(jax_node)
    # the rest of the System node merges as before: naive.yaml's console and model stay
    merged = tconfig.load_config(files)["model"]["init_args"]
    assert "mix_console" in merged and "model" in merged and merged["generate_mix"] == (overlay == "naive+feat.yaml")


def test_feature_loss_and_ke_resolve():
    assert tconfig.resolve("mst.loss.AudioFeatureLoss") is AudioFeatureLoss
    assert tconfig.resolve("mst.mixing.knowledge_engineering_mix") is knowledge_engineering_mix
    assert tconfig.instantiate("mst.mixing.knowledge_engineering_mix") is knowledge_engineering_mix


# ---------------------------------------------------------------------- CLI


@pytest.mark.parametrize("overlay,length", [("unpaired+feat.yaml", 32768), ("naive+feat.yaml", 40000)],
                         ids=["method2", "method1_features"])
def test_cli_fit_on_the_feature_loss_configs(tmp_path, corpus, monkeypatch, capsys, overlay, length):  # noqa: F811
    """``main_torch.py fit --device cpu`` on naive.yaml and a feature-loss
    YAML, at toy widths, over the synthetic corpus (Method 2: with its
    reference mixes under ``mix_root_dirs``): a step whose logged feature
    terms are finite, and a checkpoint."""
    monkeypatch.chdir(tmp_path)
    enc = {"embed_dim": 32, "n_fft": 2048, "hop_length": 128, "cnn_base_width": 4}
    data = {"track_root_dirs": [str(corpus)], "metadata_files": [str(corpus / "meta.yaml")],
            "instrument_name2id_json": str(REPO / "data" / "instrument_name2id.json"),
            "length": length, "min_tracks": 2, "max_tracks": 4, "batch_size": 2,
            "num_examples_per_pass": 2, "num_train_passes": 1, "train_buffer_size_gb": 0.001,
            "val_buffer_size_gb": 0.001}
    if overlay == "unpaired+feat.yaml":
        data["mix_root_dirs"] = [str(corpus / "mixes")]
    (tmp_path / "small.yaml").write_text(yaml.safe_dump({
        "trainer": {"max_epochs": 1, "log_every_n_steps": 1, "num_sanity_val_steps": 0,
                    "default_root_dir": str(tmp_path / "ckpts")},
        "model": {"init_args": {"model": {"init_args": {
            "track_encoder": {"init_args": enc}, "mix_encoder": {"init_args": enc},
            "controller": {"init_args": {"embed_dim": 32, "num_layers": 1, "nhead": 4}}}}}},
        "data": {"init_args": data},
    }))
    files = ["configs/config.yaml", "configs/optimizer.yaml", "configs/data/synthetic-8.yaml",
             "configs/models/naive.yaml", f"configs/models/{overlay}", str(tmp_path / "small.yaml")]
    system = main_torch.main(["fit", *(a for f in files for a in ("-c", str(REPO / f))), "--device", "cpu"])
    out = capsys.readouterr().out
    assert isinstance(system.loss, AudioFeatureLoss) and system.config.generate_mix == (overlay == "naive+feat.yaml")
    train = [ln for ln in out.splitlines() if ln.startswith("[train]")]
    assert len(train) == 1 and system.step == 1
    for ln in train:
        terms = dict(kv.split("=") for kv in ln.split()[1:])
        for k in ("loss", "mix-rms", "mix-crest_factor", "mix-stereo_width", "mix-stereo_imbalance",
                  "mix-barkspectrum"):
            assert np.isfinite(float(terms[k])), ln
    if overlay == "unpaired+feat.yaml":
        assert "data: train buffer reloaded" in out
    assert (tmp_path / "ckpts" / "last.meta.json").exists()
