"""The port's convergence demos against the JAX package's, on the CPU.

``scripts/{train_demo,probe_floor,train_demo_method2,train_demo_16track}_torch.py``
against their ``_tpu.py`` twins:

  * exact: the NumPy stem synthesis, and the Method-2 and 16-track pools
    drawn from the same seed (the JAX modules' shapes cut to toy sizes);
  * the probe's equal-gain-sum baseline against JAX's ``_probe_baseline``,
    and the three oracle floors against a reference built from the JAX
    functions that ``probe_floor_tpu.py``'s ``floors`` calls, each fed the
    reference-mix parameters that JAX's validation draws
    (``fold_in(PRNGKey(SEED + 1), i)``, then the System's first split),
    within 1e-4 of the loss;
  * the draws: the port's probe reference for batch i is bitwise the
    reference mix that the port's Trainer renders in its deterministic
    validation, and the untrained pass leaves the weights and the training
    generator as they were;
  * a toy run of each script's ``main`` on the CPU (tiny model, 2 steps,
    one probe batch), which writes its summary's keys.

Sizes: 2 x 2 x 8,192 samples for the probe (MRSTFT at its default
resolutions); the scripts' ``--toy`` model (embed 32, one layer, Cnn14
width 2, bf16) for the runs.
"""

import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
SR = 44100.0
PROBE = (2, 2, 8192)  # the probe batches' shape
N_PROBE = 2
FLAGS = dict(use_track_eq=True, use_track_compressor=True, use_fx_bus=False, use_master_bus=True)


@pytest.fixture(scope="module")
def mods():
    """The four JAX scripts and the four port scripts, by module name (the
    scripts import each other so); the module search path and the JAX ones'
    compile-cache setting are put back as they were."""
    saved, path = os.environ.get("JAX_COMPILATION_CACHE_DIR"), list(sys.path)
    sys.path.insert(0, SCRIPTS)
    try:
        names = [f"{n}_{side}" for side in ("tpu", "torch")
                 for n in ("train_demo", "probe_floor", "train_demo_method2", "train_demo_16track")]
        return {n: importlib.import_module(n) for n in names}
    finally:
        sys.path[:] = path
        if saved is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)


@pytest.fixture(scope="module")
def probe():
    """Toy probe batches and the parameters JAX's deterministic validation
    draws for them: ``_probe_baseline``'s keys, then ``naive_random_mix``'s
    four-way split (track, fx bus, master bus, reverb)."""
    from diffmst_tpu.console import AdvancedMixConsole as JaxConsole

    rng = np.random.default_rng(5)
    tracks = [(rng.normal(size=PROBE) * 0.05 * np.abs(np.sin(np.linspace(0, (2 + i) * np.pi, PROBE[-1]))))
              .astype(np.float32) for i in range(N_PROBE)]
    console = JaxConsole(SR)
    base = jax.random.PRNGKey(42 + 1)
    params = []
    bs, nt, _ = PROBE
    for i in range(N_PROBE):
        k_mix, _, _ = jax.random.split(jax.random.fold_in(base, i), 3)
        k_track, k_fx, k_master, _ = jax.random.split(k_mix, 4)
        params.append(tuple(np.asarray(jax.random.uniform(k, s)) for k, s in (
            (k_track, (bs, nt, console.num_track_control_params)),
            (k_fx, (bs, console.num_fx_bus_control_params)),
            (k_master, (bs, console.num_master_bus_control_params)))))
    return tracks, params


class _Probe:
    """A datamodule stub that holds only the probe set."""

    def __init__(self, tracks, wrap):
        self.tracks = [wrap(t) for t in tracks]

    def probe_tracks(self, i):
        return self.tracks[i]


# ------------------------------------------------------------------ exact


def test_stem_synthesis_and_pools_match_jax(mods, monkeypatch):
    """The host stem synthesis and the Method-2 and 16-track pools: the
    same arrays as JAX's scripts from the same NumPy seeds."""
    jdemo, tdemo = mods["train_demo_tpu"], mods["train_demo_torch"]
    monkeypatch.setattr(jdemo, "BS", 2)
    monkeypatch.setattr(jdemo, "NT", 3)
    monkeypatch.setattr(jdemo, "T", 1000)
    np.testing.assert_array_equal(tdemo.synth_tracks_host(np.random.default_rng(3), 2, 3, 1000),
                                  jdemo._synth_tracks_host(np.random.default_rng(3)))
    for name, dm, shape in (("train_demo_method2", "SyntheticUnpairedDM", (2, 3, 512)),
                            ("train_demo_16track", "Synthetic16DM", (1, 16, 512))):
        jmod, tmod = mods[f"{name}_tpu"], mods[f"{name}_torch"]
        for attr, v in zip(("BS", "NT", "T"), shape):
            monkeypatch.setattr(jmod, attr, v)
        want = getattr(jmod, dm)(5, device_pool=False).pool
        got = getattr(tmod, dm)(5, device="cpu", shape=shape).pool
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            for a, b in zip(g[:5], w[:5]):
                np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
            assert g[5] == w[5]
    padded = [int(b[3].sum()) for b in got]
    assert padded == [0, 4, 0, 6], padded  # the 16-track pool's padded slots


# ---------------------------------------------------- baseline and floors


def _jax_floors(tracks, params, console, loss_fn):
    """``probe_floor_tpu.py``'s ``floors`` (a closure in its ``main``) from
    the same JAX functions, the reference-mix parameters given."""
    from diffmst_tpu.console.ranges import normalize
    from diffmst_tpu.utils.audio import batch_stereo_peak_normalize

    tp, fp, mp = params
    ref = console(tracks, tp, fp, mp, use_track_input_fader=False, use_output_fader=False, **FLAGS)
    peak = jnp.max(jnp.abs(ref.mix), axis=(-2, -1))
    middle = tracks.shape[-1] // 2
    ref_b = batch_stereo_peak_normalize(ref.mix)[..., middle:]
    need_db = -20.0 * jnp.log10(jnp.maximum(peak, 1e-8))
    tp = tp.at[..., 0].set(0.5)
    mp_exact = mp.at[..., 24].set(normalize(need_db, -48.0, 48.0))
    mp_clip = mp.at[..., 24].set(normalize(jnp.clip(need_db, -48.0, 48.0), -48.0, 48.0))
    kw = dict(use_track_input_fader=True, use_output_fader=True, **FLAGS)
    # the exact and the clipped fader's half renders as one batch: one console to compile
    halves = console(jnp.concatenate([tracks[..., middle:]] * 2), jnp.concatenate([tp, tp]),
                     jnp.concatenate([fp, fp]), jnp.concatenate([mp_exact, mp_clip]), **kw).mix
    half, half_c = jnp.split(halves, 2)
    full = console(tracks, tp, fp, mp_exact, **kw).mix
    return (loss_fn(half, ref_b), loss_fn(half_c, ref_b), loss_fn(full[..., middle:], ref_b), need_db)


def test_probe_baseline_and_floors_match_jax(mods, probe):
    """The port's baseline (``train_demo_torch.probe_baseline``) against
    JAX's ``_probe_baseline``, and its three floors and needed fader dB
    (``probe_floor_torch.probe_floors``) against JAX's, on the same probe
    stems and JAX's validation draws: within 1e-4 of the loss."""
    from diffmst_tpu.console import AdvancedMixConsole as JaxConsole
    from diffmst_tpu.losses import MultiResolutionSTFTLoss as JaxMRSTFT
    from diffmst_torch.console import AdvancedMixConsole
    from diffmst_torch.losses import MultiResolutionSTFTLoss

    tracks, params = probe
    jconsole, jloss = JaxConsole(SR), JaxMRSTFT()
    want_base = mods["train_demo_tpu"]._probe_baseline(_Probe(tracks, jnp.asarray), jconsole, jloss, N_PROBE)
    floors = jax.jit(lambda t, p: _jax_floors(t, p, jconsole, jloss))
    want = [floors(jnp.asarray(t), tuple(map(jnp.asarray, p))) for t, p in zip(tracks, params)]

    console, loss = AdvancedMixConsole(SR, device="cpu"), MultiResolutionSTFTLoss()
    tparams = [tuple(map(torch.tensor, p)) for p in params]
    got = mods["probe_floor_torch"].probe_floors(_Probe(tracks, torch.from_numpy), console, loss, N_PROBE, tparams)
    base = got["equal_gain_sum_baseline"]
    assert abs(base - float(want_base)) <= 1e-4 * abs(float(want_base)), (base, float(want_base))
    for row, w in zip(got["probe_batches"], want):
        for key, v in zip(("floor_half_render", "floor_half_render_clipped", "floor_full_render_crop"), w[:3]):
            assert abs(row[key] - float(v)) <= max(1e-4 * abs(float(v)), 5e-5), (key, row[key], float(v))
        np.testing.assert_allclose(row["output_fader_needed_db"], np.round(np.asarray(w[3]), 2), atol=0.011)
    # the means of the unrounded floors
    for key, j in (("floor_half_render_mean", 0), ("floor_half_render_clipped_mean", 1),
                   ("floor_full_render_crop_mean", 2)):
        w = float(np.mean([float(x[j]) for x in want]))
        assert abs(got[key] - w) <= 1e-4 * max(abs(w), 1.0), (key, got[key], w)
    assert got["floor_half_render_mean"] < base


# --------------------------------------------------------------- the draws


def test_probe_reference_is_the_validation_mix(mods, monkeypatch):
    """For each probe batch, the port's baseline and floors render the very
    reference mix (bitwise) that the port's Trainer renders in its
    deterministic validation; the untrained pass moves neither the weights
    nor the training generator, and two passes draw the same."""
    from diffmst_torch.losses import MultiResolutionSTFTLoss
    from diffmst_torch.train import Trainer

    tdemo = mods["train_demo_torch"]
    dm = tdemo.SyntheticDM(1, n_probe=N_PROBE, device="cpu", shape=PROBE)
    system = tdemo.build_system(torch.device("cpu"), MultiResolutionSTFTLoss(), tdemo.TOY_MODEL, steps_per_epoch=1,
                                max_epochs=1)
    trainer = Trainer(system, dm, deterministic_val=True, enable_checkpointing=False, seed=tdemo.SEED)
    seen = []
    eval_step = system.eval_step

    def recording(batch, flags):
        metrics, outputs = eval_step(batch, flags)
        seen.append(outputs["ref_mix_b"])
        return metrics, outputs

    monkeypatch.setattr(system, "eval_step", recording)
    weights = {k: v.clone() for k, v in system.model.state_dict().items()}
    gen = system.generator.get_state()
    first = trainer.validate()["loss"]
    assert trainer.validate()["loss"] == first
    assert torch.equal(system.generator.get_state(), gen)
    assert all(torch.equal(v, weights[k]) for k, v in system.model.state_dict().items())
    assert len(seen) == 2 * N_PROBE
    for i in range(N_PROBE):
        tracks = dm.probe_tracks(i)
        ref_b = tdemo.probe_reference(tracks, system.mix_console, tdemo.probe_params(tracks, system.mix_console, i))
        assert torch.equal(ref_b, seen[i]) and torch.equal(ref_b, seen[N_PROBE + i]), i


# ------------------------------------------------------------- toy runs

_KEYS = {
    "train_demo_torch": {"backend", "power_limit", "shape", "recipe", "lr", "schedule", "data_mode",
                         "distinct_batches", "steps", "wall_s", "loss_trail", "smoothed_first_third",
                         "smoothed_last_third", "loss_dropped", "probe", "sustained_steps_per_sec",
                         "realtime_factor", "captured_at"},
    "probe_floor_torch": {"backend", "power_limit", "what", "probe_batches", "floor_half_render_mean",
                          "floor_half_render_clipped_mean", "floor_full_render_crop_mean", "boundary_effect",
                          "equal_gain_sum_baseline", "output_fader_within_range", "max_abs_needed_db",
                          "captured_at"},
    "train_demo_method2_torch": {"backend", "power_limit", "method", "shape", "recipe", "effective_batch",
                                 "batch_residency", "fused_steps_per_dispatch", "distinct_batches", "steps",
                                 "wall_s", "loss_trail", "smoothed_first_third", "smoothed_last_third",
                                 "loss_dropped", "sustained_steps_per_sec", "realtime_factor", "captured_at"},
    "train_demo_16track_torch": {"backend", "power_limit", "shape", "recipe", "batch_residency",
                                 "fused_steps_per_dispatch", "distinct_batches", "steps", "wall_s", "loss_trail",
                                 "smoothed_first_third", "smoothed_last_third", "loss_dropped",
                                 "sustained_steps_per_sec", "realtime_factor", "captured_at"},
}
_FILES = {"train_demo_torch": "train_demo_torch.json", "probe_floor_torch": "probe_floor_torch.json",
          "train_demo_method2_torch": "train_demo_method2_torch.json",
          "train_demo_16track_torch": "train_demo_16track_fused_torch.json"}


@pytest.mark.parametrize("name", sorted(_KEYS))
def test_script_runs_on_the_cpu(mods, name, tmp_path, monkeypatch):
    """``main`` of each script with ``--device cpu --toy`` (a tiny model, 2
    steps, fused in pairs where the script fuses, one probe batch): its summary
    under the working directory with the JAX script's keys (and the card's
    power limit), the steps taken, the probe curve finite; without a device
    it refuses here, where there is no card."""
    mod = mods[name]
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DEMO_DEVICE", raising=False)
    monkeypatch.setenv("DEMO_FUSED_STEPS", "2")
    monkeypatch.setenv("DEMO_LR", "1e-3")
    argv = (["2", "1"] if name != "probe_floor_torch" else []) + ["--toy", "--device", "cpu"]
    summary = mod.main(argv)
    saved = json.loads((tmp_path / "logs" / _FILES[name]).read_text())
    assert set(saved) == set(summary) == _KEYS[name]
    assert saved["backend"] == "cpu" and saved["power_limit"] is None
    if name == "probe_floor_torch":
        assert 0 <= saved["floor_full_render_crop_mean"] <= saved["floor_half_render_mean"]
    else:
        assert saved["steps"] == 2
    if name == "train_demo_torch":
        curve = saved["probe"]["curve"]
        assert len(curve) == 2 and all(np.isfinite(curve)) and curve[0] == saved["probe"]["untrained_loss"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv[:-2])  # no card here
