"""The PyTorch port's serving export (``utils/export.py``, ``main_torch.py
export``) against ``run_diffmst`` and the JAX package, on the CPU.

``main_torch.py export --device cpu`` writes the export of a small model
(embed 32, 1 layer, 4 heads, n_fft 2048, hop 128, Cnn14 width 4; window
16,384, 8 windows a render call) from the shipped configs with a width
overlay, its weights a port checkpoint of random Flax values
(``jax.eval_shape``, no init compiled; the heads narrowed so the mix stays
near full scale, as tests/test_torch_inference.py's). The export is loaded
with ``diffmst_torch.models`` and ``diffmst_torch.console`` refused at
import, and serves tests/test_torch_inference.py's song (3 tracks of
40,000 samples, one under the -80 LUFS gate, so its slot is masked):

  * "ola" against the port's ``run_diffmst`` within 1e-5 and JAX's within
    1e-4 (the controller's padding mask equals run_diffmst's removal of the
    gated track);
  * "streaming" (blocks of 8,192 after 8,192 of context, the export's fixed
    window) against ``overlap_save_render`` of the live model and console
    at the same geometry within 1e-5; the renderers themselves are held to
    JAX's in tests/test_torch_inference.py;
  * the manifest's fields against those of JAX's ``save_inference_export``
    (its ``platforms`` replaced by ``device``); the render graph holds K2's
    operator twice, the track and the master compressors, so neither was
    traced through its plain version; a graph whose
    operator has no kernel for the device, another format, and a CUDA
    export without a card raise; the export module's imports, followed
    through the source, reach no module of the model's or the console's.
"""

import ast
import importlib.abc
import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffmst_tpu.console import AdvancedMixConsole as JaxAdvanced
from diffmst_tpu.models import MixStyleTransferModel as JaxModel
from diffmst_tpu.utils.export import save_inference_export as jax_save_inference_export
from diffmst_tpu.utils.inference import run_diffmst as jax_run_diffmst
from diffmst_torch.console import AdvancedMixConsole
from diffmst_torch.models import MixStyleTransferModel
from diffmst_torch.utils import export
from diffmst_torch.utils.checkpoint import state_dict_from_flax
from diffmst_torch.utils.inference import overlap_save_render, run_diffmst
from test_torch_inference import ANALYSIS, SMALL, _song

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import main_torch  # noqa: E402

torch.set_num_threads(1)

SR = 44100.0
TRACKS = 3


def _random_variables(seed=0):
    """Random values in the Flax tree of the small model (no init compiled):
    BatchNorm variances in (0.5, 1.5), everything else 0.1 x N(0, 1); the
    heads narrowed as tests/test_torch_inference.py's."""
    x = jnp.zeros((1, 2, ANALYSIS), jnp.float32)
    shapes = jax.eval_shape(JaxModel.build(**SMALL).init, jax.random.PRNGKey(0), x, x)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(s.dtype)
        return (0.1 * rng.standard_normal(s.shape)).astype(s.dtype)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    variables = {k: dict(v) for k, v in variables.items()}
    ctrl = variables["params"]["controller"] = dict(variables["params"]["controller"])
    for head in ("track_projection", "fx_bus_projection", "master_bus_projection"):
        ctrl[head] = {"kernel": ctrl[head]["kernel"] * 0.1, "bias": np.zeros_like(ctrl[head]["bias"])}
    ctrl["track_projection"]["bias"][0] = np.log(0.8 / 0.2)
    return variables


class _Refuse(importlib.abc.MetaPathFinder):
    """Refuses to import the model's and the console's code."""

    def find_spec(self, name, path, target=None):
        if name.startswith(("diffmst_torch.models", "diffmst_torch.console")):
            raise ImportError(f"{name} imported while serving an export")
        return None


@pytest.fixture(scope="module")
def jax_fast():
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(scope="module")
def served(tmp_path_factory, jax_fast):
    """The export written by main_torch.py, loaded without the model's code,
    its "ola" and "streaming" mixes; the live model; JAX's "ola" mix."""
    tmp = tmp_path_factory.mktemp("export")
    variables = _random_variables()
    port = MixStyleTransferModel.build(**SMALL, device="cpu")
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    torch.save({"model": port.state_dict()}, tmp / "model.pt")
    enc = {"embed_dim": 32, "n_fft": 2048, "hop_length": 128, "cnn_base_width": 4}
    (tmp / "small.yaml").write_text(yaml.safe_dump({"model": {"init_args": {"model": {"init_args": {
        "track_encoder": {"init_args": enc}, "mix_encoder": {"init_args": enc},
        "controller": {"init_args": {"embed_dim": 32, "num_layers": 1, "nhead": 4}}}}}}}))
    cfg = [a for c in (REPO / "configs" / "config.yaml", REPO / "configs" / "models" / "naive.yaml",
                       tmp / "small.yaml") for a in ("-c", str(c))]
    manifest = main_torch.main(["export", *cfg, "--device", "cpu", "--ckpt_path", str(tmp / "model.pt"),
                                "--num_tracks", str(TRACKS), "--analysis_len", str(ANALYSIS),
                                "--output", str(tmp / "serving_export")])

    tracks, ref = _song()
    saved = {m: sys.modules.pop(m) for m in list(sys.modules)
             if m.startswith(("diffmst_torch.models", "diffmst_torch.console"))}
    guard = _Refuse()
    sys.meta_path.insert(0, guard)
    try:
        loaded = export.load_inference_export(str(tmp / "serving_export"))
        mixes = {mode: export.run_exported(loaded, tracks, ref, render_mode=mode) for mode in ("ola", "streaming")}
    finally:
        sys.meta_path.remove(guard)
        sys.modules.update(saved)

    jax_apply = jax.jit(JaxModel.build(**SMALL).apply)
    jax_mix = jax_run_diffmst(tracks, ref, lambda t, r: jax_apply(variables, t, r), JaxAdvanced(SR),
                              analysis_len=ANALYSIS)[0]
    return dict(dir=tmp / "serving_export", manifest=manifest, loaded=loaded, mixes=mixes, port=port,
                jax_mix=jax_mix)


def test_export_ola_matches_run_diffmst(served):
    tracks, ref = _song()
    mix = served["mixes"]["ola"]
    want, td, _, _ = run_diffmst(tracks, ref, served["port"], AdvancedMixConsole(SR, device="cpu"),
                                 analysis_len=ANALYSIS, device="cpu")
    assert td["compressor"]["ratio"].shape == (1, 2)  # run_diffmst removed the gated track
    assert mix.shape == want.shape == (1, 2, 40000) and np.isfinite(mix).all()
    assert 0.05 < np.abs(mix).max() < 2.0
    np.testing.assert_allclose(mix, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(mix, served["jax_mix"], rtol=0, atol=1e-4)


def test_export_streaming_matches_the_live_render(served):
    tracks, ref = _song()
    m = served["manifest"]
    console = AdvancedMixConsole(SR, device="cpu")
    # run_exported's host steps, then the live model and console
    gains, kept = [], []
    for i in range(TRACKS):
        from diffmst_torch.ops.loudness import integrated_loudness

        lufs = integrated_loudness(tracks[0, i, :ANALYSIS], SR)
        if np.isfinite(lufs) and lufs >= -80.0:
            kept.append(i)
            gains.append(np.float32(10.0 ** ((-48.0 - lufs) / 20.0)))
    norm = np.zeros((1, TRACKS, tracks.shape[-1]), np.float32)
    for slot, (i, g) in enumerate(zip(kept, gains)):
        norm[0, slot] = tracks[0, i] * g
    mask = torch.tensor([[slot >= len(kept) for slot in range(TRACKS)]])
    with torch.no_grad():
        tp, fp, mp = served["port"](torch.from_numpy(norm[..., :ANALYSIS].copy()),
                                    torch.from_numpy(ref[..., :ANALYSIS].copy()), mask)

        def render(wins):
            n = wins.shape[0]
            return console(wins, tp.expand(n, -1, -1), fp.expand(n, -1), mp.expand(n, -1), use_fx_bus=False).mix

        want = overlap_save_render(render, norm, ANALYSIS // 2, context_len=ANALYSIS - ANALYSIS // 2,
                                   render_bs=m["render_bs"], device="cpu")
    mix = served["mixes"]["streaming"]
    assert mix.shape == (1, 2, 40000) and np.isfinite(mix).all()
    np.testing.assert_allclose(mix, want, rtol=0, atol=1e-5)


def test_export_manifest_matches_jax(served, tmp_path):
    class Stub:  # the manifest does not depend on the model
        def apply(self, variables, t, r, m):
            return jnp.zeros((1, t.shape[1], 27)), jnp.zeros((1, 25)), jnp.zeros((1, 26))

    want = jax_save_inference_export(str(tmp_path / "jax"), Stub(), {}, JaxAdvanced(SR), num_tracks=TRACKS,
                                     analysis_len=ANALYSIS, render_bs=8)
    got = served["manifest"]
    assert got == json.loads((served["dir"] / "manifest.json").read_text())
    assert got["format"] == "diffmst_torch.inference_export.v2" and got["device"] == "cpu"
    assert set(got) == set(want) - {"platforms"} | {"device"}
    assert {k: v for k, v in got.items() if k not in ("format", "device")} == {
        k: v for k, v in want.items() if k not in ("format", "platforms")}
    assert sorted(p.name for p in served["dir"].iterdir()) == [
        "manifest.json", "predict_params.pt2", "render_window.pt2"]


def test_export_graph_holds_the_kernels(served, monkeypatch):
    predict, render = served["loaded"].programs
    assert export.kernel_nodes(render) == {"diffmst::compressor_fused_gain": 2}
    assert export.kernel_nodes(predict) == {}
    monkeypatch.setattr(torch._C, "_dispatch_has_kernel_for_dispatch_key", lambda name, key: False)
    with pytest.raises(RuntimeError, match="no CPU kernel"):
        export._check_kernels(render, torch.device("cpu"), "render_window.pt2")


def test_load_refuses_other_exports(served, tmp_path):
    other = tmp_path / "other"
    shutil.copytree(served["dir"], other)
    manifest = json.loads((other / "manifest.json").read_text())
    (other / "manifest.json").write_text(json.dumps({**manifest, "format": "diffmst_tpu.inference_export.v2"}))
    with pytest.raises(ValueError, match="not a diffmst_torch inference export"):
        export.load_inference_export(str(other))
    if not torch.cuda.is_available():  # a CUDA export raises without a card
        (other / "manifest.json").write_text(json.dumps({**manifest, "device": "cuda"}))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            export.load_inference_export(str(other))


def _imports(module: str) -> set:
    """The diffmst_torch modules that importing ``module`` loads: its import
    statements and those of each such module (packages' ``__init__``
    included), followed through the source."""
    seen, todo = set(), [module]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        parts = name.split(".")
        todo += [".".join(parts[:i]) for i in range(1, len(parts))]  # parent packages
        path = REPO.joinpath(*parts)
        src = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
        for node in ast.walk(ast.parse(src.read_text())):
            if isinstance(node, ast.Import):
                todo += [a.name for a in node.names if a.name.startswith("diffmst_torch")]
            elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith("diffmst_torch"):
                todo.append(node.module)
                todo += [f"{node.module}.{a.name}" for a in node.names
                         if REPO.joinpath(*node.module.split("."), a.name + ".py").exists()]
    return seen


def test_export_module_imports_no_model_code():
    """Importing the export module loads no module of models/ or console/
    (the fixture's import guard covers what loading and serving import)."""
    loaded = _imports("diffmst_torch.utils.export")
    assert {"diffmst_torch.kernels", "diffmst_torch.utils.inference"} <= loaded
    assert not [m for m in loaded if m.startswith(("diffmst_torch.models", "diffmst_torch.console"))]
    assert "diffmst_torch.models.mst_model" in _imports("diffmst_torch.models")  # the walk follows packages
