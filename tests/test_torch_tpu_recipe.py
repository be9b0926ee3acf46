"""The JAX package's fast training recipe in the port, against the JAX package.

``configs/models/naive+tpu.yaml`` builds ``MixStyleTransferModel.build`` with
bf16 compute and trains with Adam's first moment in bf16; the JAX package
also has encoder remat, Cnn14's width floor, the Nyquist crop and the
flattened optimizer. Each goes through the JAX function and its port on the
same numpy inputs made from a seed, with the Flax weights carried by
``state_dict_from_flax``. Toy sizes: embed 32, one layer, 4 heads, Cnn14
width 4, n_fft 2048, hop 128, 16,384 samples. The JAX references compile
with XLA's optimizations off, but for the bf16 model's: with them off,
XLA:CPU's bf16 model is 0.23 off its own float32 run on these inputs (0.0017
with them on, as in ``tests/test_models.py``), where the port's is 0.0017.

Tolerances, each measured on these inputs and stated at its test:
float32 encoders 1e-4 max-abs; the bf16 model against JAX's bf16 model 3e-2
on the parameters in (0, 1) and 2e-2 of each running statistic's max-abs
(bf16 rounds at 2^-8 relative, and the two round different sums: XLA's
convolutions and oneDNN's do not add in one order), and within 0.05 of its
own float32 run (``tests/test_models.py::test_bf16_compute_close_to_f32``'s
bound); remat 1e-6 (measured: bitwise); the bf16-moment Adam 1e-6 of each
parameter's max-abs against optax, its moment within one bf16 ulp; the
flattened optimizer 1e-6 against optax and 1e-7 against the per-leaf
layout; the waveform encoder 1e-4, the positional encoding 1e-6.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from diffmst_tpu.models import MixStyleTransferModel as JaxModel
from diffmst_tpu.models.encoders import PositionalEncoding as JaxPositionalEncoding
from diffmst_tpu.models.encoders import SpectrogramEncoder as JaxSpectrogramEncoder
from diffmst_tpu.models.encoders import WaveformTransformerEncoder as JaxWaveformEncoder
from diffmst_torch.models import (
    MixStyleTransferModel,
    PositionalEncoding,
    SpectrogramEncoder,
    WaveformTransformerEncoder,
)
from diffmst_torch.train import Batch, System, SystemConfig
from diffmst_torch.train.system import OptaxAdam, _global_norm
from diffmst_torch.utils import checkpoint as tckpt
from diffmst_torch.utils.checkpoint import (
    encoder_state_dict,
    state_dict_from_flax,
    waveform_encoder_state_dict_from_flax,
)

torch.set_num_threads(1)

SMALL = dict(embed_dim=32, num_layers=1, nhead=4, n_fft=2048, hop_length=128, cnn_base_width=4)
T = 16384  # 129 frames at hop 128: Cnn14 needs >= 128


@pytest.fixture(scope="module", autouse=True)
def jax_fast():
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@contextlib.contextmanager
def _xla_optimized():
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", False)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", before)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _random_variables(module, seed, *inputs):
    """Random float32 variables in the module's Flax tree (its shapes from
    ``jax.eval_shape``, no init compiled): kernels N(0, 1 / fan-in),
    biases N(0, 0.05), norm scales U(0.5, 1.5), tokens N(0, 1), running
    means N(0, 0.1) and variances U(0.5, 2), so eval mode reads them."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name == "bias":
            a = rng.normal(0.0, 0.05, shape)
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape) if name == "scale" else rng.uniform(0.5, 2.0, shape)
        elif name == "mean":
            a = rng.normal(0.0, 0.1, shape)
        else:  # the learned tokens and CLS block
            a = rng.normal(0.0, 1.0, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _inputs(seed, n_tracks=2):
    rng = np.random.default_rng(seed)
    tracks = (rng.normal(size=(1, n_tracks, T)) * 0.1).astype(np.float32)
    ref = (rng.normal(size=(1, 2, T)) * 0.1).astype(np.float32)
    return tracks, ref


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ------------------------------------------------------ 1, 2: the encoder


@pytest.mark.parametrize("option", [dict(cnn_min_width=8), dict(crop_nyquist=True)],
                         ids=["min_width", "crop_nyquist"])
def test_encoder_option_matches_jax(option):
    """Cnn14's width floor (base 4, floor 8: blocks 8, 8, 16, 32, 64, 128
    wide) and the Nyquist crop, each against JAX's encoder in float32 within
    1e-4 (measured 6e-8); the crop leaves every parameter shape as it is."""
    kw = dict(embed_dim=16, n_fft=2048, hop_length=128, cnn_base_width=4)
    jenc = JaxSpectrogramEncoder(**kw, **option)
    x = (np.random.default_rng(3).normal(size=(2, 1, T)) * 0.1).astype(np.float32)
    v = _random_variables(jenc, 1, jnp.asarray(x))
    want = jax.jit(jenc.apply)(v, jnp.asarray(x))

    port = SpectrogramEncoder(**kw, **option)
    sd = {}
    encoder_state_dict(v["params"], v["batch_stats"], "", sd)
    port.load_state_dict(sd, strict=True)
    plain = SpectrogramEncoder(**kw)
    widths = [port.model.get_submodule(f"conv_block{i}").conv1.out_channels for i in range(1, 7)]
    if "cnn_min_width" in option:
        assert widths == [8, 8, 16, 32, 64, 128]
        assert tuple(port.model.conv_block2.conv1.weight.shape) == (8, 8, 3, 3)
    else:
        assert {k: v.shape for k, v in port.state_dict().items()} == {
            k: v.shape for k, v in plain.state_dict().items()}
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-4


# ------------------------------------------------------------- 3: bf16


@pytest.fixture(scope="module")
def bf16_pair():
    """JAX's bf16 build on random float32 weights and its outputs (eval,
    and train with the updated statistics); the port's bf16 and float32
    builds on the same weights."""
    m16 = JaxModel.build(**SMALL, compute_dtype="bfloat16")
    tracks, ref = _inputs(2)
    v = _random_variables(m16, 1, jnp.asarray(tracks), jnp.asarray(ref))
    with _xla_optimized():
        ev = jax.jit(lambda v, t, r: m16.apply(v, t, r))(v, tracks, ref)
        train = jax.jit(lambda v, t, r: m16.apply(v, t, r, train=True, mutable=["batch_stats"]))
        tr, upd = train(v, tracks, ref)
    sd = state_dict_from_flax(v)
    new_stats = state_dict_from_flax({"params": v["params"], "batch_stats": _np_tree(upd["batch_stats"])})
    models = {}
    for dtype in ("bfloat16", None):
        m = MixStyleTransferModel.build(**SMALL, compute_dtype=dtype, device="cpu")
        m.load_state_dict(sd, strict=True)
        models[dtype] = m
    return dict(models=models, sd=sd, tracks=tracks, ref=ref, eval=ev, train=tr, new_stats=new_stats)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bf16_model_matches_jax(bf16_pair, train):
    """The bf16 build against JAX's on the same weights: the three parameter
    groups within 3e-2 (measured: eval 2.6e-3, train 1.3e-2), and, in train
    mode, the updated running statistics within 2e-2 of each one's max-abs
    (measured 3.1e-3); each within 0.05 of the port's own float32 run
    (measured 2.0e-3, 1.1e-2); the outputs float32, the parameters and
    running statistics still float32 after a train-mode forward."""
    p = bf16_pair
    m16, m32 = p["models"]["bfloat16"], p["models"][None]
    for m in (m16, m32):
        m.load_state_dict(p["sd"], strict=True)
    t, r = torch.from_numpy(p["tracks"]), torch.from_numpy(p["ref"])
    with torch.no_grad():
        got = m16(t, r, train=train)
        own = m32(t, r, train=train)
    want = p["train" if train else "eval"]
    for g, o, w in zip(got, own, want):
        assert g.dtype == torch.float32
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= 3e-2
        assert float((g - o).abs().max()) <= 0.05
    assert all(v.dtype in (torch.float32, torch.int64) for v in m16.state_dict().values())
    if train:
        for k, v in m16.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                assert _max_rel(v.numpy(), p["new_stats"][k].numpy()) <= 2e-2, k


# ------------------------------------------------------------ 4: remat


def _remat_pass(model, t, r, w):
    outs = model(t, r, train=True)
    sum((o * wi).sum() for o, wi in zip(outs, w)).backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    stats = {k: b.clone() for k, b in model.named_buffers()}
    return [o.detach() for o in outs], grads, stats


@pytest.mark.parametrize("option", [dict(remat_encoders=True), dict(remat_blocks=2)],
                         ids=["encoders", "blocks"])
def test_remat_matches_plain_and_updates_statistics_once(option):
    """Remat against the plain model on the same weights: the outputs and
    every gradient within 1e-6 of their max-abs (measured: bitwise), and the
    BatchNorm running statistics after the train-mode forward and backward
    equal the plain run's, so the recomputed forward did not update them a
    second time."""
    plain = MixStyleTransferModel.build(**SMALL, device="cpu", generator=torch.Generator().manual_seed(4))
    remat = MixStyleTransferModel.build(**SMALL, **option, device="cpu")
    remat.load_state_dict(plain.state_dict(), strict=True)
    tracks, ref = _inputs(5)
    t, r = torch.from_numpy(tracks), torch.from_numpy(ref)
    w = [torch.randn(s, generator=torch.Generator().manual_seed(6)) for s in ((1, 2, 27), (1, 25), (1, 26))]
    a_out, a_grads, a_stats = _remat_pass(plain, t, r, w)
    b_out, b_grads, b_stats = _remat_pass(remat, t, r, w)
    for a, b in zip(a_out, b_out):
        assert _max_rel(b.numpy(), a.numpy()) <= 1e-6
    for k in a_grads:
        assert _max_rel(b_grads[k].numpy(), a_grads[k].numpy()) <= 1e-6, k
    ones = [k for k in a_stats if k.endswith("running_var") and torch.equal(a_stats[k], torch.ones_like(a_stats[k]))]
    assert not ones  # the plain run did update them
    for k in a_stats:
        assert torch.equal(a_stats[k], b_stats[k]), k


def test_remat_options_exclude_each_other():
    with pytest.raises(ValueError, match="either remat_encoders or remat_blocks"):
        MixStyleTransferModel.build(**SMALL, remat_encoders=True, remat_blocks=2, device="cpu")


# ----------------------------------------------------- 5, 6: the optimizer

SHAPES = ((6, 5), (5,), (3, 2, 4))
GRAD_SCALES = (0.5, 20.0, 1.0, 50.0, 3.0)  # some sets over the clip of 10
LR = 1e-3


class _Leaves(torch.nn.Module):
    def __init__(self, values):
        super().__init__()
        self.p = torch.nn.ParameterList(torch.nn.Parameter(torch.from_numpy(v.copy())) for v in values)


def _opt_data():
    rng = np.random.default_rng(7)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.normal(size=s) * scale).astype(np.float32) for s in SHAPES] for scale in GRAD_SCALES]
    return params, grads


def _port_system(params, **cfg):
    return System(_Leaves(params), None, None,
                  SystemConfig(lr=LR, schedule="none", grad_clip=10.0, **cfg), device="cpu")


def _port_step(system, grads):
    """One update from numpy gradients."""
    for p, g in zip(system.params, grads):
        p.grad = torch.from_numpy(g.copy())
    system.apply_gradients(_global_norm([p.grad for p in system.params]))


def _tree(leaves):
    return {f"p{i:02d}": jnp.asarray(x) for i, x in enumerate(leaves)}  # ravelled in this order


def _optax_run(params, grads, tx):
    """optax eagerly: jitted, XLA:CPU keeps bf16 products in float32
    (``xla_allow_excess_precision``), 35 bf16 ulps off the eager first
    moment after these 5 steps; eagerly each operation rounds as its jaxpr
    says, which the port follows."""
    tree = _tree(params)
    state = tx.init(tree)
    for g in grads:
        upd, state = tx.update(_tree(g), state, tree)
        tree = optax.apply_updates(tree, upd)
    return [np.asarray(tree[f"p{i:02d}"]) for i in range(len(params))], state


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).bfloat16()


def _within_one_ulp(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Two bf16 tensors within one unit in the last place of each other."""
    ia, ib = a.view(torch.int16).int(), b.view(torch.int16).int()
    return bool(((ia - ib).abs() <= 1).all())


def test_adam_bf16_moment_matches_optax(tmp_path):
    """``adam_mu_dtype="bfloat16"`` over 5 gradient sets (three over the clip
    of 10) against ``optax.chain(clip_by_global_norm, adam(mu_dtype=bf16))``:
    the parameters within 1e-6 of each one's max-abs (measured 3.0e-8), the
    first moment within one bf16 ulp (measured: equal), the second within
    1e-6. The dtypes: mu bf16, nu and the parameters float32. The state
    survives ``save_state``/``restore_state`` and the next step of both runs
    is the same."""
    params, grads = _opt_data()
    system = _port_system(params, adam_mu_dtype="bfloat16")
    for g in grads:
        _port_step(system, g)
    opt = system.optimizer
    assert isinstance(opt, OptaxAdam) and opt.count == len(grads)
    want, state = _optax_run(
        params, grads, optax.chain(optax.clip_by_global_norm(10.0), optax.adam(LR, mu_dtype=jnp.bfloat16)))
    adam = state[1][0]
    for i, (p, w) in enumerate(zip(system.params, want)):
        assert p.dtype == torch.float32
        assert _max_rel(p.detach().numpy(), w) <= 1e-6
        mu, nu = opt.mu[i], opt.nu[i]
        assert mu.dtype == torch.bfloat16 and nu.dtype == torch.float32
        assert _within_one_ulp(mu, _bf16(adam.mu[f"p{i:02d}"])), i
        assert _max_rel(nu.numpy(), adam.nu[f"p{i:02d}"]) <= 1e-6

    tckpt.save_state(str(tmp_path / "ckpt"), system)
    again = _port_system([np.zeros(s, np.float32) for s in SHAPES], adam_mu_dtype="bfloat16")
    tckpt.restore_state(str(tmp_path / "ckpt"), again)
    assert again.optimizer.mu[0].dtype == torch.bfloat16 and again.optimizer.count == len(grads)
    _port_step(system, grads[0])
    _port_step(again, grads[0])
    for a, b in zip(system.params, again.params):
        assert torch.equal(a, b)
    for a, b in zip(system.optimizer.mu + system.optimizer.nu, again.optimizer.mu + again.optimizer.nu):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_flattened_optimizer_matches_optax_and_per_leaf(tmp_path, mu_dtype):
    """``flatten_optimizer=True``: one mu and one nu of n_params each;
    against ``optax.flatten(chain(clip, adam))`` within 1e-6 of each
    parameter's max-abs (measured 3.0e-8 with a float32 first moment and
    with a bf16 one); against the port's per-leaf update within 1e-7
    (measured 6.0e-8 against ``torch.optim.Adam``'s order, bitwise against
    the per-leaf bf16 layout); a per-leaf checkpoint does not restore into
    it, nor its checkpoint into a per-leaf System."""
    params, grads = _opt_data()
    flat = _port_system(params, adam_mu_dtype=mu_dtype, flatten_optimizer=True)
    leaf = _port_system(params, adam_mu_dtype=mu_dtype)
    for g in grads:
        _port_step(flat, g)
        _port_step(leaf, g)
    jdtype = jnp.bfloat16 if mu_dtype else None
    want, state = _optax_run(
        params, grads, optax.flatten(optax.chain(optax.clip_by_global_norm(10.0), optax.adam(LR, mu_dtype=jdtype))))
    n = sum(int(np.prod(s)) for s in SHAPES)
    opt = flat.optimizer
    assert [tuple(t.shape) for t in opt.mu + opt.nu] == [(n,), (n,)]
    assert opt.mu[0].dtype == (torch.bfloat16 if mu_dtype else torch.float32)
    jmu = state[1][0].mu
    if mu_dtype:
        assert _within_one_ulp(opt.mu[0], _bf16(jmu))
    else:
        assert _max_rel(opt.mu[0].numpy(), jmu) <= 1e-6
    for p, q, w in zip(flat.params, leaf.params, want):
        assert _max_rel(p.detach().numpy(), w) <= 1e-6
        assert _max_rel(p.detach().numpy(), q.detach().numpy()) <= 1e-7

    tckpt.save_state(str(tmp_path / "flat"), flat)
    tckpt.save_state(str(tmp_path / "leaf"), leaf)
    with pytest.raises(ValueError, match="not interchangeable"):
        tckpt.restore_state(str(tmp_path / "leaf"), _port_system(params, adam_mu_dtype=mu_dtype, flatten_optimizer=True))
    with pytest.raises(ValueError, match="not interchangeable"):
        tckpt.restore_state(str(tmp_path / "flat"), _port_system(params, adam_mu_dtype=mu_dtype))


# --------------------------------------------------- 7: waveform encoder


def test_waveform_transformer_encoder_matches_jax():
    """Block 256, one layer, 4 heads on (2, 1, 4,096): the CLS row within
    1e-4 of JAX's (measured 1.2e-6)."""
    jenc = JaxWaveformEncoder(block_size=256, num_layers=1, nhead=4)
    x = np.random.default_rng(8).normal(size=(2, 1, 4096)).astype(np.float32)
    v = _random_variables(jenc, 2, jnp.asarray(x))
    want = jax.jit(jenc.apply)(v, jnp.asarray(x))
    port = WaveformTransformerEncoder(block_size=256, num_layers=1, nhead=4)
    port.load_state_dict(waveform_encoder_state_dict_from_flax(v["params"]), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, 256)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-4


def test_positional_encoding_matches_jax_and_drops_in_training():
    """Eval: within 1e-6 of JAX's (measured 2.4e-7). Training: the shape
    kept, each value either dropped or the eval value over the keep
    probability, about half dropped at p = 0.5; without a generator it
    raises."""
    x = np.random.default_rng(9).normal(size=(2, 40, 16)).astype(np.float32)
    want = JaxPositionalEncoding(d_model=16, max_len=64).apply({}, jnp.asarray(x))
    pe = PositionalEncoding(16, max_len=64, dropout=0.5)
    got = pe(torch.from_numpy(x))
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-6
    drop = pe(torch.from_numpy(x), train=True, generator=torch.Generator().manual_seed(0))
    assert drop.shape == got.shape
    kept = drop != 0
    assert torch.allclose(drop[kept], got[kept] / 0.5)
    assert 0.4 < float(kept.float().mean()) < 0.6
    with pytest.raises(ValueError, match="generator"):
        pe(torch.from_numpy(x), train=True)


# ------------------------------------------- 8: naive+tpu.yaml, in process


def test_naive_tpu_yaml_builds_and_steps_on_the_cpu(tmp_path):
    """The shipped recipe through ``load_config`` and ``build_from_config``
    at small widths (an overlay): the model computes in bf16 and Adam's
    first moment is bf16 after one train step on the CPU."""
    import main_torch
    from diffmst_torch.utils.config import load_config

    root = main_torch.os.path.dirname(main_torch.__file__)
    overlay = tmp_path / "small.yaml"
    small = {k: SMALL[k] for k in ("embed_dim", "num_layers", "nhead", "hop_length", "cnn_base_width")}
    overlay.write_text(yaml.safe_dump({
        "trainer": {"max_epochs": 1, "default_root_dir": str(tmp_path / "ckpts")},
        "model": {"init_args": {
            "model": {"init_args": small},
            "loss": {"init_args": {"fft_sizes": [512], "hop_sizes": [256], "win_lengths": [512]}}}},
    }))
    cfg = load_config([f"{root}/configs/{c}" for c in ("config.yaml", "optimizer.yaml", "models/naive+tpu.yaml")]
                      + [str(overlay)])
    system, datamodule, _ = main_torch.build_from_config(cfg, device="cpu")
    model = system.model
    assert datamodule is None
    assert model.track_encoder.model.dtype == torch.bfloat16
    assert model.controller.transformer_encoder.layers[0].dtype == torch.bfloat16
    assert not model.track_encoder.remat and model.track_encoder.model.conv_block1.conv1.out_channels == 4
    rng = np.random.default_rng(10)
    tracks = torch.from_numpy((rng.normal(size=(1, 2, 2 * T)) * 0.1).astype(np.float32))
    ids = torch.zeros(1, 2, dtype=torch.int32)
    batch = Batch(tracks, ids, ids, torch.zeros(1, 2, dtype=torch.bool), torch.zeros(1, 2, 2 * T))
    metrics = system.train_step(batch, system.effect_flags(0))
    assert np.isfinite(float(metrics["loss"]))
    opt = system.optimizer
    assert isinstance(opt, OptaxAdam) and opt.count == 1
    assert {t.dtype for t in opt.mu} == {torch.bfloat16} and {t.dtype for t in opt.nu} == {torch.float32}
    assert all(p.dtype == torch.float32 for p in model.parameters())
