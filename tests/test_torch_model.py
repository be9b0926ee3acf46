"""The PyTorch port's MixStyleTransferModel against the Flax model.

The Flax model is initialized from ``jax.random.PRNGKey(0)`` with BatchNorm
statistics and affine parameters made non-trivial from a numpy seed; its
weights are carried into the port with ``state_dict_from_flax``, and both
models see the same numpy inputs on the CPU. Small size: embed 32, one
layer, 4 heads, n_fft 2048, hop 128, Cnn14 width 4.

Tolerance: max-abs <= 1e-4 on the three parameter tensors (BASELINE.md,
"Numerical parity").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmst_tpu.models import MixStyleTransferModel as JaxModel
from diffmst_tpu.models.cnn14 import Cnn14 as JaxCnn14
from diffmst_tpu.utils.checkpoint import port_torch_state_dict
from diffmst_torch.models import Cnn14, MixStyleTransferModel, TransformerEncoderLayer
from diffmst_torch.utils.checkpoint import _cnn14, state_dict_from_flax

torch.set_num_threads(1)

ATOL = 1e-4
SMALL = dict(embed_dim=32, num_layers=1, nhead=4, n_fft=2048, hop_length=128, cnn_base_width=4)
T = 16384  # 129 frames at hop 128: Cnn14 needs >= 128


def _perturb_bn(tree, rng, path=()):
    """Non-trivial BatchNorm: random running stats and affine parameters."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb_bn(v, rng, path + (k,))
            continue
        a = np.asarray(v)
        if k == "mean":
            a = rng.normal(0.0, 0.1, a.shape)
        elif k == "var":
            a = rng.uniform(0.5, 2.0, a.shape)
        elif any(p.startswith("bn") for p in path[-1:]) and k == "scale":
            a = rng.uniform(0.5, 1.5, a.shape)
        elif any(p.startswith("bn") for p in path[-1:]) and k == "bias":
            a = rng.normal(0.0, 0.1, a.shape)
        out[k] = jnp.asarray(a.astype(np.float32))
    return out


def _inputs(seed, n_tracks=3):
    rng = np.random.default_rng(seed)
    tracks = (rng.normal(size=(1, n_tracks, T)) * 0.1).astype(np.float32)
    ref = (rng.normal(size=(1, 2, T)) * 0.1).astype(np.float32)
    return tracks, ref


@pytest.fixture(scope="module")
def flax_model():
    model = JaxModel.build(**SMALL)
    tracks, ref = _inputs(0)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(tracks), jnp.asarray(ref))
    rng = np.random.default_rng(1)
    variables = {
        "params": _perturb_bn(jax.tree.map(np.asarray, dict(variables["params"])), rng),
        "batch_stats": _perturb_bn(jax.tree.map(np.asarray, dict(variables["batch_stats"])), rng),
    }
    return model, variables


def _port(variables):
    model = MixStyleTransferModel.build(**SMALL, device="cpu")
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, variables)), strict=True)
    return model


def test_model_matches_flax(flax_model):
    model, variables = flax_model
    port = _port(variables)
    tracks, ref = _inputs(2)
    mask = np.array([[False, False, True]])
    for m in (None, mask):
        jout = jax.jit(model.apply)(
            variables, jnp.asarray(tracks), jnp.asarray(ref),
            None if m is None else jnp.asarray(m),
        )
        with torch.no_grad():
            tout = port(
                torch.from_numpy(tracks), torch.from_numpy(ref),
                None if m is None else torch.from_numpy(m),
            )
        for a, b in zip(tout, jout):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)


def test_state_dict_from_flax_inverts_port_torch_state_dict(flax_model):
    """state_dict_from_flax, then the JAX package's port_torch_state_dict
    (with the Lightning "model." prefix), gives back the Flax tree exactly."""
    _, variables = flax_model
    sd = state_dict_from_flax(jax.tree.map(np.asarray, variables))
    back = port_torch_state_dict(
        {f"model.{k}": v.numpy() for k, v in sd.items()}, embed_dim=SMALL["embed_dim"]
    )
    flat_ref = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_ref) == len(flat_back)
    for path, v in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), np.asarray(v), err_msg=str(path))


def test_port_state_dict_names_are_the_references():
    import torch_model_ref as tmr

    ref = tmr.MixStyleTransferModel(embed_dim=32, base_width=4, num_layers=1, nhead=4)
    port = MixStyleTransferModel.build(**SMALL, device="cpu")
    assert set(port.state_dict()) == set(ref.state_dict())
    for k, v in ref.state_dict().items():
        assert port.state_dict()[k].shape == v.shape, k


def test_cnn14_pools_odd_frame_counts_like_flax():
    """513 frames (hop 512 over 262,144 samples): avg pooling floors on both sides."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0.0, 1.0, size=(2, 1, 1025, 513)).astype(np.float32)
    jmodel = JaxCnn14(num_classes=16, base_width=4)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    variables = jax.tree.map(np.asarray, variables)
    sd = {}
    _cnn14(variables["params"], variables["batch_stats"], "", sd)
    port = Cnn14(16, base_width=4)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x))),
                               rtol=0, atol=ATOL)


def test_transformer_layer_is_torch_post_norm_layer():
    """Loaded with an nn.TransformerEncoderLayer's own state dict (ReLU, FF 2048,
    dropout 0, post-norm), the port's layer gives its outputs."""
    torch.manual_seed(0)
    ref = torch.nn.TransformerEncoderLayer(32, 4, dropout=0.0, batch_first=True).eval()
    port = TransformerEncoderLayer(32, 4)
    port.load_state_dict(ref.state_dict(), strict=True)
    x = torch.randn(2, 7, 32)
    mask = torch.zeros(2, 7, dtype=torch.bool)
    mask[1, 2] = True
    with torch.no_grad():
        torch.testing.assert_close(port(x), ref(x), rtol=0, atol=1e-5)
        torch.testing.assert_close(port(x, mask), ref(x, src_key_padding_mask=mask), rtol=0, atol=1e-5)


def test_build_initializes_from_a_generator():
    a = MixStyleTransferModel.build(**SMALL, device="cpu", generator=torch.Generator().manual_seed(5))
    b = MixStyleTransferModel.build(**SMALL, device="cpu", generator=torch.Generator().manual_seed(5))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.isfinite(va.float()).all(), k
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    assert not a.training
    tracks, ref = _inputs(4, n_tracks=2)
    with torch.no_grad():
        tp, fp, mp = a(torch.from_numpy(tracks), torch.from_numpy(ref))
    assert tp.shape == (1, 2, 27) and fp.shape == (1, 25) and mp.shape == (1, 26)
    for p in (tp, fp, mp):
        assert ((p > 0) & (p < 1)).all()


def test_build_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MixStyleTransferModel.build(**SMALL)
