"""The port's "ballistics" compressor smoother against the JAX package's.

``diffmst_torch.ops.compressor`` with ``smoother="ballistics"`` runs the
branching attack/release smoother (``kernels/smoother.py``; on the CPU its
plain version, with the backward through K4's plain backward) where JAX
runs ``diffmst_tpu/ops/compressor.py::_smooth_ballistics``, a
``lax.scan``. Inputs: 2 x 2 x 4,096 samples (4 rows) of noise in bursts,
so the gain dips and recovers and both branches are taken hundreds of times,
attack 1-20 ms and release 50-300 ms.

Tolerances: in float64 (JAX with x64), outputs within 1e-6 of the peak and
the gradients in x, threshold, ratio, knee, attack and release within 1e-4
of each cotangent's max-abs; in float32 the gain envelope within 1e-3 dB
(JAX carries the state in float32, the port in float64).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmst_tpu import ops as jops
from diffmst_torch import ops as tops

smoother = importlib.import_module("diffmst_torch.kernels.smoother")
comp = importlib.import_module("diffmst_torch.ops.compressor")

torch.set_num_threads(1)

SR = 44100.0
PARAMS = ("threshold_db", "ratio", "knee_db", "attack_ms", "release_ms")


def _inputs(seed=0, bs=2, chs=2, t=4096, attack=(1.0, 20.0), release=(50.0, 300.0)):
    rng = np.random.default_rng(seed)
    bursts = np.where((np.arange(t) // 700) % 2 == 0, 1.0, 0.05)
    x = rng.normal(size=(bs, chs, t)) * bursts
    p = dict(
        threshold_db=rng.uniform(-30.0, -10.0, bs),
        ratio=rng.uniform(2.0, 8.0, bs),
        attack_ms=rng.uniform(*attack, bs),
        release_ms=rng.uniform(*release, bs),
        knee_db=rng.uniform(3.0, 9.0, bs),
        makeup_gain_db=rng.uniform(0.0, 6.0, bs),
    )
    return x, p


def _jax_compressor(x, p):
    return jops.compressor(x, SR, **p, lookahead_samples=256, smoother="ballistics")


def _port_compressor(x, p):
    return tops.compressor(x, SR, **p, lookahead_samples=256, smoother="ballistics")


def test_compressor_ballistics_matches_jax_float64():
    """Outputs and the gradients of a fixed cotangent, in float64."""
    x, p = _inputs()
    w = np.random.default_rng(1).normal(size=x.shape)
    with jax.enable_x64(True):
        jx = jnp.asarray(x, jnp.float64)
        jp = {k: jnp.asarray(v, jnp.float64) for k, v in p.items()}
        ref, vjp = jax.vjp(lambda x_, *ps: _jax_compressor(x_, {**jp, **dict(zip(PARAMS, ps))}),
                           jx, *(jp[k] for k in PARAMS))
        ref_grads = [np.asarray(g) for g in vjp(jnp.asarray(w, jnp.float64))]
        ref = np.asarray(ref)
    tx = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    tp = {k: torch.tensor(v, dtype=torch.float64, requires_grad=k in PARAMS) for k, v in p.items()}
    out = _port_compressor(tx, tp)
    assert np.abs(out.detach().numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    (out * torch.from_numpy(w)).sum().backward()
    for name, got, want in zip(("x",) + PARAMS, [tx.grad] + [tp[k].grad for k in PARAMS], ref_grads):
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * scale, name


def test_compressor_ballistics_matches_jax_float32_in_db():
    """The gain envelope in dB, float32: JAX's float32 carry against the
    port's float64 one, within 1e-3 dB; the audio within 1e-4 of its peak."""
    x, p = _inputs(seed=2)
    x32 = x.astype(np.float32)
    p32 = {k: v.astype(np.float32) for k, v in p.items()}
    flat = x32.reshape(-1, x32.shape[-1])
    rows = {k: np.repeat(p32[k], x32.shape[1]) for k in PARAMS}
    ref_db = np.asarray(jops.compressor_gain_db(jnp.asarray(flat), SR, **{k: jnp.asarray(v) for k, v in rows.items()},
                                                smoother="ballistics"))
    got_db = comp.compressor_gain_db(torch.from_numpy(flat), SR, **{k: torch.from_numpy(v) for k, v in rows.items()},
                                     smoother="ballistics")
    assert np.abs(got_db.numpy() - ref_db).max() <= 1e-3
    ref = np.asarray(_jax_compressor(jnp.asarray(x32), {k: jnp.asarray(v) for k, v in p32.items()}))
    out = _port_compressor(torch.from_numpy(x32), {k: torch.from_numpy(v) for k, v in p32.items()})
    assert np.abs(out.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_ballistics_equal_times_match_scan():
    """JAX's own check (tests/test_ops.py:197-203): with equal attack and
    release the branching smoother is the one-pole "scan" smoother."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(2, 1, 4096)) * 0.5).astype(np.float32))
    p = dict(threshold_db=torch.tensor([-20.0, -20.0]), ratio=torch.tensor([4.0, 4.0]),
             attack_ms=torch.tensor([20.0, 20.0]), release_ms=torch.tensor([20.0, 20.0]),
             knee_db=torch.tensor([6.0, 6.0]), makeup_gain_db=torch.tensor([0.0, 0.0]))
    y1 = tops.compressor(x, SR, **p, smoother="scan")
    y2 = tops.compressor(x, SR, **p, smoother="ballistics")
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=0, atol=1e-4)


def _gains(seed, rows=3, t=2000):
    rng = np.random.default_rng(seed)
    g = -np.abs(rng.normal(size=(rows, t))) * 20.0 * np.where((np.arange(t) // 300) % 2 == 0, 1.0, 0.1)
    aa = np.exp(-np.log(9.0) / (SR * rng.uniform(1.0, 20.0, rows) / 1e3))
    ar = np.exp(-np.log(9.0) / (SR * rng.uniform(50.0, 300.0, rows) / 1e3))
    return g, aa, ar


def test_plain_version_matches_the_recurrence_and_records_its_branches():
    """The plain version against the recurrence run sample by sample in
    NumPy, float64; the coefficients and branches it records are the ones
    the recurrence took, both branches many times."""
    g, aa, ar = _gains(3)
    y_ref = np.empty_like(g)
    a_ref = np.empty_like(g)
    state = np.zeros(g.shape[0])
    for n in range(g.shape[1]):
        a_ref[:, n] = np.where(g[:, n] < state, aa, ar)
        state = a_ref[:, n] * state + (1.0 - a_ref[:, n]) * g[:, n]
        y_ref[:, n] = state
    y, a, attack = smoother.ballistics_plain(*map(torch.from_numpy, (g, aa, ar)), record=True)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(a.numpy(), a_ref)
    np.testing.assert_array_equal(attack.numpy(), a_ref == aa[:, None])
    assert 100 < int(attack.sum()) < attack.numel() - 100


def test_plain_version_rounds_once_to_float32():
    """A float32 input is carried in float64 and rounded once: the float32
    output is the float64 one rounded, not a float32 carry's."""
    g, aa, ar = _gains(4)
    g32, aa32, ar32 = (torch.from_numpy(v.astype(np.float32)) for v in (g, aa, ar))
    y32 = smoother.ballistics_plain(g32, aa32, ar32)
    y_from32 = smoother.ballistics_plain(g32.double(), aa32.double(), ar32.double())
    assert y32.dtype == torch.float32
    assert torch.equal(y32, y_from32.float())


def test_gradcheck_of_the_plain_versions():
    """The autograd.Function with the plain versions (K4's plain backward
    composed with the branch-split sums) against finite differences."""
    g, aa, ar = _gains(5, rows=2, t=60)
    args = [torch.tensor(v, requires_grad=True) for v in (g, aa, ar)]
    assert torch.autograd.gradcheck(smoother.ballistics, args, eps=1e-7, atol=1e-6)


def test_backward_split_by_the_recorded_branch():
    """With equal attack and release values the forward does not depend on
    the branch, but each alpha's gradient is the sum over its own branch's
    samples: together they are the one-pole's dalpha."""
    g, aa, _ = _gains(6)
    g_t = torch.from_numpy(g)
    a_att = torch.tensor(aa, requires_grad=True)
    a_rel = torch.tensor(aa, requires_grad=True)
    y = smoother.ballistics(g_t, a_att, a_rel)
    dy = torch.from_numpy(np.random.default_rng(7).normal(size=g.shape))
    (y * dy).sum().backward()
    _, _, attack = smoother.ballistics_plain(g_t, a_att.detach(), a_rel.detach(), record=True)
    assert bool(attack.any()) and not bool(attack.all())
    alpha = torch.tensor(aa, requires_grad=True)
    scan = importlib.import_module("diffmst_torch.kernels.scan1p")  # K1's plain version
    y1 = scan.onepole_core(((1.0 - alpha)[:, None] * g_t).contiguous(), alpha)
    (y1 * dy).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), y1.detach().numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose((a_att.grad + a_rel.grad).numpy(), alpha.grad.numpy(), rtol=1e-9, atol=1e-9)
    assert float(a_att.grad.abs().min()) > 0 and float(a_rel.grad.abs().min()) > 0


def test_undifferentiated_call_goes_through_the_operator():
    """A call autograd does not record runs ``torch.ops.diffmst.ballistics``
    (on the CPU, the plain version), which ``torch.export`` can trace."""
    g, aa, ar = (torch.from_numpy(v.astype(np.float32)) for v in _gains(8))
    np.testing.assert_array_equal(torch.ops.diffmst.ballistics(g, aa, ar).numpy(),
                                  smoother.ballistics_plain(g, aa, ar).numpy())
    with torch.no_grad():
        y = smoother.ballistics(g, aa, ar.requires_grad_())
    assert not y.requires_grad


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_launch_refuses_what_the_kernel_does_not_take(bad):
    """The CUDA wrapper checks type, shape and device before any launch: a
    CPU tensor is refused, never run by the plain version."""
    g, aa, ar = (torch.from_numpy(v.astype(np.float32)) for v in _gains(9))
    if bad == "dtype":
        g, err = g.double(), TypeError
    elif bad == "shape":
        aa, err = aa[:-1], ValueError
    else:
        err = ValueError
    with pytest.raises(err):
        smoother._launch(g, aa, ar)
