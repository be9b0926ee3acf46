"""The PyTorch port's causal console against the JAX package's.

The causal console is ``AdvancedMixConsole(comp_smoother="decoupled",
eq_method="scan")``: the decoupled compressor's release min-scan (K3, then
the attack one-pole K1) and the exact causal EQ (the biquad cascade K5).
Every case feeds the same numpy inputs, made from a seed, to the JAX
function and to its counterpart in ``diffmst_torch`` on the CPU, where each
kernel wrapper runs its plain PyTorch version, forward and backward.

JAX's references run in float64, where its scans are exact to far below the
tolerances, and the port in float32, as it runs on the card. Compiling
JAX's causal console whole takes minutes on the CPU (each of its twelve
biquad sections and four compressor scans is an associative scan), so the
module fixture ``jax_twins`` jits JAX's scans one call at a time and the
console around them runs eagerly: ``ops/iir.py::sosfilt_scan`` becomes its
loop over one jitted ``biquad_scan``, and ``ops/compressor.py::
_release_min_scan`` the identical ``kernels/scan1p.py::_minscan_ref``, the
XLA twin of the Pallas K3's VJP. Every scan has R x T rows, so each compiles
once for the whole module.

Tolerances: outputs within 1e-4 (K3 and K5 alone within 1e-5), gradients
within 1e-4 of each cotangent's max-abs (2e-4 at the console, whose float32
rounding alone reaches past 1e-4: tests/test_torch_console.py).
"""

import contextlib
import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch
import torch.nn.functional as F

from diffmst_tpu import ops as jops
from diffmst_tpu.console import AdvancedMixConsole as JaxAdvanced
from diffmst_tpu.kernels.iir_fused import sosfilt_pallas
from diffmst_tpu.kernels.scan1p import _minscan_ref, minscan_core
from diffmst_torch import ops as tops
from diffmst_torch.console import AdvancedMixConsole
from diffmst_torch.kernels import iir_fused, scan1p
from diffmst_torch.ops.eq import _eq_sos

torch.set_num_threads(1)

SR = 44100.0
R, T = 4, 4096  # the shape of every JAX scan in this module


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _f64(a):
    """A float32 input as JAX's float64 reference sees it."""
    with jax.enable_x64(True):
        return jnp.asarray(np.asarray(a, np.float32), jnp.float64)


def _rel_close(port, ref, rtol, what=""):
    """max |port - ref| <= rtol * max |ref|."""
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, what
    err = np.abs(port - ref).max()
    assert err <= rtol * np.abs(ref).max(), f"{what}: {err} > {rtol} * {np.abs(ref).max()}"


def _jax_vjp(fn, *args):
    """(output, cotangent -> gradients) of ``fn`` in float64."""
    with jax.enable_x64(True):
        out, vjp = jax.vjp(fn, *args)

    def grads(w):
        with jax.enable_x64(True):
            return [np.asarray(g) for g in vjp(jnp.asarray(w, jnp.float64))]

    return np.asarray(out), grads


@contextlib.contextmanager
def jax_scan_twins():
    """JAX's XLA scans jitted one call at a time in place of the functions
    its console calls (see the module docstring), and XLA's optimization
    passes off: the references compile faster and compute the same."""
    jiir = importlib.import_module("diffmst_tpu.ops.iir")
    jcomp = importlib.import_module("diffmst_tpu.ops.compressor")
    biquad = jax.jit(jiir.biquad_scan)

    def sosfilt_scan(x, sos_b, sos_a):  # = jiir.sosfilt_scan, a jitted section at a time
        y = x
        for s in range(sos_b.shape[1]):
            y = biquad(y, sos_b[:, s], sos_a[:, s])
        return y

    minscan = jax.jit(_minscan_ref)
    optimizations_off = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jiir, "sosfilt_scan", sosfilt_scan)
            mp.setattr(jcomp, "_release_min_scan", minscan)
            mp.setattr(jcomp, "_smooth_scan", jax.jit(jcomp._smooth_scan))
            yield SimpleNamespace(sosfilt_scan=sosfilt_scan, minscan=minscan)
    finally:
        jax.config.update("jax_disable_most_optimizations", optimizations_off)


@pytest.fixture(scope="module")
def jax_twins():
    with jax_scan_twins() as twins:
        yield twins


def _release_alpha(rng, rows):
    """Release coefficients of 10-250 ms at 44.1 kHz."""
    ms = rng.uniform(10.0, 250.0, size=rows)
    return np.exp(-np.log(9.0) / (SR * ms / 1e3)).astype(np.float32)


# ------------------------------------------------------------------ K3


def test_release_min_scan_matches_jax(jax_twins):
    """K3's plain version and its backward == JAX's XLA twin ``_minscan_ref``
    and ``jax.vjp`` of it, on unit-scale gains <= 0 without ties (the
    backward takes the clamp branch at a tie, where JAX's min splits the
    cotangent: ROADMAP Queue 3)."""
    rng = np.random.default_rng(20)
    g = -(np.abs(rng.normal(size=(R, T))) + 1e-3).astype(np.float32)
    alpha = _release_alpha(rng, R)
    dy = rng.normal(size=(R, T)).astype(np.float32)
    ref, grads = _jax_vjp(jax_twins.minscan, _f64(g), _f64(alpha))
    tg, ta = _t(g).requires_grad_(), _t(alpha).requires_grad_()
    y = scan1p.release_min_scan(tg, ta)
    np.testing.assert_allclose(y.detach().numpy(), ref, rtol=0, atol=1e-5)
    (y * _t(dy)).sum().backward()
    dg, dalpha = grads(dy)
    _rel_close(tg.grad, dg, 1e-4, "dg")
    _rel_close(ta.grad, dalpha, 1e-4, "dalpha")


def test_release_min_scan_matches_pallas_interpret():
    """K3's plain version == the Pallas minscan_core in interpret mode, 5 x
    3,001 with chunk 128 (T a multiple of no chunk), on gains in [-1, 0]
    with releases of 10-100 ms: the Pallas float32 composition's drift stays
    below 1e-5 there (it reaches 3e-5 at 250 ms on gains of -4)."""
    rng = np.random.default_rng(21)
    g = -rng.uniform(0.0, 1.0, size=(5, 3001)).astype(np.float32)
    ms = rng.uniform(10.0, 100.0, size=5)
    alpha = np.exp(-np.log(9.0) / (SR * ms / 1e3)).astype(np.float32)
    ref = minscan_core(jnp.asarray(g), jnp.asarray(alpha), 128, True)
    np.testing.assert_allclose(
        scan1p.release_min_scan_plain(_t(g), _t(alpha)).numpy(), np.asarray(ref), rtol=0, atol=1e-5
    )


def test_release_min_scan_in_db_matches_float64_loop():
    """On gains of tens of dB at a = 0.9998 (a 250 ms release), K3's plain
    version, which composes in float64 and rounds once, is within 1e-5 dB of
    the recurrence run sample by sample in float64."""
    rng = np.random.default_rng(22)
    g = rng.uniform(-40.0, 0.0, size=(3, 3001)).astype(np.float32)
    alpha = np.array([0.9998, 0.999, 0.99], np.float32)
    a = alpha.astype(np.float64)
    y = np.empty(g.shape)
    state = np.zeros(3)
    for n in range(g.shape[1]):
        state = np.minimum(g[:, n], a * state + (1.0 - a) * g[:, n])
        y[:, n] = state
    out = scan1p.release_min_scan_plain(_t(g), _t(alpha)).numpy()
    np.testing.assert_allclose(out, y, rtol=0, atol=1e-5)


# ------------------------------------------------------------------ K5


def _sections(rng, rows, low_shelf_hz=None, moderate=False):
    """(rows, 6, 3) float32 sections of the console's EQ with parameters
    drawn over its ranges; ``low_shelf_hz`` pins row 0's low shelf there at
    the top Q (5) and +12 dB; ``moderate`` keeps every pole radius within
    0.994, where JAX's float32 scan is exact to 1e-5 (ops/iir.py:31-35)."""
    from diffmst_torch.console.ranges import advanced_param_ranges

    rngs = advanced_param_ranges(SR)["parametric_eq"]
    p = {k: rng.uniform(*rngs[k], size=rows) for k in rngs}
    if moderate:
        for band in ("low_shelf", "band0"):
            p[f"{band}_cutoff_freq"] = rng.uniform(400.0, 2000.0, size=rows)
            p[f"{band}_q_factor"] = rng.uniform(0.3, 1.0, size=rows)
    if low_shelf_hz is not None:
        p["low_shelf_cutoff_freq"][0] = low_shelf_hz
        p["low_shelf_q_factor"][0] = 5.0
        p["low_shelf_gain_db"][0] = 12.0
    b, a = _eq_sos(SR, **{k: torch.from_numpy(v) for k, v in p.items()})
    b, a = b.float().numpy(), a.float().numpy()
    if moderate:
        radius = max(np.abs(np.roots(a[i, s])).max() for i in range(rows) for s in range(6))
        assert radius <= 0.994, radius
    return b, a


def test_sosfilt_matches_jax(jax_twins):
    """K5's plain version and its backward == JAX's sosfilt_scan and
    jax.vjp of it (dx, sos_b, sos_a), over the console's EQ ranges with a
    20 Hz high-Q low shelf on one row (pole radius 0.9998). The output within
    1e-5 of its peak, each cotangent within 1e-4 of its max-abs."""
    rng = np.random.default_rng(23)
    b, a = _sections(rng, R, low_shelf_hz=20.0)
    x = rng.normal(size=(R, T)).astype(np.float32)
    w = rng.normal(size=(R, T)).astype(np.float32)
    ref, grads = _jax_vjp(jax_twins.sosfilt_scan, _f64(x), _f64(b), _f64(a))
    leaves = [_t(v).requires_grad_() for v in (x, b, a)]
    y = iir_fused.sosfilt(*leaves)
    _rel_close(y, ref, 1e-5, "y")
    (y * _t(w)).sum().backward()
    for name, leaf, r in zip(("dx", "dsos_b", "dsos_a"), leaves, grads(w)):
        _rel_close(leaf.grad, r, 1e-4, name)
    assert float(leaves[2].grad[..., 0].abs().max()) == 0.0  # a0 is not read


def test_sosfilt_matches_pallas_interpret():
    """K5's plain version == the Pallas sosfilt_pallas in interpret mode
    (chunk 128, float32), 4 x 2,000, at poles within 0.994. One section (a
    peaking band): interpret mode compiles the kernel's unrolled body, some
    12 s for six sections on the CPU; the cascade is held to JAX's
    sosfilt_scan above."""
    rng = np.random.default_rng(24)
    b, a = _sections(rng, 4, moderate=True)
    b, a = b[:, 1:2], a[:, 1:2]
    x = rng.normal(size=(4, 2000)).astype(np.float32)
    ref = np.asarray(sosfilt_pallas(jnp.asarray(x), jnp.asarray(b), jnp.asarray(a), 128, True))
    _rel_close(iir_fused.sosfilt_plain(_t(x), _t(b), _t(a)), ref, 1e-5)


def test_sosfilt_matches_scipy_at_a_20hz_shelf():
    """At the console's lowest, sharpest low shelf (20 Hz, Q 5, +12 dB; pole
    radius 0.9998) the float32 port is within 1e-4 of the peak of
    scipy.signal.sosfilt in float64, where JAX's float32 scan is O(1) off
    (ROADMAP Queue 3)."""
    rng = np.random.default_rng(25)
    b, a = _sections(rng, 1, low_shelf_hz=20.0)
    x = rng.normal(size=(1, 20000)).astype(np.float32)
    ref = scipy.signal.sosfilt(np.concatenate([b[0], a[0]], -1).astype(np.float64), x[0].astype(np.float64))
    _rel_close(iir_fused.sosfilt(_t(x), _t(b), _t(a))[0], ref, 1e-4)


def test_causal_plain_backward_versions_match_autograd():
    """K3's and K5's plain backward versions == autograd through float64
    references (K3's recurrence sample by sample, K5's plain forward), so
    rounding hides no wrong formula; on CPU tensors the wrappers count no
    launch."""
    scan1p.release_min_scan_backward.launches = 0
    iir_fused.sosfilt_backward.launches = 0
    rng = np.random.default_rng(26)
    dbl = lambda v: torch.from_numpy(np.asarray(v, np.float64))  # noqa: E731
    g = dbl(-np.abs(rng.normal(size=(3, 300))) - 1e-3).requires_grad_()
    alpha = dbl(_release_alpha(rng, 3)).requires_grad_()
    state, ys = torch.zeros(3, dtype=torch.float64), []
    for n in range(g.shape[1]):
        state = torch.minimum(g[:, n], alpha * state + (1.0 - alpha) * g[:, n])
        ys.append(state)
    y = torch.stack(ys, dim=-1)
    dy = dbl(rng.normal(size=(3, 300)))
    ref = torch.autograd.grad(y, (g, alpha), dy)
    got = scan1p.release_min_scan_backward(dy, g.detach(), alpha.detach(), y.detach())
    for a_, b_ in zip(got, ref):
        torch.testing.assert_close(a_, b_, rtol=1e-9, atol=1e-9)

    b, a = _sections(rng, 3)
    coef = iir_fused._coef_rows(dbl(b), dbl(a)).requires_grad_()
    x = dbl(rng.normal(size=(3, 700))).requires_grad_()
    y, stages = iir_fused._forward_plain(x, coef)
    dy = dbl(rng.normal(size=(3, 700)))
    ref = torch.autograd.grad(y, (x, coef), dy)
    got = iir_fused.sosfilt_backward(x.detach(), stages.detach(), y.detach(), coef.detach(), dy)
    for a_, b_ in zip(got, ref):
        torch.testing.assert_close(a_, b_, rtol=1e-7, atol=1e-7 * float(b_.abs().max()))
    assert scan1p.release_min_scan_backward.launches == 0
    assert iir_fused.sosfilt_backward.launches == 0


def _adjoint_matrix(coef):
    """The backward cascade's map over one sample, on the 4S states a row in
    the kernel's layout (``csrc/iir_fused.cu``, ``adjoint_pass``): stage k
    is section S-1-k, walked backwards in time; entries 4k, 4k+1 are du's
    TDF-II pair (p1, p2), 4k+2, 4k+3 w's pair (w[n], w[n+1]). Stage k's
    input is b0 times stage k-1's plus its p1 before the sample. (B, 4S, 4S)."""
    b0, b1, b2, a1, a2 = coef.flip(0).double().unbind(1)  # (S, B) each, by stage
    n_sec, rows = b0.shape
    m = torch.zeros(rows, 4 * n_sec, 4 * n_sec, dtype=torch.float64)
    for k in range(n_sec):
        i = 4 * k
        m[:, i, i], m[:, i, i + 1], m[:, i + 1, i] = -a1[k], 1.0, -a2[k]
        m[:, i + 2, i + 2], m[:, i + 2, i + 3], m[:, i + 3, i + 2] = -a1[k], -a2[k], 1.0
        for j in range(k):
            g = torch.prod(b0[j + 1 : k], dim=0)  # the b0 of the stages between
            m[:, i, 4 * j] = g * (b1[k] - a1[k] * b0[k])
            m[:, i + 1, 4 * j] = g * (b2[k] - a2[k] * b0[k])
            m[:, i + 2, 4 * j] = g
    return m


def _emulated_sosfilt_backward(x, stages, y, coef, dy, chunk):
    """K5's backward as its kernel decomposes it, in float64: chunks of
    ``chunk`` samples in reversed time (the row's end first, padded with
    zeros past its end), a chunk pass from a zero state that runs the
    stages one after another and keeps each chunk's 4S end state, the
    carries entering each chunk by A^chunk (A from ``_adjoint_matrix``), and
    an apply pass that reruns each chunk from its carry, adding the five
    sums per chunk, then the chunks in order."""
    n_sec, _, rows = coef.shape
    t = x.shape[-1]
    n_chunks = -(-t // chunk)
    pad = n_chunks * chunk - t
    b0, b1, b2, a1, a2 = (v[..., None] for v in coef.flip(0).double().unbind(1))  # (S, B, 1)
    beta1, beta2 = b1 - a1 * b0, b2 - a2 * b0

    def reversed_chunks(v, edge=0):
        """v in reversed time, position R = n_chunks chunk - 1 - n, as
        (B, chunks, chunk + edge) windows, each with the ``edge`` samples
        that precede its chunk in time."""
        r = F.pad(v.double().flip(-1), (pad, edge))
        return r.unfold(-1, chunk + edge, chunk)

    def run_stage(k, e, state, sums=None, u=None, out=None):
        p1, p2, w1, w2 = state.unbind(-1)
        du = torch.empty_like(e)
        for r in range(chunk):
            w1, w2 = e[..., r] - a1[k] * w1 - a2[k] * w2, w1
            if sums is not None:
                for m, term in enumerate((u[..., r], u[..., r + 1], u[..., r + 2],
                                          -out[..., r + 1], -out[..., r + 2])):
                    sums[m] = sums[m] + w1 * term
            du[..., r] = b0[k] * e[..., r] + p1
            p1, p2 = beta1[k] * e[..., r] - a1[k] * p1 + p2, beta2[k] * e[..., r] - a2[k] * p1
        return du, torch.stack([p1, p2, w1, w2], dim=-1)

    e = reversed_chunks(dy)
    ends = []
    for k in range(n_sec):  # chunk pass, from zero
        e, end = run_stage(k, e, torch.zeros(rows, n_chunks, 4, dtype=torch.float64))
        ends.append(end)
    ends = torch.cat(ends, dim=-1)
    a_chunk = _adjoint_matrix(coef)
    for _ in range(chunk.bit_length() - 1):
        a_chunk = a_chunk @ a_chunk
    carries = [torch.zeros(rows, 4 * n_sec, dtype=torch.float64)]
    for j in range(n_chunks - 1):
        carries.append(torch.einsum("bij,bj->bi", a_chunk, carries[-1]) + ends[:, j])
    carries = torch.stack(carries, dim=1)
    signals = [x, *stages, y]  # section s reads signals[s] and writes signals[s + 1]
    e = reversed_chunks(dy)
    dcoef = torch.empty(coef.shape, dtype=torch.float64)
    for k in range(n_sec):  # apply pass
        s = n_sec - 1 - k
        sums = [0.0] * 5
        e, _ = run_stage(k, e, carries[..., 4 * k : 4 * k + 4], sums,
                         reversed_chunks(signals[s], 2), reversed_chunks(signals[s + 1], 2))
        dcoef[s] = torch.stack([m.sum(-1) for m in sums])
    dx = e.reshape(rows, -1)[:, pad:].flip(-1)
    return dx, dcoef


def test_sosfilt_backward_chunk_decomposition_matches_plain():
    """The algebra of K5's backward kernel (4S states a row, chunk pass from
    zero, carries by A^chunk, apply pass) == sosfilt_backward_plain, in
    float64, 3 rows x 300 samples in five chunks of 64 (the last one
    padded), the console's six sections with a 20 Hz, Q 5, +12 dB low shelf
    on row 0: dx and each of the 30 sums within 1e-9 of their max-abs."""
    rng = np.random.default_rng(31)
    b, a = _sections(rng, 3, low_shelf_hz=20.0)
    coef = iir_fused._coef_rows(torch.from_numpy(b).double(), torch.from_numpy(a).double())
    x = torch.from_numpy(rng.normal(size=(3, 300)))
    y, stages = iir_fused._forward_plain(x, coef)
    dy = torch.from_numpy(rng.normal(size=(3, 300)))
    dx, dcoef = _emulated_sosfilt_backward(x, stages, y, coef, dy, chunk=64)
    dx_p, dcoef_p = iir_fused.sosfilt_backward_plain(x, stages, y, coef, dy)
    _rel_close(dx, dx_p.numpy(), 1e-9, "dx")
    for s in range(6):
        for k in range(5):
            _rel_close(dcoef[s, k], dcoef_p[s, k].numpy(), 1e-9, f"section {s}, sum {k}")


def test_causal_kernel_wrappers_check_their_inputs():
    g = torch.zeros(2, 64)
    with pytest.raises(ValueError):
        scan1p._check_rows("release_min_scan", g, torch.zeros(3))
    with pytest.raises(TypeError):
        scan1p._check_rows("release_min_scan", g.double(), torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        scan1p._launch_minscan(g, torch.zeros(2))
    with pytest.raises(ValueError):
        iir_fused._check(g, torch.zeros(6, 4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        iir_fused._launch(g, torch.zeros(6, 5, 2))


# ----------------------------------------------------- compressor and EQ


def _comp_inputs(rng):
    env = np.linspace(0.02, 1.0, T, dtype=np.float32)
    x = (rng.normal(size=(2, 2, T)) * env).astype(np.float32)
    params = dict(
        threshold_db=rng.uniform(-40.0, -6.0, 2),
        ratio=rng.uniform(1.5, 10.0, 2),
        attack_ms=rng.uniform(5.0, 250.0, 2),
        release_ms=rng.uniform(10.0, 250.0, 2),
        knee_db=rng.uniform(3.0, 12.0, 2),
        makeup_gain_db=rng.uniform(0.0, 6.0, 2),
    )
    return x, {k: v.astype(np.float32) for k, v in params.items()}


def test_decoupled_compressor_matches_jax(jax_twins):
    """The port's "decoupled" and "decoupled_pallas" (both K3 then K1) ==
    JAX ops.compressor(smoother="decoupled"), (2, 2, 4,096), lookahead 1,024:
    the output within 1e-4, and the gradients of sum(y * w) by x and the six
    parameters (release_ms included) within 2e-4 of their max-abs."""
    rng = np.random.default_rng(27)
    x, p = _comp_inputs(rng)
    w = rng.normal(size=x.shape).astype(np.float32)
    names = list(p)

    def jfn(x_, *ps):
        return jops.compressor(x_, SR, **dict(zip(names, ps)), lookahead_samples=1024,
                               smoother="decoupled")

    ref, grads = _jax_vjp(jfn, _f64(x), *(_f64(p[k]) for k in names))
    grads = grads(w)
    for smoother in ("decoupled", "decoupled_pallas"):
        leaves = [_t(v).requires_grad_() for v in (x, *p.values())]
        y = tops.compressor(leaves[0], SR, **dict(zip(names, leaves[1:])), lookahead_samples=1024,
                            smoother=smoother)
        np.testing.assert_allclose(y.detach().numpy(), ref, rtol=0, atol=1e-4)
        (y * _t(w)).sum().backward()
        for name, leaf, r in zip(["x", *names], leaves, grads):
            _rel_close(leaf.grad, r, 2e-4, f"{smoother}: d{name}")


_EQ_KEYS = [f"{band}_{q}" for band in ("low_shelf", "band0", "band1", "band2", "band3", "high_shelf")
            for q in ("gain_db", "cutoff_freq", "q_factor")]


def test_parametric_eq_scan_matches_jax(jax_twins):
    """parametric_eq(method="scan" | "scan_pallas", linear_gain=...) == JAX's
    method "scan", (2, 2, 4,096), EQ parameters over the console's ranges
    with every pole radius within 0.994 (as ``_sections(moderate=True)``):
    the output within 1e-4, and the gradients of sum(y * w) by x, the fader
    and the 18 band parameters within 1e-4 of their max-abs. Nearer the unit
    circle the float32 coefficients themselves move the response by more
    (both packages design them in the input's type)."""
    from diffmst_torch.console.ranges import advanced_param_ranges

    rng = np.random.default_rng(28)
    rngs = advanced_param_ranges(SR)["parametric_eq"]
    p = {k: rng.uniform(*rngs[k], size=2).astype(np.float32) for k in _EQ_KEYS}
    for band in ("low_shelf", "band0"):
        p[f"{band}_cutoff_freq"] = rng.uniform(400.0, 2000.0, size=2).astype(np.float32)
        p[f"{band}_q_factor"] = rng.uniform(0.3, 1.0, size=2).astype(np.float32)
    x = (rng.normal(size=(2, 2, T)) * 0.2).astype(np.float32)
    lin = rng.uniform(0.25, 4.0, 2).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)

    def jfn(x_, lin_, *ps):
        return jops.parametric_eq(x_, SR, linear_gain=lin_, method="scan", **dict(zip(_EQ_KEYS, ps)))

    ref, grads = _jax_vjp(jfn, _f64(x), _f64(lin), *(_f64(p[k]) for k in _EQ_KEYS))
    grads = grads(w)
    for method in ("scan", "scan_pallas"):
        leaves = [_t(v).requires_grad_() for v in (x, lin, *p.values())]
        y = tops.parametric_eq(leaves[0], SR, linear_gain=leaves[1], method=method,
                               **dict(zip(_EQ_KEYS, leaves[2:])))
        np.testing.assert_allclose(y.detach().numpy(), ref, rtol=0, atol=1e-4)
        (y * _t(w)).sum().backward()
        for name, leaf, r in zip(["x", "linear_gain", *_EQ_KEYS], leaves, grads):
            _rel_close(leaf.grad, r, 1e-4, f"{method}: d{name}")


# ---------------------------------------------------------------- console


def _console_inputs(seed, quiet_start):
    """(2, 2, 4,096) stems with normalized parameters; with ``quiet_start``
    the stems are silent for their first quarter, so the compressors start
    below the threshold, where K3's gain and state are both 0 dB (ties)."""
    rng = np.random.default_rng(seed)
    env = np.abs(np.sin(np.linspace(0.0, 4.0 * np.pi, T)))[None, None, :]
    tracks = (rng.normal(size=(2, 2, T)) * 0.3 * env).astype(np.float32)
    if quiet_start:
        tracks[..., : T // 4] = 0.0
    tp = rng.uniform(0.05, 0.95, size=(2, 2, 27)).astype(np.float32)
    fp = rng.uniform(0.05, 0.95, size=(2, 25)).astype(np.float32)
    mp = rng.uniform(0.05, 0.95, size=(2, 26)).astype(np.float32)
    tp[..., 0] = rng.uniform(0.4, 0.6, size=(2, 2))  # faders within +-9.6 dB
    mp[:, 24:] = rng.uniform(0.4, 0.6, size=(2, 2))
    w = rng.normal(size=(2, 2, T)).astype(np.float32)
    return tracks, tp, fp, mp, w


@pytest.mark.parametrize("quiet_start", [False, True], ids=["loud", "quiet_start"])
def test_causal_console_matches_jax(jax_twins, quiet_start):
    """AdvancedMixConsole(comp_smoother="decoupled", eq_method="scan"),
    (2, 2, 4,096), fx bus off, against JAX's in float64: the stems and the
    mix within 1e-4, and the gradients of sum(mix * w) by the stems and the
    track and master parameter vectors within 2e-4 of their max-abs."""
    tracks, tp, fp, mp, w = _console_inputs(29, quiet_start)
    jc = JaxAdvanced(SR, comp_smoother="decoupled", eq_method="scan")

    def jfn(tracks_, tp_, mp_):
        out = jc(tracks_, tp_, _f64(fp), mp_, use_fx_bus=False)
        return out.mix, out.mixed_tracks

    with jax.enable_x64(True):
        (mix_ref, stems_ref), vjp = jax.vjp(jfn, _f64(tracks), _f64(tp), _f64(mp))
        grads = vjp((jnp.asarray(w, jnp.float64), jnp.zeros_like(stems_ref)))
    leaves = [_t(v).requires_grad_() for v in (tracks, tp, mp)]
    out = AdvancedMixConsole(SR, comp_smoother="decoupled", eq_method="scan", device="cpu")(
        leaves[0], leaves[1], fp, leaves[2], use_fx_bus=False
    )
    np.testing.assert_allclose(out.mixed_tracks.detach().numpy(), np.asarray(stems_ref), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.mix.detach().numpy(), np.asarray(mix_ref), rtol=0, atol=1e-4)
    (out.mix * _t(w)).sum().backward()
    for name, leaf, r in zip(("dtracks", "dtrack_params", "dmaster_params"), leaves, grads):
        _rel_close(leaf.grad, r, 2e-4, name)


# The JAX console's names for its Pallas kernels (diffmst_tpu/ops/
# compressor.py:208, :214, :254; ops/eq.py:137), as (comp_smoother,
# eq_method): the port's console under the name, the port's canonical name
# for the same path, and the JAX console it is held to: the name's
# "_interpret" twin, or for the EQ JAX's plain "scan", since interpret mode
# compiles the cascade's Pallas body for over 30 s on the CPU.
_PALLAS_NAMES = {
    "scan_pallas": (("scan_pallas", "fs"), ("scan", "fs"), ("scan_pallas_interpret", "fs")),
    "scan_pallas_interpret": (("scan_pallas_interpret", "fs"), ("scan", "fs"),
                              ("scan_pallas_interpret", "fs")),
    "fused_pallas": (("fused_pallas", "fs"), ("fused", "fs"), ("fused_pallas_interpret", "fs")),
    "fused_pallas_interpret": (("fused_pallas_interpret", "fs"), ("fused", "fs"),
                               ("fused_pallas_interpret", "fs")),
    "decoupled_pallas": (("decoupled_pallas", "fs"), ("decoupled", "fs"),
                         ("decoupled_pallas_interpret", "fs")),
    "decoupled_pallas_interpret": (("decoupled_pallas_interpret", "fs"), ("decoupled", "fs"),
                                   ("decoupled_pallas_interpret", "fs")),
    "eq_scan_pallas": (("decoupled", "scan_pallas"), ("decoupled", "scan"), ("decoupled", "scan")),
    "eq_scan_pallas_interpret": (("decoupled", "scan_pallas_interpret"), ("decoupled", "scan"),
                                 ("decoupled", "scan")),
}
_jax_console_mixes = {}


@pytest.mark.parametrize("case", list(_PALLAS_NAMES))
def test_console_takes_the_jax_pallas_names(jax_twins, case):
    """AdvancedMixConsole under each Pallas smoother and EQ name of the JAX
    console, (2, 2, 4,096), fx bus off: the stems and the mix equal the port's
    under its canonical name for that path exactly, and agree within 1e-4 with
    JAX's console in float64 under the name's "_interpret" twin (the EQ's:
    JAX's "scan")."""
    name, canonical, jax_names = _PALLAS_NAMES[case]
    tracks, tp, fp, mp, _ = _console_inputs(33, False)

    def port(comp, eq):
        out = AdvancedMixConsole(SR, comp_smoother=comp, eq_method=eq, device="cpu")(
            _t(tracks), _t(tp), _t(fp), _t(mp), use_fx_bus=False)
        return out.mixed_tracks, out.mix

    got = port(*name)
    for a_, b_ in zip(got, port(*canonical)):
        assert torch.equal(a_, b_)
    if jax_names not in _jax_console_mixes:
        with jax.enable_x64(True):
            jc = JaxAdvanced(SR, comp_smoother=jax_names[0], eq_method=jax_names[1])
            out = jc(_f64(tracks), _f64(tp), _f64(fp), _f64(mp), use_fx_bus=False)
            _jax_console_mixes[jax_names] = (np.asarray(out.mixed_tracks), np.asarray(out.mix))
    for a_, ref in zip(got, _jax_console_mixes[jax_names]):
        np.testing.assert_allclose(a_.numpy(), ref, rtol=0, atol=1e-4)


def test_causal_console_counts_no_launch_on_cpu():
    """On CPU tensors the causal console, forward and backward, launches no
    kernel: every counter stays at 0."""
    counters = (scan1p.release_min_scan, scan1p.release_min_scan_backward, scan1p.onepole_core,
                scan1p.onepole_core_backward, iir_fused.sosfilt, iir_fused.sosfilt_backward)
    for c in counters:
        c.launches = 0
    tracks, tp, fp, mp, _ = _console_inputs(30, False)
    tr = _t(tracks[..., :1024]).requires_grad_()
    out = AdvancedMixConsole(SR, comp_smoother="decoupled_pallas", eq_method="scan_pallas", device="cpu")(
        tr, tp, fp, mp
    )
    out.mix.sum().backward()
    assert torch.isfinite(tr.grad).all()
    assert [c.launches for c in counters] == [0] * len(counters)
