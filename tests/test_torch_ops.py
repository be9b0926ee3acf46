"""The PyTorch port's DSP ops and the K1/K2 plain versions against the JAX package.

Every case feeds the same numpy inputs, made from a seed, to the JAX function
and to its counterpart in ``diffmst_torch`` on the CPU (where each kernel
wrapper runs its plain PyTorch version). The JAX Pallas kernels run in
interpret mode, as the JAX package's own tests run them.

Tolerance: max-abs <= 1e-4 on every output (BASELINE.md, "Numerical parity");
gradients within 1e-4 of each cotangent's max-abs.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmst_tpu import ops as jops
from diffmst_tpu.kernels.comp_fused import compressor_fused_gain as jax_fused_gain
from diffmst_tpu.kernels.scan1p import onepole_core as jax_onepole_core
from diffmst_torch import ops as tops
from diffmst_torch.kernels import comp_fused, scan1p

torch.set_num_threads(1)

ATOL = 1e-4
SR = 44100.0
REPO = pathlib.Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _close(port, ref, atol=ATOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=0, atol=atol)


def _attack_alpha(rng, rows):
    """One-pole coefficients of attack times from 1 to 250 ms at 44.1 kHz."""
    ms = rng.uniform(1.0, 250.0, size=rows)
    return np.exp(-np.log(9.0) / (SR * ms / 1e3)).astype(np.float32)


# ------------------------------------------------------------------ kernels


def _onepole_f64(b, alpha):
    """The recurrence run sample by sample in float64."""
    a = np.broadcast_to(alpha.reshape(alpha.shape[0], -1), b.shape).astype(np.float64)
    y = np.empty(b.shape, np.float64)
    acc = np.zeros(b.shape[0])
    for n in range(b.shape[1]):
        acc = a[:, n] * acc + b[:, n]
        y[:, n] = acc
    return y


@pytest.mark.parametrize("per_sample", [False, True], ids=["alpha_row", "alpha_sample"])
def test_onepole_plain_matches_pallas(per_sample):
    """K1's plain version == JAX onepole_core (interpret), T a multiple of no chunk.

    On unit-scale signals the float32 Pallas scan is within 1e-4 of exact.
    On gains of tens of dB with a pole at 0.9998 its own rounding reaches
    3e-4 (tests/port_precision_probe.py), so there the plain version, which
    composes in float64 as the kernel does, is held against a float64 run.
    """
    rng = np.random.default_rng(0)
    rows, t = 5, 3001
    if per_sample:
        alpha = rng.uniform(0.9, 0.9999, size=(rows, t)).astype(np.float32)
        one_minus = 1.0 - alpha
    else:
        alpha = _attack_alpha(rng, rows)
        one_minus = (1.0 - alpha)[:, None]
    g = rng.normal(size=(rows, t)).astype(np.float32)
    b = (one_minus * g).astype(np.float32)
    ref = jax_onepole_core(jnp.asarray(b), jnp.asarray(alpha), chunk=128, interpret=True)
    _close(scan1p.onepole_core_plain(_t(b), _t(alpha)), ref)
    _close(scan1p.onepole_core(_t(b), _t(alpha)), ref)

    g_db = rng.uniform(-40.0, 0.0, size=(rows, t)).astype(np.float32)
    b_db = (one_minus * g_db).astype(np.float32)
    _close(scan1p.onepole_core_plain(_t(b_db), _t(alpha)), _onepole_f64(b_db, alpha), atol=1e-5)


def test_compressor_fused_plain_matches_pallas():
    """K2's plain version == JAX compressor_fused_gain (interpret), knee 0 clamped."""
    rng = np.random.default_rng(1)
    rows, t = 6, 2500
    x = (rng.normal(size=(rows, t)) * 0.3).astype(np.float32)
    xd = np.roll(x, 1024, axis=-1)
    thr = rng.uniform(-40.0, -5.0, rows).astype(np.float32)
    ratio = rng.uniform(1.0, 10.0, rows).astype(np.float32)
    knee = rng.uniform(3.0, 12.0, rows).astype(np.float32)
    knee[0] = 0.0  # the 1e-3 clamp keeps the knee division finite
    alpha = _attack_alpha(rng, rows)
    makeup = rng.uniform(0.0, 6.0, rows).astype(np.float32)
    args = (x, xd, thr, ratio, knee, alpha, makeup)
    ref = jax_fused_gain(*map(jnp.asarray, args), 512, 1e-8, True)
    out = comp_fused.compressor_fused_gain_plain(*map(_t, args))
    assert np.isfinite(out.numpy()).all()
    _close(out, ref)
    _close(comp_fused.compressor_fused_gain(*map(_t, args)), ref)


def _rel_close(port, ref, rtol=1e-4, what=""):
    """max |port - ref| <= rtol * max |ref| (the tolerance relative to the
    cotangent's max-abs)."""
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, what
    err = np.abs(port - ref).max()
    assert err <= rtol * np.abs(ref).max(), f"{what}: {err} > {rtol} * {np.abs(ref).max()}"


@pytest.mark.parametrize("per_sample", [False, True], ids=["K1_alpha_row", "K4_alpha_sample"])
def test_onepole_backward_matches_jax_grad(per_sample):
    """K1's backward (and K4's, per-sample alpha) == jax.grad of the JAX
    smoother onepole_scan / onepole_scan_tv (Pallas, interpret), 5 x 3,001.
    The port runs the same autograd.Function on the CPU with the plain
    forward and backward. Tolerance: 1e-4 of each cotangent's max-abs."""
    from diffmst_tpu.kernels.scan1p import onepole_scan, onepole_scan_tv

    rng = np.random.default_rng(12)
    rows, t = 5, 3001
    g = rng.uniform(-40.0, 0.0, size=(rows, t)).astype(np.float32)  # gains in dB
    w = rng.normal(size=(rows, t)).astype(np.float32)  # the output's cotangent
    if per_sample:
        alpha = rng.uniform(0.9, 0.9999, size=(rows, t)).astype(np.float32)
        jfn = onepole_scan_tv
    else:
        alpha = _attack_alpha(rng, rows)
        jfn = onepole_scan
    ref = jax.grad(
        lambda g_, a_: jnp.sum(jfn(g_, a_, 128, True) * w), argnums=(0, 1)
    )(jnp.asarray(g), jnp.asarray(alpha))

    tg, ta = _t(g).requires_grad_(), _t(alpha).requires_grad_()
    one_minus = (1.0 - ta) if per_sample else (1.0 - ta)[:, None]
    y = scan1p.onepole_core(one_minus * tg, ta)
    (y * _t(w)).sum().backward()
    _rel_close(tg.grad, ref[0], what="dg")
    _rel_close(ta.grad, ref[1], what="dalpha")


@pytest.mark.parametrize("lookahead", [None, 1024], ids=["x_delayed_free", "lookahead_1024"])
def test_compressor_fused_backward_matches_jax_grad(lookahead):
    """K2's backward == jax.grad of the JAX compressor_fused_gain (Pallas,
    interpret; its VJP recomputes through XLA), 6 x 2,500, knee 0 clamped on
    row 0. With x_delayed its own input all seven cotangents are compared;
    with a lookahead x_delayed = roll(x) and dx sums both paths.
    Tolerance: 1e-4 of each cotangent's max-abs."""
    rng = np.random.default_rng(13)
    rows, t = 6, 2500
    x = (rng.normal(size=(rows, t)) * 0.3).astype(np.float32)
    xd = (rng.normal(size=(rows, t)) * 0.3).astype(np.float32)
    p = [
        rng.uniform(-40.0, -5.0, rows).astype(np.float32),  # threshold
        rng.uniform(1.0, 10.0, rows).astype(np.float32),  # ratio
        rng.uniform(3.0, 12.0, rows).astype(np.float32),  # knee
        _attack_alpha(rng, rows),
        rng.uniform(0.0, 6.0, rows).astype(np.float32),  # makeup
    ]
    p[2][0] = 0.0  # clamped to 1e-3: its cotangent is 0
    w = rng.normal(size=(rows, t)).astype(np.float32)

    def jloss(x_, xd_, *params):
        if lookahead is not None:
            xd_ = jnp.roll(x_, lookahead, axis=-1)
        return jnp.sum(jax_fused_gain(x_, xd_, *params, 512, 1e-8, True) * w)

    ref = jax.jit(jax.grad(jloss, argnums=tuple(range(7))))(*map(jnp.asarray, [x, xd, *p]))
    leaves = [_t(a).requires_grad_() for a in [x, xd, *p]]
    tx, txd = leaves[:2]
    if lookahead is not None:
        txd = torch.roll(tx, lookahead, dims=-1)
    (comp_fused.compressor_fused_gain(tx, txd, *leaves[2:]) * _t(w)).sum().backward()
    names = ["dx", "dx_delayed", "dthreshold", "dratio", "dknee", "dalpha", "dmakeup"]
    for name, leaf, r in zip(names, leaves, ref):
        if lookahead is not None and name == "dx_delayed":
            assert leaf.grad is None
            continue
        _rel_close(leaf.grad, r, what=name)
    assert float(leaves[4].grad[0]) == 0.0


def test_backward_wrappers_take_plain_version_on_cpu():
    """The backward wrappers run their plain versions on CPU tensors and
    count no launch; the plain versions agree with autograd through the
    plain forwards (float64, so rounding does not hide a wrong formula)."""
    scan1p.onepole_core_backward.launches = 0
    scan1p.onepole_core_backward.launches_per_sample = 0
    comp_fused.compressor_fused_backward.launches = 0
    rng = np.random.default_rng(14)
    rows, t = 3, 700
    dbl = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float64))  # noqa: E731
    for alpha in (dbl(_attack_alpha(rng, rows)), dbl(rng.uniform(0.5, 0.99, (rows, t)))):
        b = dbl(rng.normal(size=(rows, t))).requires_grad_()
        a = alpha.clone().requires_grad_()
        y = scan1p.onepole_core_plain(b, a)
        dy = dbl(rng.normal(size=(rows, t)))
        ref = torch.autograd.grad(y, (b, a), dy)
        db, da = scan1p.onepole_core_backward(dy, alpha, y.detach())
        torch.testing.assert_close(db, ref[0], rtol=1e-9, atol=1e-9)
        torch.testing.assert_close(da, ref[1], rtol=1e-9, atol=1e-9)

    x = dbl(rng.normal(size=(rows, t)) * 0.3).requires_grad_()
    xd = dbl(rng.normal(size=(rows, t)) * 0.3).requires_grad_()
    params = torch.stack([
        dbl(rng.uniform(-30.0, -10.0, rows)), dbl(rng.uniform(-0.9, -0.1, rows)),
        dbl(rng.uniform(3.0, 12.0, rows)), dbl(_attack_alpha(rng, rows)),
        dbl(rng.uniform(0.0, 6.0, rows)),
    ]).requires_grad_()
    out, env = comp_fused._forward_plain(x, xd, params, 1e-8)
    dy = dbl(rng.normal(size=(rows, t)))
    ref = torch.autograd.grad(out, (x, xd, params), dy)
    got = comp_fused.compressor_fused_backward(x.detach(), xd.detach(), params.detach(), env.detach(), dy)
    for g_, r in zip(got, ref):
        torch.testing.assert_close(g_, r, rtol=1e-9, atol=1e-9)
    assert scan1p.onepole_core_backward.launches == 0
    assert scan1p.onepole_core_backward.launches_per_sample == 0
    assert comp_fused.compressor_fused_backward.launches == 0


def _affine(f, t):
    """(A, B) of "apply f, then t" for maps y -> A y + B."""
    return f[0] * t[0], t[0] * f[1] + t[1]


def _min_affine(f, t):
    """(A, D, C) of "apply f, then t" for maps y -> min(C, A y + D), fmin
    dropping the NaN of an underflowed A times an identity's C = +inf, as
    the kernels' MinAffine::compose does."""
    with np.errstate(invalid="ignore"):
        return f[0] * t[0], t[0] * f[1] + t[1], np.fmin(t[2], t[0] * f[2] + t[1])


# Each map family of the look-back: its compose, its application to a
# state and its identity.
AFFINE = (_affine, lambda m, y: m[0] * y + m[1], (1.0, 0.0))
MIN_AFFINE = (_min_affine, lambda m, y: np.fmin(m[2], m[0] * y + m[1]), (1.0, 0.0, np.inf))


def _warp_tree(m, compose):
    """The look-back warp's fixed tree over 32 lanes (higher lanes earlier in
    time), maps given as tuples of (rows, 32) components: lane l takes lane
    l + d before it, d = 1, 2, ..., 16; lane 0's map."""
    m = tuple(c.copy() for c in m)
    for d in (1, 2, 4, 8, 16):
        new = compose(tuple(c[:, d:] for c in m), tuple(c[:, : 32 - d] for c in m))
        for c, n in zip(m, new):
            c[:, : 32 - d] = n
    return tuple(c[:, 0] for c in m)


def _lookback_scan(maps, pole, tile, reverse, kind=AFFINE):
    """The states of a first-order recurrence from 0 (or its adjoint,
    backwards in time), float64, in the order of the single-pass kernels
    (kernels/csrc/lookback.cuh). ``maps`` holds the per-sample map's
    components (each broadcast to (rows, T), the multiplicative one first:
    (rows, T) for a per-sample coefficient) of the family ``kind`` (AFFINE
    or MIN_AFFINE); ``pole`` (rows,) is the row's pole. Scan-order tiles of
    `tile` samples (reversed: the partial chunk at the row's end comes
    first), each composed from the identity; each tile's entering state
    from the state entering its group of 32 tiles, which the group's last
    tile publishes, and the aggregates before it in the group, in the warp's
    tree; the multiplicative part of a read aggregate or group state
    pole^tile by squaring, of the tile's own aggregate its product. With
    ``pole`` None the tiles and groups publish the multiplicative part as a
    word too, as a GatedAffine carries it (K3's backward). Returns the
    states in forward time and the number of tiles."""
    compose, apply, ident = kind
    rows, t = np.broadcast_shapes(*(np.shape(c) for c in maps))
    nt = -(-t // tile)
    pad = nt * tile - t

    def lay(c, v):  # scan order, identity maps in the padding
        c, fill = np.broadcast_to(c, (rows, t)), np.full((rows, pad), v)
        c = np.concatenate([fill, c[:, ::-1]], 1) if reverse else np.concatenate([c, fill], 1)
        return c.reshape(rows, nt, tile)

    m_n = tuple(lay(c, v) for c, v in zip(maps, ident))
    agg = tuple(np.full((rows, nt), float(v)) for v in ident)
    for i in range(tile):
        agg = compose(agg, tuple(c[:, :, i] for c in m_n))
    words = 0 if pole is None else 1  # the first published component
    if pole is not None:
        a_tile = pole.astype(np.float64)
        for _ in range(int(np.log2(tile))):
            a_tile = a_tile * a_tile
    identity = tuple(np.full((rows, 32), float(v)) for v in ident)
    prefix, entering = {}, np.empty((rows, nt))
    for j in range(nt):
        q, r = divmod(j, 32)
        m = tuple(c.copy() for c in identity)  # lane l < r: tile j-1-l of the group
        if pole is not None:
            m[0][:, :r] = a_tile[:, None]
        for c, a in zip(m[words:], agg[words:]):
            c[:, :r] = a[:, j - 1 - np.arange(r)]
        g = tuple(c[:, 0] for c in identity)
        if q:
            g = prefix[q] if pole is None else (a_tile, *prefix[q])
        entering[:, j] = apply(compose(g, _warp_tree(m, compose)), 0.0)
        if r == 31 and j + 1 < nt:  # the state entering the next group
            up = tuple(np.concatenate([a[:, j, None], c[:, :31]], 1) for c, a in zip(m, agg))
            prefix[q + 1] = compose(g, _warp_tree(up, compose))[words:]
    y, out = entering, np.empty((rows, nt, tile))
    for i in range(tile):
        y = apply(tuple(c[:, :, i] for c in m_n), y)
        out[:, :, i] = y
    y = out.reshape(rows, nt * tile)
    y = y[:, pad:][:, ::-1] if reverse else y[:, :t]
    return y, nt


def _knee_terms(x, params, eps=1e-8):
    """g_c and its derivatives by over, 1/ratio - 1 and the knee, float64."""
    thr, irm1, knee, _, _ = (p[:, None] for p in params)
    knee = np.maximum(knee, 1e-3)
    over = 20.0 / np.log(10.0) * np.log(np.maximum(np.abs(x), eps)) - thr
    w = over + knee / 2
    below, above = over <= -knee / 2, over >= knee / 2

    def region(at_above, in_knee):
        return np.where(below, 0.0, np.where(above, at_above, in_knee))

    return (region(irm1 * over, irm1 * w * w / (2 * knee)), region(irm1 + 0 * over, irm1 * w / knee),
            region(over, w * w / (2 * knee)), region(0 * over, irm1 * w * (knee - w) / (2 * knee**2)))


def _row_sums_of_last_tile(term, tile, nt):
    """Per-row sums of ``term`` (rows, T) as a reverse-time look-back kernel
    adds them: a partial a scan-order tile (the partial chunk at the row's
    end first), then the row's last tile's order (lane l takes tiles l, l +
    32, ..., then the lanes in a tree)."""
    rows, t = term.shape
    parts = np.pad(term[:, ::-1], ((0, 0), (nt * tile - t, 0))).reshape(rows, nt, tile).sum(-1)
    lanes = np.zeros((rows, 32))
    for j in range(nt):
        lanes[:, j % 32] += parts[:, j]
    for d in (16, 8, 4, 2, 1):
        lanes[:, :d] += lanes[:, d : 2 * d]
    return lanes[:, 0]


@pytest.mark.parametrize("tile,t", [(4096, 10001), (16, 5000)], ids=["tile4096", "tile16_313"])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_compressor_lookback_decomposition_matches_plain(direction, tile, t):
    """The algebra of K2's single-pass kernels, emulated in float64: tiles
    scanned from zero, their aggregates, the look-back's compositions
    (groups of 32 tiles), reversed-time tiles with the partial one first,
    and for the backward the per-tile partial sums added as the row's last
    tile adds them (lane l takes tiles l, l + 32, ..., then the lanes in a
    tree). Held against onepole_core_plain (the envelope) and
    compressor_fused_backward_plain at 1e-12 of each output's max-abs;
    3 rows, 4,096-sample tiles at T = 10,001 and 16-sample tiles over 313
    tiles at T = 5,000."""
    rng = np.random.default_rng(41)
    rows, eps, k = 3, 1e-8, np.log(10.0) / 20.0
    x = rng.normal(size=(rows, t)) * np.linspace(0.02, 1.0, t)
    x /= np.abs(x).max(axis=-1, keepdims=True)
    xd = np.roll(x, 1024, axis=-1)
    params = np.stack([rng.uniform(-40.0, -6.0, rows), 1.0 / rng.uniform(1.5, 10.0, rows) - 1.0,
                       rng.uniform(0.0, 12.0, rows), np.full(rows, 0.9998), rng.uniform(0.0, 6.0, rows)])
    params[3, 0] = _attack_alpha(rng, 1)[0]
    alpha, makeup = params[3], params[4][:, None]
    g_c, d_over, d_irm1, d_knee = _knee_terms(x, params, eps)
    b = torch.from_numpy((1.0 - alpha)[:, None] * g_c)
    env_plain = scan1p.onepole_core_plain(b, torch.from_numpy(alpha))
    if direction == "forward":
        env, _ = _lookback_scan((alpha[:, None], (1.0 - alpha)[:, None] * g_c), alpha, tile, reverse=False)
        _rel_close(env, env_plain.numpy(), 1e-12, "g_s")
        return
    dy = rng.normal(size=(rows, t))
    env = env_plain.numpy()
    dxd = dy * np.exp(k * (env + makeup))
    u = dxd * xd * k
    s, nt = _lookback_scan((alpha[:, None], u), alpha, tile, reverse=True)
    dg = (1.0 - alpha)[:, None] * s
    dx = np.where(np.abs(x) > eps, dg * d_over / (k * x), 0.0)
    g_prev = np.pad(env[:, :-1], ((0, 0), (1, 0)))
    terms = [-dg * d_over, dg * d_irm1, dg * d_knee * (params[2] > 1e-3)[:, None], s * (g_prev - g_c), u]
    sums = [_row_sums_of_last_tile(term, tile, nt) for term in terms]
    want = comp_fused.compressor_fused_backward_plain(
        *(torch.from_numpy(a) for a in (x, xd, params, env, dy)), eps)
    for name, got, w in zip(("dx", "dx_delayed", "dparams"), (dx, dxd, np.stack(sums)), want):
        _rel_close(got, w.numpy(), 1e-12, name)


_SCAN_TILE = 4096  # samples a tile of K1 and K3 (kernels/csrc/scan1p.cu: 256 x kScanItems)


@pytest.mark.parametrize("tile,t", [(_SCAN_TILE, 10001), (16, 5000)], ids=["tile_k1", "tile16_313"])
def test_onepole_lookback_decomposition_matches_plain(tile, t):
    """The algebra of K1's single-pass kernel (a row's alpha), emulated in
    float64 as for K2: affine maps, one carried word a tile. Held against
    onepole_core_plain at 1e-12 of its max-abs; one row at alpha 0.9998 and
    one at an attack pole, on gains in dB, at K1's tile and T = 10,001 (a
    partial last tile) and at 16-sample tiles over 313 tiles (groups)."""
    rng = np.random.default_rng(42)
    alpha = np.array([0.9998, _attack_alpha(rng, 1)[0]], np.float32).astype(np.float64)
    b = (1.0 - alpha)[:, None] * rng.uniform(-40.0, 0.0, size=(2, t))
    y, _ = _lookback_scan((alpha[:, None], b), alpha, tile, reverse=False)
    _rel_close(y, scan1p.onepole_core_plain(torch.from_numpy(b), torch.from_numpy(alpha)).numpy(),
               1e-12, "y")


@pytest.mark.parametrize("tile,t", [(_SCAN_TILE, 10001), (16, 5000)], ids=["tile_k3", "tile16_313"])
def test_minscan_lookback_decomposition_matches_plain(tile, t):
    """The algebra of K3's single-pass kernel, emulated in float64: min-affine
    maps (A, D, C) carried as the two words (D, C) with A = alpha^tile by
    squaring, through the group states and the warp's tree, the partial last
    tile included. Held against release_min_scan_plain at 1e-12 of its
    max-abs. Rows: a release pole of 0.9998; one of 10 ms; a pole of 0.05,
    whose powers underflow to 0 over a tile or a group, so that 0 * inf
    (an identity's C) meets fmin; and gains held equal over long stretches,
    so that y[n-1] == g[n] (ties)."""
    rng = np.random.default_rng(43)
    alpha = np.array([0.9998, np.exp(-np.log(9.0) / (SR * 0.010)), 0.05, 0.999],
                     np.float32).astype(np.float64)
    g = -30.0 * rng.uniform(size=(4, t)) ** 2
    g[:, : t // 5] = 0.0  # below the threshold: 0 dB, the state's start
    g[3] = np.repeat(rng.uniform(-24.0, 0.0, size=-(-t // 700)), 700)[:t]  # steps of 700 samples
    y, _ = _lookback_scan((alpha[:, None], (1.0 - alpha)[:, None] * g, g), alpha, tile,
                          reverse=False, kind=MIN_AFFINE)
    want = scan1p.release_min_scan_plain(torch.from_numpy(g), torch.from_numpy(alpha)).numpy()
    assert np.isfinite(y).all()
    assert (np.pad(y[3, :-1], (1, 0)) == g[3]).sum() > t // 10  # ties
    _rel_close(y, want, 1e-12, "y")


@pytest.mark.parametrize("tile,t", [(_SCAN_TILE, 10001), (16, 5000)], ids=["tile_k1bwd", "tile16_313"])
def test_onepole_backward_lookback_decomposition_matches_plain(tile, t):
    """The algebra of K1's backward single-pass kernel (a row's alpha),
    emulated in float64: the adjoint's affine maps in reversed time, the
    partial tile first, one carried word a tile (alpha^tile by squaring),
    and dalpha's row sums in the row's last tile's order. Held against
    onepole_core_backward_plain at 1e-12 of each output's max-abs. Rows: a
    pole of 0.9998, an attack pole, and 0.05, whose powers underflow to 0
    over a tile."""
    rng = np.random.default_rng(44)
    alpha = np.array([0.9998, _attack_alpha(rng, 1)[0], 0.05], np.float32).astype(np.float64)
    y = rng.uniform(-40.0, 0.0, size=(3, t))
    dy = rng.normal(size=(3, t))
    s, nt = _lookback_scan((alpha[:, None], dy), alpha, tile, reverse=True)
    dalpha = _row_sums_of_last_tile(s * np.pad(y[:, :-1], ((0, 0), (1, 0))), tile, nt)
    db_p, da_p = scan1p.onepole_core_backward_plain(*(torch.from_numpy(a) for a in (dy, alpha, y)))
    _rel_close(s, db_p.numpy(), 1e-12, "db")
    _rel_close(dalpha, da_p.numpy(), 1e-12, "dalpha")


@pytest.mark.parametrize("tile,t", [(_SCAN_TILE, 10001), (16, 5000)], ids=["tile_k3bwd", "tile16_313"])
def test_minscan_backward_lookback_decomposition_matches_plain(tile, t):
    """The algebra of K3's backward single-pass kernel, emulated in float64:
    the adjoint's affine maps with the per-sample coefficient a * L[n+1] in
    reversed time, each tile's and group's map carried as the two words (A,
    B), and dalpha's row sums in the row's last tile's order. Held against
    release_min_scan_backward_plain at 1e-12 of each output's max-abs. Rows:
    release poles of 0.9998 and of 10 ms; 0.05, whose powers underflow; a
    row clamped at the first and last sample of every tile (so that a zero
    coefficient falls on every tile and group boundary); and gains held over
    stretches of 700 samples, so that y[n-1] == g[n] (ties, which take the
    clamp) across tiles."""
    rng = np.random.default_rng(45)
    alpha = np.array([0.9998, np.exp(-np.log(9.0) / (SR * 0.010)), 0.05, 0.999, 0.999],
                     np.float32).astype(np.float64)
    g = -30.0 * rng.uniform(size=(5, t)) ** 2
    g[:, : t // 5] = 0.0
    g[3, ::tile] = g[3, tile - 1 :: tile] = -60.0  # clamps at the tiles' edges
    g[4] = np.repeat(rng.uniform(-24.0, 0.0, size=-(-t // 700)), 700)[:t]
    y = scan1p.release_min_scan_plain(torch.from_numpy(g), torch.from_numpy(alpha)).numpy()
    dy = rng.normal(size=(5, t))
    y_prev = np.pad(y[:, :-1], ((0, 0), (1, 0)))
    linear = y_prev < g  # L[n]; a tie takes the clamp
    assert not linear[3, ::tile].any() and not linear[3, tile - 1 :: tile].any()
    assert (y_prev[4] == g[4]).sum() > t // 10  # ties
    coef = np.where(np.pad(linear[:, 1:], ((0, 0), (0, 1))), alpha[:, None], 0.0)  # a L[n+1]
    s, nt = _lookback_scan((coef, dy), None, tile, reverse=True)
    dg = np.where(linear, (1.0 - alpha)[:, None] * s, s)
    dalpha = _row_sums_of_last_tile(np.where(linear, s * (y_prev - g), 0.0), tile, nt)
    dg_p, da_p = scan1p.release_min_scan_backward_plain(
        *(torch.from_numpy(a) for a in (dy, g, alpha, y)))
    assert np.isfinite(s).all()
    _rel_close(dg, dg_p.numpy(), 1e-12, "dg")
    _rel_close(dalpha, da_p.numpy(), 1e-12, "dalpha")


def _per_sample_poles(rng, t, tile):
    """Four rows of per-sample one-pole coefficients (float32 values, as
    float64): poles near 0.9998; attack poles of 1-250 ms drawn per sample;
    0.05, whose products underflow to 0 over a tile; and 0.999 with 0 at the
    first and last sample of every tile, so that a zero coefficient falls on
    every tile and group boundary."""
    alpha = np.stack([1.0 - 2e-4 * rng.uniform(0.5, 1.5, t), _attack_alpha(rng, t),
                      np.full(t, 0.05), np.full(t, 0.999)]).astype(np.float32).astype(np.float64)
    alpha[3, ::tile] = alpha[3, tile - 1 :: tile] = 0.0
    return alpha


@pytest.mark.parametrize("tile,t", [(_SCAN_TILE, 10001), (16, 5000)], ids=["tile_k4", "tile16_313"])
def test_onepole_per_sample_lookback_decomposition_matches_plain(tile, t):
    """The algebra of K4's single-pass kernel (a per-sample alpha), emulated
    in float64: each sample's alpha its map's coefficient, each tile's and
    group's map carried as the two words (A, B), the partial last tile
    included. Held against onepole_core_plain at 1e-12 of its max-abs, on
    gains in dB, over the rows of _per_sample_poles."""
    rng = np.random.default_rng(46)
    alpha = _per_sample_poles(rng, t, tile)
    b = (1.0 - alpha) * rng.uniform(-40.0, 0.0, size=alpha.shape)
    y, _ = _lookback_scan((alpha, b), None, tile, reverse=False)
    want = scan1p.onepole_core_plain(torch.from_numpy(b), torch.from_numpy(alpha)).numpy()
    assert np.isfinite(y).all()
    _rel_close(y, want, 1e-12, "y")


@pytest.mark.parametrize("tile,t", [(_SCAN_TILE, 10001), (16, 5000)], ids=["tile_k4bwd", "tile16_313"])
def test_onepole_per_sample_backward_lookback_decomposition_matches_plain(tile, t):
    """The algebra of K4's backward single-pass kernel, emulated in float64:
    the adjoint in reversed time with the coefficients shifted by one
    (sample n's is alpha[n+1]; the row's last sample's, which multiplies the
    zero state, is 0), the partial tile first, (A, B) carried a tile and a
    group, and dalpha[n] = s[n] * y[n-1] per sample. Held against
    onepole_core_backward_plain at 1e-12 of each output's max-abs, over the
    rows of _per_sample_poles."""
    rng = np.random.default_rng(47)
    alpha = _per_sample_poles(rng, t, tile)
    y = rng.uniform(-40.0, 0.0, size=alpha.shape)
    dy = rng.normal(size=alpha.shape)
    coef = np.pad(alpha[:, 1:], ((0, 0), (0, 1)))  # alpha[n+1]
    s, _ = _lookback_scan((coef, dy), None, tile, reverse=True)
    dalpha = s * np.pad(y[:, :-1], ((0, 0), (1, 0)))
    db_p, da_p = scan1p.onepole_core_backward_plain(*(torch.from_numpy(a) for a in (dy, alpha, y)))
    assert np.isfinite(s).all()
    _rel_close(s, db_p.numpy(), 1e-12, "db")
    _rel_close(dalpha, da_p.numpy(), 1e-12, "dalpha")


def test_kernel_wrappers_take_plain_version_on_cpu():
    """On CPU tensors no kernel launches: both launch counters stay at 0."""
    scan1p.onepole_core.launches = 0
    comp_fused.compressor_fused_gain.launches = 0
    rng = np.random.default_rng(2)
    x = _t(rng.normal(size=(2, 2, 4096)) * 0.3)
    p = {k: torch.full((2,), v) for k, v in _COMP_PARAMS.items()}
    for smoother in ("auto", "fused", "scan"):
        y = tops.compressor(x, SR, **p, lookahead_samples=1024, smoother=smoother)
        assert y.shape == x.shape and torch.isfinite(y).all()
    assert scan1p.onepole_core.launches == 0
    assert comp_fused.compressor_fused_gain.launches == 0


def test_kernel_wrappers_check_their_inputs():
    b = torch.zeros(2, 64)
    with pytest.raises(ValueError):
        scan1p._check(b, torch.zeros(3))
    with pytest.raises(TypeError):
        scan1p._check(b.double(), torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError):
        scan1p._check(torch.zeros(64, 2).t(), torch.zeros(2))
    with pytest.raises(ValueError):
        comp_fused._check(b, torch.zeros(2, 63), torch.zeros(5, 2))


# --------------------------------------------------------------- compressor

_COMP_PARAMS = dict(
    threshold_db=-24.0, ratio=4.0, attack_ms=10.0, release_ms=100.0,
    knee_db=6.0, makeup_gain_db=2.0,
)


def _comp_inputs(seed, bs=2, chs=2, t=8192):
    rng = np.random.default_rng(seed)
    env = np.linspace(0.05, 1.0, t, dtype=np.float32)
    x = (rng.normal(size=(bs, chs, t)) * env).astype(np.float32)
    params = dict(
        threshold_db=rng.uniform(-40.0, -6.0, bs),
        ratio=rng.uniform(1.5, 10.0, bs),
        attack_ms=rng.uniform(5.0, 250.0, bs),
        release_ms=rng.uniform(10.0, 250.0, bs),
        knee_db=rng.uniform(3.0, 12.0, bs),
        makeup_gain_db=rng.uniform(0.0, 6.0, bs),
    )
    return x, {k: v.astype(np.float32) for k, v in params.items()}


@pytest.mark.parametrize("lookahead", [2048, 1024])
@pytest.mark.parametrize("smoother", ["scan", "fused", "auto"])
def test_compressor_matches_jax_scan(smoother, lookahead):
    """Every exact smoother of the port == JAX ops.compressor(smoother="scan")."""
    x, p = _comp_inputs(3)
    ref = jops.compressor(
        jnp.asarray(x), SR, **{k: jnp.asarray(v) for k, v in p.items()},
        lookahead_samples=lookahead, smoother="scan",
    )
    out = tops.compressor(
        _t(x), SR, **{k: _t(v) for k, v in p.items()},
        lookahead_samples=lookahead, smoother=smoother,
    )
    _close(out, ref)


def test_compressor_fsm_and_gain_db_match_jax():
    x, p = _comp_inputs(4, bs=3, chs=1, t=4096)
    flat = x.reshape(3, -1)
    for smoother in ("fsm", "scan"):
        ref = jops.compressor_gain_db(
            jnp.asarray(flat), SR, **{k: jnp.asarray(v) for k, v in p.items() if k != "makeup_gain_db"},
            smoother=smoother,
        )
        out = tops.compressor_gain_db(
            _t(flat), SR, **{k: _t(v) for k, v in p.items() if k != "makeup_gain_db"},
            smoother=smoother,
        )
        _close(out, ref, atol=ATOL * 10)  # gains in dB, tens of dB in size
    ref = jops.compressor(
        jnp.asarray(x), SR, **{k: jnp.asarray(v) for k, v in p.items()},
        lookahead_samples=512, smoother="fsm",
    )
    out = tops.compressor(
        _t(x), SR, **{k: _t(v) for k, v in p.items()}, lookahead_samples=512, smoother="fsm"
    )
    _close(out, ref)


@pytest.mark.parametrize("smoother", ["ballistics"])
def test_compressor_unported_smoothers_raise(smoother):
    x, p = _comp_inputs(5, t=1024)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.compressor(_t(x), SR, **{k: _t(v) for k, v in p.items()}, smoother=smoother)


# ---------------------------------------------------------------- basic ops


def test_gain_db_to_linear_and_mono_to_stereo_match_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 3, 500)).astype(np.float32)
    g = rng.uniform(-48.0, 48.0, size=(2, 3)).astype(np.float32)
    _close(tops.db_to_linear(_t(g)), jops.db_to_linear(jnp.asarray(g)), atol=ATOL * 1e3)
    _close(tops.gain(_t(x), SR, _t(g)), jops.gain(jnp.asarray(x), SR, jnp.asarray(g)), atol=ATOL * 1e2)
    _close(tops.gain(_t(x), SR, _t(g[:, 0])), jops.gain(jnp.asarray(x), SR, jnp.asarray(g[:, 0])), atol=ATOL * 1e2)
    _close(tops.mono_to_stereo(_t(x)), jops.mono_to_stereo(jnp.asarray(x)))


def test_stereo_panner_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 4, 300)).astype(np.float32)
    pan = rng.uniform(0.0, 1.0, size=(2, 4)).astype(np.float32)
    pan[0, :3] = [0.0, 0.5, 1.0]  # hard left, centre (-4.5 dB), hard right
    out = tops.stereo_panner(_t(x), SR, _t(pan))
    assert out.shape == (2, 2, 4, 300)
    _close(out, jops.stereo_panner(jnp.asarray(x), SR, jnp.asarray(pan)))


@pytest.mark.parametrize("n_fft,hop,t", [(2048, 128, 16384), (2048, 512, 5000), (512, 128, 1999)])
def test_stft_matches_jax(n_fft, hop, t):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 1, t)).astype(np.float32)
    ref = np.asarray(jops.stft(jnp.asarray(x), n_fft, hop))
    out = tops.stft(_t(x), n_fft, hop).numpy()
    assert out.shape == ref.shape == (2, 1, n_fft // 2 + 1, 1 + t // hop)
    np.testing.assert_allclose(out.real, ref.real, rtol=0, atol=ATOL * 10)  # sums of 2048 terms
    np.testing.assert_allclose(out.imag, ref.imag, rtol=0, atol=ATOL * 10)
    np.testing.assert_array_equal(tops.hann_window(n_fft), jops.hann_window(n_fft))


# ----------------------------------------------------------------------- EQ

_EQ_KEYS = [
    f"{band}_{p}"
    for band in ("low_shelf", "band0", "band1", "band2", "band3", "high_shelf")
    for p in ("gain_db", "cutoff_freq", "q_factor")
]


def _eq_params(rng, bs):
    from diffmst_torch.console.ranges import advanced_param_ranges

    rngs = advanced_param_ranges(SR)["parametric_eq"]
    return {
        k: rng.uniform(*rngs[k], size=bs).astype(np.float32) for k in _EQ_KEYS
    }


def test_biquad_and_response_match_jax():
    rng = np.random.default_rng(9)
    p = _eq_params(rng, 3)
    for ftype, key in (("low_shelf", "low_shelf"), ("peaking", "band1"), ("high_shelf", "high_shelf")):
        args = [p[f"{key}_gain_db"], p[f"{key}_cutoff_freq"], p[f"{key}_q_factor"]]
        jb, ja = jops.biquad(*map(jnp.asarray, args), SR, ftype)
        tb, ta = tops.biquad(*map(_t, args), SR, ftype)
        _close(tb, jb)
        _close(ta, ja)
    ref = jops.parametric_eq_response(SR, 4096, **{k: jnp.asarray(v) for k, v in p.items()})
    out = tops.parametric_eq_response(SR, 4096, **{k: _t(v) for k, v in p.items()})
    _close(torch.view_as_real(out), np.stack([np.real(ref), np.imag(ref)], -1), atol=ATOL * 10)


@pytest.mark.parametrize("fader", [False, True], ids=["no_fader", "fader"])
def test_parametric_eq_fs_matches_jax(fader):
    rng = np.random.default_rng(10)
    bs, chs, t = 3, 2, 8192
    x = (rng.normal(size=(bs, chs, t)) * 0.2).astype(np.float32)
    p = _eq_params(rng, bs)
    lin = rng.uniform(0.25, 4.0, bs).astype(np.float32) if fader else None
    ref = jops.parametric_eq(
        jnp.asarray(x), SR, linear_gain=None if lin is None else jnp.asarray(lin),
        **{k: jnp.asarray(v) for k, v in p.items()},
    )
    out = tops.parametric_eq(
        _t(x), SR, linear_gain=None if lin is None else _t(lin), **{k: _t(v) for k, v in p.items()}
    )
    _close(out, ref)
    with pytest.raises(ValueError, match="eq method"):
        tops.parametric_eq(_t(x), SR, method="iir", **{k: _t(v) for k, v in p.items()})


# ----------------------------------------------------------------- loudness


def test_integrated_loudness_matches_jax_host_path():
    rng = np.random.default_rng(11)
    for x in (
        rng.normal(size=20000).astype(np.float32) * 0.1,
        rng.normal(size=(30000, 2)).astype(np.float32) * 0.01,
        np.zeros(20000, np.float32),
        rng.normal(size=5000).astype(np.float32),  # shorter than one 400 ms block
    ):
        assert tops.integrated_loudness(x, SR) == jops.integrated_loudness(x, SR)
    from diffmst_tpu.ops.loudness import k_weighting_sos

    np.testing.assert_array_equal(tops.k_weighting_sos(SR), k_weighting_sos(SR))


# ------------------------------------------------------------ import rules

_FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "diffmst_tpu"}


def _port_sources():
    files = sorted((REPO / "diffmst_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "main_torch.py", *sorted((REPO / "scripts").glob("*_torch.py"))]
    return files


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_jax(path):
    """No module of the port, nor chip_smoke.py, the port's CLI
    (main_torch.py) or its scripts (scripts/*_torch.py), imports JAX or the
    JAX package."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", "")) in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            names = [str(node.args[0].value)]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in _FORBIDDEN, f"{path.name}:{node.lineno} imports {name}"
