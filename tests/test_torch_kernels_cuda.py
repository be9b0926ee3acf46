"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and ``nvcc``; without a card each one skips.
On the card, from the repository root (the suite's conftest imports JAX,
which the card's machine does not have):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Shapes are ragged on purpose: T below, at and just past one 2,048-sample
block (K5's forward, K2's, K1's, K3's and K4's and their backward
kernels: one 4,096-sample chunk or tile; K2's backward: 2,048), and row
counts that fill no warp. Tolerances: 1e-5 in dB on K1, K3 and K4 (both
versions compose in float64 and round once), 1e-5 on K2's audio and 1e-5
of K5's peak. The backward kernels are held against their plain versions
at 1e-5 of each output's max-abs (K4's dalpha, per sample, too), and at
1e-4 on the per-row sums (both add in float64, in another order). The
ballistics smoother's kernel is held at 1e-5 dB, its recorded coefficients
and branches bitwise, and its backward (K4's backward kernel) as the
others. The fused steps (``train/fused.py``): two replays of a CUDA graph
of 2 toy-width Method-1 steps against 4 eager steps (bitwise, cuDNN
deterministic; also with the fx bus), a capture that fails raising, and
``release`` handing the graph's pool back (``-k fused``).
"""

import numpy as np
import pytest
import torch

from diffmst_torch.kernels import comp_fused, iir_fused, scan1p

pytestmark = pytest.mark.cuda

SR = 44100.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _alpha(gen, rows, dev):
    ms = 1.0 + 249.0 * torch.rand(rows, generator=gen)
    return torch.exp(-np.log(9.0) / (SR * ms / 1e3)).to(dev)


@pytest.mark.parametrize("rows,t", [(1, 1), (3, 100), (5, 2047), (2, 2048), (7, 2049), (33, 10000)])
@pytest.mark.parametrize("per_sample", [False, True], ids=["alpha_row", "alpha_sample"])
def test_onepole_kernel_matches_plain(card, rows, t, per_sample):
    gen = torch.Generator().manual_seed(rows * t)
    g = (-40.0 * torch.rand(rows, t, generator=gen)).to(card)
    a = _alpha(gen, rows, card)
    if per_sample:
        a = a[:, None].expand(rows, t).contiguous()
        b = ((1.0 - a) * g).contiguous()
    else:
        b = ((1.0 - a)[:, None] * g).contiguous()
    counter = "launches_per_sample" if per_sample else "launches"
    before = getattr(scan1p.onepole_core, counter)
    y = scan1p.onepole_core(b, a)
    torch.cuda.synchronize()
    assert getattr(scan1p.onepole_core, counter) == before + 1
    torch.testing.assert_close(y, scan1p.onepole_core_plain(b, a), rtol=0, atol=1e-5)


@pytest.mark.parametrize("rows,t,lookahead", [(1, 1, 0), (3, 2047, 1024), (8, 5000, 2048)])
def test_compressor_kernel_matches_plain(card, rows, t, lookahead):
    gen = torch.Generator().manual_seed(rows + t)
    x = torch.randn(rows, t, generator=gen).to(card)
    x = x / x.abs().amax(dim=-1, keepdim=True)
    xd = torch.roll(x, lookahead, dims=-1)
    u = lambda lo, hi: (lo + (hi - lo) * torch.rand(rows, generator=gen)).to(card)  # noqa: E731
    args = (x, xd, u(-40.0, -6.0), u(1.5, 10.0), u(0.0, 12.0), _alpha(gen, rows, card), u(0.0, 6.0))
    before = comp_fused.compressor_fused_gain.launches
    y = comp_fused.compressor_fused_gain(*args)
    torch.cuda.synchronize()
    assert comp_fused.compressor_fused_gain.launches == before + 1
    torch.testing.assert_close(y, comp_fused.compressor_fused_gain_plain(*args), rtol=0, atol=1e-5)


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("t", [1, 2047, 4097, 10001])
@pytest.mark.parametrize("rows", [1, 8, 32])
@pytest.mark.parametrize("per_sample", [False, True], ids=["K1_alpha_row", "K4_alpha_sample"])
def test_onepole_backward_kernel_matches_plain(card, rows, t, per_sample):
    gen = torch.Generator().manual_seed(rows * t + per_sample)
    a = _alpha(gen, rows, card)
    if per_sample:
        a = (a[:, None] * (1.0 - 0.01 * torch.rand(rows, t, generator=gen).to(card))).contiguous()
    y = (-40.0 * torch.rand(rows, t, generator=gen)).to(card)
    dy = torch.randn(rows, t, generator=gen).to(card)
    counter = "launches_per_sample" if per_sample else "launches"
    before = getattr(scan1p.onepole_core_backward, counter)
    db, da = scan1p.onepole_core_backward(dy, a, y)
    torch.cuda.synchronize()
    assert getattr(scan1p.onepole_core_backward, counter) == before + 1
    db_p, da_p = scan1p.onepole_core_backward_plain(dy, a, y)
    assert db.shape == dy.shape and da.shape == a.shape
    assert _rel(db, db_p) <= 1e-5
    assert _rel(da, da_p) <= (1e-5 if per_sample else 1e-4)


@pytest.mark.parametrize("t", [1, 2047, 4097, 10001])
@pytest.mark.parametrize("rows", [1, 8, 32])
def test_compressor_backward_kernel_matches_plain(card, rows, t):
    gen = torch.Generator().manual_seed(rows + 7 * t)
    x = torch.randn(rows, t, generator=gen).to(card)
    x = x / x.abs().amax(dim=-1, keepdim=True)
    xd = torch.roll(x, 1024, dims=-1)
    u = lambda lo, hi: (lo + (hi - lo) * torch.rand(rows, generator=gen)).to(card)  # noqa: E731
    params = comp_fused._param_rows(u(-40.0, -6.0), u(1.5, 10.0), u(0.0, 12.0),
                                    _alpha(gen, rows, card), u(0.0, 6.0)).contiguous()
    _, env = comp_fused._forward_plain(x, xd, params, 1e-8)
    dy = torch.randn(rows, t, generator=gen).to(card)
    before = comp_fused.compressor_fused_backward.launches
    got = comp_fused.compressor_fused_backward(x, xd, params, env, dy)
    torch.cuda.synchronize()
    assert comp_fused.compressor_fused_backward.launches == before + 1
    want = comp_fused.compressor_fused_backward_plain(x, xd, params, env, dy)
    for name, g, w in zip(("dx", "dx_delayed"), got, want):
        assert _rel(g, w) <= 1e-5, name
    for k, name in enumerate(("threshold", "1/ratio-1", "knee", "alpha", "makeup")):
        assert _rel(got[2][k], want[2][k]) <= 1e-4, name


def test_compressor_forward_envelope_matches_plain(card):
    """The envelope a differentiated forward writes is the plain version's g_s."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(8, 5000, generator=gen).to(card) * 0.3
    params = comp_fused._param_rows(*(torch.full((8,), v, device=card) for v in
                                      (-20.0, 4.0, 6.0, 0.999, 2.0))).contiguous()
    out, env = comp_fused._launch(x, x, params, 1e-8, envelope=True)
    out_p, env_p = comp_fused._forward_plain(x, x, params, 1e-8)
    torch.cuda.synchronize()
    torch.testing.assert_close(env, env_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-5)


def _comp_case(card, rows, t, seed, alpha=None):
    """Peak-normalized audio, x_delayed = x rolled by 1,024, (5, rows)
    parameter rows (attacks of 1-250 ms, or ``alpha`` on every row) and a
    cotangent."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, t, generator=gen) * torch.linspace(0.02, 1.0, t)
    x = (x / x.abs().amax(dim=-1, keepdim=True)).to(card)
    xd = torch.roll(x, 1024, dims=-1)
    u = lambda lo, hi: (lo + (hi - lo) * torch.rand(rows, generator=gen)).to(card)  # noqa: E731
    a = _alpha(gen, rows, card) if alpha is None else torch.full((rows,), alpha, device=card)
    params = comp_fused._param_rows(u(-40.0, -6.0), u(1.5, 10.0), u(0.0, 12.0), a,
                                    u(0.0, 6.0)).contiguous()
    return x, xd, params, torch.randn(rows, t, generator=gen).to(card)


def _check_compressor_kernels(x, xd, params, dy, plain_dtype=torch.float32):
    """K2 (with and without the envelope) and its backward against their
    plain versions run in ``plain_dtype``: the output within 1e-5, the
    envelope within 1e-5 dB, dx and dx_delayed within 1e-5 and the five sums
    within 1e-4 of their max-abs; one launch a call."""
    before = (comp_fused.compressor_fused_gain.launches, comp_fused.compressor_fused_backward.launches)
    out, _ = comp_fused._launch(x, xd, params, 1e-8, envelope=False)
    out_e, env = comp_fused._launch(x, xd, params, 1e-8, envelope=True)
    got = comp_fused.compressor_fused_backward(x, xd, params, env, dy)
    torch.cuda.synchronize()
    assert comp_fused.compressor_fused_gain.launches == before[0] + 2
    assert comp_fused.compressor_fused_backward.launches == before[1] + 1
    cast = [t.to(plain_dtype) for t in (x, xd, params, env, dy)]
    out_p, env_p = comp_fused._forward_plain(*cast[:3], 1e-8)
    want = comp_fused.compressor_fused_backward_plain(*cast)
    assert torch.equal(out, out_e)
    assert (out.double() - out_p.double()).abs().max().item() <= 1e-5
    assert (env.double() - env_p.double()).abs().max().item() <= 1e-5
    for name, g, w in zip(("dx", "dx_delayed"), got, want):
        assert bool(torch.isfinite(g).all()) and _rel(g, w) <= 1e-5, name
    for k, name in enumerate(("threshold", "1/ratio-1", "knee", "alpha", "makeup")):
        assert _rel(got[2][k], want[2][k]) <= 1e-4, name
    return out, env, got


@pytest.mark.parametrize("t", [1, 2, 3, 5, 4097, 4100, 10001])
@pytest.mark.parametrize("rows", [1, 8, 33])
def test_compressor_lookback_kernels_match_plain(card, rows, t):
    """K2 and its backward at ragged shapes: one tile or a few, the row's
    start off 16 bytes (T % 4 != 0: scalar loads) or on them (4100)."""
    _check_compressor_kernels(*_comp_case(card, rows, t, seed=rows * t + 11))


def test_compressor_lookback_holds_over_256_tiles_at_a_250ms_attack(card):
    """4 x (2^20 + 3) samples, 257 tiles a row forward and 513 backward,
    alpha 0.9998 (a 250 ms attack): the look-back's float64 carries against
    the plain versions run in float64."""
    _check_compressor_kernels(*_comp_case(card, 4, 2**20 + 3, seed=12, alpha=0.9998),
                              plain_dtype=torch.float64)


def test_compressor_lookback_runs_more_tiles_than_are_resident(card):
    """256 x 262,144 samples: 16,384 tiles, more than the card holds at once."""
    _check_compressor_kernels(*_comp_case(card, 256, 262144, seed=13))


def test_compressor_lookback_kernels_are_deterministic(card):
    """Three calls give bit-identical outputs, envelopes and sums."""
    x, xd, params, dy = _comp_case(card, 33, 100003, seed=14)
    runs = []
    for _ in range(3):
        out, env = comp_fused._launch(x, xd, params, 1e-8, envelope=True)
        runs.append((out, env, *comp_fused.compressor_fused_backward(x, xd, params, env, dy)))
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], run))


def test_compressor_lookback_kernels_on_two_streams(card):
    """Calls on two CUDA streams at once give what they give one after the
    other: each call has its own scratch."""
    cases = [_comp_case(card, rows, t, seed=15 + rows) for rows, t in ((32, 131072), (8, 262144))]

    def run(case):
        x, xd, params, dy = case
        out, env = comp_fused._launch(x, xd, params, 1e-8, envelope=True)
        return (out, env, *comp_fused.compressor_fused_backward(x, xd, params, env, dy))

    alone = [run(c) for c in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    together = []
    for s, c in zip(streams, cases):
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            together.append(run(c))
    torch.cuda.synchronize()
    for a, b in zip(alone, together):
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_compressor_lookback_takes_more_than_65535_rows(card):
    """70,000 rows of 5 samples: one tile a row, a one-dimensional grid."""
    _check_compressor_kernels(*_comp_case(card, 70000, 5, seed=16))


def _call_records(prof) -> list:
    """The card's records in a trace, but for the spin kernels of
    ``torch.cuda._sleep`` that lead it: on an H100, a trace begun some
    seconds after the last one ended can lose the first few records of the
    card's activity (``scripts/trace_probe_torch.py``)."""
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name]


def test_compressor_lookback_is_one_kernel_and_one_memset_a_call(card):
    """A trace of one call of K2 (with and without the envelope) and of its
    backward shows one kernel launch, one memset and no copy each."""
    from torch.profiler import ProfilerActivity, profile

    x, xd, params, dy = _comp_case(card, 8, 10001, seed=17)
    _, env = comp_fused._launch(x, xd, params, 1e-8, envelope=True)
    calls = (lambda: comp_fused._launch(x, xd, params, 1e-8, envelope=False),
             lambda: comp_fused._launch(x, xd, params, 1e-8, envelope=True),
             lambda: comp_fused.compressor_fused_backward(x, xd, params, env, dy))
    for fn in calls:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(64):  # a trace after a pause can lose its first few records
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        names = _call_records(prof)
        memsets = [n for n in names if n.startswith("Memset")]
        assert len(memsets) == 1 and len(names) == 2 and not any(n.startswith("Memcpy") for n in names), names


def test_autograd_runs_the_backward_kernels(card):
    """Gradients through the compressor on the card launch the K2 backward
    (smoother "fused") or the K1 backward ("scan"), and match the plain
    versions' gradients on the CPU."""
    from diffmst_torch import ops

    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 2, 6000, generator=gen) * 0.3
    p = {k: torch.full((2,), v) for k, v in dict(threshold_db=-24.0, ratio=4.0, attack_ms=10.0,
                                                    release_ms=100.0, knee_db=6.0,
                                                    makeup_gain_db=2.0).items()}
    w = torch.randn(2, 2, 6000, generator=gen)
    for smoother, counter in (("fused", comp_fused.compressor_fused_backward),
                              ("scan", scan1p.onepole_core_backward)):
        grads = {}
        for dev in ("cpu", card):
            leaves = [t.detach().to(dev).clone().requires_grad_() for t in (x, *p.values())]
            before = counter.launches
            y = ops.compressor(leaves[0], SR, *leaves[1:], lookahead_samples=1024, smoother=smoother)
            (y * w.to(dev)).sum().backward()
            launched = counter.launches - before
            assert launched == (0 if dev == "cpu" else 1), (smoother, dev, launched)
            # release_ms reaches no output: the attack-only smoothers ignore it
            grads[str(dev)] = [leaf.grad.cpu() for leaf in leaves if leaf.grad is not None]
        assert len(grads["cpu"]) == len(grads[str(card)]) == len(leaves) - 1
        for g_card, g_cpu in zip(grads[str(card)], grads["cpu"]):
            assert _rel(g_card, g_cpu) <= 1e-4, smoother


def _gains_db(gen, rows, t, dev):
    """Compressor gains in dB (<= 0, some rows starting at 0 dB, as below
    the threshold) with release coefficients of 10-250 ms."""
    g = -30.0 * torch.rand(rows, t, generator=gen) ** 2
    g[::2, : t // 3] = 0.0
    ms = 10.0 + 240.0 * torch.rand(rows, generator=gen)
    return g.to(dev), torch.exp(-np.log(9.0) / (SR * ms / 1e3)).to(dev)


@pytest.mark.parametrize("rows,t", [(1, 1), (3, 100), (5, 2047), (2, 2048), (7, 2049), (33, 10000)])
def test_release_min_scan_kernel_matches_plain(card, rows, t):
    gen = torch.Generator().manual_seed(rows * t + 1)
    g, a = _gains_db(gen, rows, t, card)
    before = scan1p.release_min_scan.launches
    y = scan1p.release_min_scan(g, a)
    torch.cuda.synchronize()
    assert scan1p.release_min_scan.launches == before + 1
    torch.testing.assert_close(y, scan1p.release_min_scan_plain(g, a), rtol=0, atol=1e-5)


@pytest.mark.parametrize("t", [1, 2047, 4097, 10001])
@pytest.mark.parametrize("rows", [1, 8, 32])
def test_release_min_scan_backward_kernel_matches_plain(card, rows, t):
    gen = torch.Generator().manual_seed(rows * t + 2)
    g, a = _gains_db(gen, rows, t, card)
    y = scan1p.release_min_scan_plain(g, a)
    dy = torch.randn(rows, t, generator=gen).to(card)
    before = scan1p.release_min_scan_backward.launches
    dg, da = scan1p.release_min_scan_backward(dy, g, a, y)
    torch.cuda.synchronize()
    assert scan1p.release_min_scan_backward.launches == before + 1
    dg_p, da_p = scan1p.release_min_scan_backward_plain(dy, g, a, y)
    assert _rel(dg, dg_p) <= 1e-5
    assert _rel(da, da_p) <= 1e-4


def _scan_case(card, rows, t, seed, alpha=None):
    """K1's input b = (1 - a) g with attacks of 1-250 ms, K3's gains g with
    releases of 10-250 ms, K4's per-sample alpha with attacks of 1-250 ms
    drawn per sample (or ``alpha`` on every row of K1 and K3, and within
    1e-5 of it on every sample of K4), and a cotangent dy for the backward
    kernels."""
    gen = torch.Generator().manual_seed(seed)
    g, a3 = _gains_db(gen, rows, t, card)
    a1 = _alpha(gen, rows, card)
    dy = torch.randn(rows, t, generator=gen).to(card)
    if alpha is None:
        a4 = _alpha(gen, rows * t, card).reshape(rows, t)
    else:
        a1, a3 = (torch.full((rows,), alpha, device=card) for _ in range(2))
        a4 = (alpha * (1.0 - 1e-5 * torch.rand(rows, t, generator=gen))).to(card)
    return ((1.0 - a1)[:, None] * g).contiguous(), a1, g, a3, dy, a4.contiguous()


def _scan_calls(b, a1, g, a3, dy, a4):
    """K1, K3, K4 (on b4 = (1 - a4) g) and their backward kernels on their
    outputs: (y1, y3, y4, (db, dalpha), (dg, dalpha), (db4, dalpha4))."""
    y1 = scan1p.onepole_core(b, a1)
    y3 = scan1p.release_min_scan(g, a3)
    y4 = scan1p.onepole_core(((1.0 - a4) * g).contiguous(), a4)
    return (y1, y3, y4, scan1p.onepole_core_backward(dy, a1, y1),
            scan1p.release_min_scan_backward(dy, g, a3, y3),
            scan1p.onepole_core_backward(dy, a4, y4))


def _flat(outs):
    y1, y3, y4, (db, da1), (dg, da3), (db4, da4) = outs
    return y1, y3, y4, db, da1, dg, da3, db4, da4


# (wrapper, counter): K1, K3, K4, K1-bwd, K3-bwd, K4-bwd
_SCAN_COUNTERS = ((scan1p.onepole_core, "launches"), (scan1p.release_min_scan, "launches"),
                  (scan1p.onepole_core, "launches_per_sample"),
                  (scan1p.onepole_core_backward, "launches"),
                  (scan1p.release_min_scan_backward, "launches"),
                  (scan1p.onepole_core_backward, "launches_per_sample"))


def _check_scan_kernels(b, a1, g, a3, dy, a4, plain_dtype=torch.float32):
    """K1, K3, K4 and their backward kernels, the single-pass look-back
    kernels, against their plain versions run in ``plain_dtype``: K1, K3 and
    K4 within 1e-5 dB, or within 1e-5 of the max-abs against float64; db,
    dg and K4's dalpha (per sample) within 1e-5 and the dalpha row sums of
    K1 and K3 within 1e-4 of their max-abs; one launch a call."""
    before = [getattr(fn, c) for fn, c in _SCAN_COUNTERS]
    y1, y3, y4, (db, da1), (dg, da3), (db4, da4) = _scan_calls(b, a1, g, a3, dy, a4)
    torch.cuda.synchronize()
    assert [getattr(fn, c) - n for (fn, c), n in zip(_SCAN_COUNTERS, before)] == [1] * 6
    cast = lambda *ts: [t.to(plain_dtype) for t in ts]  # noqa: E731
    want1 = scan1p.onepole_core_plain(*cast(b, a1))
    want3 = scan1p.release_min_scan_plain(*cast(g, a3))
    want4 = scan1p.onepole_core_plain(*cast(((1.0 - a4) * g).contiguous(), a4))
    for name, y, w in (("K1", y1, want1), ("K3", y3, want3), ("K4", y4, want4)):
        assert bool(torch.isfinite(y).all()), name
        if plain_dtype == torch.float64:
            assert _rel(y, w) <= 1e-5, name
        else:
            assert (y.double() - w.double()).abs().max().item() <= 1e-5, name
    want1 = scan1p.onepole_core_backward_plain(*cast(dy, a1, y1))
    want3 = scan1p.release_min_scan_backward_plain(*cast(dy, g, a3, y3))
    want4 = scan1p.onepole_core_backward_plain(*cast(dy, a4, y4))
    for name, got, want, sums_tol in (("K1-bwd", (db, da1), want1, 1e-4),
                                      ("K3-bwd", (dg, da3), want3, 1e-4),
                                      ("K4-bwd", (db4, da4), want4, 1e-5)):
        assert all(bool(torch.isfinite(v).all()) for v in got), name
        assert _rel(got[0], want[0]) <= 1e-5, name
        assert _rel(got[1], want[1]) <= sums_tol, name
    return y1, y3


@pytest.mark.parametrize("t", [1, 2, 3, 5, 2049, 4097, 4100, 10001])
@pytest.mark.parametrize("rows", [1, 8, 33])
def test_scan_lookback_kernels_match_plain(card, rows, t):
    """K1, K3, K4 and their backward kernels at ragged shapes: one tile or a
    few (tiles of 4,096), the row's start off 16 bytes (T % 4 != 0: 4-byte
    copies) or on them (4100)."""
    _check_scan_kernels(*_scan_case(card, rows, t, seed=rows * t + 21))


def test_scan_lookback_holds_over_256_tiles_at_a_pole_of_0_9998(card):
    """4 x (2^20 + 3) samples, 257 tiles a row at 4,096 samples, alpha 0.9998
    on K1, K3 and their backward kernels, and per-sample alphas within 1e-5
    of it on K4 and K4's backward: the look-back's float64 carries against
    the plain versions run in float64."""
    _check_scan_kernels(*_scan_case(card, 4, 2**20 + 3, seed=22, alpha=0.9998),
                        plain_dtype=torch.float64)


def test_scan_lookback_at_a_pole_whose_powers_underflow(card):
    """alpha 0.05 on K1, K3 and their backward kernels, and about 0.05 on
    every sample of K4 and its backward: alpha^4096 is 0, so K3's look-back
    meets 0 * inf (an identity's C), which fmin drops, and K4's tiles carry
    a product A of 0; 8 x 300,000 samples, 74 tiles a row, two groups and a
    partial one."""
    _check_scan_kernels(*_scan_case(card, 8, 300000, seed=28, alpha=0.05))


def test_scan_lookback_min_scan_backward_with_clamps_across_tiles(card):
    """K3's backward where its coefficient a * L[n+1] is 0 at the first and
    last sample of every 2,048: of every tile of 4,096 (a clamp there, whose
    gate reads g across a tile's end) and of every thread block's half
    tile; and over stretches of held gains that cross tiles, where y[n-1] ==
    g[n] (ties take the clamp); 8 x 300,003 samples at release poles of
    10-250 ms and of 0.9998. K4 and its backward with alpha 0 at the same
    samples: a zero coefficient on every tile's edges, the backward's (the
    next sample's alpha) one sample earlier."""
    b, a1, g, a3, dy, a4 = _scan_case(card, 8, 300003, seed=29)
    a4[:, ::2048] = 0.0
    a4[:, 2047::2048] = 0.0
    a3[::2] = 0.9998
    t = g.shape[1]
    g[:, ::2048] = -60.0
    g[:, 2047::2048] = -60.0
    steps = -24.0 * torch.rand(8, t // 700 + 1, generator=torch.Generator().manual_seed(30))
    held = torch.repeat_interleave(steps, 700, dim=1)[:, :t]
    g[4:, t // 2 :] = held[4:, t // 2 :].to(g.device)
    y3 = scan1p.release_min_scan(g, a3)
    y_prev = torch.nn.functional.pad(y3[:, :-1], (1, 0))
    # clamped at every tile's start before the held stretches (y is causal)
    assert not bool((y_prev < g)[:, : t // 2 : 2048].any())
    assert int((y_prev[4:, t // 2 :] == g[4:, t // 2 :]).sum()) > t // 4  # ties
    _check_scan_kernels(b, a1, g, a3, dy, a4)


def test_scan_lookback_runs_more_tiles_than_are_resident(card):
    """256 x 262,144 samples: 16,384 tiles of 4,096, more than the card
    holds at once."""
    _check_scan_kernels(*_scan_case(card, 256, 262144, seed=23))


def test_scan_lookback_kernels_are_deterministic(card):
    """Three calls of each kernel give bit-identical outputs and row sums
    (K4's backward: dalpha per sample)."""
    case = _scan_case(card, 33, 100003, seed=24)
    runs = [_flat(_scan_calls(*case)) for _ in range(3)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert all(torch.equal(u, v) for u, v in zip(runs[0], run))


def test_scan_lookback_kernels_on_two_streams(card):
    """Calls on two CUDA streams at once give what they give one after the
    other: each call has its own scratch."""
    cases = [_scan_case(card, rows, t, seed=25 + rows) for rows, t in ((32, 131072), (8, 262144))]

    def run(case):
        return _flat(_scan_calls(*case))

    alone = [run(c) for c in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    together = []
    for s, c in zip(streams, cases):
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            together.append(run(c))
    torch.cuda.synchronize()
    for a, b in zip(alone, together):
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_scan_lookback_takes_more_than_65535_rows(card):
    """70,000 rows of 5 samples: one tile a row, a one-dimensional grid."""
    _check_scan_kernels(*_scan_case(card, 70000, 5, seed=26))


def test_scan_lookback_is_one_kernel_and_one_memset_a_call(card):
    """A trace of one call of K1 (a row's alpha), of K3, of K4 (a per-sample
    alpha) and of their backward kernels shows one kernel launch, one memset
    and no copy each."""
    from torch.profiler import ProfilerActivity, profile

    b, a1, g, a3, dy, a4 = _scan_case(card, 8, 10001, seed=27)
    b4 = ((1.0 - a4) * g).contiguous()
    y1, y3, y4 = scan1p.onepole_core(b, a1), scan1p.release_min_scan(g, a3), scan1p.onepole_core(b4, a4)
    for fn in (lambda: scan1p.onepole_core(b, a1), lambda: scan1p.release_min_scan(g, a3),
               lambda: scan1p.onepole_core(b4, a4),
               lambda: scan1p.onepole_core_backward(dy, a1, y1),
               lambda: scan1p.release_min_scan_backward(dy, g, a3, y3),
               lambda: scan1p.onepole_core_backward(dy, a4, y4)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(64):  # a trace after a pause can lose its first few records
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        names = _call_records(prof)
        memsets = [n for n in names if n.startswith("Memset")]
        assert len(memsets) == 1 and len(names) == 2 and not any(n.startswith("Memcpy") for n in names), names


def _sections(gen, rows, dev, low_shelf_hz=None):
    """(B, 6, 3) sections of the console's EQ, parameters drawn over its
    ranges; ``low_shelf_hz`` pins the low shelf's cutoff, with Q 5."""
    from diffmst_torch.console.ranges import advanced_param_ranges
    from diffmst_torch.ops.eq import _eq_sos

    rngs = advanced_param_ranges(SR)["parametric_eq"]
    p = {k: lo + (hi - lo) * torch.rand(rows, generator=gen, dtype=torch.float64)
         for k, (lo, hi) in rngs.items()}
    if low_shelf_hz is not None:
        p["low_shelf_cutoff_freq"] = torch.full((rows,), low_shelf_hz, dtype=torch.float64)
        p["low_shelf_q_factor"] = torch.full((rows,), 5.0, dtype=torch.float64)
        p["low_shelf_gain_db"] = torch.full((rows,), 12.0, dtype=torch.float64)
    b, a = _eq_sos(SR, **p)
    return b.float().to(dev), a.float().to(dev)


_K5_CHUNK = 4096  # samples a block of K5's forward (csrc/iir_fused.cu, kChunk)


def _more_sections(b, a, sections):
    """The EQ's six sections repeated up to ``sections`` (a wider state)."""
    return tuple(v.repeat(1, 3, 1)[:, :sections].contiguous() for v in (b, a))


@pytest.mark.parametrize(
    "rows,t,sections",
    [(1, 1, 6), (3, 100, 6), (5, 2047, 6), (2, 2048, 6), (7, 2049, 6), (33, 10000, 6),
     (1, _K5_CHUNK - 1, 6), (1, _K5_CHUNK, 6), (1, _K5_CHUNK + 1, 6), (1, 3 * _K5_CHUNK + 17, 6),
     (3, 3 * _K5_CHUNK + 17, 1), (3, 3 * _K5_CHUNK + 17, 9)],
)
def test_sosfilt_kernel_matches_plain(card, rows, t, sections):
    gen = torch.Generator().manual_seed(rows * t + 3)
    b, a = _sections(gen, rows, card)
    b, a = _more_sections(b, a, sections)  # a wider carry
    x = torch.randn(rows, t, generator=gen).to(card)
    before = iir_fused.sosfilt.launches
    y = iir_fused.sosfilt(x, b, a)
    torch.cuda.synchronize()
    assert iir_fused.sosfilt.launches == before + 1
    assert _rel(y, iir_fused.sosfilt_plain(x, b, a)) <= 1e-5


def test_sosfilt_without_stages_gives_the_same_output(card):
    """A forward that keeps no stages writes none and gives the same y."""
    gen = torch.Generator().manual_seed(8)
    b, a = _sections(gen, 4, card)
    coef = iir_fused._coef_rows(b, a)
    x = torch.randn(4, 2 * _K5_CHUNK + 5, generator=gen).to(card)
    y, stages = iir_fused._launch(x, coef)
    y_bare, none = iir_fused._launch(x, coef, keep_stages=False)
    torch.cuda.synchronize()
    assert stages.shape == (5, *x.shape) and none.numel() == 0
    assert torch.equal(y, y_bare)


def test_sosfilt_kernel_matches_scipy_at_a_20hz_shelf(card):
    import scipy.signal

    gen = torch.Generator().manual_seed(5)
    b, a = _sections(gen, 4, card, low_shelf_hz=20.0)
    x = torch.randn(4, 30000, generator=gen).to(card)
    y = iir_fused.sosfilt(x, b, a).cpu().double().numpy()
    sos = torch.cat([b, a], dim=-1).cpu().double().numpy()
    ref = np.stack([scipy.signal.sosfilt(sos[i], x[i].cpu().double().numpy()) for i in range(4)])
    assert np.abs(y - ref).max() <= 1e-4 * np.abs(ref).max()


def test_sosfilt_carries_hold_over_256_chunks_at_a_20hz_shelf(card):
    """The chunk carries of K5's forward do not pile up errors over a long
    row: 4 x 1,048,576 samples at the 20 Hz, Q 5 shelf against scipy in
    float64."""
    import scipy.signal

    gen = torch.Generator().manual_seed(9)
    b, a = _sections(gen, 4, card, low_shelf_hz=20.0)
    x = torch.randn(4, 2**20, generator=gen).to(card)
    y = iir_fused.sosfilt(x, b, a).cpu().double().numpy()
    sos = torch.cat([b, a], dim=-1).cpu().double().numpy()
    ref = np.stack([scipy.signal.sosfilt(sos[i], x[i].cpu().double().numpy()) for i in range(4)])
    assert np.abs(y - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("sections", [1, 6, 9, 16])
@pytest.mark.parametrize("t", [1, 2, 3, 2047, 4097, 10001])
@pytest.mark.parametrize("rows", [1, 8, 32])
def test_sosfilt_backward_kernel_matches_plain(card, rows, t, sections):
    """Above eight sections the backward runs in groups of eight."""
    gen = torch.Generator().manual_seed(rows * t + 4)
    b, a = _sections(gen, rows, card, low_shelf_hz=20.0 if rows > 1 else None)
    coef = iir_fused._coef_rows(*_more_sections(b, a, sections))
    x = torch.randn(rows, t, generator=gen).to(card)
    y, stages = iir_fused._forward_plain(x, coef)
    dy = torch.randn(rows, t, generator=gen).to(card)
    before = iir_fused.sosfilt_backward.launches
    dx, dcoef = iir_fused.sosfilt_backward(x, stages, y, coef, dy)
    torch.cuda.synchronize()
    assert iir_fused.sosfilt_backward.launches == before + 1
    dx_p, dcoef_p = iir_fused.sosfilt_backward_plain(x, stages, y, coef, dy)
    assert _rel(dx, dx_p) <= 1e-5
    for s in range(coef.shape[0]):
        for k in range(coef.shape[1]):
            assert _rel(dcoef[s, k], dcoef_p[s, k]) <= 1e-4, (s, k)


def test_sosfilt_backward_holds_over_256_chunks_at_a_20hz_shelf(card):
    """The 4S-state chunk carries of K5's backward do not pile up errors over
    a long row: 4 x 1,048,576 samples with the 20 Hz, Q 5, +12 dB low shelf
    against the plain backward in float64 (same stages), dx within 1e-5 of
    its max-abs and each of the 30 sums within 1e-4."""
    gen = torch.Generator().manual_seed(10)
    b, a = _sections(gen, 4, card, low_shelf_hz=20.0)
    coef = iir_fused._coef_rows(b, a)
    x = torch.randn(4, 2**20, generator=gen).to(card)
    y, stages = iir_fused._forward_plain(x, coef)
    dy = torch.randn(4, 2**20, generator=gen).to(card)
    dx, dcoef = iir_fused.sosfilt_backward(x, stages, y, coef, dy)
    torch.cuda.synchronize()
    dx_p, dcoef_p = iir_fused.sosfilt_backward_plain(
        *(t.double() for t in (x, stages, y, coef, dy)))
    assert bool(torch.isfinite(dx).all() and torch.isfinite(dcoef).all())
    assert _rel(dx, dx_p) <= 1e-5
    for s in range(6):
        for k in range(5):
            assert _rel(dcoef[s, k], dcoef_p[s, k]) <= 1e-4, (s, k)


@pytest.mark.parametrize("sections", [6, 16])
def test_sosfilt_backward_counts_one_launch_a_call(card, sections):
    """A backward call counts one launch, whether it starts four CUDA kernels
    (up to eight sections) or seven (two groups); its pass events, taken at
    up to eight sections, time four launches."""
    gen = torch.Generator().manual_seed(11)
    b, a = _sections(gen, 4, card)
    coef = iir_fused._coef_rows(*_more_sections(b, a, sections))
    x = torch.randn(4, 3 * _K5_CHUNK + 5, generator=gen).to(card)
    y, stages = iir_fused._launch(x, coef)
    dy = torch.randn_like(x)
    iir_fused.sosfilt_backward.launches = 0
    iir_fused.sosfilt_backward(x, stages, y, coef, dy)
    assert iir_fused.sosfilt_backward.launches == 1
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    for e in events:
        e.record()
    if sections > 8:
        with pytest.raises(ValueError):
            iir_fused._launch_backward(x, stages, y, coef, dy, events=events)
        return
    iir_fused._launch_backward(x, stages, y, coef, dy, events=events)
    events[-1].synchronize()
    assert iir_fused.sosfilt_backward.launches == 2
    assert all(events[k].elapsed_time(events[k + 1]) >= 0.0 for k in range(4))


def test_sosfilt_forward_stages_match_plain(card):
    """The stages a differentiated forward keeps are the plain sections' outputs."""
    gen = torch.Generator().manual_seed(6)
    b, a = _sections(gen, 8, card)
    coef = iir_fused._coef_rows(b, a)
    x = torch.randn(8, 3 * _K5_CHUNK + 17, generator=gen).to(card)
    y, stages = iir_fused._launch(x, coef)
    y_p, stages_p = iir_fused._forward_plain(x, coef)
    torch.cuda.synchronize()
    assert stages.shape == (5, 8, 3 * _K5_CHUNK + 17)
    assert _rel(stages, stages_p) <= 1e-5 and _rel(y, y_p) <= 1e-5


def test_autograd_runs_the_causal_backward_kernels(card):
    """Gradients through the decoupled compressor and the causal EQ on the
    card launch the K3, K1 and K5 backward kernels once each, and match the
    plain versions' gradients on the CPU."""
    from diffmst_torch import ops

    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 2, 6000, generator=gen) * 0.3
    comp = {k: torch.full((2,), v) for k, v in dict(threshold_db=-24.0, ratio=4.0, attack_ms=10.0,
                                                       release_ms=100.0, knee_db=6.0,
                                                       makeup_gain_db=2.0).items()}
    b, a = _sections(gen, 2, "cpu")
    w = torch.randn(2, 2, 6000, generator=gen)
    counters = (scan1p.release_min_scan_backward, scan1p.onepole_core_backward, iir_fused.sosfilt_backward)
    grads = {}
    for dev in ("cpu", card):
        leaves = [t.detach().to(dev).clone().requires_grad_() for t in (x, *comp.values())]
        before = [c.launches for c in counters]
        y = ops.compressor(leaves[0], SR, *leaves[1:], lookahead_samples=1024, smoother="decoupled")
        flat = y.reshape(4, 6000).contiguous()
        z = iir_fused.sosfilt(flat, b.repeat_interleave(2, 0).to(dev), a.repeat_interleave(2, 0).to(dev))
        (z.reshape(2, 2, 6000) * w.to(dev)).sum().backward()
        launched = [c.launches - n for c, n in zip(counters, before)]
        assert launched == ([0, 0, 0] if dev == "cpu" else [1, 1, 1]), (dev, launched)
        grads[str(dev)] = [leaf.grad.cpu() for leaf in leaves]
    for g_card, g_cpu in zip(grads[str(card)], grads["cpu"]):
        assert _rel(g_card, g_cpu) <= 1e-4


def test_kernels_refuse_what_they_do_not_take(card):
    b = torch.zeros(2, 64, device=card)
    with pytest.raises(TypeError):
        scan1p.onepole_core(b.double(), torch.zeros(2, device=card, dtype=torch.float64))
    with pytest.raises(ValueError):
        scan1p.onepole_core(b, torch.zeros(2))  # alpha on the CPU
    with pytest.raises(ValueError):
        scan1p.onepole_core(torch.zeros(64, 2, device=card).t(), torch.zeros(2, device=card))
    x = torch.zeros(2, 64, device=card)
    p = torch.ones(2, device=card)
    with pytest.raises(ValueError):
        comp_fused.compressor_fused_gain(x, x[:, :32], p, p, p, p, p)
    # the backward kernels
    a = torch.full((2,), 0.9, device=card)
    with pytest.raises(TypeError):
        scan1p.onepole_core_backward(b.double(), a.double(), b.double())
    with pytest.raises(ValueError):
        scan1p.onepole_core_backward(b, a, b[:, :32].contiguous())  # y not shaped as dy
    with pytest.raises(ValueError):
        scan1p.onepole_core_backward(b.t().contiguous().t(), a, b)  # not contiguous
    params = torch.ones(5, 2, device=card)
    with pytest.raises(TypeError):
        comp_fused.compressor_fused_backward(x, x, params, x, x.half())
    with pytest.raises(ValueError):
        comp_fused.compressor_fused_backward(x, x, params[:, :1].contiguous(), x, x)
    with pytest.raises(ValueError):
        comp_fused.compressor_fused_backward(x, x, params, x[:, :32].contiguous(), x)
    # K3 and K5
    with pytest.raises(ValueError):
        scan1p.release_min_scan(b, torch.zeros(3, device=card))
    with pytest.raises(TypeError):
        scan1p.release_min_scan_backward(b, b, a.double(), b)
    coef = torch.zeros(6, 5, 2, device=card)
    with pytest.raises(ValueError):
        iir_fused.sosfilt_backward(x, torch.zeros(4, 2, 64, device=card), x, coef, x)  # 5 stages
    with pytest.raises(ValueError):
        iir_fused._launch(x, coef[:, :4].contiguous())
    with pytest.raises(ValueError):
        iir_fused._launch(x, torch.zeros(17, 5, 2, device=card))  # over 16 sections


def test_remixer_remix_through_k2_matches_plain(card, monkeypatch):
    """The parameter-estimation Remixer (HPSS, ``AdvancedMixConsole(44100)``,
    the fx bus on, the tanh clip) at 4 x 2 x 262,144: its remix through K2,
    two launches (the tracks and the master bus), against the same remix
    with K2's plain version on the same draws, within 1e-4 of the peak."""
    import importlib

    from diffmst_torch.console import AdvancedMixConsole
    from diffmst_torch.ops.reverb import draw_reverb_noise, reverb_noise_shape
    from diffmst_torch.train import Remixer

    gen = torch.Generator().manual_seed(3)
    t = torch.arange(262144) / SR
    x = (0.1 * torch.randn(4, 2, 262144, generator=gen) + 0.2 * torch.sin(2 * np.pi * 220.0 * t)).to(card)
    console = AdvancedMixConsole(SR)
    draws = dict(tp=torch.rand(4, 8, 27, generator=gen).to(card), fp=torch.rand(4, 25, generator=gen).to(card),
                 mp=torch.rand(4, 26, generator=gen).to(card),
                 noise=draw_reverb_noise(gen, reverb_noise_shape(4, 2, 65536, 1023), card))
    remixer = Remixer(SR)
    before = comp_fused.compressor_fused_gain.launches
    remix, *_ = remixer(x, console, **draws)
    torch.cuda.synchronize()
    assert comp_fused.compressor_fused_gain.launches == before + 2
    comp_ops = importlib.import_module("diffmst_torch.ops.compressor")
    monkeypatch.setattr(comp_ops, "compressor_fused_gain", lambda x, xd, thr, ratio, knee, alpha, makeup, eps=1e-8: (
        comp_fused._Compressor.apply(x, xd, comp_fused._param_rows(thr, ratio, knee, alpha, makeup).contiguous(),
                                     eps, True)))
    plain, *_ = remixer(x, console, **draws)
    assert comp_fused.compressor_fused_gain.launches == before + 2
    assert bool(torch.isfinite(remix).all()) and float(remix.abs().max()) <= 4.0
    assert _rel(remix, plain) <= 1e-4


def test_bf16_model_step_through_k2_matches_plain(card, monkeypatch):
    """A Method-1 step of a bf16 toy-width model (``compute_dtype="bfloat16"``:
    embed 32, one layer, Cnn14 width 4, hop 128) on 2 x 2 x 32,768: the
    heads' outputs float32; its forward and backward through K2 (4
    launches) and K2-bwd (2) against the same pass through K2's plain
    version, at the same weights, BatchNorm statistics and reference mix
    (rendered once: the bf16 model turns two renders' 1e-9 difference into
    1e-3 of the loss), cuDNN deterministic: the loss within 1e-5, the
    console's cotangents at the predicted parameters within 2e-2 of their
    norm (``chip_smoke.py`` [training]'s bounds: the MRSTFT loss's L1 signs
    flip where the two mixes nearly meet)."""
    import importlib

    from diffmst_torch.console import AdvancedMixConsole
    from diffmst_torch.losses import MultiResolutionSTFTLoss
    from diffmst_torch.mixing import naive_random_mix
    from diffmst_torch.mixing.naive import draw_mix_params
    from diffmst_torch.models import MixStyleTransferModel
    from diffmst_torch.train import Batch, System, SystemConfig

    model = MixStyleTransferModel.build(embed_dim=32, num_layers=1, nhead=4, hop_length=128, cnn_base_width=4,
                                        compute_dtype="bfloat16", device=card)
    console = AdvancedMixConsole(SR)
    system = System(model, console, MultiResolutionSTFTLoss(fft_sizes=(512, 2048), hop_sizes=(128, 512),
                                                            win_lengths=(512, 2048)),
                    SystemConfig(adam_mu_dtype="bfloat16"), device=card)
    gen = torch.Generator().manual_seed(5)
    tracks = (0.1 * torch.randn(2, 2, 32768, generator=gen)).to(card)
    ids = torch.zeros(2, 2, dtype=torch.int32)
    batch = Batch(tracks, ids, ids, torch.zeros(2, 2, dtype=torch.bool, device=card),
                  torch.zeros(2, 2, 32768, device=card))
    ref_params = draw_mix_params(tracks, console, torch.Generator().manual_seed(6))
    stats = {k: v.clone() for k, v in model.named_buffers()}
    ref_once = {}

    def fixed_reference(tracks, console_, generator, **kw):
        if "ref" not in ref_once:
            ref_once["ref"] = naive_random_mix(tracks, console_, generator, **kw)
        return ref_once["ref"]

    system.mix_fn = fixed_reference

    def grad_pass():
        with torch.no_grad():
            for k, v in model.named_buffers():
                v.copy_(stats[k])
        loss, _, out = system.forward(batch, system.effect_flags(0), True, ref_params)
        assert all(p.dtype == torch.float32 for p in out["pred_params"])
        cot = {}
        for name, p in (("track", out["pred_params"][0]), ("master", out["pred_params"][2])):
            p.register_hook(lambda g, name=name: cot.__setitem__(name, g.detach().clone()))
        system.backward(loss)
        torch.cuda.synchronize()
        return float(loss.detach()), cot

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    before = (comp_fused.compressor_fused_gain.launches, comp_fused.compressor_fused_backward.launches)
    loss_k, cot_k = grad_pass()
    after = (comp_fused.compressor_fused_gain.launches, comp_fused.compressor_fused_backward.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (4, 2)
    comp_ops = importlib.import_module("diffmst_torch.ops.compressor")
    monkeypatch.setattr(comp_ops, "compressor_fused_gain", lambda x, xd, thr, ratio, knee, alpha, makeup, eps=1e-8: (
        comp_fused._Compressor.apply(x, xd, comp_fused._param_rows(thr, ratio, knee, alpha, makeup).contiguous(),
                                     eps, True)))
    loss_p, cot_p = grad_pass()
    assert (comp_fused.compressor_fused_gain.launches, comp_fused.compressor_fused_backward.launches) == after
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    for name in ("track", "master"):
        assert float((cot_k[name] - cot_p[name]).norm() / cot_p[name].norm()) <= 2e-2, name


def _ballistics_inputs(gen, rows, t, dev):
    """Gains in dB whose level alternates every 300 samples, attack 1-20 ms
    and release 50-300 ms: both branches taken."""
    level = torch.where((torch.arange(t) // 300) % 2 == 0, 1.0, 0.1)
    g = (-40.0 * torch.rand(rows, t, generator=gen) * level).to(dev)
    aa = torch.exp(-np.log(9.0) / (SR * (1.0 + 19.0 * torch.rand(rows, generator=gen)) / 1e3)).to(dev)
    ar = torch.exp(-np.log(9.0) / (SR * (50.0 + 250.0 * torch.rand(rows, generator=gen)) / 1e3)).to(dev)
    return g, aa, ar


@pytest.mark.parametrize("rows,t", [(1, 1), (3, 31), (5, 32), (2, 33), (33, 10000), (64, 4099)])
def test_ballistics_kernel_matches_plain(card, rows, t):
    """The forward, and what it records for its backward, equal the plain
    version's (both carry float64 and round once); one launch a call."""
    import importlib

    smoother = importlib.import_module("diffmst_torch.kernels.smoother")
    g, aa, ar = _ballistics_inputs(torch.Generator().manual_seed(rows * t), rows, t, card)
    before = smoother.ballistics.launches
    y, a, attack = smoother._launch(g, aa, ar, record=True)
    torch.cuda.synchronize()
    assert smoother.ballistics.launches == before + 1
    y_p, a_p, attack_p = smoother.ballistics_plain(g, aa, ar, record=True)
    torch.testing.assert_close(y, y_p, rtol=0, atol=1e-5)
    assert torch.equal(a, a_p) and torch.equal(attack, attack_p)
    assert torch.equal(smoother._launch(g, aa, ar), y)


def test_ballistics_backward_runs_k4_backward(card):
    """Autograd through the kernel: one K4-bwd launch, gradients of g and
    both alphas equal to the plain versions' at 1e-5 of each max-abs (1e-4
    on the row sums)."""
    import importlib

    smoother = importlib.import_module("diffmst_torch.kernels.smoother")
    g, aa, ar = _ballistics_inputs(torch.Generator().manual_seed(7), 33, 5000, card)
    dy = torch.randn(33, 5000, generator=torch.Generator().manual_seed(8)).to(card)
    grads = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (g, aa, ar)]
        before = scan1p.onepole_core_backward.launches_per_sample
        (smoother._Ballistics.apply(*leaves, plain) * dy).sum().backward()
        torch.cuda.synchronize()
        assert scan1p.onepole_core_backward.launches_per_sample == before + (0 if plain else 1)
        grads.append([leaf.grad for leaf in leaves])
    for k, (got, want) in enumerate(zip(*grads)):
        tol = (1e-5 if k == 0 else 1e-4) * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=tol)


def _fused_system(card, **config):
    """A toy-width Method-1 System on the card (embed 32, one layer, Cnn14
    width 4, hop 128) whose lr follows a cosine over six steps: each update
    has its own learning rate and bias corrections."""
    from diffmst_torch.console import AdvancedMixConsole
    from diffmst_torch.losses import MultiResolutionSTFTLoss
    from diffmst_torch.models import MixStyleTransferModel
    from diffmst_torch.train import System, SystemConfig

    model = MixStyleTransferModel.build(embed_dim=32, num_layers=1, nhead=4, hop_length=128, cnn_base_width=4,
                                        device=card, generator=torch.Generator().manual_seed(2))
    cfg = SystemConfig(lr=1e-3, schedule="cosine", steps_per_epoch=6, max_epochs=1, **config)
    # the loss's frames overlap by half: two atomic additions a sample in the
    # STFT's backward, whose sum does not depend on their order
    return System(model, AdvancedMixConsole(SR), MultiResolutionSTFTLoss(fft_sizes=(512, 2048),
                  hop_sizes=(256, 1024), win_lengths=(512, 2048)), cfg,
                  generator=torch.Generator().manual_seed(3), device=card)


def _fused_batches(card, n):
    from diffmst_torch.train import Batch

    gen = torch.Generator().manual_seed(4)
    ids = torch.zeros(2, 2, dtype=torch.int32)
    return [Batch((0.1 * torch.randn(2, 2, 32768, generator=gen)).to(card), ids, ids,
                  torch.zeros(2, 2, dtype=torch.bool, device=card), torch.zeros(2, 2, 32768, device=card))
            for _ in range(n)]


def _clone(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone(v) for v in obj)
    return obj


def _flat_state(system):
    sd = system.state_dict()
    opt = sd["optimizer"]
    moments = ([t for st in opt["state"].values() for t in st.values()] if "state" in opt
               else opt["mu"] + opt["nu"])
    return list(sd["model"].values()) + moments


@pytest.mark.parametrize("config", [{}, {"adam_mu_dtype": "bfloat16"}, {"active_fx_bus_epoch": 0}],
                         ids=["torch_adam", "optax_bf16_mu", "fx_bus"])
def test_fused_replay_equals_eager_steps(card, monkeypatch, config):
    """Two replays of a K = 2 graph (``train/fused.py``) equal four eager
    ``train_step`` calls from the same state, across a per-step learning
    rate (a learning rate or bias correction baked in at capture would
    differ by a whole step's update), and with the fx bus (two reverb
    noises a step, from seeds the group stages in a sequential step's
    order, into static buffers): losses, parameters, BatchNorm
    statistics, moments and the generator within twice the spread of two
    eager runs, or 1e-6 of each tensor's max-abs (cuDNN deterministic, the
    eager runs are bitwise equal); the counters advance by 4 and K2 and
    K2-bwd by 16 and 8 launches. The state is restored in place between
    runs (``System.load_state_dict``)."""
    from diffmst_torch.train.fused import FusedSteps

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    system = _fused_system(card, **config)
    flags = system.effect_flags(0)
    steps = FusedSteps(system, flags, 2)  # torch.optim.Adam becomes capturable
    batches = _fused_batches(card, 4)
    system.train_step(batches[0], flags)  # the optimizer's state exists before the snapshot
    start = _clone(system.state_dict())

    def eager():
        system.load_state_dict(start)
        losses = [float(system.train_step(b, flags)["loss"]) for b in batches]
        return losses, _clone(_flat_state(system)), system.generator.get_state()

    runs = [eager(), eager()]
    system.load_state_dict(start)
    steps(batches[:2])  # the warm-up group, then the capture
    assert steps.graph is not None
    system.load_state_dict(start)
    before = (comp_fused.compressor_fused_gain.launches, comp_fused.compressor_fused_backward.launches)
    losses = [float(m["loss"]) for group in (batches[:2], batches[2:]) for m in steps(group)]
    torch.cuda.synchronize()
    after = (comp_fused.compressor_fused_gain.launches, comp_fused.compressor_fused_backward.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (16, 8)
    assert (system.step, system.updates) == (5, 5)
    (l0, s0, g0), (l1, s1, _) = runs
    assert torch.equal(system.generator.get_state(), g0)
    for got, a, b in zip(losses, l0, l1):
        assert abs(got - a) <= max(2 * abs(a - b), 1e-6 * abs(a)), (got, a, b)
    for got, a, b in zip(_flat_state(system), s0, s1):
        spread = float((a.double() - b.double()).abs().max())
        err = float((got.double() - a.double()).abs().max())
        assert err <= max(2 * spread, 1e-6 * float(a.double().abs().max())), (err, spread)


def test_fused_capture_failure_raises(card, monkeypatch):
    """A step that synchronizes with the host cannot be captured: the call
    raises and leaves no graph; it runs no eager steps in the graph's
    place."""
    from diffmst_torch.train.fused import FusedSteps

    system = _fused_system(card)
    flags = system.effect_flags(0)
    steps = FusedSteps(system, flags, 2)
    loss = system.loss

    def syncing_loss(pred, target):
        out = loss(pred, target)
        torch.cuda.synchronize()
        return out

    system.loss = syncing_loss
    batches = _fused_batches(card, 2)
    with pytest.raises(RuntimeError):
        steps(batches)  # the warm-up runs; the capture fails
    assert steps.graph is None and system.step == 2


def test_fused_release_frees_the_graph_pool(card):
    """``FusedSteps.release`` (the Trainer's, when the epoch's flags move
    on) resets the graph and hands its private pool back to the card."""
    from diffmst_torch.train.fused import FusedSteps

    system = _fused_system(card)
    flags = system.effect_flags(0)
    steps = FusedSteps(system, flags, 2)
    batches = _fused_batches(card, 2)
    steps(batches)  # the warm-up group, then the capture
    steps(batches)  # a replay
    torch.cuda.synchronize()
    assert steps.graph is not None and steps.pool_bytes > 0
    reserved = torch.cuda.memory_reserved()
    steps.release()
    assert steps.graph is None
    assert torch.cuda.memory_reserved() <= reserved - steps.pool_bytes
