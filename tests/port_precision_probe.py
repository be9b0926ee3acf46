"""How far the float32 JAX package and the port are from float64, on the CPU.

Run from the repository root: ``JAX_PLATFORMS=cpu python tests/port_precision_probe.py``.
It prints five measurements (not a test; pytest does not collect it):

  1. the compressor's one-pole smoother at 8 x 262,144 (the master bus at
     the serving window), gains of tens of dB and attack times of 1-250 ms:
     JAX's float32 associative scan (``ops/compressor.py::_smooth_scan``,
     the JAX console's "auto") and the port's ``onepole_core`` on the CPU
     (its plain version, float64 inside), each against a float64 run; and
     the Pallas ``onepole_core`` in interpret mode on a 5 x 3,001 corner;
  2. one loud console window (2 tracks x 16,384, faders +22/+14/+31.5 dB):
     the JAX console jitted and eager, and the port's float32 console,
     against the port's console run in float64;
  3. the decoupled compressor's release min-scan at 8 x 262,144 on gains of
     tens of dB with releases of 10-250 ms: JAX's float32 associative scan
     (``ops/compressor.py::_release_min_scan``) and the port's
     ``release_min_scan``, each against the recurrence run sample by sample
     in float64;
  4. the causal EQ's biquad cascade at 4 x 262,144 with the console's
     lowest, sharpest low shelf (20 Hz, Q 5, +12 dB) and the other five
     bands drawn over the console's ranges: JAX's float32 ``sosfilt_scan``
     (``ops/iir.py``) and the port's ``sosfilt``, each against
     ``scipy.signal.sosfilt`` in float64, relative to the peak; and the same
     with every pole radius within 0.994.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import scipy.signal  # noqa: E402
import torch  # noqa: E402

from diffmst_tpu.console import AdvancedMixConsole as JaxAdvanced  # noqa: E402
from diffmst_tpu.kernels.scan1p import onepole_core as jax_onepole_core  # noqa: E402
from diffmst_tpu.ops.compressor import _release_min_scan, _smooth_scan  # noqa: E402
from diffmst_tpu.ops.iir import sosfilt_scan  # noqa: E402
from diffmst_torch.console import AdvancedMixConsole  # noqa: E402
from diffmst_torch.kernels.iir_fused import sosfilt  # noqa: E402
from diffmst_torch.kernels.scan1p import onepole_core, release_min_scan  # noqa: E402
from diffmst_torch.ops.eq import _eq_sos  # noqa: E402

SR = 44100.0


def smoother():
    rng = np.random.default_rng(0)
    rows, t = 8, 262144
    g = rng.uniform(-40.0, 0.0, size=(rows, t)).astype(np.float32)
    ms = rng.uniform(1.0, 250.0, size=rows)
    a = np.exp(-np.log(9.0) / (SR * ms / 1e3)).astype(np.float32)
    b = ((1.0 - a)[:, None] * g).astype(np.float32)
    y64 = np.stack([scipy.signal.lfilter([1.0], [1.0, -float(a[i])], b[i].astype(np.float64))
                    for i in range(rows)])
    y_jax = np.asarray(_smooth_scan(jnp.asarray(g), jnp.asarray(a)))
    y_port = onepole_core(torch.from_numpy(b), torch.from_numpy(a)).numpy()
    print(f"one-pole 8x262144, dB gains: JAX float32 scan {np.abs(y_jax - y64).max():.3g} dB,"
          f" port {np.abs(y_port - y64).max():.3g} dB off float64")
    b5, a5 = b[:5, :3001], a[:5]
    y_pl = np.asarray(jax_onepole_core(jnp.asarray(b5), jnp.asarray(a5), chunk=128, interpret=True))
    print(f"one-pole 5x3001, dB gains: JAX Pallas onepole_core (interpret)"
          f" {np.abs(y_pl - y64[:5, :3001]).max():.3g} dB off float64")


def console():
    rng = np.random.default_rng(0)
    tracks = (rng.normal(size=(1, 2, 16384)) * 0.005).astype(np.float32)
    tp = rng.uniform(0.05, 0.95, size=(1, 2, 27)).astype(np.float32)
    mp = rng.uniform(0.05, 0.95, size=(1, 26)).astype(np.float32)
    fp = np.full((1, 25), 0.5, np.float32)
    tp[..., 0], mp[:, 25], mp[:, 24], mp[:, 18] = 0.73, 0.65, 0.83, 0.34
    jc = JaxAdvanced(SR)
    args = tuple(map(jnp.asarray, (tracks, tp, fp, mp)))
    eager = np.asarray(jc(*args, use_fx_bus=False).mix)
    jit = np.asarray(jax.jit(lambda *a: jc(*a, use_fx_bus=False).mix)(*args))
    port = AdvancedMixConsole(SR, device="cpu")(tracks, tp, fp, mp).mix.numpy()
    # the same chain in float64: forward_mix_console keeps its inputs' type
    c64 = AdvancedMixConsole(SR, comp_smoother="scan", device="cpu")
    t64, tp64, fp64, mp64 = (torch.from_numpy(v.astype(np.float64)) for v in (tracks, tp, fp, mp))
    ref = c64.forward_mix_console(t64, *c64.param_dicts(tp64, fp64, mp64))[1].numpy()
    print(f"console 2x16384, peak {np.abs(ref).max():.4g}: jitted JAX {np.abs(jit - ref).max():.3g},"
          f" eager JAX {np.abs(eager - ref).max():.3g}, port {np.abs(port - ref).max():.3g}"
          f" off float64; jitted - eager JAX {np.abs(jit - eager).max():.3g}")


def release():
    rng = np.random.default_rng(0)
    rows, t = 8, 262144
    g = rng.uniform(-40.0, 0.0, size=(rows, t)).astype(np.float32)
    ms = rng.uniform(10.0, 250.0, size=rows)
    a = np.exp(-np.log(9.0) / (SR * ms / 1e3)).astype(np.float32)
    a64, state, y64 = a.astype(np.float64), np.zeros(rows), np.empty((rows, t))
    for n in range(t):
        state = np.minimum(g[:, n], a64 * state + (1.0 - a64) * g[:, n])
        y64[:, n] = state
    y_jax = np.asarray(jax.jit(_release_min_scan)(jnp.asarray(g), jnp.asarray(a)))
    y_port = release_min_scan(torch.from_numpy(g), torch.from_numpy(a)).numpy()
    print(f"release min-scan 8x262144, dB gains: JAX float32 scan {np.abs(y_jax - y64).max():.3g} dB,"
          f" port {np.abs(y_port - y64).max():.3g} dB off float64")


def causal_eq():
    from diffmst_torch.console.ranges import advanced_param_ranges

    rng = np.random.default_rng(0)
    rows, t = 4, 262144
    rngs = advanced_param_ranges(SR)["parametric_eq"]
    x = rng.normal(size=(rows, t)).astype(np.float32)
    for label, moderate in (("20 Hz, Q 5 low shelf", False), ("pole radius <= 0.994", True)):
        p = {k: rng.uniform(*rngs[k], size=rows) for k in rngs}
        if moderate:
            for band in ("low_shelf", "band0"):
                p[f"{band}_cutoff_freq"] = rng.uniform(400.0, 2000.0, size=rows)
                p[f"{band}_q_factor"] = rng.uniform(0.3, 1.0, size=rows)
        else:
            p["low_shelf_cutoff_freq"][:] = 20.0
            p["low_shelf_q_factor"][:] = 5.0
            p["low_shelf_gain_db"][:] = 12.0
        b, a = (v.float().numpy() for v in _eq_sos(SR, **{k: torch.from_numpy(v) for k, v in p.items()}))
        radius = max(np.abs(np.roots(a[i, s])).max() for i in range(rows) for s in range(6))
        ref = np.stack([scipy.signal.sosfilt(np.concatenate([b[i], a[i]], -1).astype(np.float64),
                                             x[i].astype(np.float64)) for i in range(rows)])
        y_jax = np.asarray(jax.jit(sosfilt_scan)(*map(jnp.asarray, (x, b, a))))
        y_port = sosfilt(*map(torch.from_numpy, (x, b, a))).numpy()
        peak = np.abs(ref).max()
        print(f"biquad cascade 4x262144, {label} (largest pole radius {radius:.6f}), peak {peak:.4g}:"
              f" JAX float32 sosfilt_scan {np.abs(y_jax - ref).max() / peak:.3g},"
              f" port {np.abs(y_port - ref).max() / peak:.3g} of the peak off scipy float64")


if __name__ == "__main__":
    smoother()
    console()
    release()
    causal_eq()
