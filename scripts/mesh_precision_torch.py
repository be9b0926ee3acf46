"""How far float32 carries the mesh's training step, on the CPU.

Two measurements, on the toy Method-1 step of ``tests/test_torch_mesh.py``'s
Trainer cases (Cnn14 width 2, embed 32, one transformer layer, one MRSTFT
resolution, a seeded 2 x 2 x 8,192 batch):

  * BatchNorm's variance over a group: float32 channels of mean 10 and
    spread 0.01 (4 x 3 x 8 x 16), summed as two ranks' halves, by the one-pass
    E[x^2] - mean^2, by two passes (the mean first, then the sum of
    (x - mean)^2, as ``models/cnn14.py::_GroupBatchNorm`` takes it) and by
    ``torch.var_mean``: each one's largest error relative to float64.
  * The step's gradients in float32 against float64 (the global norm of the
    difference over the global norm), in one process and over a dp = 2
    mesh of two gloo ranks; then, for every train-mode BatchNorm of the
    float64 step, ATen's ``F.batch_norm`` and the mesh's group BatchNorm
    (a one-rank group) in float32 on that layer's own input, against
    float64: the largest error of the output and the input, weight and bias
    gradients, over all layers.

    python3 scripts/mesh_precision_torch.py

It runs on the CPU only, in about 25 s.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from diffmst_torch import parallel  # noqa: E402
from diffmst_torch.console import AdvancedMixConsole  # noqa: E402
from diffmst_torch.losses import MultiResolutionSTFTLoss  # noqa: E402
from diffmst_torch.models import MixStyleTransferModel, cnn14  # noqa: E402
from diffmst_torch.train import Batch, System, SystemConfig  # noqa: E402

TINY = dict(embed_dim=32, num_layers=1, nhead=4, n_fft=2048, hop_length=32, cnn_base_width=2)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def variance_errors() -> dict:
    rng = np.random.default_rng(7)
    x = torch.from_numpy((10.0 + 0.01 * rng.normal(size=(4, 3, 8, 16))).astype(np.float32))
    dims = (0, 2, 3)
    truth = x.double().var(dims, unbiased=False)
    halves = (x[:2], x[2:])
    n = x.numel() // x.shape[1]
    mean = sum(h.sum(dims) for h in halves) / n
    one_pass = (sum(h.square().sum(dims) for h in halves) / n - mean * mean).clamp_min(0.0)
    two_pass = sum((h - mean.view(1, -1, 1, 1)).square().sum(dims) for h in halves) / n
    local = torch.var_mean(x, dim=dims, unbiased=False)[0]
    return {name: rel(v, truth) for name, v in
            (("one pass", one_pass), ("two passes", two_pass), ("var_mean", local))}


def system(dtype: torch.dtype) -> System:
    model = MixStyleTransferModel.build(**TINY, device="cpu", generator=torch.Generator().manual_seed(0))
    return System(model.to(dtype), AdvancedMixConsole(44100.0, device="cpu"),
                  MultiResolutionSTFTLoss(fft_sizes=(512,), hop_sizes=(256,), win_lengths=(512,)),
                  SystemConfig(lr=1e-4, steps_per_epoch=2, max_epochs=4), device="cpu")


def batch(dtype: torch.dtype) -> Batch:
    rng = np.random.default_rng(0)
    env = np.abs(np.sin(np.linspace(0.0, 3 * np.pi, 8192)))
    tracks = torch.from_numpy(rng.normal(size=(2, 2, 8192)) * 0.1 * env).to(dtype)
    ids = torch.zeros(2, 2, dtype=torch.int32)
    return Batch(tracks, ids, ids, torch.zeros(2, 2, dtype=torch.bool), torch.zeros(2, 2, 8192, dtype=dtype))


def gradients(dtype: torch.dtype, mesh=None) -> dict:
    s, b = system(dtype), batch(dtype)
    if mesh is not None:
        s.distribute(mesh)
        b = parallel.shard_batch(b, mesh)
    s.gradients(b, s.effect_flags(0))
    return {n: p.grad.detach().clone() for n, p in s.model.named_parameters()}


def dp2_gradients() -> dict:
    torch.set_num_threads(1)
    return gradients(torch.float32, parallel.make_mesh(2, 1))


def global_rel(got: dict, ref: dict) -> float:
    num = sum(float(((got[n].double() - g.double()) ** 2).sum()) for n, g in ref.items())
    return (num / sum(float((g.double() ** 2).sum()) for g in ref.values())) ** 0.5


def batchnorm_layers() -> dict:
    """Every train-mode BatchNorm input of the float64 step, normalized by
    ATen and by the group BatchNorm in float32 (one-rank group)."""
    inputs = []
    plain = cnn14.batch_norm

    def spy(bn, x, train, axis_name=None):
        if train:
            inputs.append(x.detach().clone())
        return plain(bn, x, train, axis_name)

    cnn14.batch_norm = spy
    try:
        gradients(torch.float64)
    finally:
        cnn14.batch_norm = plain
    worst = {"aten": 0.0, "group": 0.0}
    gen = torch.Generator().manual_seed(0)
    for x in inputs:
        dy = torch.randn(x.shape, generator=gen, dtype=torch.float64)
        c = x.shape[1]
        out = {}
        for name in ("float64", "aten", "group"):
            dt = torch.float64 if name == "float64" else torch.float32
            xs, w, b = (t.to(dt).clone().requires_grad_(True)
                        for t in (x, torch.ones(c, dtype=torch.float64), torch.zeros(c, dtype=torch.float64)))
            if name == "group":
                y = cnn14._GroupBatchNorm.apply(xs, w, b, 1e-5, dist.group.WORLD)[2]
            else:
                y = F.batch_norm(xs, None, None, w, b, True, 0.0, 1e-5)
            y.backward(dy.to(dt))
            out[name] = (y, xs.grad, w.grad, b.grad)
        for name in ("aten", "group"):
            worst[name] = max(worst[name], *(rel(a, r) for a, r in zip(out[name], out["float64"])))
    return dict(layers=len(inputs), **worst)


def main() -> None:
    torch.set_num_threads(4)
    for name, err in variance_errors().items():
        print(f"variance, float32 channels of mean 10 and spread 0.01, {name}: {err:.3g} off float64")
    ref = gradients(torch.float64)
    print(f"step gradients, float32 in one process: {global_rel(gradients(torch.float32), ref):.3g} off float64")
    got = parallel.launch(dp2_gradients, 2, device="cpu")[0]
    print(f"step gradients, float32 over dp = 2 (gloo): {global_rel(got, ref):.3g} off float64")
    layers = parallel.launch(batchnorm_layers, 1, device="cpu")[0]
    print(f"BatchNorm layers of the step ({layers['layers']}), float32 on their own inputs, the largest "
          f"error of y, dx, dw, db: ATen {layers['aten']:.3g}, group {layers['group']:.3g} off float64")


if __name__ == "__main__":
    main()
