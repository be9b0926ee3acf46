"""Random reference-mix generator (the Method-1 training data factory).

Port of ``diffmst_tpu/mixing/naive.py::naive_random_mix``: uniform (0, 1)
parameters for all three groups, rendered through the console without
gradients. An explicit ``torch.Generator`` replaces the JAX key; the two
give different numbers from one seed, so the tests compare the draw's
distribution and feed the JAX draw to the port through the train step's
``ref_params``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["NaiveRandomMix", "naive_random_mix"]


class NaiveRandomMix(NamedTuple):
    mixed_tracks: torch.Tensor
    mix: torch.Tensor
    track_param_dict: dict
    fx_bus_param_dict: dict
    master_bus_param_dict: dict
    track_params: torch.Tensor
    fx_bus_params: torch.Tensor
    master_bus_params: torch.Tensor


def draw_mix_params(tracks: torch.Tensor, mix_console, generator: torch.Generator, device=None):
    """Uniform (0, 1) (track (bs, n, P_t), fx bus (bs, P_f), master bus
    (bs, P_m)) parameters, drawn on the generator's device in that order and
    moved to ``device`` (default: the tracks')."""
    bs, num_tracks, _ = tracks.shape
    shapes = (
        (bs, num_tracks, mix_console.num_track_control_params),
        (bs, mix_console.num_fx_bus_control_params),
        (bs, mix_console.num_master_bus_control_params),
    )
    return tuple(
        torch.rand(s, generator=generator, device=generator.device).to(device or tracks.device)
        for s in shapes
    )


@torch.no_grad()
def naive_random_mix(
    tracks: torch.Tensor,
    mix_console,
    generator: torch.Generator,
    use_track_input_fader: bool = True,
    use_track_eq: bool = True,
    use_track_compressor: bool = True,
    use_track_panner: bool = True,
    use_fx_bus: bool = True,
    use_master_bus: bool = True,
    use_output_fader: bool = True,
    params=None,
    noise=None,
) -> NaiveRandomMix:
    """Render a reference mix of (bs, num_tracks, seq_len) stems with
    uniformly random console parameters drawn from ``generator``, or with
    the given normalized ``params`` (track, fx bus, master bus).

    With the fx bus, the reverb takes ``noise`` or draws it from
    ``generator`` after the parameters (``ops.reverb.draw_reverb_noise``).
    """
    if params is None:
        params = draw_mix_params(tracks, mix_console, generator)
    track_params, fx_bus_params, master_bus_params = params
    out = mix_console(
        tracks,
        track_params,
        fx_bus_params,
        master_bus_params,
        use_track_input_fader=use_track_input_fader,
        use_track_eq=use_track_eq,
        use_track_compressor=use_track_compressor,
        use_track_panner=use_track_panner,
        use_fx_bus=use_fx_bus,
        use_master_bus=use_master_bus,
        use_output_fader=use_output_fader,
        generator=generator,
        noise=noise,
    )
    return NaiveRandomMix(*out, track_params, fx_bus_params, master_bus_params)
