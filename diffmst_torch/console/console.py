"""Mix consoles (Basic: gain + pan; Advanced: the full channel strip).

Port of ``diffmst_tpu/console/console.py``. A console holds only static
configuration; calling it renders (batch, num_tracks, time) mono stems with
normalized (0, 1) parameter vectors on the console's device: the CUDA device
unless it was built with ``device="cpu"``. Per-track work runs on the
flattened (batch * tracks) axis, so each EQ and compressor call handles every
track at once.

``AdvancedMixConsole(mesh=...)`` with an "mp" axis larger than 1 runs the
per-track chain (input fader, EQ, compressor) on this rank's tracks and
gathers its output along tracks before the panner; the panner, the fx bus
and the master bus run on every track, replicated over mp (JAX's
``console.py:279-300``: the chain under ``shard_map``, the rest global
view). Each rank passes its dp row's whole batch and parameters.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from diffmst_torch import ops
from diffmst_torch.console import ranges as _ranges
from diffmst_torch.console.ranges import ParamDict
from diffmst_torch.parallel.mesh import assert_mesh_divisible, gather_tracks, track_slice
from diffmst_torch.utils.device import resolve_device

__all__ = ["ConsoleOutput", "BasicMixConsole", "AdvancedMixConsole"]


class ConsoleOutput(NamedTuple):
    mixed_tracks: torch.Tensor  # (bs, 2, num_tracks, seq_len) panned stems
    mix: torch.Tensor  # (bs, 2, seq_len) master bus output
    track_param_dict: ParamDict
    fx_bus_param_dict: ParamDict
    master_bus_param_dict: ParamDict


def _on(device: torch.device, x) -> Optional[torch.Tensor]:
    """x on ``device``: a floating tensor keeps its dtype, anything else
    becomes float32."""
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(device)
    return None if x is None else torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class BasicMixConsole:
    """Gain + constant-power pan console. Track parameters: [gain_db, pan]."""

    sample_rate: float = 44100.0
    input_min_gain_db: float = -48.0
    input_max_gain_db: float = 48.0
    min_pan: float = 0.0
    max_pan: float = 1.0
    device: Optional[str] = None  # None: the CUDA device

    num_track_control_params: int = 2
    num_fx_bus_control_params: int = 0
    num_master_bus_control_params: int = 0

    @property
    def param_ranges(self):
        return _ranges.basic_param_ranges(
            self.input_min_gain_db, self.input_max_gain_db, self.min_pan, self.max_pan
        )

    def param_dicts(self, track_params, fx_bus_params=None, master_bus_params=None):
        """Denormalized (track, fx, master) dicts; the basic console has no busses."""
        param_dict = {
            "input_fader": {"gain_db": track_params[..., 0]},
            "stereo_panner": {"pan": track_params[..., 1]},
        }
        return _ranges.denormalize_parameters(param_dict, self.param_ranges), {}, {}

    def __call__(
        self,
        tracks,
        track_params,
        fx_bus_params=None,
        master_bus_params=None,
        *,
        use_track_input_fader: bool = True,
        use_track_panner: bool = True,
        **_unused_flags,
    ) -> ConsoleOutput:
        dev = resolve_device(self.device)
        x, track_params = _on(dev, tracks), _on(dev, track_params)
        d, _, _ = self.param_dicts(track_params)
        if use_track_input_fader:
            x = x * ops.db_to_linear(d["input_fader"]["gain_db"])[..., None]
        if use_track_panner:
            stems = ops.stereo_panner(x, self.sample_rate, d["stereo_panner"]["pan"])
        else:
            stems = ops.mono_to_stereo(x)
        return ConsoleOutput(stems, stems.sum(dim=2), d, {}, {})


@dataclasses.dataclass(frozen=True)
class AdvancedMixConsole:
    """Full console: per-track [input fader -> 6-band EQ -> compressor
    (lookahead 2048)] -> pan -> stereo sum; the fx bus [per-track sends ->
    12-band noise reverb] added to it; master [input fader -> EQ ->
    compressor (lookahead 1024)] -> output fader.

    The reverb's noise is explicit: a render with the fx bus takes it as
    ``noise`` or draws it from ``generator`` (``ops/reverb.py``), where
    JAX's console takes a ``key``.
    """

    sample_rate: float = 44100.0
    input_min_gain_db: float = -48.0
    input_max_gain_db: float = 48.0
    output_min_gain_db: float = -48.0
    output_max_gain_db: float = 48.0
    min_send_db: float = -80.0
    max_send_db: float = 12.0
    eq_min_gain_db: float = -12.0
    eq_max_gain_db: float = 12.0
    min_pan: float = 0.0
    max_pan: float = 1.0
    reverb_min_band_gain: float = 0.0
    reverb_max_band_gain: float = 1.0
    reverb_min_band_decay: float = 0.0
    reverb_max_band_decay: float = 1.0

    track_comp_lookahead: int = 2048
    master_comp_lookahead: int = 1024
    reverb_num_samples: int = 65536
    reverb_num_taps: int = 1023
    # Compressor smoother (ops/compressor.py): "auto" (= "fused", kernel K2),
    # "scan" (kernel K1), "fsm" (the reference's circular FFT smoother),
    # "decoupled" (attack and release: K3, then K1), or "ballistics" (the
    # exact branching attack and release, one sequential kernel; its
    # backward K4's backward kernel). The JAX console's
    # Pallas names take the port's kernel for the same path: "scan_pallas"
    # is "scan", "fused_pallas" is "fused", "decoupled_pallas" is
    # "decoupled", and so are their "_interpret" twins.
    comp_smoother: str = "auto"
    # EQ method (ops/eq.py): the reference's frequency sampling "fs" (with
    # the input fader folded into the response), or the causal cascade
    # "scan" (kernel K5; also "scan_pallas" and "scan_pallas_interpret"),
    # which with "decoupled" makes the causal console that
    # run_diffmst(render_mode="streaming") renders with.
    eq_method: str = "fs"
    device: Optional[str] = None  # None: the CUDA device
    # A (dp, mp) mesh (diffmst_torch/parallel): with mp > 1 the per-track
    # chain runs on this rank's tracks (see the module docstring).
    mesh: Optional[object] = None

    num_track_control_params: int = _ranges.NUM_TRACK_PARAMS
    num_fx_bus_control_params: int = _ranges.NUM_FX_BUS_PARAMS
    num_master_bus_control_params: int = _ranges.NUM_MASTER_BUS_PARAMS

    @property
    def param_ranges(self):
        return _ranges.advanced_param_ranges(
            self.sample_rate,
            self.input_min_gain_db,
            self.input_max_gain_db,
            self.output_min_gain_db,
            self.output_max_gain_db,
            self.min_send_db,
            self.max_send_db,
            self.eq_min_gain_db,
            self.eq_max_gain_db,
            self.min_pan,
            self.max_pan,
            self.reverb_min_band_gain,
            self.reverb_max_band_gain,
            self.reverb_min_band_decay,
            self.reverb_max_band_decay,
        )

    def param_dicts(self, track_params, fx_bus_params=None, master_bus_params=None):
        """Denormalized (track, fx, master) dicts from (0,1) vectors; omitted
        bus groups come back as empty dicts."""
        rngs = self.param_ranges
        track_d = _ranges.denormalize_parameters(_ranges.split_track_params(track_params), rngs)
        fx_d = (
            _ranges.denormalize_parameters(_ranges.split_fx_bus_params(fx_bus_params), rngs)
            if fx_bus_params is not None
            else {}
        )
        master_d = (
            _ranges.denormalize_parameters(_ranges.split_master_bus_params(master_bus_params), rngs)
            if master_bus_params is not None
            else {}
        )
        return track_d, fx_d, master_d

    def _track_chain(
        self,
        tracks: torch.Tensor,
        track_param_dict: ParamDict,
        use_track_input_fader: bool,
        use_track_eq: bool,
        use_track_compressor: bool,
    ) -> torch.Tensor:
        """Per-track gain -> EQ -> compressor over (bs, num_tracks, seq_len)."""
        bs, num_tracks, seq_len = tracks.shape
        sr = self.sample_rate
        x = tracks.reshape(bs * num_tracks, 1, seq_len)

        def flat(p):  # (bs, num_tracks) -> (bs * num_tracks,)
            return p.reshape(bs * num_tracks)

        fader_lin = None
        if use_track_input_fader:
            fader_lin = ops.db_to_linear(flat(track_param_dict["input_fader"]["gain_db"]))
            if not use_track_eq:
                x = x * fader_lin[:, None, None]
        if use_track_eq:
            eq = {k: flat(v) for k, v in track_param_dict["parametric_eq"].items()}
            # the fader folds into the EQ ("fs": its sampled response)
            x = ops.parametric_eq(x, sr, linear_gain=fader_lin, method=self.eq_method, **eq)
        if use_track_compressor:
            comp = {k: flat(v) for k, v in track_param_dict["compressor"].items()}
            x = ops.compressor(
                x, sr, **comp,
                lookahead_samples=self.track_comp_lookahead,
                smoother=self.comp_smoother,
            )
        return x.reshape(bs, num_tracks, seq_len)

    def forward_mix_console(
        self,
        tracks: torch.Tensor,
        track_param_dict: ParamDict,
        fx_bus_param_dict: ParamDict,
        master_bus_param_dict: ParamDict,
        use_track_input_fader: bool = True,
        use_track_eq: bool = True,
        use_track_compressor: bool = True,
        use_track_panner: bool = True,
        use_fx_bus: bool = True,
        use_master_bus: bool = True,
        use_output_fader: bool = True,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ):
        """Render denormalized parameter dicts -> (stems, master). With the
        fx bus, ``noise`` or ``generator`` feeds the reverb
        (``ops.noise_shaped_reverberation``)."""
        sr = self.sample_rate
        chain_kwargs = dict(
            use_track_input_fader=use_track_input_fader,
            use_track_eq=use_track_eq,
            use_track_compressor=use_track_compressor,
        )
        chain_params = {k: track_param_dict[k] for k in ("input_fader", "parametric_eq", "compressor")}
        mesh = self.mesh
        if mesh is not None and mesh.shape["mp"] > 1:
            assert_mesh_divisible(mesh, tracks.shape[0] * mesh.shape["dp"], tracks.shape[1],
                                  "console track chain")
            local = {k: {n: track_slice(v, mesh) for n, v in d.items()} for k, d in chain_params.items()}
            x = gather_tracks(self._track_chain(track_slice(tracks, mesh), local, **chain_kwargs), mesh)
        else:
            x = self._track_chain(tracks, chain_params, **chain_kwargs)
        if use_track_panner:
            stems = ops.stereo_panner(x, sr, track_param_dict["stereo_panner"]["pan"])
        else:
            stems = ops.mono_to_stereo(x)
        master = stems.sum(dim=2)  # (bs, 2, seq_len)

        if use_fx_bus:
            fx = ops.stereo_bus(stems, sr, track_param_dict["fx_bus"]["send_db"])
            fx = ops.noise_shaped_reverberation(
                fx, sr,
                **fx_bus_param_dict["reverberation"],
                num_samples=self.reverb_num_samples,
                num_bandpass_taps=self.reverb_num_taps,
                noise=noise,
                generator=generator,
            )
            master = master + fx

        if use_master_bus:
            # The input fader folds into the EQ (its sampled response under
            # "fs") and the output fader into the compressor's makeup gain
            # (10^((g+m)/20) * 10^(o/20) == 10^((g+m+o)/20)).
            master = ops.parametric_eq(
                master, sr,
                linear_gain=ops.db_to_linear(master_bus_param_dict["input_fader"]["gain_db"]),
                method=self.eq_method,
                **master_bus_param_dict["parametric_eq"],
            )
            comp_kwargs = dict(master_bus_param_dict["compressor"])
            if use_output_fader:
                comp_kwargs["makeup_gain_db"] = (
                    comp_kwargs["makeup_gain_db"]
                    + master_bus_param_dict["output_fader"]["gain_db"]
                )
            master = ops.compressor(
                master, sr, **comp_kwargs,
                lookahead_samples=self.master_comp_lookahead,
                smoother=self.comp_smoother,
            )
        elif use_output_fader:
            master = ops.gain(master, sr, master_bus_param_dict["output_fader"]["gain_db"])
        return stems, master

    def __call__(
        self,
        tracks,
        track_params,
        fx_bus_params,
        master_bus_params,
        *,
        use_track_input_fader: bool = True,
        use_track_eq: bool = True,
        use_track_compressor: bool = True,
        use_track_panner: bool = True,
        use_fx_bus: bool = True,
        use_master_bus: bool = True,
        use_output_fader: bool = True,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> ConsoleOutput:
        """Render a mix from normalized (0, 1) parameter vectors.

        Args:
          tracks: (bs, num_tracks, seq_len) mono stems.
          track_params: (bs, num_tracks, 27).
          fx_bus_params: (bs, 25).
          master_bus_params: (bs, 26).
          use_*: effect toggles (curriculum stages).
          generator, noise: the reverb's noise with the fx bus: the
            (bs, 2, 12, reverb_num_samples + reverb_num_taps - 1) tensor,
            or the generator it is drawn from (``ops.reverb.
            draw_reverb_noise``); with neither, a generator seeded 0, as
            JAX's default key.
        """
        dev = resolve_device(self.device)
        tracks = _on(dev, tracks)
        track_d, fx_d, master_d = self.param_dicts(
            _on(dev, track_params), _on(dev, fx_bus_params), _on(dev, master_bus_params)
        )
        stems, mix = self.forward_mix_console(
            tracks,
            track_d,
            fx_d,
            master_d,
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
        return ConsoleOutput(stems, mix, track_d, fx_d, master_d)
