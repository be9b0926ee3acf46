"""DSP primitives on tensors (port of ``diffmst_tpu/ops``)."""

from diffmst_torch.ops.basic import db_to_linear, gain, mono_to_stereo, stereo_bus, stereo_panner
from diffmst_torch.ops.biquad import biquad, sos_frequency_response
from diffmst_torch.ops.compressor import compressor, compressor_gain_db
from diffmst_torch.ops.eq import parametric_eq, parametric_eq_response
from diffmst_torch.ops.loudness import integrated_loudness, k_weighting_sos
from diffmst_torch.ops.reverb import fft_convolve, noise_shaped_reverberation, octave_band_filterbank
from diffmst_torch.ops.stft import hann_window, istft, reflect_pad, stft

__all__ = [
    "db_to_linear",
    "gain",
    "mono_to_stereo",
    "stereo_panner",
    "stereo_bus",
    "biquad",
    "sos_frequency_response",
    "compressor",
    "compressor_gain_db",
    "parametric_eq",
    "parametric_eq_response",
    "integrated_loudness",
    "k_weighting_sos",
    "fft_convolve",
    "noise_shaped_reverberation",
    "octave_band_filterbank",
    "hann_window",
    "reflect_pad",
    "stft",
    "istft",
]
