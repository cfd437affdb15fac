"""Frozen configuration for the track analysis framework.

The reference scatters its tunables as keyword defaults across modules
(reference: src/track_analyser/tempo.py:12-13, analysis/structure.py:39-40,
analysis/loudness.py:48, harmony.py:254, features.py:107, utils.py:24-25).
Here every constant lives in one typed, hashable config object so that the
whole analysis graph can be staged under ``jax.jit`` with the config as a
static argument.
"""

from __future__ import annotations

import dataclasses


DEFAULT_SR = 44_100
DEFAULT_SEED = 13_370


@dataclasses.dataclass(frozen=True)
class AnalysisConfig:
    """All tunables of the analysis pipeline (hashable / jit-static)."""

    # Core signal handling (reference: utils.py:24-25)
    target_sr: int = DEFAULT_SR
    seed: int = DEFAULT_SEED

    # Framing (reference: tempo.py:12-13, structure.py:39-40)
    hop_length: int = 512
    n_fft: int = 2_048
    beats_per_bar: int = 4

    # Tempo search band (reference: tempo.py:30-31)
    bpm_min: float = 90.0
    bpm_max: float = 135.0

    # Mel / MFCC (librosa defaults used throughout the reference)
    n_mels: int = 128
    n_mfcc: int = 13

    # Structure segmentation (reference: structure.py:86-97, 181-224)
    novelty_context_seconds: float = 2.0
    novelty_smooth_sigma: float = 1.5
    min_segment_spacing_seconds: float = 8.0
    boundary_refine_seconds: float = 3.0
    novelty_weights: tuple[float, float, float] = (0.5, 0.3, 0.2)
    hpss_kernel: int = 31
    hpss_power: float = 2.0

    # Loudness (reference: analysis/loudness.py:30-97; EBU R128 / BS.1770)
    loudness_block_seconds: float = 0.400
    short_term_seconds: float = 3.0
    true_peak_oversample: int = 8
    gate_absolute_lufs: float = -70.0
    gate_relative_lu: float = -10.0

    # Harmony (reference: harmony.py:254, 285-342). The reference
    # measures spectral balance on a dedicated 4096/1024 STFT; here the
    # measurement rides the shared 2048/512 family (fractional edge-bin
    # weights recover the finer band splits — ops/spectral.py), so the
    # fused graph runs one fewer transform (~8 ms device budget).
    balance_n_fft: int = 2_048
    balance_hop: int = 512
    chord_window_frames: int = 2
    chord_change_threshold: float = 0.15
    chord_change_keep_fraction: float = 0.9

    # Spectral features (reference: features.py:107)
    rolloff_percent: float = 0.85

    # Chroma / key estimation. The reference relies on librosa's recursive
    # multirate CQT (harmony.py:107); this framework's equivalent is a
    # THREE-resolution filterbank projection (ops/chroma.py
    # cq_chroma_tribank): bass octaves (< cq_low_octaves) from a
    # cq_low_n_fft STFT of the cq_decim-fold decimated signal (4096 @
    # sr/16 = a 1.49 s window, matching librosa's own C1 window), mid
    # octaves (< cq_family_octave) from a cq_mid_n_fft STFT of the SAME
    # decimated signal (0.37 s window), and the top octaves straight off
    # the shared 2048-family magnitude — low-register semitones resolved
    # instead of FFT-bin-limited, with zero full-rate extra transforms.
    cq_n_fft: int = 8_192  # legacy two-bank path (profiling comparisons)
    cq_bins_per_octave: int = 36
    cq_n_octaves: int = 7
    cq_fmin_midi: int = 24  # C1 = 32.703 Hz, librosa's default CQT fmin
    cq_low_n_fft: int = 4_096
    cq_mid_n_fft: int = 1_024
    cq_decim: int = 16
    cq_keep_hz: float = 1_050.0  # decimation passband: B5 + channel bw
    cq_low_octaves: int = 3
    cq_family_octave: int = 5
    # The long-window chroma is computed every cq_hop samples and repeated
    # up to hop_length resolution (a 93 ms analysis window moves little in
    # 12 ms; 4x fewer FFTs).
    cq_hop: int = 2_048

    # Fixed-capacity device outputs (dynamic shapes are hostile to XLA;
    # beats / peaks are computed as masked fixed-size arrays, trimmed on
    # host).
    max_beats: int = 4_096
    max_peaks: int = 256

    @property
    def frames_per_second(self) -> float:
        return self.target_sr / float(self.hop_length)


DEFAULT_CONFIG = AnalysisConfig()
