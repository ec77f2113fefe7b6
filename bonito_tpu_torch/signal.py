"""
Signal conditioning: adapter trimming and normalisation of raw current,
bonito_tpu's (``bonito_tpu/signal.py``) copied. Every function here feeds
the basecall output, so the arithmetic is bit-compatible with it (and with
upstream bonito's reader): the same constants, the same trim heuristic,
the two scaling strategies, and the f64 standardisation stored as f32.
"""

import numpy as np

# kit-14 DNA quantile normalisation defaults
DEFAULT_NORM_PARAMS = {
    "quantile_a": 0.2,
    "quantile_b": 0.9,
    "shift_multiplier": 0.51,
    "scale_multiplier": 0.53,
}


def trim(signal, window_size=40, threshold=2.4, min_trim=10, min_elements=3,
         max_samples=8000, max_trim=0.3):
    """Start-of-read adapter trim: scan fixed windows for the first
    sustained peak, cut where the signal settles back under threshold.
    Bit-identical to the reference heuristic."""
    seen_peak = False
    num_windows = min(max_samples, len(signal)) // window_size

    for pos in range(num_windows):
        start = pos * window_size + min_trim
        end = start + window_size
        window = signal[start:end]
        if len(window[window > threshold]) > min_elements or seen_peak:
            seen_peak = True
            if window[-1] > threshold:
                continue
            if end >= min(max_samples, len(signal)) or end / len(signal) > max_trim:
                return min_trim
            return end

    return min_trim


def _scale_quantile(sig, norm_params):
    """(shift, scale) from signal quantiles (kit-14 style)."""
    if norm_params is None:
        norm_params = DEFAULT_NORM_PARAMS
    qa, qb = np.quantile(
        sig, [norm_params["quantile_a"], norm_params["quantile_b"]])
    shift = max(10, norm_params["shift_multiplier"] * (qa + qb))
    scale = max(1.0, norm_params["scale_multiplier"] * (qb - qa))
    return shift, scale


def _scale_pa(sig, norm_params):
    """(shift, scale) for picoampere-calibrated models: the model config
    carries the standardisation constants (or opts out)."""
    if norm_params and norm_params.get("standardise") == 1:
        return norm_params.get("mean"), norm_params.get("stdev")
    if norm_params and norm_params.get("standardise") == 0:
        return 0.0, 1.0
    raise ValueError(
        "Picoampere scaling requested, but standardisation flag "
        "not provided")


_STRATEGIES = {"quantile": _scale_quantile, "pa": _scale_pa}


def normalisation(sig, scaling_strategy=None, norm_params=None):
    """(shift, scale) for signal standardisation under the config's
    scaling strategy (default: quantile)."""
    name = (scaling_strategy or {}).get("strategy", "quantile")
    fn = _STRATEGIES.get(name)
    if fn is None:
        raise ValueError(
            f"Scaling strategy {name} not supported; choose quantile or pa.")
    return fn(sig, norm_params)


def apply_standardisation(read, scaled, scaling_strategy=None,
                          norm_params=None, do_trim=True):
    """Common tail of every backend's Read init: normalise + trim + slice
    the calibrated signal, recording the scaling metadata on the read."""
    read.scaling_strategy = (
        "quantile" if scaling_strategy is None
        else scaling_strategy.get("strategy", "quantile"))
    read.shift, read.scale = normalisation(scaled, scaling_strategy, norm_params)
    read.trimmed_samples = (
        trim(scaled, threshold=read.scale * 2.4 + read.shift) if do_trim else 0)
    read.template_start = read.start + read.trimmed_samples / read.sample_rate
    read.template_duration = (
        read.duration - read.trimmed_samples / read.sample_rate)
    # standardise in f64 (shift/scale are quantile-derived f64 scalars),
    # then store f32: the device step consumes f32 (chunk() casts anyway,
    # so this is bit-identical downstream) and an f64 signal would double
    # every reader-worker pickle and queue transfer
    read.signal = np.asarray(
        (scaled[read.trimmed_samples:] - read.shift) / read.scale,
        dtype=np.float32)
    read.num_samples = len(scaled)
    return read
