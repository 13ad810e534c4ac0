"""From-scratch numpy implementations of the WORLD / SPTK feature extractors.

The reference evaluation toolchain (upstream evaluate_tts.py:118-156)
computes its objective metrics from pyworld ``harvest`` F0, pyworld
``cheaptrick`` spectral envelopes and pysptk ``mcep`` / ``sp2mc``
mel-cepstra.  Those C libraries are optional dependencies; this module
re-implements the underlying published algorithms in pure numpy/scipy so
``evaluate_pair(backend='world')`` executes everywhere:

- :func:`mcep` — SPTK mel-cepstral analysis (Fukada et al., "An adaptive
  algorithm for mel-cepstral analysis of speech", ICASSP 1992): Newton
  iteration on the spectral criterion E = mean(exp(R) - R - 1),
  R = log I - log |H|^2, with the Toeplitz-plus-Hankel Hessian in the
  warped autocorrelation domain.  Vectorized over frames (pysptk loops
  frames in C; here one batched ``np.linalg.solve`` per iteration).
- :func:`freqt` / :func:`sp2mc` / :func:`mc2sp` — Oppenheim's recursive
  all-pass frequency transform and the SPTK spectrum<->mel-cepstrum
  conversions built on it.
- :func:`cheaptrick` — WORLD's CheapTrick spectral envelope (Morise,
  "CheapTrick, a spectral envelope estimator for high-quality speech
  synthesis", 2015): pitch-adaptive Hanning window, DC correction,
  rectangular smoothing of width (2/3)F0, and sinc + q1 liftering.
- :func:`harvest` — WORLD's Harvest F0 estimator (Morise, "Harvest: a
  high-performance fundamental frequency estimator from speech signals",
  INTERSPEECH 2017): multi-channel filtered zero-crossing candidates on a
  1-ms grid, instantaneous-frequency refinement over the first six
  harmonics, reliability pruning, contour fixing and smoothing.

These are algorithm-faithful re-implementations, not bindings: outputs are
not bit-identical to the C libraries (different quadrature grids and
filter details), but they are validated on synthetic ground truth
(tests/test_worldnp.py) and cross-checked against pyworld/pysptk by tests
that run wherever those libraries are installed
(tests/test_eval.py::test_world_backend_reference_comparable).

The port's own copy of gradtts_tpu/eval/worldnp.py: the same numpy code, its
imports from gradtts_tpu_torch.
"""

import numpy as np

# ---------------------------------------------------------------------------
# SPTK: windows and the all-pass frequency transform
# ---------------------------------------------------------------------------


def hamming(n: int) -> np.ndarray:
    """SPTK's hamming window (window.c): 0.54 - 0.46 cos(2 pi i/(n-1))."""
    if n == 1:
        return np.ones(1)
    i = np.arange(n)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * i / (n - 1))


def freqt(c: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """All-pass frequency transform of a cepstrum (SPTK freqt.c;
    Oppenheim & Johnson 1972 recursion).

    ``c[..., :]`` are cepstral coefficients of log|H| on one frequency
    axis; returns ``[..., order+1]`` coefficients on the axis warped by
    ``z~ = (z - alpha)/(1 - alpha z)``.  Vectorized over leading dims.
    """
    c = np.asarray(c, np.float64)
    m1 = c.shape[-1] - 1
    b = 1.0 - alpha * alpha
    g = np.zeros(c.shape[:-1] + (order + 1,))
    for i in range(m1, -1, -1):
        d = g
        g = np.empty_like(d)
        g[..., 0] = c[..., i] + alpha * d[..., 0]
        if order >= 1:
            g[..., 1] = b * d[..., 0] + alpha * d[..., 1]
        for j in range(2, order + 1):
            g[..., j] = d[..., j - 1] + alpha * (d[..., j] - g[..., j - 1])
    return g


def _log_cepstrum_from_power(logsp: np.ndarray, n_fft: int) -> np.ndarray:
    """[..., n_fft//2+1] log power half-spectrum -> one-sided cepstrum c
    of log|H| (log|H|(w) = sum_k c[k] cos(k w))."""
    a = np.fft.irfft(logsp, n=n_fft, axis=-1)
    c = a[..., :n_fft // 2 + 1].copy()
    c[..., 0] *= 0.5          # power = 2x log-magnitude
    c[..., -1] *= 0.5         # Nyquist bin appears once in the full series
    return c


def sp2mc(sp: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """Power spectrum envelope [..., n_fft//2+1] -> mel-cepstrum
    [..., order+1] (pysptk sp2mc: log, real cepstrum, freqt)."""
    sp = np.asarray(sp, np.float64)
    n_fft = 2 * (sp.shape[-1] - 1)
    c = _log_cepstrum_from_power(np.log(sp), n_fft)
    return freqt(c, order, alpha)


def mc2sp(mc: np.ndarray, alpha: float, n_fft: int) -> np.ndarray:
    """Mel-cepstrum [..., M+1] -> power spectrum [..., n_fft//2+1]
    (pysptk mc2sp: inverse freqt, symmetric DFT, exp)."""
    mc = np.asarray(mc, np.float64)
    single = mc.ndim == 1
    if single:
        mc = mc[None]
    c = freqt(mc, n_fft // 2, -alpha)
    half = n_fft // 2
    v = np.zeros(mc.shape[:-1] + (n_fft,))
    v[..., 0] = c[..., 0]
    v[..., 1:half] = 0.5 * c[..., 1:half]
    v[..., -1:-half:-1] += 0.5 * c[..., 1:half]
    v[..., half] = c[..., half]
    logmag = np.fft.rfft(v, axis=-1).real
    out = np.exp(2.0 * logmag)
    return out[0] if single else out


# ---------------------------------------------------------------------------
# SPTK mcep: mel-cepstral analysis by Newton iteration
# ---------------------------------------------------------------------------


def _warped_basis(n_fft: int, order: int, alpha: float):
    """cos(m * beta(w_k)) on the rfft bin grid, plus full-circle weights."""
    k = n_fft // 2 + 1
    om = np.arange(k) * (2.0 * np.pi / n_fft)
    beta = om + 2.0 * np.arctan2(alpha * np.sin(om),
                                 1.0 - alpha * np.cos(om))
    basis = np.cos(np.outer(np.arange(order + 1), beta))   # [order+1, k]
    w = np.full(k, 2.0)
    w[0] = w[-1] = 1.0                                     # bins 0 and pi once
    return basis, w


def mcep(frames: np.ndarray, order: int, alpha: float, eps: float = 1e-6,
         etype: int = 1, min_iter: int = 2, max_iter: int = 30,
         threshold: float = 0.001) -> np.ndarray:
    """Mel-cepstral analysis of (already windowed) waveform frames
    (parity: pysptk.mcep(x, order, alpha, eps=.., etype=1) over SPTK
    mcep.c / Fukada 1992).

    Minimizes, per frame, the discretized spectral criterion
    ``E = mean_w[exp(R) - R - 1]`` with ``R = log I - 2 log|H|``,
    ``log|H|(w) = sum_m mc[m] cos(m beta(w))`` on the all-pass-warped
    axis.  The stationarity condition is ``r~[m] = (-alpha)^m`` where
    ``r~`` is the warped autocorrelation of the whitened spectrum
    I/|H|^2 — the (-alpha)^m term is the DC coefficient of the m-th
    all-pass power, ``(1/2pi) int cos(m beta(w)) dw`` (SPTK's mcep
    subtracts the same alpha-power vector).  Newton step: gain update
    ``mc[0] += log(r~[0])/2`` (making r~[0] = 1), then solve the
    Toeplitz+Hankel system ``(r~[|i-j|] + r~[i+j]) d = r~[i] -
    (-alpha)^i`` for ``mc[1:]``.  All frames iterate together;
    converged frames are masked out.

    ``etype=1`` adds ``eps`` to the periodogram (the reference call
    site's setting, upstream evaluate_tts.py:136).
    """
    if etype not in (0, 1):
        raise NotImplementedError('only etype in (0, 1) is supported '
                                  '(the reference uses etype=1)')
    x = np.asarray(frames, np.float64)
    single = x.ndim == 1
    x = np.atleast_2d(x)
    n_fft = x.shape[-1]
    xs = np.fft.rfft(x, axis=-1)
    periodogram = xs.real ** 2 + xs.imag ** 2
    if etype == 1:
        periodogram = periodogram + eps
    else:
        periodogram = np.maximum(periodogram, 1e-300)

    # initial value: freqt of the linear-frequency log cepstrum
    mc = freqt(_log_cepstrum_from_power(np.log(periodogram), n_fft),
               order, alpha)

    big_basis, w = _warped_basis(n_fft, 2 * order, alpha)
    model_basis = big_basis[:order + 1]
    idx = np.arange(1, order + 1)
    t_idx = np.abs(idx[:, None] - idx[None, :])
    h_idx = idx[:, None] + idx[None, :]
    wq = w / n_fft                                  # quadrature weights
    eye = np.eye(order) * 1e-12                     # theq-style min-det guard
    alpha_pow = (-alpha) ** idx                     # (1/2pi) int cos(m beta)

    def _crit(mc_a, per_a):
        whitened = per_a * np.exp(-2.0 * (mc_a @ model_basis))
        return whitened, (whitened - np.log(whitened) - 1.0) @ wq

    e_prev = None
    active = np.ones(x.shape[0], bool)
    for it in range(max_iter):
        whitened, err = _crit(mc, periodogram)
        if e_prev is not None and it >= min_iter:
            active = np.abs(e_prev - err) > threshold * np.abs(err)
            if not active.any():
                break
        e_prev = err
        per_a = periodogram[active]
        rw = (whitened[active] * wq) @ big_basis.T  # [f, 2M+1]
        gain = rw[:, :1]
        rw = rw / gain
        mc0 = mc[active]
        dgain = 0.5 * np.log(gain[:, 0])
        delta = np.linalg.solve(
            rw[:, t_idx] + rw[:, h_idx] + eye,
            (rw[:, 1:order + 1] - alpha_pow)[..., None])[..., 0]
        # damped Newton: per-frame backtracking keeps E monotone (the
        # undamped step diverges when the initial gain is far off)
        e_cur = err[active]
        scale = np.ones(len(e_cur))
        trial = mc0
        for _ in range(12):
            trial = mc0.copy()
            trial[:, 0] += scale * dgain
            trial[:, 1:] += scale[:, None] * delta
            _, e_t = _crit(trial, per_a)
            worse = ~(e_t <= e_cur + 1e-12 * np.abs(e_cur))  # NaN-safe
            if not worse.any():
                break
            scale[worse] *= 0.5
        mc[active] = trial
    return mc[0] if single else mc


def mcep_frames_from_waveform(x: np.ndarray, fs: int, n_fft: int = 512,
                              n_shift: int = 256, order: int = 34,
                              alpha: float = 0.45,
                              eps: float = 1e-6) -> np.ndarray:
    """Hamming-windowed frame track -> [N, order+1] mel-cepstra (parity:
    sptk_extract, upstream evaluate_tts.py:118-138 — same framing
    ``(len(x)-n_fft)//n_shift + 1``, SPTK hamming, eps, etype=1)."""
    x = np.asarray(x, np.float64)
    n_frame = (len(x) - n_fft) // n_shift + 1
    if n_frame <= 0:
        return np.zeros((0, order + 1))
    starts = np.arange(n_frame) * n_shift
    frames = x[starts[:, None] + np.arange(n_fft)] * hamming(n_fft)
    return mcep(frames, order, alpha, eps=eps, etype=1)


# ---------------------------------------------------------------------------
# WORLD CheapTrick
# ---------------------------------------------------------------------------

_CHEAPTRICK_DEFAULT_F0 = 500.0     # WORLD kDefaultF0 for unvoiced frames


def cheaptrick_f0_floor(fs: int, fft_size: int) -> float:
    """Lowest F0 whose 3*T0 window fits fft_size (WORLD
    GetF0FloorForCheapTrick)."""
    return 3.0 * fs / (fft_size - 3.0)


def _windowed_waveform(x, fs, f0, t):
    """Pitch-adaptive Hanning windowing over +-1.5 T0 with weighted DC
    removal (WORLD GetWindowedWaveform)."""
    half = int(round(1.5 * fs / f0))
    base = np.arange(-half, half + 1)
    index = np.clip(int(round(t * fs)) + base, 0, len(x) - 1)
    window = 0.5 * np.cos(np.pi * (base / fs) * f0 / 1.5) + 0.5
    waveform = x[index] * window
    return waveform - window * (waveform.sum() / window.sum())


def _dc_correction(ps, f0, fs, n_fft):
    """Mirror spectral power below F0 back across DC (WORLD DCCorrection):
    bins with f < F0 get + ps(F0 - f)."""
    freq = np.arange(len(ps)) * (fs / n_fft)
    low = freq < f0
    if not low.any():
        return ps
    mirrored = np.interp(f0 - freq[low], freq, ps)
    out = ps.copy()
    out[low] += mirrored
    return out


def _linear_smoothing(ps, width, fs, n_fft):
    """Rectangular smoothing of the piecewise-linear power spectrum with a
    window of ``width`` Hz (WORLD LinearSmoothing): smoothed(f) =
    (1/width) * integral_{f-w/2}^{f+w/2} ps.  The spectrum is reflected at
    0 and Nyquist, matching the DFT symmetry."""
    k = len(ps)
    df = fs / n_fft
    # reflect enough bins on both sides to cover width/2
    pad = int(np.ceil(width / 2.0 / df)) + 1
    ext = np.concatenate([ps[pad:0:-1], ps, ps[-2:-2 - pad:-1]])
    grid = (np.arange(len(ext)) - pad) * df
    # cumulative integral of the piecewise-linear function
    cum = np.concatenate([[0.0], np.cumsum(0.5 * (ext[1:] + ext[:-1]) * df)])

    def cum_at(f):
        pos = (f - grid[0]) / df
        lo = np.clip(np.floor(pos).astype(int), 0, len(cum) - 2)
        frac = pos - lo
        base = cum[lo]
        # linear segment integral from grid[lo] to f
        y0 = ext[lo]
        y1 = ext[np.minimum(lo + 1, len(ext) - 1)]
        seg = df * (y0 * frac + 0.5 * (y1 - y0) * frac ** 2)
        return base + seg

    f = np.arange(k) * df
    return (cum_at(f + width / 2.0) - cum_at(f - width / 2.0)) / width


def _smoothing_with_recovery(smoothed_ps, f0, fs, n_fft, q1):
    """Lifter the log envelope: sinc recovery of the (2/3)F0 rectangular
    smoothing plus the q1 compensation lifter (WORLD
    SmoothingWithRecovery)."""
    tau = np.arange(n_fft // 2 + 1) / fs
    arg = np.pi * f0 * tau
    with np.errstate(invalid='ignore'):
        smoothing_lifter = np.where(arg == 0.0, 1.0, np.sin(arg)
                                    / np.where(arg == 0.0, 1.0, arg))
    compensation_lifter = (1.0 - 2.0 * q1) + 2.0 * q1 * np.cos(2.0 * arg)
    lifter = smoothing_lifter * compensation_lifter
    log_ps = np.log(np.maximum(smoothed_ps, 1e-250))
    ceps = np.fft.irfft(log_ps, n=n_fft)
    full_lifter = np.concatenate([lifter, lifter[-2:0:-1]])
    return np.exp(np.fft.rfft(ceps * full_lifter).real)


def cheaptrick(x: np.ndarray, f0: np.ndarray, temporal_positions: np.ndarray,
               fs: int, fft_size: int = None,
               q1: float = -0.15) -> np.ndarray:
    """CheapTrick spectral envelope [N, fft_size//2+1] (power), one row per
    F0 frame (parity: pyworld.cheaptrick as called at
    upstream evaluate_tts.py:151).

    Per frame: pitch-adaptive windowing (+-1.5 T0 Hanning), power
    spectrum, DC correction below F0, rectangular smoothing of width
    (2/3)F0, then cepstral liftering (sinc smoothing recovery x q1
    compensation).  Unvoiced / too-low frames use WORLD's 500 Hz default
    F0 — with fft_size=512 at 16 kHz the window must fit 512 samples, so
    the floor is ``3 fs/(fft_size-3)`` exactly as in WORLD.
    """
    x = np.asarray(x, np.float64)
    f0 = np.asarray(f0, np.float64)
    if fft_size is None:
        fft_size = int(2 ** np.ceil(np.log2(3.0 * fs / 71.0 + 1.0)))
    floor = cheaptrick_f0_floor(fs, fft_size)
    out = np.empty((len(f0), fft_size // 2 + 1))
    for i, t in enumerate(np.asarray(temporal_positions, np.float64)):
        cf0 = f0[i] if f0[i] > floor else _CHEAPTRICK_DEFAULT_F0
        waveform = _windowed_waveform(x, fs, cf0, t)
        spec = np.fft.rfft(waveform, n=fft_size)
        ps = spec.real ** 2 + spec.imag ** 2
        ps = _dc_correction(ps, cf0, fs, fft_size)
        ps = _linear_smoothing(ps, cf0 * 2.0 / 3.0, fs, fft_size)
        out[i] = _smoothing_with_recovery(ps, cf0, fs, fft_size, q1)
    return out


# ---------------------------------------------------------------------------
# WORLD Harvest
# ---------------------------------------------------------------------------


def _nuttall(n: int) -> np.ndarray:
    """Nuttall window (WORLD common.cpp NuttallWindow)."""
    t = np.arange(n) * (2.0 * np.pi / (n - 1))
    return (0.355768 - 0.487396 * np.cos(t) + 0.144232 * np.cos(2.0 * t)
            - 0.012604 * np.cos(3.0 * t))


def _decimate(x: np.ndarray, r: int) -> np.ndarray:
    """Low-pass + subsample by integer factor r (zero-phase FIR)."""
    if r <= 1:
        return x.copy()
    from scipy import signal
    return signal.decimate(x, r, ftype='fir', zero_phase=True)


def _zero_crossing_track(sig: np.ndarray, actual_fs: float, negative: bool):
    """(event_times, 1/intervals) for negative- or positive-going zero
    crossings of ``sig`` (WORLD ZeroCrossingEngine): interval between
    successive crossings -> instantaneous frequency at the midpoint."""
    if negative:
        hit = (sig[:-1] > 0.0) & (sig[1:] <= 0.0)
    else:
        hit = (sig[:-1] < 0.0) & (sig[1:] >= 0.0)
    edges = np.nonzero(hit)[0]
    if len(edges) < 3:
        return np.empty(0), np.empty(0)
    # sub-sample crossing location by linear interpolation
    frac = sig[edges] / (sig[edges] - sig[edges + 1])
    locations = (edges + frac) / actual_fs
    intervals = np.diff(locations)
    times = 0.5 * (locations[:-1] + locations[1:])
    good = intervals > 0
    return times[good], 1.0 / intervals[good]


def _four_zero_crossings(filtered: np.ndarray, actual_fs: float):
    """The four event-interval tracks Harvest extracts from one filtered
    channel: negative/positive zero crossings of the signal and of its
    first difference (peaks and dips)."""
    d = np.diff(filtered)
    return [
        _zero_crossing_track(filtered, actual_fs, True),
        _zero_crossing_track(filtered, actual_fs, False),
        _zero_crossing_track(d, actual_fs, True),
        _zero_crossing_track(d, actual_fs, False),
    ]


def _channel_candidate(filtered, actual_fs, boundary_f0, t_grid,
                       f0_floor, f0_ceil):
    """Per-channel candidate contour on the 1-ms grid (WORLD
    GetF0CandidateContour): average of the four interval tracks, kept only
    within +-10% of the channel's boundary frequency."""
    tracks = _four_zero_crossings(filtered, actual_fs)
    interp = np.zeros((4, len(t_grid)))
    for k, (times, freqs) in enumerate(tracks):
        if len(times) < 2:
            return np.zeros(len(t_grid))
        interp[k] = np.interp(t_grid, times, freqs)
        # zero outside the observed event range
        interp[k, (t_grid < times[0]) | (t_grid > times[-1])] = 0.0
    cand = interp.mean(axis=0)
    bad = ((cand > boundary_f0 * 1.1) | (cand < boundary_f0 * 0.9)
           | (cand > f0_ceil) | (cand < f0_floor))
    cand[bad] = 0.0
    return cand


def _refine_f0_batch(x, fs, ts, f0s, f0_floor, f0_ceil, n_harmonics=6):
    """Instantaneous-frequency refinement of all candidates at once (WORLD
    GetRefinedF0 / GetMeanF0): per candidate, a Blackman window over
    +-1.5 T0, bin-wise instantaneous frequency from the spectrum of the
    window-derivative, amplitude-weighted average over the first
    harmonics.  Candidates sharing a window length are batched through
    one rfft (the window length depends only on the candidate F0), which
    is the difference between ~3000 python-loop FFTs and ~100 batched
    ones on a typical utterance.

    Returns (refined_f0s, scores), scores in [0, 1] — the weighted
    harmonicity (1 = the harmonics' instantaneous frequencies agree
    exactly with multiples of the refined F0)."""
    ts = np.asarray(ts, np.float64)
    f0s = np.asarray(f0s, np.float64)
    out_f = np.zeros(len(ts))
    out_s = np.zeros(len(ts))
    valid = f0s > 0.0
    halves = np.zeros(len(ts), np.int64)
    halves[valid] = (1.5 * fs / f0s[valid] + 1.0).astype(np.int64)
    harm = np.arange(1, n_harmonics + 1)
    for half in np.unique(halves[valid]):
        sel = np.nonzero(valid & (halves == half))[0]
        base = np.arange(-half, half + 1)
        centers = np.round(ts[sel] * fs).astype(np.int64)
        seg = x[np.clip(centers[:, None] + base[None, :], 0, len(x) - 1)]
        span = (2 * half + 1) / fs
        u = base / fs / span                   # in (-0.5, 0.5)
        main_window = (0.42 + 0.5 * np.cos(2.0 * np.pi * u)
                       + 0.08 * np.cos(4.0 * np.pi * u))
        diff_window = np.empty_like(main_window)
        diff_window[1:-1] = -(main_window[2:] - main_window[:-2]) / 2.0
        diff_window[0] = -main_window[1] / 2.0
        diff_window[-1] = main_window[-2] / 2.0

        fft_size = int(2 ** np.ceil(np.log2(2 * half + 2)))
        spec = np.fft.rfft(seg * main_window, n=fft_size, axis=1)
        dspec = np.fft.rfft(seg * diff_window, n=fft_size, axis=1)
        power = spec.real ** 2 + spec.imag ** 2 + 1e-300
        n_bins = power.shape[1]
        # d(phase)/dt per bin: bin frequency + power-normalized correction
        binf = np.arange(n_bins) * (fs / fft_size)
        inst = binf + (spec.real * dspec.imag
                       - spec.imag * dspec.real) / power * fs / (2.0 * np.pi)

        k = np.round(harm[None, :] * f0s[sel][:, None]
                     * fft_size / fs).astype(np.int64)      # [G, H]
        ok = (k > 0) & (k < n_bins)
        kc = np.clip(k, 0, n_bins - 1)
        amps = np.sqrt(np.take_along_axis(power, kc, 1)) * ok
        ests = np.take_along_axis(inst, kc, 1) / harm
        wsum = amps.sum(axis=1)
        good = wsum > 0.0
        refined = np.where(good, (amps * ests).sum(axis=1)
                           / np.where(good, wsum, 1.0), 0.0)
        good &= (refined >= f0_floor) & (refined <= f0_ceil)
        safe_ref = np.where(good, refined, 1.0)
        deviation = np.sqrt((amps * (ests - refined[:, None]) ** 2)
                            .sum(axis=1) / np.where(good, wsum, 1.0)
                            ) / safe_ref
        out_f[sel] = np.where(good, refined, 0.0)
        out_s[sel] = np.where(good, np.maximum(0.0, 1.0 - deviation), 0.0)
    return out_f, out_s


def _runs(mask: np.ndarray):
    """[(start, stop)] of consecutive True runs."""
    padded = np.concatenate([[False], mask, [False]])
    starts = np.nonzero(padded[1:] & ~padded[:-1])[0]
    stops = np.nonzero(~padded[1:] & padded[:-1])[0]
    return list(zip(starts, stops))


def harvest(x: np.ndarray, fs: int, f0_floor: float = 71.0,
            f0_ceil: float = 800.0, frame_period: float = 5.0):
    """Harvest F0 estimation (parity: pyworld.harvest as called at
    upstream evaluate_tts.py:150).

    Returns ``(f0, temporal_positions)`` on the ``frame_period``-ms grid,
    with f0 = 0 on unvoiced frames.  Pipeline (Morise 2017): decimate to
    ~8 kHz; for ~60 log-spaced boundary channels, band-pass with a
    Nuttall-windowed filter and extract interval-based candidates from
    four zero-crossing event types on a 1-ms grid; collapse per-channel
    agreement runs into official candidates; refine each candidate by
    harmonic instantaneous frequency on the full-rate signal; prune by
    temporal consistency; pick best-scored contour; drop sub-9-ms voiced
    islands; extend segments through dropouts from the candidate pool;
    smooth voiced segments (zero-phase low-pass on the 1-ms grid).
    """
    x = np.asarray(x, np.float64)
    if len(x) == 0:
        return np.zeros(0), np.zeros(0)

    ratio = max(1, int(fs / 8000.0))
    y = _decimate(x - x.mean(), ratio)
    actual_fs = fs / ratio

    # 1-ms analysis grid
    n_1ms = int(1000.0 * len(x) / fs) + 1
    t_grid = np.arange(n_1ms) * 0.001

    num_ch = int(np.log2(f0_ceil / f0_floor) * 24.0) + 1
    boundary_f0 = f0_floor * 2.0 ** ((np.arange(num_ch) + 1) / 24.0)

    fft_size = int(2 ** np.ceil(np.log2(
        len(y) + int(round(actual_fs / boundary_f0[0] * 2)) * 4 + 2)))
    y_spec = np.fft.rfft(y, n=fft_size)

    per_channel = np.zeros((num_ch, n_1ms))
    for c, bf0 in enumerate(boundary_f0):
        half = int(round(actual_fs / bf0 * 2.0))
        tt = np.arange(-half, half + 1)
        lpf = _nuttall(2 * half + 1) * np.cos(2.0 * np.pi * bf0 * tt
                                              / actual_fs)
        filt_spec = np.fft.rfft(lpf, n=fft_size)
        filtered = np.fft.irfft(y_spec * filt_spec, n=fft_size)
        filtered = filtered[half:half + len(y)]      # compensate delay
        per_channel[c] = _channel_candidate(filtered, actual_fs, bf0,
                                            t_grid, f0_floor, f0_ceil)

    # official candidates: runs of >=2 agreeing adjacent channels
    cand_lists = [[] for _ in range(n_1ms)]
    nz = per_channel > 0.0
    for t in range(n_1ms):
        for s, e in _runs(nz[:, t]):
            if e - s >= 2:
                cand_lists[t].append(per_channel[s:e, t].mean())
    # overlap +-2 neighbouring frames' candidates
    pooled = [sorted(set(
        v for tt in range(max(0, t - 2), min(n_1ms, t + 3))
        for v in cand_lists[tt])) for t in range(n_1ms)]

    # refinement on the full-rate signal, batched by window length
    refined = np.zeros((n_1ms, max(1, max(len(p) for p in pooled))))
    scores = np.zeros_like(refined)
    flat_rows = np.array([t for t in range(n_1ms)
                          for _ in pooled[t]], np.int64)
    flat_cols = np.array([j for t in range(n_1ms)
                          for j in range(len(pooled[t]))], np.int64)
    if len(flat_rows):
        flat_f0, flat_sc = _refine_f0_batch(
            x, fs, t_grid[flat_rows],
            np.array([c for p in pooled for c in p]), f0_floor, f0_ceil)
        refined[flat_rows, flat_cols] = flat_f0
        scores[flat_rows, flat_cols] = flat_sc

    # temporal-consistency pruning (WORLD RemoveUnreliableCandidates):
    # a candidate with no close (<5%) counterpart in a neighbour frame
    # is unreliable
    for t in range(n_1ms):
        lo = refined[max(0, t - 1)]
        hi = refined[min(n_1ms - 1, t + 1)]
        for j in range(refined.shape[1]):
            v = refined[t, j]
            if v <= 0.0:
                continue
            close = lambda arr: np.any((arr > 0)
                                       & (np.abs(arr / v - 1.0) < 0.05))
            if not (close(lo) or close(hi)):
                scores[t, j] = 0.0

    best = np.argmax(scores, axis=1)
    base_f0 = refined[np.arange(n_1ms), best]
    base_f0[scores[np.arange(n_1ms), best] < 0.25] = 0.0

    # fix step 1: break on >18% jumps between adjacent voiced frames
    for t in range(1, n_1ms):
        if base_f0[t] > 0 and base_f0[t - 1] > 0 and \
                abs(base_f0[t] / base_f0[t - 1] - 1.0) > 0.18:
            base_f0[t] = 0.0
    # fix step 2: drop voiced islands shorter than 9 ms
    for s, e in _runs(base_f0 > 0):
        if e - s < 9:
            base_f0[s:e] = 0.0

    # fix step 3/4: bridge dropout gaps between voiced segments from the
    # candidate pool — a gap is filled only when a forward walk from the
    # left segment and a backward walk from the right segment both cross
    # it (each step to the nearest candidate within 18% of the previous
    # value) AND the two walks agree, so isolated noise between segments
    # is never voiced by extension
    def _walk(start_value, frames):
        values, prev = [], start_value
        for t in frames:
            cands = refined[t]
            ok = (cands > 0) & (np.abs(cands / prev - 1.0) < 0.18)
            if not ok.any():
                return None
            prev = cands[ok][np.argmin(np.abs(cands[ok] - prev))]
            values.append(prev)
        return np.asarray(values)

    fixed = base_f0.copy()
    segs = _runs(fixed > 0)
    for (s1, e1), (s2, _) in zip(segs[:-1], segs[1:]):
        if s2 - e1 > 100:          # bridge at most 100 ms
            continue
        fwd = _walk(fixed[e1 - 1], range(e1, s2))
        bwd = _walk(fixed[s2], range(s2 - 1, e1 - 1, -1))
        if fwd is None or bwd is None:
            continue
        bwd = bwd[::-1]
        if np.all(np.abs(fwd / bwd - 1.0) < 0.18):
            fixed[e1:s2] = 0.5 * (fwd + bwd)

    # smoothing: zero-phase 2nd-order low-pass on each voiced segment
    try:
        from scipy import signal
        b, a = signal.butter(2, 30.0, fs=1000.0)
        for s, e in _runs(fixed > 0):
            if e - s > 12:
                pad = min(e - s - 1, 300)
                fixed[s:e] = signal.filtfilt(b, a, fixed[s:e],
                                             padlen=pad)
    except ImportError:
        pass

    # resample the 1-ms contour to the requested frame period
    n_out = int(1000.0 * len(x) / fs / frame_period) + 1
    temporal_positions = np.arange(n_out) * frame_period / 1000.0
    src = np.minimum(np.round(temporal_positions * 1000.0).astype(int),
                     n_1ms - 1)
    return fixed[src], temporal_positions
