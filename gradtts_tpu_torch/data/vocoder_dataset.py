"""HiFi-GAN training data: waveform segments and their mels.

Counterpart of gradtts_tpu/data/vocoder_dataset.py: ``vocoder_filelists``
(:29), ``_peak_normalize`` (:40), ``VocoderMelDataset`` (:48-145) and
``VocoderBatchCollate`` (:148). Items are numpy arrays cropped or padded to
``segment_size`` samples, so every batch has one shape. A crop offset is
drawn from ``np.random.default_rng((seed, index, call))``, ``call`` counting
the calls of ``__getitem__`` under a lock (the loader's threads share the
dataset), so the port's items equal the JAX package's draw for draw. The
loss mel uses ``fmax_loss``, ``sampling_rate / 2`` when None.
"""

import math
import os
import threading
from typing import Optional, Sequence

import numpy as np

from gradtts_tpu_torch.data.dataset import load_wav
from gradtts_tpu_torch.data.mel import mel_spectrogram_np


def vocoder_filelists(input_training_file, input_validation_file,
                      input_wavs_dir):
    """``name|text`` filelists -> (training wav paths, validation wav
    paths), each ``input_wavs_dir/name.wav``."""
    def read(path):
        with open(path, encoding='utf-8') as f:
            return [os.path.join(input_wavs_dir, ln.split('|')[0] + '.wav')
                    for ln in f.read().split('\n') if ln]
    return read(input_training_file), read(input_validation_file)


def _peak_normalize(audio, headroom=0.95):
    """``audio`` scaled so its peak is ``headroom`` (silence stays 0)."""
    peak = np.max(np.abs(audio))
    if peak > 0:
        audio = audio / peak
    return audio * headroom


class VocoderMelDataset:
    """wav files -> {'mel' [F, M], 'audio' [S], 'mel_loss' [F, M]}.

    ``split=True`` crops or zero-pads the peak-normalized audio to
    ``segment_size`` samples. ``fine_tuning=True`` reads the generator's
    input mels from ``base_mels_path/<stem>.npy`` ([M, F] or [1, M, F] as
    the reference dumps them, or [F, M]) and crops audio and mel at one
    frame offset; its audio is not normalized."""

    def __init__(self, training_files: Sequence[str], segment_size=8192,
                 n_fft=1024, num_mels=80, hop_size=256, win_size=1024,
                 sampling_rate=22050, fmin=0.0, fmax=8000.0,
                 fmax_loss: Optional[float] = None, split=True, shuffle=True,
                 seed=1234, fine_tuning=False,
                 base_mels_path: Optional[str] = None):
        self.audio_files = list(training_files)
        self.seed = seed
        if shuffle:
            np.random.default_rng(seed).shuffle(self.audio_files)
        self._lock = threading.Lock()
        self._calls = 0
        self.segment_size = segment_size
        self.n_fft, self.num_mels = n_fft, num_mels
        self.hop_size, self.win_size = hop_size, win_size
        self.sampling_rate, self.fmin, self.fmax = sampling_rate, fmin, fmax
        self.fmax_loss = sampling_rate / 2.0 if fmax_loss is None \
            else fmax_loss
        self.split = split
        self.fine_tuning = fine_tuning
        self.base_mels_path = base_mels_path

    def __len__(self):
        return len(self.audio_files)

    def _mel(self, audio, fmax):
        return mel_spectrogram_np(
            audio[None], n_fft=self.n_fft, num_mels=self.num_mels,
            sampling_rate=self.sampling_rate, hop_size=self.hop_size,
            win_size=self.win_size, fmin=self.fmin, fmax=fmax)[0]

    def _item_rng(self, index):
        with self._lock:
            n = self._calls
            self._calls += 1
        return np.random.default_rng((self.seed, index, n))

    def __getitem__(self, index):
        rng = self._item_rng(index)
        filename = self.audio_files[index]
        audio, sr = load_wav(filename)
        if sr != self.sampling_rate:
            raise ValueError(f'{filename}: {sr} != {self.sampling_rate}')
        if not self.fine_tuning:
            audio = _peak_normalize(audio)
            if self.split:
                if len(audio) >= self.segment_size:
                    start = int(rng.integers(
                        0, len(audio) - self.segment_size + 1))
                    audio = audio[start:start + self.segment_size]
                else:
                    audio = np.pad(audio,
                                   (0, self.segment_size - len(audio)))
            mel = self._mel(audio, self.fmax)
        else:
            stem = os.path.splitext(os.path.basename(filename))[0]
            mel = np.load(os.path.join(self.base_mels_path, stem + '.npy'))
            if mel.ndim == 3:
                mel = mel[0]
            if mel.shape[0] == self.num_mels:          # [M, F] -> [F, M]
                mel = mel.T
            mel = np.ascontiguousarray(mel, np.float32)
            if self.split:
                frames = math.ceil(self.segment_size / self.hop_size)
                if len(audio) >= self.segment_size:
                    hi = mel.shape[0] - frames - 1
                    ms = int(rng.integers(0, max(hi, 0) + 1))
                    mel = mel[ms:ms + frames]
                    audio = audio[ms * self.hop_size:
                                  (ms + frames) * self.hop_size]
                if mel.shape[0] < frames:
                    mel = np.pad(mel, ((0, frames - mel.shape[0]), (0, 0)))
                if len(audio) < self.segment_size:
                    audio = np.pad(audio,
                                   (0, self.segment_size - len(audio)))
        mel_loss = self._mel(audio, self.fmax_loss)
        return {'mel': mel.astype(np.float32),
                'audio': audio.astype(np.float32),
                'mel_loss': mel_loss.astype(np.float32)}


class VocoderBatchCollate:
    """Stacks same-shape items into {'mel' [B, F, M], 'audio' [B, S],
    'mel_loss' [B, F, M]}."""

    def __call__(self, batch):
        return {k: np.stack([b[k] for b in batch])
                for k in ('mel', 'audio', 'mel_loss')}
