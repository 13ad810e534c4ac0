"""Configuration system: a single typed config tree with named presets.

Replaces the reference's three parallel ``params*.py`` modules selected by
editing import lines (reference params.py, params_tedlium.py,
params_tedlium_spk.py) with dataclasses + named presets + programmatic
overrides. All hyperparameters carry the same values as the reference presets
so trained behavior matches.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence, Tuple


def fix_len_compatibility(length: int, num_downsamplings_in_unet: int = 2) -> int:
    """Round ``length`` up to a multiple of 2**num_downsamplings (parity:
    reference model/utils.py:13-17)."""
    factor = 2 ** num_downsamplings_in_unet
    return ((length + factor - 1) // factor) * factor


def bucket_length(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length (last bucket if none fits); copy of
    gradtts_tpu/data/dataset.py:bucket_length."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


@dataclass(frozen=True)
class DataConfig:
    train_filelist_path: str = 'resources/filelists/ljspeech/train.txt'
    valid_filelist_path: str = 'resources/filelists/ljspeech/valid.txt'
    test_filelist_path: str = 'resources/filelists/ljspeech/test.txt'
    cmudict_path: str = 'resources/cmu_dictionary'
    # path to a tensor of pretrained speaker embeddings (zero-speaker mode)
    train_spk_path: Optional[str] = None
    valid_spk_path: Optional[str] = None
    test_spk_path: Optional[str] = None
    add_blank: bool = True
    n_feats: int = 80
    n_fft: int = 1024
    sample_rate: int = 22050
    hop_length: int = 256
    win_length: int = 1024
    f_min: float = 0.0
    f_max: float = 8000.0
    # Static-shape bucketing: sequence lengths are padded up to the nearest
    # bucket boundary so only a handful of shapes are ever run.
    x_buckets: Tuple[int, ...] = (64, 128, 192, 256, 384, 512)
    y_buckets: Tuple[int, ...] = (128, 256, 384, 512, 768, 1024, 1536, 2048)


@dataclass(frozen=True)
class EncoderConfig:
    n_enc_channels: int = 192
    filter_channels: int = 768
    filter_channels_dp: int = 256
    n_enc_layers: int = 6
    enc_kernel: int = 3
    enc_dropout: float = 0.1
    n_heads: int = 2
    window_size: int = 4


@dataclass(frozen=True)
class DecoderConfig:
    dec_dim: int = 64
    beta_min: float = 0.05
    beta_max: float = 20.0
    pe_scale: float = 1000.0  # 1 for the legacy `grad-tts-old` checkpoint


@dataclass(frozen=True)
class TrainConfig:
    log_dir: str = 'logs/new_exp'
    test_size: int = 4
    n_epochs: int = 10000
    batch_size: int = 16
    learning_rate: float = 1e-4
    seed: int = 37
    save_every: int = 1
    # Training crops mels to ~2 s of audio; derived in __post_init__ users
    # should read `out_size` from GradTTSConfig.
    # Mesh axes for distribution. data: batch sharding (psum grads over ICI);
    # model: optional tensor-parallel axis for the U-Net.
    mesh_data: int = -1   # -1 = all available devices
    mesh_model: int = 1
    grad_clip_norm: float = 1.0  # applied per submodule (encoder / decoder)
    use_bf16_compute: bool = True
    # The training fields mirror gradtts_tpu.config so that a preset reads
    # the same in both packages. The port's trainer (train/loop.py) runs
    # one process a GPU: mesh_data must be the process count (torchrun
    # --nproc-per-node) or -1, and mesh_model above 1 (tensor parallelism)
    # is refused. remat_estimator recomputes the U-Net's forward in the
    # backward pass (less memory, the same gradients). device_mel True
    # computes the mels on the trainer's device, False on the host; None
    # picks the device on a GPU in one process and the host on the CPU.
    remat_estimator: bool = False
    device_mel: Optional[bool] = None


@dataclass(frozen=True)
class GradTTSConfig:
    name: str = 'ljspeech'
    # n_spks semantics (parity with reference):
    #   1  -> single speaker, no conditioning
    #   >1 -> learned speaker-id embedding table of that size
    #   -1 -> external pretrained speaker embedding vectors (zero-speaker)
    n_spks: int = 1
    spk_emb_dim: int = 64
    # False = fork wiring (decoder-only speaker conditioning, tts.py:49-51);
    # True = upstream wiring (speaker embedding concat into the encoder
    # after the prenet) — required by upstream multi-speaker checkpoints
    # such as grad-tts-libri-tts.pt (SURVEY.md §3).
    encoder_speaker: bool = False
    data: DataConfig = field(default_factory=DataConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    @property
    def n_vocab(self) -> int:
        from gradtts_tpu_torch.text.symbols import symbols
        return len(symbols) + 1  # +1 for interspersed blank

    @property
    def out_size(self) -> int:
        """Training crop length in mel frames (~2 s of audio)."""
        return fix_len_compatibility(2 * self.data.sample_rate // self.data.hop_length)


def _ljspeech() -> GradTTSConfig:
    return GradTTSConfig(name='ljspeech', n_spks=1)


def _libri_tts() -> GradTTSConfig:
    # parity: reference params.py (n_spks=247 for the Libri-TTS filelist)
    return GradTTSConfig(
        name='libri-tts', n_spks=247, spk_emb_dim=64,
        data=DataConfig(
            train_filelist_path='resources/filelists/libri-tts/train.txt',
            valid_filelist_path='resources/filelists/libri-tts/valid.txt',
            test_filelist_path='resources/filelists/libri-tts/test.txt',
            sample_rate=24000,
        ),
    )


def _tedlium() -> GradTTSConfig:
    # parity: reference params_tedlium.py (zero-speaker, ECAPA 192-d)
    return GradTTSConfig(
        name='tedlium', n_spks=-1, spk_emb_dim=192,
        data=DataConfig(
            train_filelist_path='resources/filelists/tedlium/train.txt',
            valid_filelist_path='resources/filelists/tedlium/dev.txt',
            test_filelist_path='resources/filelists/tedlium/test.txt',
            sample_rate=16000,
        ),
        train=TrainConfig(log_dir='logs/tedlium/zero_spk', n_epochs=50, seed=1),
    )


def _tedlium_spk() -> GradTTSConfig:
    # parity: reference params_tedlium_spk.py (speaker-id table)
    return GradTTSConfig(
        name='tedlium-spk', n_spks=675, spk_emb_dim=128,
        data=DataConfig(
            train_filelist_path='resources/filelists/tedlium_speaker/train.txt',
            valid_filelist_path='resources/filelists/tedlium_speaker/dev.txt',
            test_filelist_path='resources/filelists/tedlium_speaker/test.txt',
            sample_rate=16000,
        ),
        train=TrainConfig(log_dir='logs/tedlium/spk_id', n_epochs=50, seed=1),
    )


PRESETS = {
    'ljspeech': _ljspeech,
    'libri-tts': _libri_tts,
    'tedlium': _tedlium,
    'tedlium-spk': _tedlium_spk,
}


def get_config(preset: str = 'ljspeech', **overrides) -> GradTTSConfig:
    """Build a config from a named preset with optional field overrides.

    Overrides may address nested fields with dotted keys, e.g.
    ``get_config('ljspeech', **{'train.batch_size': 8})``.
    """
    if preset not in PRESETS:
        raise KeyError(f'unknown preset {preset!r}; choose from {sorted(PRESETS)}')
    cfg = PRESETS[preset]()
    flat = {k: v for k, v in overrides.items() if '.' not in k}
    nested = {}
    for k, v in overrides.items():
        if '.' in k:
            head, tail = k.split('.', 1)
            nested.setdefault(head, {})[tail] = v
    if flat:
        cfg = replace(cfg, **flat)
    for head, sub in nested.items():
        cfg = replace(cfg, **{head: replace(getattr(cfg, head), **sub)})
    return cfg


def config_to_dict(cfg: GradTTSConfig) -> dict:
    return dataclasses.asdict(cfg)
