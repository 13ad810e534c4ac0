"""What the Grad-TTS drives share: the program's preset held to the
configuration, the seeded weights of both sides (with the duration bias and
the score U-Net's output gain), the reference model built from the
configuration's reference file, the U-Net's kernel bounds, the control's
precision, and the names of the program's spans that they and their metric
files read (each one of the program's ``utils/profiling.py SPANS``).
"""

import torch

from benchmark import counting, drives, traffic, weights

# the program's spans: a call's root of each drive, and its stages
SYNTHESIZE = 'gradtts.synthesize'
SCORE = 'gradtts.score'
TRAIN_STEP = 'gradtts.train_step'
ENCODER = 'gradtts.encoder'
ALIGN = 'gradtts.align'
UNET = 'gradtts.unet'
K1_TANGENT = 'gradtts.unet.k1_tangent'
BACKWARD = 'gradtts.train.backward'
OPTIMIZER = 'gradtts.train.optimizer'
VOCODER = 'gradtts.vocoder'

# configuration keys and where the program's preset holds each
PORT_KEYS = {
    'n_vocab': 'n_vocab', 'n_spks': 'n_spks', 'spk_emb_dim': 'spk_emb_dim',
    'n_enc_channels': 'encoder.n_enc_channels',
    'filter_channels': 'encoder.filter_channels',
    'filter_channels_dp': 'encoder.filter_channels_dp',
    'n_heads': 'encoder.n_heads', 'n_enc_layers': 'encoder.n_enc_layers',
    'enc_kernel': 'encoder.enc_kernel', 'window_size': 'encoder.window_size',
    'enc_dropout': 'encoder.enc_dropout', 'n_feats': 'data.n_feats',
    'sample_rate': 'data.sample_rate', 'hop_length': 'data.hop_length',
    'x_buckets': 'data.x_buckets', 'y_buckets': 'data.y_buckets',
    'dec_dim': 'decoder.dec_dim', 'beta_min': 'decoder.beta_min',
    'beta_max': 'decoder.beta_max', 'pe_scale': 'decoder.pe_scale',
    'learning_rate': 'train.learning_rate',
    'grad_clip_norm': 'train.grad_clip_norm', 'out_size': 'out_size',
}
SCORE_OUTPUT = ('decoder.estimator.final_conv.weight',
                'decoder.estimator.final_conv.bias')
SAMPLE_ROWS = 8


def _get(obj, path):
    for part in path.split('.'):
        obj = getattr(obj, part)
    return obj


def port_config(cfg, sizes):
    """The program's preset ``cfg['preset']`` with ``sizes`` (configuration
    keys, set in tests only) applied; raises if any configuration key
    differs from the preset's value."""
    from gradtts_tpu_torch.config import get_config
    over = {PORT_KEYS[k]: (tuple(v) if isinstance(v, list) else v)
            for k, v in sizes.items() if k in PORT_KEYS}
    pc = get_config(cfg['preset'], **over)
    diff = {k: (cfg[k], _get(pc, p)) for k, p in PORT_KEYS.items()
            if (tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k])
            != _get(pc, p)}
    if diff:
        raise RuntimeError(f'the program\'s preset {cfg["preset"]!r} differs '
                           f'from the configuration file: {diff}')
    return pc


class GradTTSDrive(drives.Drive):
    """A cell of the program's Grad-TTS model: the reference is the
    configuration's reference file's ``GradTTS``."""

    def __init__(self, cfg, tr, seed, device):
        super().__init__(cfg, tr, seed, device)
        self.reference = self.ref.GradTTS(cfg)

    def state_dict(self):
        """The seeded weights of both sides. A traffic's
        ``score_output_gain`` scales the score U-Net's output conv (see
        ``weights.py``)."""
        fixed = {'encoder.proj_w.proj.bias': self.cfg['duration_log_bias']}
        sd = weights.seeded_state_dict(weights.shapes_of(self.reference),
                                       self.weight_seed, self.device, fixed)
        gain = self.tr.get('score_output_gain', 1.0)
        for name in SCORE_OUTPUT:
            sd[name] *= gain
        return sd

    def program_model(self, sizes):
        from gradtts_tpu_torch.models.tts import GradTTS, set_compute_dtype
        with torch.device(self.device):
            model = GradTTS.from_config(port_config(self.cfg, sizes))
        model.load_state_dict(self.state_dict(), strict=True)
        return set_compute_dtype(model, self.dtype)

    def prepare(self):
        """The cell's inputs, from the seed (no program involved)."""
        self.inputs = traffic.make_inputs(self.tr, self.cfg, self.input_seed,
                                          self.device)

    def reference_model(self):
        model = self.reference.to(self.device)
        model.load_state_dict(self.state_dict(), strict=True)
        return model

    def meta_reference(self):
        return counting.meta_model(lambda: self.ref.GradTTS(self.cfg))

    def low_precision(self, model, on):
        """fp8 operands (``reference/lowp.py``) for a bf16 configuration,
        TF32 for an f32 one."""
        if self.cfg['precision'] == 'bfloat16':
            self.ref.set_precision(model, 'fp8' if on else None)
        else:
            torch.backends.cuda.matmul.allow_tf32 = on
            torch.backends.cudnn.allow_tf32 = on


def unet_bounds(cfg, B, T, attention, calls, conv_passes=1):
    """{family: least seconds} of ``calls`` U-Net passes at [B, T]: K1, the
    attention families ``attention`` and, in f32 (the only precision that
    runs the Block convolution's kernel), ``conv_passes`` times the 25
    Block convolutions a pass (2 in forward mode: primal and tangent)."""
    out = {'K1': counting.kernel_bound_s((), B, cfg['n_feats'], T,
                                         cfg['dec_dim'], cfg['precision'],
                                         calls)}
    for k in attention:
        out[k] = counting.kernel_bound_s((k,), B, cfg['n_feats'], T,
                                         cfg['dec_dim'], cfg['precision'],
                                         calls) - out['K1']
    if cfg['precision'] == 'float32':
        out['conv3x3'] = conv_passes * counting.conv3x3_bound_s(
            B, cfg['n_feats'], T, cfg['dec_dim'], cfg['n_spks'], calls)
    return out
