"""HiFi-GAN training: the GAN step (MPD + MSD + mel L1) on one device.

Counterpart of gradtts_tpu/train/vocoder.py:42-162, the upstream HiFi-GAN
recipe: AdamW (lr 2e-4, betas (0.8, 0.99), weight decay 0.01) with the
learning rate decayed 0.999 an epoch, as a per-step staircase; a
discriminator step on the detached generator output, then a generator step
against the updated discriminators with the adversarial, 2 x feature
matching and 45 x mel L1 losses. The loss mel is computed on the device
from the generated audio (``data.mel.mel_spectrogram``, differentiable)
with ``fmax_loss``, ``sampling_rate / 2`` when unset. Everything is f32,
as in the JAX package. The generator's forward runs once a step: its
weights do not change between the two phases.
"""

from dataclasses import dataclass
from typing import Optional

import torch

from gradtts_tpu_torch.data.mel import mel_spectrogram
from gradtts_tpu_torch.models.hifigan import (
    Generator, HiFiGANConfig, MultiPeriodDiscriminator,
    MultiScaleDiscriminator, discriminator_loss, feature_loss,
    generator_loss)

METRICS = ('loss/disc_total', 'loss/disc_mpd', 'loss/disc_msd',
           'loss/gen_total', 'loss/gen_mel', 'loss/gen_fm', 'loss/gen_adv')


def make_vocoder_optimizer(params, learning_rate=2e-4, betas=(0.8, 0.99),
                           lr_decay=0.999, steps_per_epoch=1000,
                           weight_decay=0.01):
    """(AdamW, its schedule). Call the schedule's ``step()`` after each
    ``optimizer.step()``: optimizer step k (from 0) then runs at
    ``learning_rate * lr_decay ** (k // steps_per_epoch)``, optax's
    ``exponential_decay(staircase=True)`` of the JAX package (:42)."""
    opt = torch.optim.AdamW(params, lr=learning_rate, betas=tuple(betas),
                            eps=1e-8, weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda k: lr_decay ** (k // steps_per_epoch))
    return opt, sched


@dataclass
class VocoderState:
    """The generator, the two discriminators, their optimizers and
    schedules (one AdamW over MPD and MSD together) and the step."""
    generator: Generator
    mpd: MultiPeriodDiscriminator
    msd: MultiScaleDiscriminator
    gen_opt: torch.optim.Optimizer
    disc_opt: torch.optim.Optimizer
    gen_sched: torch.optim.lr_scheduler.LRScheduler
    disc_sched: torch.optim.lr_scheduler.LRScheduler
    step: int = 0

    def payload(self) -> dict:
        """The checkpoint payload: 'generator' is a plain-weight
        ``state_dict`` with the reference's keys."""
        return {'generator': self.generator.state_dict(),
                'mpd': self.mpd.state_dict(), 'msd': self.msd.state_dict(),
                'gen_opt': self.gen_opt.state_dict(),
                'disc_opt': self.disc_opt.state_dict(),
                'gen_sched': self.gen_sched.state_dict(),
                'disc_sched': self.disc_sched.state_dict()}

    def load_payload(self, payload: dict):
        for name in ('generator', 'mpd', 'msd', 'gen_opt', 'disc_opt',
                     'gen_sched', 'disc_sched'):
            getattr(self, name).load_state_dict(payload[name])
        self.step = int(payload['step'])


def init_vocoder_state(cfg: HiFiGANConfig, device, steps_per_epoch: int,
                       seed: int = 1234, generator_state: Optional[dict] = None,
                       learning_rate: Optional[float] = None,
                       lr_decay: Optional[float] = None) -> VocoderState:
    """Generator and discriminators with weights drawn from ``seed`` (the
    generator's from ``generator_state``, a plain-weight ``state_dict``,
    where given) on ``device``, and their optimizers; the learning rate
    and its decay default to ``cfg``'s."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        generator = Generator(cfg)
        mpd = MultiPeriodDiscriminator()
        msd = MultiScaleDiscriminator()
    if generator_state is not None:
        generator.load_state_dict(generator_state, strict=True)
    generator, mpd, msd = (m.to(device).train() for m in (generator, mpd, msd))
    kw = dict(learning_rate=learning_rate or cfg.learning_rate,
              betas=(cfg.adam_b1, cfg.adam_b2),
              lr_decay=lr_decay or cfg.lr_decay,
              steps_per_epoch=steps_per_epoch)
    gen_opt, gen_sched = make_vocoder_optimizer(generator.parameters(), **kw)
    disc_opt, disc_sched = make_vocoder_optimizer(
        list(mpd.parameters()) + list(msd.parameters()), **kw)
    return VocoderState(generator, mpd, msd, gen_opt, disc_opt, gen_sched,
                        disc_sched)


def make_vocoder_train_step(cfg: HiFiGANConfig):
    """Returns ``step(state, batch) -> metrics``: one GAN update of
    ``state`` in place on ``batch`` ({'mel' [B, F, M], 'audio' [B, S],
    'mel_loss' [B, F, M]} tensors on the state's device). The metrics are
    the JAX step's seven (``METRICS``) as 0-d tensors, not fetched. The
    loss mel takes ``cfg``'s settings."""
    mel_kw = dict(n_fft=cfg.n_fft, num_mels=cfg.num_mels,
                  sampling_rate=cfg.sampling_rate, hop_size=cfg.hop_size,
                  win_size=cfg.win_size, fmin=cfg.fmin,
                  fmax=cfg.sampling_rate / 2.0 if cfg.fmax_loss is None
                  else cfg.fmax_loss)

    def step(state: VocoderState, batch: dict) -> dict:
        y = batch['audio']
        y_g = state.generator(batch['mel'])

        # 1-2: the discriminators on the detached generator output
        state.disc_opt.zero_grad(set_to_none=True)
        p_r, p_g, _, _ = state.mpd(y, y_g.detach())
        d_p, _, _ = discriminator_loss(p_r, p_g)
        s_r, s_g, _, _ = state.msd(y, y_g.detach())
        d_s, _, _ = discriminator_loss(s_r, s_g)
        d_total = d_p + d_s
        d_total.backward()
        state.disc_opt.step()
        state.disc_sched.step()

        # 3-4: the generator against the updated discriminators, whose
        # weights take no gradient here
        disc_params = [p for group in state.disc_opt.param_groups
                       for p in group['params']]
        state.gen_opt.zero_grad(set_to_none=True)
        for p in disc_params:
            p.requires_grad_(False)
        try:
            l_mel = torch.mean(torch.abs(
                batch['mel_loss'] - mel_spectrogram(y_g, **mel_kw))) * 45.0
            _, p_g, fmap_pr, fmap_pg = state.mpd(y, y_g)
            _, s_g, fmap_sr, fmap_sg = state.msd(y, y_g)
            l_fm = feature_loss(fmap_pr, fmap_pg) \
                + feature_loss(fmap_sr, fmap_sg)
            l_adv = generator_loss(p_g)[0] + generator_loss(s_g)[0]
            g_total = l_adv + l_fm + l_mel
            g_total.backward()
        finally:
            for p in disc_params:
                p.requires_grad_(True)
        state.gen_opt.step()
        state.gen_sched.step()
        state.step += 1
        values = (d_total, d_p, d_s, g_total, l_mel, l_fm, l_adv)
        return {k: v.detach() for k, v in zip(METRICS, values)}

    return step
