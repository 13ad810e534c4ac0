"""``train.remat_estimator``: ``compute_loss(remat=True)`` keeps none of
the U-Net's activations and runs its forward again in the backward (the
autograd Functions of K1-K3 included). It changes memory, not math: the
losses and every gradient equal the plain step's, on the CPU bit for bit
(held to 1e-6 of the largest), and match the JAX package's
``compute_loss(remat=True)``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (CMUDICT, TINY_SET, jax_model_and_params,
                         torch_model, write_corpus)
from gradtts_tpu.models.tts import compute_loss as jax_compute_loss
from gradtts_tpu_torch.cli.train import main as train_main
from gradtts_tpu_torch.config import get_config
from gradtts_tpu_torch.models.tts import compute_loss, set_compute_dtype
from gradtts_tpu_torch.train.loop import train
from gradtts_tpu_torch.utils.convert import flax_params_to_state_dict
from test_torch_train import OUT_SIZE, _batch, _jax_draws


@pytest.fixture(scope='module')
def tiny():
    return jax_model_and_params(seed=31)


def _loss_and_grads(model, batch, draws, remat, spk=None):
    """compute_loss in train() mode (dropout from a generator seeded 0) and
    its backward: (the three losses, {name: grad})."""
    model.zero_grad(set_to_none=True)
    x, xl, y, yl = (torch.from_numpy(a) for a in batch)
    offset, t, z = (torch.from_numpy(a.copy()) for a in draws)
    res = compute_loss(model, x.long(), xl.long(), y, yl.long(),
                       out_size=OUT_SIZE, offset=offset.long(), t=t, z=z,
                       generator=torch.Generator().manual_seed(0), spk=spk,
                       remat=remat)
    (res.dur_loss + res.prior_loss + res.diff_loss).backward()
    return ([float(v.detach()) for v in res[:3]],
            {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None})


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('speakers', [False, True])
def test_remat_grads_equal_the_plain_step(dtype, speakers):
    """f32 and bf16 compute (the recompute keeps the first forward's
    dtype), with and without a speaker table (the speaker MLP inside the
    U-Net then takes its grads through the recompute)."""
    overrides = dict(n_spks=5, spk_emb_dim=16) if speakers else {}
    _, params = jax_model_and_params(seed=32, **overrides)
    model = set_compute_dtype(torch_model(params, **overrides).train(),
                              dtype)
    batch = _batch(33)
    draws = _jax_draws(jax.random.PRNGKey(34), batch[3])
    spk = torch.tensor([4, 0, 2]) if speakers else None
    plain_losses, plain = _loss_and_grads(model, batch, draws, False, spk)
    remat_losses, remat = _loss_and_grads(model, batch, draws, True, spk)
    assert remat_losses == pytest.approx(plain_losses, rel=1e-6)
    assert set(remat) == set(plain) == {n for n, _ in
                                        model.named_parameters()}
    largest = max(float(g.abs().max()) for g in plain.values())
    for name, g in plain.items():
        torch.testing.assert_close(remat[name], g, rtol=0,
                                   atol=1e-6 * largest, msg=name)


def test_remat_grads_match_jax_remat(tiny):
    """Against the JAX package's compute_loss(remat=True) (jax.checkpoint
    around the U-Net), with the JAX draws; the bounds of
    tests/test_torch_train.py (f32 both sides, sums in other orders)."""
    jmodel, params = tiny
    batch = _batch(36)
    key = jax.random.PRNGKey(37)
    x, xl, y, yl = map(jnp.asarray, batch)

    def loss_fn(p):
        res = jax_compute_loss(jmodel, p, key, x, xl, y, yl,
                               out_size=OUT_SIZE, train=False,
                               dropout_key=None, fused_attention=False,
                               remat=True)
        return res.dur_loss + res.prior_loss + res.diff_loss, res

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    model = torch_model(params)                   # eval(): no dropout
    losses, grads = _loss_and_grads(model, batch, _jax_draws(key, batch[3]),
                                    True)
    np.testing.assert_allclose(
        losses, [float(want.dur_loss), float(want.prior_loss),
                 float(want.diff_loss)], rtol=1e-5)
    want_grads = flax_params_to_state_dict(jax.device_get(jgrads))
    largest = max(float(w.abs().max()) for w in want_grads.values())
    for name, w in want_grads.items():
        g = grads.get(name, torch.zeros_like(w))
        if name.endswith('conv_k.bias'):      # an exact grad of zero
            assert float(g.abs().max()) < 1e-8 * largest, name
            continue
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=2e-4 * float(w.abs().max()),
                                   msg=name)


def _loader():
    x, xl, y, yl = _batch(38)
    return [{'x': x, 'x_lengths': xl, 'y': y, 'y_lengths': yl}]


def test_train_with_remat_estimator_takes_the_plain_steps(tmp_path):
    """Two steps of ``train`` with train.remat_estimator=True end on the
    plain run's weights."""
    overrides = {k: int(v) for k, v in (s.split('=') for s in TINY_SET)}
    results = []
    for remat in (False, True):
        cfg = get_config('ljspeech', **overrides, **{
            'train.use_bf16_compute': False, 'train.remat_estimator': remat,
            'data.x_buckets': (64,), 'data.y_buckets': (64,)})
        results.append(train(cfg, n_epochs=2, log_dir=str(tmp_path / str(
            remat)), loader=_loader(), device='cpu').model.state_dict())
    plain, remat = results
    for name, w in plain.items():
        torch.testing.assert_close(remat[name], w, rtol=0, atol=1e-7,
                                   msg=name)


def test_train_cli_takes_remat_estimator(tmp_path):
    log_dir = tmp_path / 'logs'
    res = train_main([
        '--cpu', '--max-steps', '1', '--log-dir', str(log_dir),
        '--batch-size', '2', '--no-previews', '--set', *TINY_SET,
        f'data.cmudict_path={CMUDICT}',
        f'data.train_filelist_path={write_corpus(tmp_path, 4)}',
        'data.x_buckets=(64,)', 'data.y_buckets=(64,)',
        'train.use_bf16_compute=False', 'train.remat_estimator=True'])
    assert res.step == 1
    assert 'epoch 0:' in (log_dir / 'train.log').read_text()
    assert (log_dir / 'ckpt' / 'step_00000001.pt').exists()
