"""The port's speaker set-ups against the JAX package's on the tiny seeded
model: a speaker-id table (``n_spks`` 5), external speaker vectors
(``n_spks`` -1) and the upstream encoder-side concat (``encoder_speaker``),
each through the encoder, the estimator, synthesis, ``compute_loss`` with
its grads and ``score_batch``; the vector-independence quirk of ``n_spks``
-1; ``detect_encoder_speaker``; the speaker datasets, ``transform_txt``
and the collated ``spk``; and the training and n-best CLIs on a speaker
corpus."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gradtts_tpu.data.dataset as jds
import gradtts_tpu_torch.data.dataset as tds
from _torch_port import (CMUDICT, TINY_SET, JaxGradTTS, jax_model_and_params,
                         text_batch, torch_model, write_corpus)
from gradtts_tpu.config import get_config as jax_get_config
from gradtts_tpu.models import synthesize as jax_synthesize
from gradtts_tpu.models.tts import compute_loss as jax_compute_loss
from gradtts_tpu.nbest.scoring import score_batch as jax_score_batch
from gradtts_tpu.utils.convert import \
    detect_encoder_speaker as jax_detect_encoder_speaker
from gradtts_tpu.utils.convert import gradtts_torch_to_flax
from gradtts_tpu_torch.cli.nbest import main as nbest_main
from gradtts_tpu_torch.cli.train import main as train_main
from gradtts_tpu_torch.config import get_config
from gradtts_tpu_torch.models.tts import (GradTTS, compute_loss,
                                          synthesize)
from gradtts_tpu_torch.nbest import make_synthetic_n_best, save_n_best
from gradtts_tpu_torch.nbest.scoring import score_batch
from gradtts_tpu_torch.utils.convert import (detect_encoder_speaker,
                                             flax_params_to_state_dict)

D = 8                                      # speaker embedding width
SETUPS = {'ids': dict(n_spks=5, spk_emb_dim=D),
          'vectors': dict(n_spks=-1, spk_emb_dim=D),
          'encoder': dict(n_spks=5, spk_emb_dim=D, encoder_speaker=True)}
OUT_SIZE, Y_MAX = 32, 64


def _spk(setup, seed=0):
    if SETUPS[setup]['n_spks'] > 1:
        return np.array([3, 1], np.int32)
    return np.random.default_rng(seed).standard_normal((2, D)).astype(
        np.float32)


def _t(a):
    t = torch.from_numpy(np.array(a))
    return t.long() if not t.is_floating_point() else t


@pytest.fixture(scope='module', params=list(SETUPS))
def case(request):
    hp = SETUPS[request.param]
    jmodel, params = jax_model_and_params(seed=41, **hp)
    return request.param, jmodel, params, torch_model(params, **hp)


def test_encoder_matches_jax(case):
    setup, jmodel, params, model = case
    x, xl = text_batch(42, (16, 11))
    spk = _spk(setup)
    mu, logw, x_mask, _ = jax.jit(lambda p, *a: jmodel.apply(
        p, *a, method=JaxGradTTS.encode))(params, x, xl, spk)
    with torch.no_grad():
        tmu, tlogw, tmask = model.encode(
            _t(x), _t(xl), spk_vec=model.embed_speaker(_t(spk)))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(x_mask))
    # test_torch_text_encoder.py's tolerance
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tlogw.numpy(), np.asarray(logw), rtol=1e-5,
                               atol=1e-5)
    if setup == 'encoder':                  # the speaker reaches mu_x
        with torch.no_grad():
            other = model.encode(_t(x), _t(xl), spk_vec=model.embed_speaker(
                _t(spk[::-1].copy())))[0]
        assert not torch.equal(other, tmu)


def test_estimator_matches_jax(case):
    setup, jmodel, params, model = case
    rng = np.random.default_rng(43)
    xt, mu = (rng.standard_normal((2, 48, 80)).astype(np.float32)
              for _ in range(2))
    mask = (np.arange(48)[None] < np.array([[48], [40]])).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    spk = _spk(setup)
    want = np.asarray(jax.jit(lambda p, *a: jmodel.apply(
        p, *a, method=JaxGradTTS.estimate))(params, xt, mask, mu, t, spk))
    with torch.no_grad():
        got = model.estimate(*map(_t, (xt, mask, mu, t)),
                             model.embed_speaker(_t(spk))).numpy()
    # test_torch_estimator.py's tolerance
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if setup != 'vectors':                  # the third channel is read
        with torch.no_grad():
            other = model.estimate(*map(_t, (xt, mask, mu, t)),
                                   model.embed_speaker(
                                       _t(spk[::-1].copy()))).numpy()
        assert np.abs(other - got).max() > 1e-3


def _synth_both(jmodel, params, model, spk, sampler='euler'):
    x, xl = text_batch(44, (16, 9))
    noise = np.random.default_rng(45).standard_normal(
        (2, Y_MAX, 80)).astype(np.float32)
    want = jax_synthesize(jmodel, params, jnp.asarray(x), jnp.asarray(xl),
                          n_timesteps=4, y_max_length=Y_MAX,
                          key=jax.random.PRNGKey(0), temperature=1.5,
                          spk=jnp.asarray(spk), noise=jnp.asarray(noise),
                          sampler=sampler)
    got = synthesize(model, _t(x), _t(xl), n_timesteps=4,
                     y_max_length=Y_MAX, temperature=1.5, noise=_t(noise),
                     spk=_t(spk), sampler=sampler)
    return got, want


def test_synthesize_matches_jax(case):
    setup, jmodel, params, model = case
    got, want = _synth_both(jmodel, params, model, _spk(setup))
    np.testing.assert_array_equal(got.y_lengths.numpy(),
                                  np.asarray(want.y_lengths))
    np.testing.assert_array_equal(got.attn.numpy(), np.asarray(want.attn))
    dec = np.asarray(want.decoder_outputs)
    # test_torch_synthesize.py's tolerance
    np.testing.assert_allclose(got.decoder_outputs.numpy(), dec, rtol=1e-4,
                               atol=1e-4 * np.abs(dec).max())


def test_vector_speaker_output_ignores_the_vector():
    """n_spks -1: the JAX package computes the speaker MLP and uses it
    nowhere (the fork's quirk), so two vectors give the same mel in both
    packages."""
    hp = SETUPS['vectors']
    jmodel, params = jax_model_and_params(seed=46, **hp)
    model = torch_model(params, **hp)
    (g1, w1), (g2, w2) = (_synth_both(jmodel, params, model,
                                      _spk('vectors', seed))
                          for seed in (1, 2))
    assert torch.equal(g1.decoder_outputs, g2.decoder_outputs)
    np.testing.assert_array_equal(np.asarray(w1.decoder_outputs),
                                  np.asarray(w2.decoder_outputs))


def test_unscaled_random_weights_blow_up_alike_in_both_packages():
    """torch's default init with ReZero gains of 0.5 is not scaled for the
    sampler: the random score drives 4 Euler steps of one item to
    overflow. The JAX package on the same weights (carried by its own
    ``gradtts_torch_to_flax``) turns the same mel values non-finite, and
    the port agrees with it on the rest, so such a blow-up is the model's,
    not the port's. The widths are test_torch_cuda.py's speaker case."""
    hp = dict(n_vocab=40, n_enc_channels=32, filter_channels=64,
              filter_channels_dp=16, n_heads=2, n_enc_layers=1, n_feats=80,
              dec_dim=16, **SETUPS['ids'])
    torch.manual_seed(0)
    model = GradTTS(**hp).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('.g'):
                p.fill_(0.5)
    jmodel = JaxGradTTS(**hp)
    params = gradtts_torch_to_flax(model.state_dict(), jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32), jnp.array([8]),
        jnp.zeros((1, 16, 80)), jnp.array([16]),
        jnp.zeros((1,), jnp.int32)))
    x = torch.randint(1, 40, (2, 12))
    x_lengths = torch.tensor([12, 7])
    spk = torch.tensor([3, 1])
    noise = torch.randn(2, Y_MAX, 80)
    got = synthesize(model, x, x_lengths, 4, Y_MAX, noise=noise,
                     spk=spk).decoder_outputs.numpy()
    want = np.asarray(jax_synthesize(
        jmodel, params, *(jnp.asarray(a.numpy().astype(np.int32))
                          for a in (x, x_lengths)),
        n_timesteps=4, y_max_length=Y_MAX, key=jax.random.PRNGKey(0),
        spk=jnp.asarray(spk.numpy().astype(np.int32)),
        noise=jnp.asarray(noise.numpy())).decoder_outputs)
    bad = ~np.isfinite(want)
    assert bad.any() and not bad.all()
    np.testing.assert_array_equal(~np.isfinite(got), bad)
    # test_torch_synthesize.py's tolerance, on the values that stay finite
    np.testing.assert_allclose(got[~bad], want[~bad], rtol=1e-4,
                               atol=1e-4 * np.abs(want[~bad]).max())


def _jax_draws(key, y_lengths, n_feats=80):
    """The crop offset, t and z of JAX ``compute_loss`` (tts.py:266-269,
    diffusion.py:777-780), as test_torch_train.py draws them."""
    key, off_key = jax.random.split(key)
    max_offset = np.maximum(y_lengths - OUT_SIZE, 0)
    rand = np.asarray(jax.random.randint(off_key, (len(y_lengths),), 0,
                                         1 << 30))
    offset = np.where(max_offset > 0, rand % np.maximum(max_offset, 1), 0)
    _, diff_key = jax.random.split(key)
    key_t, key_z = jax.random.split(diff_key)
    t = jax.random.uniform(key_t, (len(y_lengths),), dtype=jnp.float32)
    z = jax.random.normal(key_z, (len(y_lengths), OUT_SIZE, n_feats),
                          dtype=jnp.float32)
    return offset, np.asarray(t), np.asarray(z)


def test_compute_loss_and_grads_match_jax(case):
    setup, jmodel, params, model = case
    x, xl = text_batch(47, (16, 11))
    rng = np.random.default_rng(47)
    yl = np.array([64, 20], np.int32)
    y = rng.standard_normal((2, 64, 80)).astype(np.float32)
    y *= (np.arange(64)[None, :, None] < yl[:, None, None])
    spk = _spk(setup)
    key = jax.random.PRNGKey(48)

    def loss_fn(p):
        res = jax_compute_loss(jmodel, p, key, x, xl, y, yl, spk=spk,
                               out_size=OUT_SIZE)
        return res.dur_loss + res.prior_loss + res.diff_loss, res

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    offset, t, z = _jax_draws(key, yl)
    model.zero_grad(set_to_none=True)
    got = compute_loss(model, _t(x), _t(xl), _t(y), _t(yl),
                       out_size=OUT_SIZE, offset=_t(offset), t=_t(t),
                       z=_t(z), spk=_t(spk))
    (got.dur_loss + got.prior_loss + got.diff_loss).backward()
    np.testing.assert_array_equal(got.attn.numpy(), np.asarray(want.attn))
    # test_torch_train.py's tolerances: the losses within 1e-5, every grad
    # within 2e-4 of its tensor's largest value; the encoder attention's
    # key biases (an exact zero grad) are rounding noise on both sides,
    # and the unused speaker MLP of n_spks -1 has a zero grad in JAX and
    # none in the port, which does not run it. A ReZero gain's grad is one
    # sum over every position of its attention's output times the incoming
    # grad; where that sum cancels (measured: to 2e-5 against 3e-2 for the
    # largest gain, 2e-3 apart relative, 4e-8 absolute), its own value is
    # no scale for the rounding of its terms: the six gains are held as
    # one tensor, within 2e-4 of the largest gain grad
    for name in ('dur_loss', 'prior_loss', 'diff_loss'):
        np.testing.assert_allclose(getattr(got, name).item(),
                                   float(getattr(want, name)), rtol=1e-5,
                                   err_msg=name)
    want_grads = flax_params_to_state_dict(jax.device_get(jgrads))
    params_t = dict(model.named_parameters())
    assert set(want_grads) == set(params_t)
    largest = max(float(w.abs().max()) for w in want_grads.values())
    gains = max(float(w.abs().max()) for n, w in want_grads.items()
                if n.endswith('.fn.g'))
    for name, w in want_grads.items():
        g = params_t[name].grad
        g = torch.zeros_like(w) if g is None else g
        scale = gains if name.endswith('.fn.g') else float(w.abs().max())
        if name.endswith('conv_k.bias'):
            assert float(g.abs().max()) < 1e-8 * largest, name
            assert float(w.abs().max()) < 1e-8 * largest, name
            continue
        if setup == 'vectors' and 'spk_mlp' in name:
            assert params_t[name].grad is None and float(w.abs().max()) == 0
            continue
        torch.testing.assert_close(g, w, rtol=0, atol=2e-4 * scale,
                                   msg=name)
    if setup != 'vectors':
        assert float(params_t['spk_emb.weight'].grad.abs().max()) > 0


def test_score_batch_matches_jax(case):
    setup, jmodel, params, model = case
    x, xl = text_batch(49, (16, 11))
    rng = np.random.default_rng(50)
    y = (rng.standard_normal((2, 32, 80)) - 2.0).astype(np.float32)
    yl = np.array([32, 24], np.int32)
    y[1, 24:] = 0.0
    spk = _spk(setup)
    key = jax.random.PRNGKey(51)
    want = jax.jit(lambda p, *a: jax_score_batch(jmodel, p, key, *a,
                                                 n_euler=4))(
        params, x, xl, y, yl, spk)
    probe = np.asarray(jax.random.randint(key, y.shape, 0, 2).astype(
        jnp.float32) * 2.0 - 1.0)
    got = score_batch(model, _t(x), _t(xl), _t(y), _t(yl), n_euler=4,
                      epsilon=_t(probe), spk=_t(spk))
    # test_torch_likelihood.py's tolerance
    for name in ('score', 'prior_logp', 'delta_logp', 'z'):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize('encoder_speaker', [False, True])
def test_detect_encoder_speaker_on_both_wirings(encoder_speaker):
    model = GradTTS(n_vocab=20, n_enc_channels=16, filter_channels=32,
                    filter_channels_dp=8, n_enc_layers=1, dec_dim=8,
                    n_spks=4, spk_emb_dim=D, encoder_speaker=encoder_speaker)
    sd = model.state_dict()
    assert detect_encoder_speaker(sd, 16) is encoder_speaker
    assert jax_detect_encoder_speaker(sd, 16) is encoder_speaker
    assert detect_encoder_speaker({}, 16) is False


def test_transform_txt_matches_jax():
    cases = ['Hello [NOISE] World', "THAT 'S  (laughs) it <sil> {x} ok",
             "  we ' re   here  [um] ", "rock 'n' roll", '(all) [of] <it>',
             "It's {BREATH}  fine '"]
    for text in cases:
        assert tds.transform_txt(text) == jds.transform_txt(text), text


def _items_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def test_speaker_id_dataset_and_collate_match_jax(tmp_path):
    filelist = write_corpus(tmp_path, 3, speakers=[4, 0, 2])
    kw = dict(filelist_path=filelist, cmudict_path=CMUDICT, shuffle=False)
    got_ds = tds.TextMelSpeakerDataset(**kw)
    want_ds = jds.TextMelSpeakerDataset(**kw)
    items = []
    for i in range(3):
        _items_equal(got_ds[i], want_ds[i])
        items.append(got_ds[i])
    batch = tds.BatchCollate()(items)
    _items_equal(batch, jds.BatchCollate()(items))
    assert batch['spk'].tolist() == [4, 0, 2]


@pytest.mark.parametrize('fmt', ['npy', 'npz', 'pt'])
def test_zero_speaker_dataset_and_collate_match_jax(tmp_path, fmt):
    filelist = write_corpus(tmp_path, 3)
    emb = np.random.default_rng(52).standard_normal((3, D)).astype(np.float32)
    path = str(tmp_path / f'spk.{fmt}')
    if fmt == 'npy':
        np.save(path, emb)
    elif fmt == 'npz':
        np.savez(path, emb=emb)
    else:
        torch.save(torch.from_numpy(emb), path)
    got_ds = tds.TextMelZeroSpeakerDataset(filelist, path, CMUDICT,
                                           spk_emb_dim=D)
    want_ds = jds.TextMelZeroSpeakerDataset(filelist, path, CMUDICT,
                                            spk_emb_dim=D)
    items = [got_ds[i] for i in range(3)]
    for i in range(3):
        _items_equal(items[i], want_ds[i])
    np.testing.assert_array_equal(items[1]['spk'], emb[1])
    batch = tds.BatchCollate()(items)
    _items_equal(batch, jds.BatchCollate()(items))
    assert batch['spk'].shape == (3, D) and batch['spk'].dtype == np.float32


@pytest.mark.parametrize('preset', ['ljspeech', 'tedlium', 'tedlium-spk'])
def test_dataset_from_config_matches_jax(tmp_path, preset):
    speakers = [1, 0, 2] if preset == 'tedlium-spk' else None
    filelist = write_corpus(tmp_path, 3, speakers=speakers)
    spk_path = str(tmp_path / 'spk.npy')
    np.save(spk_path, np.ones((3, 192), np.float32))
    over = {'data.train_filelist_path': filelist,
            'data.train_spk_path': spk_path, 'data.cmudict_path': CMUDICT,
            'data.sample_rate': 22050}
    got = tds.dataset_from_config(get_config(preset, **over))
    want = jds.dataset_from_config(jax_get_config(preset, **over))
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want) == 3
    for i in range(3):
        _items_equal(got[i], want[i])


def test_train_cli_trains_a_speaker_preset(tmp_path):
    """cli.train on a speaker-id corpus (``wav|text|speaker`` lines, the
    tedlium-spk preset at tiny widths): the loop's dataset carries the
    ids to compute_loss, and the speaker table learns."""
    filelist = write_corpus(tmp_path, 4, sr=16000, speakers=[3, 1, 3, 7])
    log_dir = tmp_path / 'logs'
    res = train_main(['--preset', 'tedlium-spk', '--cpu', '--max-steps', '1',
                      '--log-dir', str(log_dir), '--batch-size', '2',
                      '--no-previews',
                      '--set', *TINY_SET,
                      f'data.train_filelist_path={filelist}',
                      f'data.cmudict_path={CMUDICT}', 'data.x_buckets=(64,)',
                      'data.y_buckets=(64,)', 'train.use_bf16_compute=False'])
    assert res.step == 1
    assert 'epoch 0:' in (log_dir / 'train.log').read_text()
    table = res.model.spk_emb.weight
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(get_config('tedlium-spk').train.seed)
        start = GradTTS.from_config(get_config(
            'tedlium-spk', **{k: int(v) for k, v in (
                s.split('=') for s in TINY_SET)})).spk_emb.weight
    moved = (table.detach() != start).any(dim=1)
    assert moved.sum() >= 1 and not moved[0]   # speaker 0 is in no batch


def test_nbest_cli_scores_with_its_default_preset(tmp_path, capsys):
    """cli.nbest score with no --preset: tedlium-spk, whose filelist lines
    carry the speaker id."""
    _, params = jax_model_and_params(seed=53, n_spks=675, spk_emb_dim=128)
    ckpt = tmp_path / 'tiny.pt'
    torch.save(flax_params_to_state_dict(params), ckpt)
    filelist = write_corpus(tmp_path, 2, sr=16000, speakers=[5, 600])
    entries = [{'target': 'hello world, number 0.',
                'hyps': ['hello world, number 0.', 'yellow word']},
               {'target': 'hello world, number 1.',
                'hyps': ['hello world, number 1.', 'hollow world']}]
    pkl = str(tmp_path / 'nbest.pkl')
    save_n_best(make_synthetic_n_best(entries, seed=5), pkl)
    out_dir = tmp_path / 'scores'
    nbest_main(['score', '--n-best', pkl, '--checkpoint', str(ckpt),
                '--filelist', filelist, '--out-dir', str(out_dir), '--cpu',
                '-N', '2', '--n-euler', '2', '--set', *TINY_SET,
                f'data.cmudict_path={CMUDICT}', 'data.x_buckets=(64,)',
                'data.y_buckets=(64,)'])
    assert 'scored 4 (utterance' in capsys.readouterr().out
    scores = sorted(os.listdir(out_dir))
    assert len(scores) == 4
