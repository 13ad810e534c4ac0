"""The weight bridge between the JAX package's param trees and the reference
torch ``state_dict`` layout that the port's modules carry.

``flax_params_to_state_dict`` is the exact inverse of
gradtts_tpu/utils/convert.py ``gradtts_torch_to_flax`` (:199); the key
mapping below is the port's own copy of that file's ``_encoder_torch_key``
(:71) and ``_estimator_torch_key`` (:111). Per parameter kind:

  flax Conv kernel (K, I, O)         -> torch Conv1d (O, I, K)
  flax Dense kernel (I, O)           -> torch Linear (O, I)
  flax Dense from a k=1 conv (I, O)  -> torch Conv1d (O, I, 1)
  flax Conv kernel (Kh, Kw, I, O)    -> torch Conv2d (O, I, Kh, Kw)
  flax flipped kernel (Kh, Kw, I, O) -> torch ConvTranspose2d (I, O, Kh, Kw)
      (the JAX Upsample correlates with the spatially flipped kernel,
       convert.py:44-45; the flip is undone here)
  everything else                    -> copied

``state_dict_to_flax_params`` is the exact inverse of
``flax_params_to_state_dict``, so that a port checkpoint exports to the
JAX package's ``.npz`` layout (``utils.io.save_params_npz``).
``load_checkpoint`` and ``load_vocoder_checkpoint`` read every checkpoint
format the CLIs take, orbax directories of the JAX trainers included
(``utils.io.read_orbax_checkpoint``).

The vocoder's bridge (gradtts_tpu/models/hifigan.py :372-420):
``load_hifigan_state_dict`` folds a reference generator's weight norm as
``_fold_weight_norm`` does, and ``hifigan_flax_to_state_dict`` is the
inverse of ``hifigan_torch_to_flax``; ``discriminator_flax_to_state_dict``
carries the multi-period and multi-scale discriminators (:243-330).
"""

import os
import re

import numpy as np
import torch

from gradtts_tpu_torch.utils.io import load_params_npz, read_orbax_checkpoint

_IDX = re.compile(r'^(.*)_(\d+)$')
# the encoder's module lists: flax 'conv_layers_0' is torch 'conv_layers.0'
_ENCODER_LISTS = ('conv_layers', 'norm_layers', 'attn_layers', 'ffn_layers',
                  'norm_layers_1', 'norm_layers_2')


def _encoder_torch_key(path):
    """('prenet', 'conv_layers_0', 'kernel') ->
    ('encoder.prenet.conv_layers.0.weight', kind)."""
    *mods, leaf = path
    torch_parts = []
    for m in mods:
        match = _IDX.match(m)
        base, idx = (match.group(1), match.group(2)) if match else (m, None)
        if base in _ENCODER_LISTS:
            torch_parts += [base, idx]
        else:
            torch_parts.append(m)
    kind = None
    if leaf == 'kernel':
        torch_leaf = 'weight'
        kind = 'dense_from_conv1' if mods[-1] in (
            'conv_q', 'conv_k', 'conv_v', 'conv_o') else 'conv1d'
    elif leaf in ('bias', 'gamma', 'beta', 'emb_rel_k', 'emb_rel_v'):
        torch_leaf = leaf
    elif leaf == 'embedding':
        torch_leaf = 'weight'
    else:
        raise KeyError(f'unhandled encoder leaf {path}')
    return '.'.join(['encoder'] + torch_parts + [torch_leaf]), kind


def _estimator_torch_key(path):
    """flax estimator path -> (key under decoder.estimator, kind)."""
    parts = list(path)
    name = parts[0]
    weight = {'kernel': 'weight', 'bias': 'bias', 'scale': 'weight'}

    def resblock(sub, prefix):
        if sub[0] in ('block1', 'block2'):
            which = {'conv': '0', 'norm': '1'}[sub[1]]
            kind = 'conv2d' if sub[2] == 'kernel' else None
            return f'{prefix}.{sub[0]}.block.{which}.{weight[sub[2]]}', kind
        if sub[0] == 'mlp_dense':
            return (f'{prefix}.mlp.1.{weight[sub[1]]}',
                    'dense' if sub[1] == 'kernel' else None)
        if sub[0] == 'res_conv':
            return (f'{prefix}.res_conv.{weight[sub[1]]}',
                    'conv2d' if sub[1] == 'kernel' else None)
        raise KeyError(sub)

    def attnblock(sub, prefix):
        if sub[0] == 'g':
            return f'{prefix}.fn.g', None
        return (f'{prefix}.fn.fn.{sub[1]}.{weight[sub[2]]}',
                'conv2d' if sub[2] == 'kernel' else None)

    m = re.match(r'^(downs|ups)_(\d+)_(res1|res2|attn|down|up)$', name)
    if m:
        grp, i, role = m.groups()
        slot = {'res1': '0', 'res2': '1', 'attn': '2', 'down': '3',
                'up': '3'}[role]
        prefix = f'{grp}.{i}.{slot}'
        if role in ('res1', 'res2'):
            return resblock(parts[1:], prefix)
        if role == 'attn':
            return attnblock(parts[1:], prefix)
        kind = {'down': 'conv2d', 'up': 'convT2d'}[role]
        return (f'{prefix}.conv.{weight[parts[-1]]}',
                kind if parts[-1] == 'kernel' else None)
    if name in ('mid_block1', 'mid_block2'):
        return resblock(parts[1:], name)
    if name == 'mid_attn':
        return attnblock(parts[1:], name)
    if name == 'final_block':
        which = {'conv': '0', 'norm': '1'}[parts[1]]
        return (f'final_block.block.{which}.{weight[parts[2]]}',
                'conv2d' if parts[2] == 'kernel' else None)
    if name == 'final_conv':
        return (f'final_conv.{weight[parts[1]]}',
                'conv2d' if parts[1] == 'kernel' else None)
    m = re.match(r'^(spk_mlp|mlp)_(\d)$', name)
    if m:
        return (f'{m.group(1)}.{m.group(2)}.{weight[parts[1]]}',
                'dense' if parts[1] == 'kernel' else None)
    raise KeyError(f'unhandled estimator path {path}')


# flax array -> torch layout, the inverse of convert.py's _KIND_FN
_TO_TORCH = {
    None: lambda w: w,
    'conv1d': lambda w: w.transpose(2, 1, 0),
    'dense': lambda w: w.T,
    'dense_from_conv1': lambda w: w.T[:, :, None],
    'conv2d': lambda w: w.transpose(3, 2, 0, 1),
    'convT2d': lambda w: w[::-1, ::-1].transpose(2, 3, 0, 1),
}


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def flax_params_to_state_dict(params) -> dict:
    """The JAX package's GradTTS param tree (``{'params': ...}`` or its inner
    dict, leaves as numpy arrays) -> reference-layout ``state_dict`` of f32
    torch tensors."""
    tree = params.get('params', params)
    sd = {}
    for path, leaf in _flatten(tree).items():
        if path[0] == 'encoder':
            key, kind = _encoder_torch_key(path[1:])
        elif path[0] == 'estimator':
            key, kind = _estimator_torch_key(path[1:])
            key = 'decoder.estimator.' + key
        elif path[0] == 'spk_emb':
            key, kind = 'spk_emb.weight', None
        else:
            raise KeyError(f'unhandled top-level module {path[0]}')
        w = _TO_TORCH[kind](np.asarray(leaf, dtype=np.float32))
        sd[key] = torch.from_numpy(np.array(w, order='C'))
    return sd


# torch layout -> flax array, the inverse of _TO_TORCH
_TO_FLAX = {
    None: lambda w: w,
    'conv1d': lambda w: w.transpose(2, 1, 0),
    'dense': lambda w: w.T,
    'dense_from_conv1': lambda w: w[:, :, 0].T,
    'conv2d': lambda w: w.transpose(2, 3, 1, 0),
    'convT2d': lambda w: w.transpose(2, 3, 0, 1)[::-1, ::-1],
}


def _encoder_flax_path(parts):
    """['prenet', 'conv_layers', '0', 'weight'] -> (('prenet',
    'conv_layers_0', 'kernel'), kind): the inverse of
    :func:`_encoder_torch_key`."""
    *mods, leaf = parts
    path = []
    for m in mods:
        if path and m.isdigit() and path[-1] in _ENCODER_LISTS:
            path[-1] = f'{path[-1]}_{m}'
        else:
            path.append(m)
    if leaf != 'weight':
        return tuple(path) + (leaf,), None
    if path[-1] == 'emb':
        return tuple(path) + ('embedding',), None
    kind = 'dense_from_conv1' if path[-1] in (
        'conv_q', 'conv_k', 'conv_v', 'conv_o') else 'conv1d'
    return tuple(path) + ('kernel',), kind


def _estimator_flax_path(parts):
    """A key under decoder.estimator, split on '.' -> (flax path, kind):
    the inverse of :func:`_estimator_torch_key`."""
    leaf = {'weight': 'kernel', 'bias': 'bias'}

    def conv_leaf(p, kind):
        return (leaf[p],), kind if p == 'weight' else None

    def resblock(sub):
        if sub[0] in ('block1', 'block2'):
            which = {'0': 'conv', '1': 'norm'}[sub[2]]
            if which == 'norm':
                return (sub[0], 'norm',
                        'scale' if sub[3] == 'weight' else 'bias'), None
            path, kind = conv_leaf(sub[3], 'conv2d')
            return (sub[0], 'conv') + path, kind
        if sub[0] == 'mlp':
            path, kind = conv_leaf(sub[2], 'dense')
            return ('mlp_dense',) + path, kind
        if sub[0] == 'res_conv':
            path, kind = conv_leaf(sub[1], 'conv2d')
            return ('res_conv',) + path, kind
        raise KeyError(sub)

    def attnblock(sub):
        if sub[1] == 'g':
            return ('g',), None
        path, kind = conv_leaf(sub[3], 'conv2d')
        return ('fn', sub[2]) + path, kind

    name = parts[0]
    if name in ('downs', 'ups'):
        role = {'0': 'res1', '1': 'res2', '2': 'attn',
                '3': 'down' if name == 'downs' else 'up'}[parts[2]]
        top, sub = f'{name}_{parts[1]}_{role}', parts[3:]
        if role in ('res1', 'res2'):
            path, kind = resblock(sub)
        elif role == 'attn':
            path, kind = attnblock(sub)
        elif role == 'down':
            path, kind = conv_leaf(sub[1], 'conv2d')
            path = ('conv',) + path
        else:
            path, kind = conv_leaf(sub[1], 'convT2d')
        return (top,) + path, kind
    if name in ('mid_block1', 'mid_block2'):
        path, kind = resblock(parts[1:])
        return (name,) + path, kind
    if name == 'mid_attn':
        path, kind = attnblock(parts[1:])
        return (name,) + path, kind
    if name == 'final_block':
        if parts[2] == '1':
            return (name, 'norm',
                    'scale' if parts[3] == 'weight' else 'bias'), None
        path, kind = conv_leaf(parts[3], 'conv2d')
        return (name, 'conv') + path, kind
    if name == 'final_conv':
        path, kind = conv_leaf(parts[1], 'conv2d')
        return (name,) + path, kind
    if name in ('mlp', 'spk_mlp'):
        path, kind = conv_leaf(parts[2], 'dense')
        return (f'{name}_{parts[1]}',) + path, kind
    raise KeyError(f'unhandled estimator key {".".join(parts)}')


def flax_path(key: str):
    """A GradTTS ``state_dict`` key -> (its path in the JAX package's param
    tree, the layout kind of :data:`_TO_FLAX`):
    'decoder.estimator.mid_block1.mlp.1.weight' -> (('estimator',
    'mid_block1', 'mlp_dense', 'kernel'), 'dense')."""
    top, *parts = key.split('.')
    if top == 'encoder':
        path, kind = _encoder_flax_path(parts)
        return ('encoder',) + path, kind
    if top == 'decoder' and parts[0] == 'estimator':
        path, kind = _estimator_flax_path(parts[1:])
        return ('estimator',) + path, kind
    if key == 'spk_emb.weight':
        return ('spk_emb', 'embedding'), None
    raise KeyError(f'unhandled state_dict key {key}')


def state_dict_to_flax_params(state_dict) -> dict:
    """A reference-layout GradTTS ``state_dict`` -> the JAX package's param
    tree ``{'params': ...}`` of f32 numpy arrays: the exact inverse of
    :func:`flax_params_to_state_dict`, so that a port checkpoint exports to
    ``.npz`` (``utils.io.save_params_npz``) for the JAX CLIs."""
    tree = {}
    for key, value in state_dict.items():
        path, kind = flax_path(key)
        w = torch.as_tensor(value).detach().cpu().float().numpy()
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(_TO_FLAX[kind](w), order='C')
    return {'params': tree}


def shard_state_dict(state_dict, index: int, size: int) -> dict:
    """The blocks that rank ``index`` of a ``size``-wide 'model' axis holds
    of a full GradTTS ``state_dict``: each tensor that the split rule
    (``parallel.mesh.split_dim``) splits cut to its ``index``-th
    contiguous block along its split dim, every other tensor as it is.
    With :func:`flax_params_to_state_dict` it takes the JAX package's
    params to any rank's blocks."""
    # parallel.mesh reads this module's key map: imported at the call
    from gradtts_tpu_torch.parallel.mesh import split_dim
    out = {}
    for key, value in state_dict.items():
        dim = split_dim(key, value.shape, size)
        if dim is None:
            out[key] = value
        else:
            n = value.shape[dim] // size
            out[key] = value.narrow(dim, index * n, n).clone()
    return out


def gather_state_dict(blocks) -> dict:
    """The inverse of :func:`shard_state_dict`: the full ``state_dict`` from
    the M ranks' ``state_dict``s, ``blocks[j]`` rank j's, each split
    tensor the concatenation of its blocks. A tensor that the rule splits
    by name whose block width does not divide by M could also be one that
    the rule kept whole (its full width does not divide by M): it raises
    ``ValueError``."""
    from gradtts_tpu_torch.parallel.mesh import split_dim
    size = len(blocks)
    out = {}
    for key, value in blocks[0].items():
        full = (value.shape[0] * size, *value.shape[1:])
        dim = split_dim(key, full, size)
        if dim is not None and value.shape[dim] % size:
            raise ValueError(f'{key}: a block of width {value.shape[dim]} '
                             f'on a {size}-wide model axis may be whole')
        out[key] = value if dim is None else torch.cat(
            [b[key] for b in blocks], dim)
    return out


def detect_encoder_speaker(state_dict, n_enc_channels: int) -> bool:
    """True where a reference ``state_dict`` has the upstream encoder-side
    speaker wiring: ``encoder.proj_m`` reads ``n_enc_channels +
    spk_emb_dim`` channels (copy of gradtts_tpu/utils/convert.py:186)."""
    w = state_dict.get('encoder.proj_m.weight')
    if w is None:
        return False
    return int(w.shape[1]) > n_enc_channels


def _hifigan_bases(cfg):
    """(key base, transposed) of every weighted layer of the generator."""
    bases = [('conv_pre', False), ('conv_post', False)]
    bases += [(f'ups.{i}', True) for i in range(len(cfg.upsample_rates))]
    n_kernels = len(cfg.resblock_kernel_sizes)
    for b in range(len(cfg.upsample_rates) * n_kernels):
        n_dil = len(cfg.resblock_dilation_sizes[b % n_kernels])
        convs = ('convs1', 'convs2') if cfg.resblock == '1' else ('convs',)
        bases += [(f'resblocks.{b}.{c}.{j}', False) for c in convs
                  for j in range(n_dil)]
    return bases


def load_hifigan_state_dict(state_dict, cfg) -> dict:
    """A reference generator checkpoint (the dict under a ``.pt`` file's
    ``generator`` key, with ``weight_g``/``weight_v`` pairs or plain
    weights) -> the plain ``state_dict`` of ``models.hifigan.Generator``:
    weight = g v / ||v||, the norm over every axis but the first (torch's
    ``weight_norm`` default, ``_fold_weight_norm`` :372). Raises KeyError
    where a layer of ``cfg`` is missing."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    out = {}
    for base, _ in _hifigan_bases(cfg):
        if base + '.weight_g' in sd:
            g = sd[base + '.weight_g'].double()
            v = sd[base + '.weight_v'].double()
            norm = v.pow(2).sum(dim=tuple(range(1, v.ndim)),
                                keepdim=True).sqrt()
            w = (g * v / norm).float()
        else:
            w = sd[base + '.weight'].float()
        out[base + '.weight'] = w
        out[base + '.bias'] = sd[base + '.bias'].float()
    return out


def hifigan_flax_to_state_dict(params, cfg) -> dict:
    """The JAX package's generator params (``{'params': ...}`` or the inner
    dict) -> the plain ``state_dict`` of ``models.hifigan.Generator``, the
    inverse of ``hifigan_torch_to_flax`` (:388): a conv kernel (K, I, O)
    goes to (O, I, K); an upsample's kernel, stored flipped on K as
    (K, I, O), goes to (I, O, K) unflipped."""
    tree = params.get('params', params)
    out = {}
    for base, transposed in _hifigan_bases(cfg):
        node = tree
        parts = base.split('.')
        if parts[0] == 'resblocks':
            node = tree[f'resblocks_{parts[1]}'][f'{parts[2]}_{parts[3]}']
        else:
            node = tree[base.replace('.', '_')]
        k = np.asarray(node['kernel'], dtype=np.float32)
        w = k[::-1].transpose(1, 2, 0) if transposed else k.transpose(2, 1, 0)
        out[base + '.weight'] = torch.from_numpy(np.array(w, order='C'))
        out[base + '.bias'] = torch.from_numpy(
            np.asarray(node['bias'], dtype=np.float32).copy())
    return out


def discriminator_flax_to_state_dict(params) -> dict:
    """The JAX package's ``MultiPeriodDiscriminator`` or
    ``MultiScaleDiscriminator`` params (``{'params': ...}`` or the inner
    dict) -> the ``state_dict`` of the port's module of the same name: a
    2-D kernel (K, 1, I, O) goes to (O, I, K, 1), a (grouped) 1-D kernel
    (K, I / groups, O) to (O, I / groups, K)."""
    out = {}
    for path, leaf in _flatten(params.get('params', params)).items():
        parts = []
        for name in path[:-1]:
            match = _IDX.match(name)
            parts += [match.group(1), match.group(2)] if match else [name]
        a = np.asarray(leaf, dtype=np.float32)
        if path[-1] == 'kernel':
            a = a.transpose((3, 2, 0, 1) if a.ndim == 4 else (2, 1, 0))
            parts.append('weight')
        else:
            parts.append(path[-1])
        out['.'.join(parts)] = torch.from_numpy(np.array(a, order='C'))
    return out


def load_checkpoint(path: str) -> dict:
    """A reference-layout ``state_dict`` from a reference ``.pt``/``.pth``
    file (or a trainer's ``ckpt/step_*.pt``), a ``.npz`` param tree written
    by either package, or an orbax checkpoint directory of the JAX
    package's acoustic trainer (a ``step_*`` directory, or the checkpoint
    directory, whose latest step is read; ``utils.io
    .read_orbax_checkpoint``, which needs tensorstore)."""
    if os.path.isdir(path):
        params = read_orbax_checkpoint(path)['params']
        if 'gen' in params:
            raise ValueError(f'{path!r} is a vocoder checkpoint (its params '
                             "are 'gen', 'mpd' and 'msd'); pass it as a "
                             'vocoder')
        return flax_params_to_state_dict(params)
    if path.endswith(('.pt', '.pth')):
        sd = torch.load(path, map_location='cpu', weights_only=True)
        if isinstance(sd.get('model'), dict):
            sd = sd['model']
        return sd
    if path.endswith('.npz'):
        return flax_params_to_state_dict(load_params_npz(path))
    raise ValueError(f'unsupported checkpoint file {path!r}: the port loads '
                     'reference .pt files, .npz param trees and orbax '
                     'directories')


def load_vocoder_checkpoint(path: str, cfg) -> dict:
    """The plain ``state_dict`` of ``models.hifigan.Generator(cfg)`` from a
    reference HiFi-GAN ``.pt`` or a vocoder trainer's ``ckpt/step_*.pt``
    (its ``generator`` key, or a bare generator ``state_dict``), or from an
    orbax directory of the JAX package's
    vocoder trainer, whose params are ``{'gen', 'mpd', 'msd'}``
    (gradtts_tpu/cli/train_vocoder.py:178-186): the generator's are read."""
    if os.path.isdir(path):
        params = read_orbax_checkpoint(path)['params']
        if 'gen' not in params:
            raise ValueError(f'{path!r} is not a vocoder checkpoint: its '
                             f'params hold {sorted(params)}, not '
                             "'gen', 'mpd' and 'msd'")
        return hifigan_flax_to_state_dict(params['gen'], cfg)
    sd = torch.load(path, map_location='cpu', weights_only=True)
    return load_hifigan_state_dict(sd.get('generator', sd), cfg)
