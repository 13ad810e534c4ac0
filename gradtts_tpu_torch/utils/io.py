"""Param trees as single ``.npz`` files, in the layout of
gradtts_tpu/utils/io.py (:31): one array per leaf under its '/'-joined
path, so that a file written here loads with the JAX package's
``load_params_npz`` and the other way round. A port checkpoint goes
through ``utils.convert.state_dict_to_flax_params`` first.

``read_orbax_checkpoint`` reads a checkpoint directory that the JAX
package's trainers write (``gradtts_tpu/train/checkpoint.py:18-37``) into
numpy, with tensorstore alone: the ``_METADATA`` JSON gives the tree, and
each array is a zarr array in the step's ``ocdbt`` key-value store.
Neither orbax nor JAX is needed. It is a host-side format converter: a
machine without tensorstore loads the ``.npz`` that ``save_params_npz``
writes on one that has it."""

import json
import os

import numpy as np


def _flatten(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        key = f'{prefix}/{k}' if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        *parents, leaf = key.split('/')
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def save_params_npz(path, params) -> None:
    np.savez(path, **_flatten(params))


def load_params_npz(path) -> dict:
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


def _orbax_step_dir(path: str) -> str:
    """``path`` itself where it is an orbax step directory (it holds
    ``_METADATA``), else its latest ``step_*`` subdirectory, as
    ``gradtts_tpu/train/checkpoint.py:40-60`` picks it. Raises ValueError
    where there is neither."""
    if os.path.isfile(os.path.join(path, '_METADATA')):
        return path
    steps = sorted(d for d in os.listdir(path) if d.startswith('step_')
                   and os.path.isdir(os.path.join(path, d)))
    if not steps:
        raise ValueError(f'unsupported checkpoint directory {path!r}: it '
                         'holds neither an orbax step (_METADATA) nor '
                         'step_* directories')
    return os.path.join(path, steps[-1])


# orbax's value types of a leaf that holds no array
_EMPTY = {'None': lambda: None, 'Dict': dict, 'List': list}


def read_orbax_checkpoint(path: str) -> dict:
    """The payload of an orbax checkpoint of the JAX package (``step``,
    ``params``, ``opt_state`` and, from the acoustic trainer, ``key``) as
    nested dicts and lists of numpy arrays, from a ``step_*`` directory or
    the latest step of a checkpoint directory (:func:`_orbax_step_dir`).
    Needs tensorstore, and raises an ImportError that names the ``.npz``
    route where it is missing."""
    step_dir = os.path.abspath(_orbax_step_dir(path))
    with open(os.path.join(step_dir, '_METADATA'), encoding='utf-8') as f:
        meta = json.load(f)
    if not meta.get('use_ocdbt') or meta.get('use_zarr3'):
        raise ValueError(f'{step_dir}: only the ocdbt store of zarr arrays '
                         'that the JAX package writes is read')
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            f'reading the orbax checkpoint {path!r} needs tensorstore, '
            'which this machine lacks: it is a host-side format converter. '
            'On a host that has it, load the params with '
            'gradtts_tpu_torch.utils.io.read_orbax_checkpoint (or the JAX '
            'package), write them with gradtts_tpu_torch.utils.io'
            '.save_params_npz and pass the .npz') from e
    entries, pending = [], []
    for entry in meta['tree_metadata'].values():
        keys = [(k['key'], k['key_type']) for k in entry['key_metadata']]
        kind = entry['value_metadata']['value_type']
        if kind in _EMPTY:
            entries.append((keys, kind))
            continue
        if kind not in ('np.ndarray', 'jax.Array', 'scalar'):
            raise ValueError(f'{step_dir}: unsupported orbax leaf {kind!r} '
                             f'at {[k for k, _ in keys]}')
        entries.append((keys, kind))
        pending.append(ts.open({'driver': 'zarr', 'kvstore': {
            'driver': 'ocdbt', 'base': f'file://{step_dir}/',
            'path': '.'.join(k for k, _ in keys) + '/'}}, open=True,
            read=True))
    reads = iter([f.result().read() for f in pending])
    tree, sequences = {}, set()
    for keys, kind in entries:
        if kind in _EMPTY:
            value = _EMPTY[kind]()
        else:
            value = np.asarray(next(reads).result())
            if kind == 'scalar':
                value = value.item()
        node = tree
        for depth, (key, key_type) in enumerate(keys):
            if key_type == 1:
                sequences.add(tuple(k for k, _ in keys[:depth]))
            if depth == len(keys) - 1:
                node[key] = value
            else:
                node = node.setdefault(key, {})
    return _as_sequences(tree, (), sequences)


def _as_sequences(node, path, sequences):
    """Nested dicts -> the same with a list where orbax saved a sequence."""
    if not isinstance(node, dict):
        return node
    out = {k: _as_sequences(v, path + (k,), sequences)
           for k, v in node.items()}
    if path in sequences:
        return [out[k] for k in sorted(out, key=int)]
    return out
