"""Text frontend: string -> token-id sequence.

Behavioral parity target: reference text/__init__.py:22-62 — same
cleaner pipeline, CMUdict grapheme->ARPAbet substitution, curly-brace ARPAbet
passthrough, and symbol ids, so identical input strings produce identical id
sequences.
"""

import re

from gradtts_tpu_torch.text import cleaners
from gradtts_tpu_torch.text.cmudict import CMUDict
from gradtts_tpu_torch.text.symbols import symbols, SYMBOL_TO_ID, ID_TO_SYMBOL, BLANK_ID

__all__ = [
    'text_to_sequence', 'sequence_to_text', 'intersperse_blank',
    'CMUDict', 'symbols', 'BLANK_ID',
]

_curly_re = re.compile(r'(.*?)\{(.+?)\}(.*)')


def _clean(text, cleaner_names):
    for name in cleaner_names:
        fn = getattr(cleaners, name, None)
        if fn is None:
            raise ValueError('Unknown cleaner: %s' % name)
        text = fn(text)
    return text


def _symbols_to_ids(syms):
    return [SYMBOL_TO_ID[s] for s in syms if s in SYMBOL_TO_ID and s not in ('_', '~')]


def _arpabet_to_ids(text):
    return _symbols_to_ids(['@' + s for s in text.split()])


def _word_to_arpabet(word, dictionary):
    prons = dictionary.lookup(word)
    return '{' + prons[0] + '}' if prons is not None else word


def text_to_sequence(text, cleaner_names=('english_cleaners',), dictionary=None):
    """Convert ``text`` to a list of symbol ids.

    ARPAbet sequences may be embedded in curly braces, e.g.
    ``"Turn left on {HH AW1 S S T AH0 N} Street."``. When ``dictionary`` is
    given, each cleaned word is replaced by its first CMUdict pronunciation
    when available.
    """
    sequence = []
    space = _symbols_to_ids(' ')
    while len(text):
        m = _curly_re.match(text)
        if not m:
            clean_text = _clean(text, cleaner_names)
            if dictionary is not None:
                parts = [_word_to_arpabet(w, dictionary) for w in clean_text.split(' ')]
                for part in parts:
                    if part.startswith('{'):
                        sequence += _arpabet_to_ids(part[1:-1])
                    else:
                        sequence += _symbols_to_ids(part)
                    sequence += space
            else:
                sequence += _symbols_to_ids(clean_text)
            break
        sequence += _symbols_to_ids(_clean(m.group(1), cleaner_names))
        sequence += _arpabet_to_ids(m.group(2))
        text = m.group(3)

    if dictionary is not None and sequence and sequence[-1] == space[0]:
        sequence = sequence[:-1]
    return sequence


def sequence_to_text(sequence):
    """Inverse of :func:`text_to_sequence` for debugging."""
    out = []
    for sid in sequence:
        if sid in ID_TO_SYMBOL:
            s = ID_TO_SYMBOL[sid]
            if len(s) > 1 and s[0] == '@':
                s = '{%s}' % s[1:]
            out.append(s)
    return ''.join(out).replace('}{', ' ')


def intersperse_blank(seq, item=BLANK_ID):
    """Insert ``item`` between every pair of ids and at both ends
    (parity: reference utils.py:17-21)."""
    result = [item] * (len(seq) * 2 + 1)
    result[1::2] = seq
    return result
