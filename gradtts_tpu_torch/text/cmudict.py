"""CMU pronouncing dictionary loader.

Parses the classic CMUdict 0.7 text format (latin-1, ``WORD  PH ON ES`` with
``(n)`` alternates) into a word -> [pronunciation, ...] mapping restricted to
the ARPAbet inventory in :mod:`gradtts_tpu_torch.text.symbols`.

Behavioral parity target: reference text/cmudict.py:19-34.
"""

import re

from gradtts_tpu_torch.text.symbols import ARPABET

_VALID = frozenset(ARPABET)
_ALT_RE = re.compile(r'\([0-9]+\)')


class CMUDict:
    def __init__(self, file_or_path, keep_ambiguous=True):
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding='latin-1') as f:
                entries = _parse(f)
        else:
            entries = _parse(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self):
        return len(self._entries)

    def lookup(self, word):
        """Return the list of ARPAbet pronunciations of ``word`` or None."""
        return self._entries.get(word.upper())


def _parse(lines):
    entries = {}
    for line in lines:
        if not line or not ('A' <= line[0] <= 'Z' or line[0] == "'"):
            continue
        parts = line.split('  ')
        if len(parts) < 2:
            continue
        word = _ALT_RE.sub('', parts[0])
        phones = parts[1].strip().split(' ')
        if any(p not in _VALID for p in phones):
            continue
        entries.setdefault(word, []).append(' '.join(phones))
    return entries
