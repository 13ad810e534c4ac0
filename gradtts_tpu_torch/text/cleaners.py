"""Text cleaning pipelines (ascii folding, casing, abbreviation and number
expansion).

Behavioral parity target: reference text/cleaners.py:67-73. ASCII
folding uses a unicodedata-based transliteration instead of ``unidecode``
(not a dependency here); for the Latin-accented input typical of TTS corpora
the two agree.
"""

import re
import unicodedata

_whitespace_re = re.compile(r'\s+')

# A few common characters NFKD decomposition does not reduce to ASCII.
_TRANSLIT = {
    'æ': 'ae', 'Æ': 'AE', 'œ': 'oe', 'Œ': 'OE', 'ø': 'o', 'Ø': 'O',
    'ß': 'ss', 'ð': 'd', 'Ð': 'D', 'þ': 'th', 'Þ': 'Th', 'ł': 'l', 'Ł': 'L',
    'đ': 'd', 'Đ': 'D', 'ħ': 'h', 'Ħ': 'H', '’': "'", '‘': "'", '“': '"',
    '”': '"', '—': '-', '–': '-', '…': '...', '«': '"', '»': '"',
}

_abbreviations = [
    (re.compile(r'\b%s\.' % abbr, re.IGNORECASE), full) for abbr, full in [
        ('mrs', 'misess'), ('mr', 'mister'), ('dr', 'doctor'),
        ('st', 'saint'), ('co', 'company'), ('jr', 'junior'),
        ('maj', 'major'), ('gen', 'general'), ('drs', 'doctors'),
        ('rev', 'reverend'), ('lt', 'lieutenant'), ('hon', 'honorable'),
        ('sgt', 'sergeant'), ('capt', 'captain'), ('esq', 'esquire'),
        ('ltd', 'limited'), ('col', 'colonel'), ('ft', 'fort'),
    ]
]

from gradtts_tpu_torch.text.numbers import normalize_numbers  # noqa: E402


def convert_to_ascii(text):
    text = ''.join(_TRANSLIT.get(c, c) for c in text)
    decomposed = unicodedata.normalize('NFKD', text)
    return decomposed.encode('ascii', 'ignore').decode('ascii')


def lowercase(text):
    return text.lower()


def expand_numbers(text):
    return normalize_numbers(text)


def expand_abbreviations(text):
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def collapse_whitespace(text):
    return re.sub(_whitespace_re, ' ', text)


def basic_cleaners(text):
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text):
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text):
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text
