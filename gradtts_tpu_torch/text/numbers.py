"""Number verbalization for English text normalization.

Self-contained replacement for the ``inflect``-based expansion in the
reference (reference text/numbers.py) — the semantics (comma removal,
currency, decimals, ordinals, year-style grouping for 1000<n<3000) follow that
file, but the cardinal/ordinal verbalizer here is written from scratch since
``inflect`` is not a dependency of this framework.
"""

import re

_comma_number_re = re.compile(r'([0-9][0-9\,]+[0-9])')
_decimal_number_re = re.compile(r'([0-9]+\.[0-9]+)')
_pounds_re = re.compile(r'£([0-9\,]*[0-9]+)')
_dollars_re = re.compile(r'\$([0-9\.\,]*[0-9]+)')
_ordinal_re = re.compile(r'[0-9]+(st|nd|rd|th)')
_number_re = re.compile(r'[0-9]+')

_ONES = ['zero', 'one', 'two', 'three', 'four', 'five', 'six', 'seven',
         'eight', 'nine', 'ten', 'eleven', 'twelve', 'thirteen', 'fourteen',
         'fifteen', 'sixteen', 'seventeen', 'eighteen', 'nineteen']
_TENS = ['', '', 'twenty', 'thirty', 'forty', 'fifty', 'sixty', 'seventy',
         'eighty', 'ninety']
_SCALES = [(10 ** 12, 'trillion'), (10 ** 9, 'billion'), (10 ** 6, 'million'),
           (10 ** 3, 'thousand')]

_ORDINAL_IRREGULAR = {
    'one': 'first', 'two': 'second', 'three': 'third', 'five': 'fifth',
    'eight': 'eighth', 'nine': 'ninth', 'twelve': 'twelfth',
}


def _two_digits(n):
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    word = _TENS[tens]
    return word + '-' + _ONES[ones] if ones else word


def _three_digits(n):
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(_ONES[hundreds] + ' hundred')
    if rest:
        parts.append(_two_digits(rest))
    return ' '.join(parts)


def number_to_words(n):
    """Cardinal verbalization, e.g. 1234567 ->
    'one million, two hundred thirty-four thousand, five hundred sixty-seven'.
    """
    if n == 0:
        return 'zero'
    parts = []
    for scale, name in _SCALES:
        if n >= scale:
            count, n = divmod(n, scale)
            parts.append(_three_digits(count) + ' ' + name)
    if n:
        parts.append(_three_digits(n))
    return ', '.join(parts)


def number_to_words_grouped2(n, zero='oh'):
    """Year-style verbalization in digit pairs: 1999 -> 'nineteen ninety-nine',
    1905 -> 'nineteen oh five', 1900 -> 'nineteen hundred'."""
    digits = str(n)
    if len(digits) % 2 == 1:
        digits = '0' + digits
    pairs = [int(digits[i:i + 2]) for i in range(0, len(digits), 2)]
    words = []
    for i, p in enumerate(pairs):
        is_last = i == len(pairs) - 1
        if p == 0:
            words.append('hundred' if is_last and words else zero + ' ' + zero)
        elif p < 10:
            if is_last:
                words.append(zero + ' ' + _ONES[p])
            else:
                words.append(zero + ' ' + _ONES[p])
        else:
            words.append(_two_digits(p))
    return ' '.join(words)


def ordinal_to_words(n):
    """Ordinal verbalization, e.g. 21 -> 'twenty-first', 100 -> 'one hundredth'."""
    cardinal = number_to_words(n).replace(', ', ' ')
    words = cardinal.split(' ')
    last = words[-1]
    if '-' in last:
        head, tail = last.rsplit('-', 1)
        last = head + '-' + _ordinalize_word(tail)
    else:
        last = _ordinalize_word(last)
    return ' '.join(words[:-1] + [last])


def _ordinalize_word(word):
    if word in _ORDINAL_IRREGULAR:
        return _ORDINAL_IRREGULAR[word]
    if word.endswith('y'):
        return word[:-1] + 'ieth'
    return word + 'th'


def _remove_commas(m):
    return m.group(1).replace(',', '')


def _expand_decimal_point(m):
    return m.group(1).replace('.', ' point ')


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split('.')
    if len(parts) > 2:
        return match + ' dollars'
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = 'dollar' if dollars == 1 else 'dollars'
        cent_unit = 'cent' if cents == 1 else 'cents'
        return '%s %s, %s %s' % (dollars, dollar_unit, cents, cent_unit)
    elif dollars:
        return '%s %s' % (dollars, 'dollar' if dollars == 1 else 'dollars')
    elif cents:
        return '%s %s' % (cents, 'cent' if cents == 1 else 'cents')
    return 'zero dollars'


def _expand_ordinal(m):
    return ordinal_to_words(int(m.group(0)[:-2]))


def _expand_number(m):
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return 'two thousand'
        elif 2000 < num < 2010:
            return 'two thousand ' + number_to_words(num % 100)
        elif num % 100 == 0:
            return number_to_words(num // 100) + ' hundred'
        else:
            return number_to_words_grouped2(num)
    return number_to_words(num)


def normalize_numbers(text):
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r'\1 pounds', text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
