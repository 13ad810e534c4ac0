"""Symbol inventory for the text frontend.

Defines the 148-entry grapheme/phoneme symbol table used by the acoustic
model's embedding layer, plus the ARPAbet phone set used for CMUdict lookups.
Behavioral parity target: reference text/symbols.py:5-14 (the standard
keithito/tacotron inventory) — same ordering, so token ids are identical.

The blank token inserted between symbols (``intersperse``) uses id
``len(symbols)`` == 148 and is NOT part of this table; the embedding size is
therefore ``len(symbols) + 1``.
"""

# ARPAbet phone set (with stress markers), prefixed with '@' in the symbol
# table to keep phones distinct from raw graphemes.
ARPABET = [
    'AA', 'AA0', 'AA1', 'AA2', 'AE', 'AE0', 'AE1', 'AE2', 'AH', 'AH0', 'AH1',
    'AH2', 'AO', 'AO0', 'AO1', 'AO2', 'AW', 'AW0', 'AW1', 'AW2', 'AY', 'AY0',
    'AY1', 'AY2', 'B', 'CH', 'D', 'DH', 'EH', 'EH0', 'EH1', 'EH2', 'ER',
    'ER0', 'ER1', 'ER2', 'EY', 'EY0', 'EY1', 'EY2', 'F', 'G', 'HH', 'IH',
    'IH0', 'IH1', 'IH2', 'IY', 'IY0', 'IY1', 'IY2', 'JH', 'K', 'L', 'M', 'N',
    'NG', 'OW', 'OW0', 'OW1', 'OW2', 'OY', 'OY0', 'OY1', 'OY2', 'P', 'R',
    'S', 'SH', 'T', 'TH', 'UH', 'UH0', 'UH1', 'UH2', 'UW', 'UW0', 'UW1',
    'UW2', 'V', 'W', 'Y', 'Z', 'ZH',
]

PAD = '_'
SPECIAL = '-'
PUNCTUATION = "!'(),.:;? "
LETTERS = 'ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz'

symbols = (
    [PAD]
    + list(SPECIAL)
    + list(PUNCTUATION)
    + list(LETTERS)
    + ['@' + p for p in ARPABET]
)

SYMBOL_TO_ID = {s: i for i, s in enumerate(symbols)}
ID_TO_SYMBOL = {i: s for i, s in enumerate(symbols)}

#: id used for the interspersed blank token (== embedding row 148)
BLANK_ID = len(symbols)
