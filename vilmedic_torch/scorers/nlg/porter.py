"""The Porter stemmer as ``rouge_score`` runs it (NLTK's ``PorterStemmer``
in its default ``NLTK_EXTENSIONS`` mode), so that ROUGE needs neither
package.

Porter, M. "An algorithm for suffix stripping." Program 14.3 (1980):
130-137, with the extensions of Martin Porter's own implementations and
NLTK's: irregular forms, ``ies``/``ied`` on four-letter words, ``y -> i``
only after a consonant that is not the whole stem, ``bli -> ble``,
``alli``, ``fulli`` and ``logi``, and a two-letter vowel-consonant stem
counted as ``*o``. Words of up to two letters are returned lower-cased.
"""

from __future__ import annotations

import functools

VOWELS = frozenset("aeiou")

IRREGULAR = {
    "skies": "sky", "sky": "sky", "dying": "die", "lying": "lie", "tying": "tie",
    "news": "news", "innings": "inning", "inning": "inning", "outings": "outing",
    "outing": "outing", "cannings": "canning", "canning": "canning", "howe": "howe",
    "proceed": "proceed", "exceed": "exceed", "succeed": "succeed",
}


def _is_consonant(word: str, i: int) -> bool:
    """A letter other than a vowel, and other than a ``y`` after a consonant
    (a run of ``y`` alternates)."""
    if word[i] in VOWELS:
        return False
    if word[i] != "y":
        return True
    negate = False
    while i > 0 and word[i] == "y":
        negate = not negate
        i -= 1
    return (word[i] not in VOWELS) != negate


def _measure(stem: str) -> int:
    """m in [C](VC){m}[V]."""
    cv = "".join("c" if _is_consonant(stem, i) else "v" for i in range(len(stem)))
    return cv.count("vc")


def _positive(stem: str) -> bool:
    return _measure(stem) > 0


def _contains_vowel(stem: str) -> bool:
    return any(not _is_consonant(stem, i) for i in range(len(stem)))


def _ends_double_consonant(word: str) -> bool:
    return len(word) >= 2 and word[-1] == word[-2] and _is_consonant(word, len(word) - 1)


def _ends_cvc(word: str) -> bool:
    """``*o``: consonant-vowel-consonant, the last not w, x or y; or a
    two-letter vowel-consonant word."""
    n = len(word)
    if n >= 3 and (_is_consonant(word, n - 3) and not _is_consonant(word, n - 2)
                   and _is_consonant(word, n - 1) and word[-1] not in "wxy"):
        return True
    return n == 2 and not _is_consonant(word, 0) and _is_consonant(word, 1)


def _apply_rules(word: str, rules) -> str:
    """The first rule whose suffix the word ends with decides: its
    replacement where its condition holds on the stem, else the word as it
    is. The suffix ``*d`` stands for a double consonant."""
    for suffix, replacement, condition in rules:
        if suffix == "*d":
            if _ends_double_consonant(word):
                stem = word[:-2]
                return stem + replacement if condition is None or condition(stem) else word
            continue
        if word.endswith(suffix):
            stem = word[:len(word) - len(suffix)]
            return stem + replacement if condition is None or condition(stem) else word
    return word


def _step1a(word: str) -> str:
    if word.endswith("ies") and len(word) == 4:
        return word[:-3] + "ie"
    return _apply_rules(word, [("sses", "ss", None), ("ies", "i", None), ("ss", "ss", None),
                               ("s", "", None)])


def _step1b(word: str) -> str:
    if word.endswith("ied"):
        return word[:-3] + ("ie" if len(word) == 4 else "i")
    if word.endswith("eed"):
        stem = word[:-3]
        return stem + "ee" if _measure(stem) > 0 else word
    for suffix in ("ed", "ing"):
        if word.endswith(suffix) and _contains_vowel(word[:-len(suffix)]):
            stem = word[:-len(suffix)]
            break
    else:
        return word
    return _apply_rules(stem, [
        ("at", "ate", None), ("bl", "ble", None), ("iz", "ize", None),
        ("*d", stem[-1], lambda s: stem[-1] not in "lsz"),
        ("", "e", lambda s: _measure(s) == 1 and _ends_cvc(s)),
    ])


def _step1c(word: str) -> str:
    return _apply_rules(word, [("y", "i", lambda s: len(s) > 1 and _is_consonant(s, len(s) - 1))])


_STEP2 = [(suffix, repl, _positive) for suffix, repl in (
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
    ("izer", "ize"), ("bli", "ble"), ("alli", "al"), ("entli", "ent"), ("eli", "e"),
    ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
    ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"), ("ousness", "ous"),
    ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"), ("fulli", "ful"))]


def _step2(word: str) -> str:
    if word.endswith("alli") and _positive(word[:-4]):
        return _step2(word[:-4] + "al")
    return _apply_rules(word, _STEP2 + [("logi", "log", lambda s: _positive(word[:-3]))])


_STEP3 = [(suffix, repl, _positive) for suffix, repl in (
    ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"), ("ical", "ic"),
    ("ful", ""), ("ness", ""))]


def _m_gt_1(stem: str) -> bool:
    return _measure(stem) > 1


_STEP4 = [(suffix, "", _m_gt_1) for suffix in (
    "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement", "ment", "ent")]
_STEP4.append(("ion", "", lambda s: _measure(s) > 1 and s[-1] in "st"))
_STEP4 += [(suffix, "", _m_gt_1) for suffix in ("ou", "ism", "ate", "iti", "ous", "ive", "ize")]


def _step5a(word: str) -> str:
    if word.endswith("e"):
        stem = word[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _ends_cvc(stem)):
            return stem
    return word


def _step5b(word: str) -> str:
    return _apply_rules(word, [("ll", "l", lambda s: _measure(word[:-1]) > 1)])


@functools.lru_cache(maxsize=1 << 16)
def stem(word: str) -> str:
    """The stem of ``word``, lower-cased."""
    low = word.lower()
    if low in IRREGULAR:
        return IRREGULAR[low]
    if len(word) <= 2:
        return low
    for step in (_step1a, _step1b, _step1c, _step2):
        low = step(low)
    low = _apply_rules(low, _STEP3)
    low = _apply_rules(low, _STEP4)
    return _step5b(_step5a(low))
