"""Report text cleaners, dispatched through the port's processing registry
(a copy of ``data/processing.py`` of the JAX package, which the port never
imports).

The regex semantics must match the JAX package's exactly for tokenizer,
vocabulary and metric parity, historical quirks included (the character
class of ``r2gen_clean_report`` whose ``:-[`` span also removes
``;<=>?@``). None needs NLTK, which the card's machine does not have:
``ifcc_clean_report`` is NLTK's ``wordpunct_tokenize`` as a regular
expression, ``gloria_clean_report_chexpert`` its word-character
``RegexpTokenizer`` (``re.findall`` under the tokenizer's flags), and the
stemming ``rouge``
cleaner uses the port's copy of NLTK's Porter stemmer
(``scorers/nlg/porter.py``).
"""

from __future__ import annotations

import re

from ..registry import register

_R2GEN_SENT_PUNCT = re.compile(r"[.,?;*!%^&_+():-\[\]{}]")
_MULTI_UNDERSCORE = re.compile(r"_{2,}")
# NLTK's RegexpTokenizer(r"\w+"): findall under its default flags
_WORDS = re.compile(r"\w+", re.UNICODE | re.MULTILINE | re.DOTALL)
_MULTI_SPACE = re.compile(r" {2,}")
_MULTI_DOT = re.compile(r"\.{2,}")


@register("processing")
def r2gen_clean_report(report: str) -> str:
    """R2Gen (Memory-driven Transformer) report cleaner.

    Reference report_preprocessing.py:8-23; upstream
    github.com/cuhksz-nlp/R2Gen modules/tokenizers.py.
    """

    def report_cleaner(t: str):
        t = t.replace("\n", " ")
        t = _MULTI_UNDERSCORE.sub("_", t)
        t = _MULTI_SPACE.sub(" ", t)
        t = _MULTI_DOT.sub(".", t)
        t = (
            t.replace("1. ", "")
            .replace(". 2. ", ". ")
            .replace(". 3. ", ". ")
            .replace(". 4. ", ". ")
            .replace(". 5. ", ". ")
            .replace(" 2. ", ". ")
            .replace(" 3. ", ". ")
            .replace(" 4. ", ". ")
            .replace(" 5. ", ". ")
        )
        return t.strip().lower().split(". ")

    def sent_cleaner(t: str):
        t = (
            t.replace('"', "")
            .replace("/", "")
            .replace("\\", "")
            .replace("'", "")
            .strip()
            .lower()
        )
        return _R2GEN_SENT_PUNCT.sub("", t)

    # NOTE: upstream filters on `!= []`, which is vacuously true for strings —
    # empty sentences are kept, reproduced here for output parity.
    tokens = [sent_cleaner(sent) for sent in report_cleaner(report) if sent_cleaner(sent) != []]
    if tokens == [""]:
        return ""
    return " . ".join(tokens) + " ."


# NLTK's ``wordpunct_tokenize``: its WordPunctTokenizer is this pattern's findall
_WORDPUNCT = re.compile(r"\w+|[^\w\s]+", re.UNICODE | re.MULTILINE | re.DOTALL)


@register("processing")
def ifcc_clean_report(report: str) -> str:
    """IFCC cleaner: lowercase + wordpunct tokenization
    (reference report_preprocessing.py:28-31), without NLTK."""
    return " ".join(_WORDPUNCT.findall(report.lower()))


@register("processing")
def gloria_clean_report_chexpert(report: str) -> str:
    """GLoRIA CheXpert report cleaner (reference report_preprocessing.py:36-67)."""
    t = report.replace("\n", " ")
    captions = re.split(r"[0-9]+\.", t)
    captions = [sent for point in captions for sent in point.split(".")]

    all_sents = []
    for cap in captions:
        cap = cap.replace("��", " ")
        tokens = _WORDS.findall(cap.lower())
        if len(tokens) <= 1:
            continue
        included = [w for w in (tok.encode("ascii", "ignore").decode("ascii") for tok in tokens) if w]
        all_sents.append(" ".join(included))
    return " ".join(all_sents)


@register("processing")
def rouge(text: str, use_stemmer: bool = False) -> str:
    """Google-ROUGE tokenizer-as-cleaner (reference report_preprocessing.py:71-103)."""
    text = text.lower()
    text = re.sub(r"[^a-z0-9]+", " ", text)
    tokens = re.split(r"\s+", text)
    if use_stemmer:
        from ..scorers.nlg.porter import stem

        tokens = [stem(x) if len(x) > 3 else x for x in tokens]
    tokens = [x for x in tokens if re.match(r"^[a-z0-9]+$", x)]
    return " ".join(tokens)


@register("processing")
def identity(text: str) -> str:
    return text


def get_processing(name):
    """Resolve a processing function by name (``None`` -> identity)."""
    from .. import registry

    if name is None:
        return identity
    if callable(name):
        return name
    return registry.get("processing", name)
