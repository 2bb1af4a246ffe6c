"""METEOR-ES: exact + Porter-stem METEOR (no WordNet synonymy); the port's
copy of ``vae_captioning_tpu/eval/meteor.py``.

The reference delegates scoring to tylin/coco-caption
(the reference's ``README.md:47``), whose METEOR is the METEOR-1.5 Java
jar with WordNet synonym and paraphrase tables.  Neither the jar nor the
WordNet corpus ships with the package, so this
module implements the *published* METEOR algorithm (Banerjee & Lavie
2005 / Lavie & Agarwal 2007) restricted to its exact and Porter-stem
matching stages.

**Comparability warning — read before quoting numbers.**  Without the
synonym/paraphrase stages, scores are systematically LOWER than official
METEOR-1.5 numbers and must not be compared against published results.
They ARE internally consistent: use them for relative tracking (A/B
between checkpoints, per-epoch trend curves), which is their in-training
purpose here.  Results are reported under the key ``METEOR_es`` — never
plain ``METEOR`` — so a reader cannot mistake them for jar numbers.

Algorithm (sentence level, Lavie & Agarwal 2007 defaults):
  * Unigram alignment in stages — exact surface match first, then
    Porter-stem match on the residue.  Within a stage the hypothesis is
    scanned right-to-left and each word takes the right-most unused
    reference occurrence (the standard greedy alignment; matches the
    nltk implementation, against which the arithmetic is
    oracle-validated in tests/test_meteor.py).
  * P = m/|hyp|, R = m/|ref|, F_mean = P·R / (α·P + (1-α)·R) with
    α = 0.9.
  * Fragmentation penalty γ·(chunks/m)^β with β = 3, γ = 0.5, where
    chunks is the number of runs of matches adjacent in both strings.
  * score = (1 - penalty)·F_mean; 0 when there are no matches.
  * Multiple references: max of the per-reference sentence scores.

The Porter stemmer below is a from-the-paper implementation of the
original algorithm (M.F. Porter, "An algorithm for suffix stripping",
Program 14(3), 1980), validated in tests against
``nltk.PorterStemmer(mode="ORIGINAL_ALGORITHM")``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

__all__ = ["porter_stem", "meteor_es", "corpus_meteor_es"]


# ----------------------------------------------------------------------
# Porter stemmer (original 1980 algorithm)
# ----------------------------------------------------------------------

_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    """Consonant per the paper: not a/e/i/o/u, and 'y' is a consonant
    only when it is the first letter or follows a vowel ('y' after a
    consonant acts as a vowel: syzygy)."""
    ch = word[i]
    if ch in _VOWELS:
        return False
    if ch == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """m in [C](VC)^m[V]: the number of vowel→consonant alternations."""
    m = 0
    prev_cons = None
    for i in range(len(stem)):
        cons = _is_cons(stem, i)
        if prev_cons is False and cons:
            m += 1
        prev_cons = cons
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(stem: str) -> bool:
    return (len(stem) >= 2 and stem[-1] == stem[-2]
            and _is_cons(stem, len(stem) - 1))


def _ends_cvc(stem: str) -> bool:
    """*o: ends cvc where the final c is not w, x or y."""
    if len(stem) < 3:
        return False
    return (_is_cons(stem, len(stem) - 3)
            and not _is_cons(stem, len(stem) - 2)
            and _is_cons(stem, len(stem) - 1)
            and stem[-1] not in "wxy")


def _apply_rules(word: str, rules, min_m: int = None) -> str:
    """First (longest-listed-first) suffix that matches decides; its
    replacement applies only if the remaining stem has m > min_m (the
    paper's longest-match-wins within a step)."""
    for suffix, repl in rules:
        if word.endswith(suffix):
            stem = word[: len(word) - len(suffix)]
            if min_m is None or _measure(stem) > min_m:
                return stem + repl
            return word  # longest match decides even when condition fails
    return word


def porter_stem(word: str) -> str:
    """Original Porter (1980) stem of a lowercase word.

    No short-word guard: the paper's published C implementation skips
    words of length ≤ 2, but nltk's ORIGINAL_ALGORITHM mode (the test
    oracle) applies the rules to every length, e.g. "as" → "a".  Both
    sides of an alignment stem identically so matching is unaffected.
    """
    w = word

    # Step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]

    # Step 1b
    flag_1b = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and _has_vowel(w[:-2]):
        w = w[:-2]
        flag_1b = True
    elif w.endswith("ing") and _has_vowel(w[:-3]):
        w = w[:-3]
        flag_1b = True
    if flag_1b:
        if w.endswith(("at", "bl", "iz")):
            w = w + "e"
        elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _ends_cvc(w):
            w = w + "e"

    # Step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # Step 2 (longest match first; condition m(stem) > 0)
    w = _apply_rules(w, [
        ("ational", "ate"), ("ization", "ize"), ("iveness", "ive"),
        ("fulness", "ful"), ("ousness", "ous"), ("biliti", "ble"),
        ("tional", "tion"), ("alism", "al"), ("aliti", "al"),
        ("iviti", "ive"), ("ation", "ate"), ("entli", "ent"),
        ("ousli", "ous"), ("enci", "ence"), ("anci", "ance"),
        ("izer", "ize"), ("abli", "able"), ("alli", "al"),
        ("ator", "ate"), ("eli", "e"),
    ], min_m=0)

    # Step 3 (condition m(stem) > 0)
    w = _apply_rules(w, [
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ], min_m=0)

    # Step 4 (condition m(stem) > 1; "ion" additionally needs *S or *T)
    for suffix in ("ement", "ance", "ence", "able", "ible", "ment",
                   "ant", "ent", "ion", "ism", "ate", "iti", "ous",
                   "ive", "ize", "al", "er", "ic", "ou"):
        if w.endswith(suffix):
            stem = w[: len(w) - len(suffix)]
            if _measure(stem) > 1 and (suffix != "ion"
                                       or stem[-1:] in ("s", "t")):
                w = stem
            break

    # Step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _ends_cvc(stem)):
            w = stem

    # Step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]

    return w


# ----------------------------------------------------------------------
# METEOR alignment + score
# ----------------------------------------------------------------------

def _greedy_match(hyp: List, ref: List):
    """Right-to-left greedy stage match: each remaining hypothesis word
    takes the right-most unused reference occurrence of the same key.
    Items are (orig_index, key).  Returns (matches, hyp_rest, ref_rest)
    with matches as (hyp_index, ref_index) pairs."""
    positions: Dict[str, List[int]] = {}
    for j, (_, key) in enumerate(ref):
        positions.setdefault(key, []).append(j)
    matches, used_h, used_r = [], set(), set()
    for i in range(len(hyp) - 1, -1, -1):
        stack = positions.get(hyp[i][1])
        if stack:
            j = stack.pop()
            matches.append((hyp[i][0], ref[j][0]))
            used_h.add(i)
            used_r.add(j)
    hyp_rest = [p for i, p in enumerate(hyp) if i not in used_h]
    ref_rest = [p for j, p in enumerate(ref) if j not in used_r]
    return matches, hyp_rest, ref_rest


def _align(hyp_tokens: Sequence[str], ref_tokens: Sequence[str]):
    hyp = list(enumerate(hyp_tokens))
    ref = list(enumerate(ref_tokens))
    exact, hyp, ref = _greedy_match(hyp, ref)
    hyp_s = [(i, porter_stem(w)) for i, w in hyp]
    ref_s = [(j, porter_stem(w)) for j, w in ref]
    stem, _, _ = _greedy_match(hyp_s, ref_s)
    return sorted(exact + stem)


def _count_chunks(matches: List) -> int:
    """Fewest runs of matches that are adjacent in both strings."""
    chunks = 1
    for a, b in zip(matches, matches[1:]):
        if not (b[0] == a[0] + 1 and b[1] == a[1] + 1):
            chunks += 1
    return chunks


def _sentence_score(hyp_tokens: Sequence[str], ref_tokens: Sequence[str],
                    alpha: float, beta: float, gamma: float) -> float:
    matches = _align(hyp_tokens, ref_tokens)
    m = len(matches)
    if m == 0 or not hyp_tokens or not ref_tokens:
        return 0.0
    precision = m / len(hyp_tokens)
    recall = m / len(ref_tokens)
    fmean = (precision * recall) / (alpha * precision + (1 - alpha) * recall)
    penalty = gamma * (_count_chunks(matches) / m) ** beta
    return (1.0 - penalty) * fmean


def meteor_es(hyp_tokens: Sequence[str],
              refs_tokens: Sequence[Sequence[str]],
              alpha: float = 0.9, beta: float = 3.0,
              gamma: float = 0.5) -> float:
    """Sentence METEOR-ES: max over references (standard multi-reference
    handling).  Tokens must already be tokenized+lowercased (use
    ``scorers.ptb_tokenize`` for coco-caption-style normalization)."""
    return max((_sentence_score(hyp_tokens, r, alpha, beta, gamma)
                for r in refs_tokens), default=0.0)


def corpus_meteor_es(hyps: Sequence[Sequence[str]],
                     refs: Sequence[Sequence[Sequence[str]]]) -> float:
    """Mean of sentence-level METEOR-ES over the corpus.

    NOTE: the METEOR-1.5 jar aggregates corpus statistics before the
    final formula rather than averaging sentence scores; combined with
    the absent synonym/paraphrase stages this is one more reason these
    numbers are for RELATIVE tracking only (module docstring)."""
    if len(hyps) != len(refs):
        raise ValueError(f"{len(hyps)} hypotheses vs {len(refs)} reference "
                         "sets")
    if not hyps:
        return 0.0
    return sum(meteor_es(h, r) for h, r in zip(hyps, refs)) / len(hyps)
