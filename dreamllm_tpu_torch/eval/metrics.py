"""Evaluation metrics: VQA accuracy, ANLS, POPE, CIDEr-D (a copy of
``dreamllm_tpu/eval/metrics.py``, which imports no JAX; the port keeps its
own copy so that it imports nothing of the JAX package).

Self-contained ports of the metric definitions the reference vendors
(omni/eval/vqa/pyevaltools/vqaEval.py — the official VQA normalization +
min(matches/3, 1) consensus accuracy; doctextVQAeval.py — ANLS; POPE yes/no
stats; pycocoevalcap CIDEr-D). Pure numpy/python — metrics are host-side.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict

# --- VQA answer normalization (vqaEval.py conventions) ---

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hes": "he's", "im": "i'm", "isnt": "isn't", "itd": "it'd", "itll": "it'll",
    "lets": "let's", "shed": "she'd", "shes": "she's", "shouldve": "should've",
    "shouldnt": "shouldn't", "thats": "that's", "theres": "there's", "theyd": "they'd",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've", "wasnt": "wasn't",
    "werent": "weren't", "whats": "what's", "wheres": "where's", "wholl": "who'll",
    "whos": "who's", "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
    "youd": "you'd", "youll": "you'll", "youre": "you're", "youve": "you've",
}
_NUMBER_WORDS = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
}
_ARTICLES = {"a", "an", "the"}
_PUNCT = re.compile(r"[;/\[\]\"{}()=+\\_><@`,?!]")
# official vqaEval periodStrip: a period is removed only when NOT followed by
# a digit — '2.5' keeps its decimal point, 'dog.' loses the period
_PERIOD = re.compile(r"\.(?!\d)")


def normalize_vqa_answer(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip().lower()
    # hyphens become SPACES (official vqaEval processPunctuation: 'well-lit'
    # must match 'well lit', not collapse to 'welllit')
    ans = ans.replace("-", " ")
    ans = _PUNCT.sub("", ans)
    ans = _PERIOD.sub("", ans)
    ans = ans.replace(":", "")
    words = []
    for w in ans.split():
        w = _NUMBER_WORDS.get(w, w)
        w = _CONTRACTIONS.get(w, w)
        if w not in _ARTICLES:
            words.append(w)
    return " ".join(words)


def vqa_accuracy(prediction: str, gt_answers: list[str]) -> float:
    """Official consensus accuracy: avg over leave-one-out subsets of
    min(#matches/3, 1)."""
    pred = normalize_vqa_answer(prediction)
    gts = [normalize_vqa_answer(a) for a in gt_answers]
    if len(gts) == 1:
        return float(pred == gts[0])
    accs = []
    for i in range(len(gts)):
        others = gts[:i] + gts[i + 1:]
        matches = sum(1 for a in others if a == pred)
        accs.append(min(matches / 3.0, 1.0))
    return sum(accs) / len(accs)


# --- ANLS (DocVQA / InfographicVQA) ---


def _levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def anls(prediction: str, gt_answers: list[str], threshold: float = 0.5) -> float:
    """Average Normalized Levenshtein Similarity (max over gts, thresholded)."""
    pred = prediction.strip().lower()
    best = 0.0
    for gt in gt_answers:
        g = gt.strip().lower()
        denom = max(len(pred), len(g))
        sim = 1.0 - _levenshtein(pred, g) / denom if denom else 1.0
        best = max(best, sim)
    return best if best >= threshold else 0.0


# --- Exact match (TallyQA / OCR-VQA / AI2D: "EM" in eval_utils.py:75-124) ---


def exact_match(prediction: str, gt_answers: list[str]) -> float:
    pred = prediction.strip().lower()
    return float(any(pred == g.strip().lower() for g in gt_answers))


# --- Relaxed accuracy (ChartQA: "RA") ---


def relaxed_accuracy(prediction: str, gt_answers: list[str], tolerance: float = 0.05) -> float:
    """ChartQA protocol: numeric answers match within ±5% relative tolerance,
    non-numeric answers require exact (case-insensitive) match."""
    pred = prediction.strip().rstrip("%").strip()
    for gt in gt_answers:
        g = gt.strip().rstrip("%").strip()
        try:
            p_val, g_val = float(pred), float(g)
            if g_val == 0.0:
                if p_val == 0.0:
                    return 1.0
            elif abs(p_val - g_val) / abs(g_val) <= tolerance:
                return 1.0
        except ValueError:
            if pred.lower() == g.lower():
                return 1.0
    return 0.0


# --- POPE (hallucination yes/no) ---


def pope_metrics(predictions: list[str], labels: list[str]) -> dict:
    def to_bool(s):
        s = s.strip().lower()
        return "yes" in s[:5]

    tp = fp = tn = fn = 0
    for p, l in zip(predictions, labels):
        pb, lb = to_bool(p), to_bool(l)
        if pb and lb:
            tp += 1
        elif pb and not lb:
            fp += 1
        elif not pb and not lb:
            tn += 1
        else:
            fn += 1
    n = max(tp + fp + tn + fn, 1)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return {
        "accuracy": (tp + tn) / n,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "yes_ratio": (tp + fp) / n,
    }


# --- CIDEr-D (caption) ---


def _ngrams(tokens: list[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


_PTB_PUNCT = re.compile(r"[\"'`.,;:?!()\[\]{}]")


def caption_tokenize(s: str) -> list[str]:
    """Lowercase + strip punctuation — a host-side approximation of the
    PTBTokenizer the COCO caption pipeline applies before CIDEr-D."""
    return _PTB_PUNCT.sub("", s.lower()).split()


def cider_d(
    candidates: dict[str, str],
    references: dict[str, list[str]],
    n_max: int = 4,
    sigma: float = 6.0,
) -> float:
    """CIDEr-D over {id: caption} vs {id: [refs]}.

    Exact pycocoevalcap ``ciderD_scorer.py`` semantics (the scorer behind the
    reference's caption_eval.py:5 ``COCOEvalCap``): tf = RAW n-gram count
    (not length-normalized), idf = log(N_images) - log(max(df, 1)) with df
    counted over each image's reference set, count-clipped "cosine"
    min(h_g, r_g)·r_g / (|h||r|), gaussian length penalty
    exp(-(len_h - len_r)^2 / 2σ²), averaged over refs and n, scaled ×10.
    Tokenization approximates PTBTokenizer (lowercase, strip punctuation).
    """
    ids = list(candidates)
    # document frequency: #images whose reference set contains the ngram
    df = [defaultdict(int) for _ in range(n_max)]
    for rid in ids:
        for n in range(n_max):
            seen = set()
            for ref in references[rid]:
                seen |= set(_ngrams(caption_tokenize(ref), n + 1).keys())
            for g in seen:
                df[n][g] += 1
    log_docs = math.log(max(len(ids), 1))

    def tfidf_vec(counts: Counter, n: int):
        vec, norm = {}, 0.0
        for g, c in counts.items():
            idf = log_docs - math.log(max(df[n][g], 1))
            w = float(c) * idf  # raw count — pycocoevalcap counts2vec
            vec[g] = w
            norm += w * w
        return vec, math.sqrt(norm)

    scores = []
    for rid in ids:
        cand_toks = caption_tokenize(candidates[rid])
        per_n = []
        for n in range(n_max):
            cvec, cnorm = tfidf_vec(_ngrams(cand_toks, n + 1), n)
            sims = []
            for ref in references[rid]:
                ref_toks = caption_tokenize(ref)
                rvec, rnorm = tfidf_vec(_ngrams(ref_toks, n + 1), n)
                num = sum(min(cvec.get(g, 0.0), v) * v for g, v in rvec.items())
                denom = cnorm * rnorm
                sim = num / denom if denom > 0 else 0.0
                delta = len(cand_toks) - len(ref_toks)
                sim *= math.exp(-(delta**2) / (2 * sigma**2))
                sims.append(sim)
            per_n.append(sum(sims) / max(len(sims), 1))
        scores.append(10.0 * sum(per_n) / n_max)
    return sum(scores) / max(len(scores), 1)
