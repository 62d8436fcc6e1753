"""MMBench evaluation helpers: option-letter extraction, circular evaluation,
and result export (a copy of ``dreamllm_tpu/eval/mmbench.py``, which
imports no JAX).

The reference's MMBench path (omni/eval/vqa — xlsx export + letter matching).
xlsx needs openpyxl (not in this image); export falls back to TSV, which the
MMBench server also accepts.
"""

from __future__ import annotations

import csv
import re
from collections import defaultdict

LETTERS = "ABCD"


def build_mmbench_prompt(question: str, options: dict[str, str], hint: str | None = None) -> str:
    parts = []
    if hint:
        parts.append(f"Hint: {hint}")
    parts.append(question)
    for k in LETTERS:
        if k in options and options[k]:
            parts.append(f"{k}. {options[k]}")
    parts.append("Answer with the option's letter from the given choices directly.")
    return "\n".join(parts)


def extract_option_letter(prediction: str, options: dict[str, str] | None = None) -> str | None:
    """Pull the chosen letter out of a free-form answer: leading letter,
    '(A)', 'A.', or a unique option-text match."""
    p = prediction.strip()
    # uppercase letter: any terminator. Lowercase: only with explicit option
    # punctuation ('a.' / '(a)' / 'a:') — a bare lowercase 'a ' is almost
    # always the English article ('a dog'), not option A
    m = re.match(r"^\(?([A-D])\)?([.:\s]|$)", p)
    if m:
        return m.group(1)
    m = re.match(r"^\(([a-d])\)|^([a-d])[.:]", p)
    if m:
        return (m.group(1) or m.group(2)).upper()
    m = re.search(r"answer\s+is\s*:?\s*\(?([A-D])\)?(\b|$)", p, re.IGNORECASE)
    if m:
        return m.group(1).upper()
    if options:
        hits = [k for k, v in options.items() if v and v.strip().lower() in p.lower()]
        if len(hits) == 1:
            return hits[0]
    return None


def circular_accuracy(records: list[dict]) -> float:
    """MMBench circular evaluation: a question (grouped by ``group_id``)
    counts only if ALL its option-rotated variants are answered correctly."""
    groups = defaultdict(list)
    for r in records:
        groups[r["group_id"]].append(r)
    correct = 0
    for g in groups.values():
        ok = all(
            extract_option_letter(r["prediction"], r.get("options")) == r["answer"]
            for r in g
        )
        correct += int(ok)
    return correct / max(len(groups), 1)


def export_results(records: list[dict], out_path: str):
    """Write the MMBench submission table (xlsx if openpyxl exists, else TSV
    with identical columns)."""
    cols = ["index", "question", "A", "B", "C", "D", "prediction"]

    def row(r):
        opts = r.get("options", {})
        return [r.get("index", r.get("group_id", "")), r.get("question", ""),
                opts.get("A", ""), opts.get("B", ""), opts.get("C", ""),
                opts.get("D", ""), r["prediction"]]

    try:
        import openpyxl  # noqa: F401
        from openpyxl import Workbook

        wb = Workbook()
        ws = wb.active
        ws.append(cols)
        for r in records:
            ws.append(row(r))
        wb.save(out_path if out_path.endswith(".xlsx") else out_path + ".xlsx")
    except ImportError:
        path = out_path.rsplit(".", 1)[0] + ".tsv"
        with open(path, "w", newline="") as f:
            w = csv.writer(f, delimiter="\t")
            w.writerow(cols)
            for r in records:
                w.writerow(row(r))
