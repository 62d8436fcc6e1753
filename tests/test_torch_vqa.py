"""The port's VQA driver and its metrics (``dreamllm_tpu_torch/eval/{vqa,
metrics,mmbench}.py``) against the JAX package on the CPU: the prompt ids
and the image position; ``run_vqa``'s predictions and score, greedy and
with 2 beams at batch 2, on the tiny float32 DreamLLM (weights from
``bridge.from_jax``), also under a template whose separator halts decoding;
``score_predictions`` for every metric; shard files merged; the process
split; and every metric and MMBench helper over one table of inputs.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import dreamllm_tpu.eval.metrics as jmetrics
import dreamllm_tpu.eval.mmbench as jmmbench
import dreamllm_tpu.eval.vqa as jvqa
import dreamllm_tpu_torch.eval.metrics as pmetrics
import dreamllm_tpu_torch.eval.mmbench as pmmbench
import dreamllm_tpu_torch.eval.vqa as pvqa
from dreamllm_tpu_torch.data.tokenization import ToyTokenizer
from tests._torch_port_helpers import dreamllm_params


class DecToy(ToyTokenizer):
    """Decodes every id above 9 to a word, so predictions carry the ids."""

    def decode(self, ids):
        return " ".join(f"t{int(i)}" for i in ids if int(i) > 9)


def _samples(n=3, px=16):
    rng = np.random.default_rng(0)
    return [{"id": i, "question": f"what is in image {i}?",
             "image": rng.random((px, px, 3)).astype(np.float32),
             "answers": ["something"] * 9 + [f"t{i}"]} for i in range(n)]


@pytest.mark.parametrize("template", ["vicuna_v1.1", "vicuna_v0"])
def test_prompt_ids_and_image_position_match_jax(template):
    jc, pc, _, _ = dreamllm_params()
    tok = DecToy(vocab_size=jc.llm.vocab_size)
    for q in ("what?", "How many dogs are there?\nAnswer briefly."):
        assert pvqa.build_vqa_prompt(pc, q, template) == jvqa.build_vqa_prompt(jc, q, template)
        p_ids, p_pos = pvqa.encode_vqa_prompt(tok, pc, q, template)
        j_ids, j_pos = jvqa.encode_vqa_prompt(tok, jc, q, template)
        np.testing.assert_array_equal(p_ids, j_ids)
        assert p_pos == j_pos and p_ids.dtype == np.int32
        st = pc.special_tokens
        assert p_ids[p_pos - 1] == st.im_start and p_ids[p_pos + pc.image_embed_len] == st.im_end


@pytest.mark.parametrize("num_beams,template", [(1, "vicuna_v1.1"), (2, "vicuna_v1.1"),
                                                (1, "vicuna_v0")],
                         ids=["greedy", "2beams", "greedy-halting-template"])
def test_run_vqa_matches_jax(num_beams, template, tmp_path):
    jc, pc, jp, pp = dreamllm_params()
    tok = DecToy(vocab_size=jc.llm.vocab_size)
    samples = _samples(3)
    kw = dict(task="vqav2", max_new_tokens=5, batch_size=2, num_beams=num_beams,
              template=template)
    want = jvqa.run_vqa(jp, jc, tok, samples, **kw)
    got = pvqa.run_vqa(pp, pc, tok, samples, **kw, out_path=str(tmp_path / "s.json"),
                       device="cpu")
    assert [p["prediction"] for p in got["predictions"]] == \
        [p["prediction"] for p in want["predictions"]]
    assert got["predictions"] == want["predictions"]
    assert got["score"] == pytest.approx(want["score"], abs=1e-12) and 0.0 <= got["score"] <= 1.0
    assert all(p["prediction"] for p in got["predictions"])  # decoded something
    assert json.load(open(tmp_path / "s.json"))["predictions"] == got["predictions"]


def test_run_vqa_mixed_image_sizes_and_shard_merge(tmp_path):
    jc, pc, jp, pp = dreamllm_params()
    tok = DecToy(vocab_size=jc.llm.vocab_size)
    samples = _samples(2, px=16) + _samples(1, px=24)
    samples[2]["id"] = 2
    kw = dict(task="vqav2", max_new_tokens=4, batch_size=3)
    got = pvqa.run_vqa(pp, pc, tok, samples, **kw, out_path=str(tmp_path / "a.json"),
                       device="cpu")
    assert got["predictions"] == jvqa.run_vqa(jp, jc, tok, samples, **kw)["predictions"]
    pvqa.run_vqa(pp, pc, tok, samples[:1], **kw, out_path=str(tmp_path / "b.json"), device="cpu")
    paths = [str(tmp_path / "a.json"), str(tmp_path / "b.json")]
    merged = pvqa.merge_prediction_shards(paths, str(tmp_path / "m.json"))
    want = jvqa.merge_prediction_shards(paths, str(tmp_path / "jm.json"))
    assert merged == want and merged["n"] == 4
    with pytest.raises(ValueError, match="no shard"):
        pvqa.merge_prediction_shards([], str(tmp_path / "x.json"))


def test_shard_for_process():
    items = list(range(10))
    assert pvqa.shard_for_process(items, index=0, count=3) == [0, 3, 6, 9]
    assert pvqa.shard_for_process(items, index=2, count=3) == [2, 5, 8]
    assert not torch.distributed.is_initialized()
    assert pvqa.shard_for_process(items) == items  # rank 0 of 1 outside a process group


def test_task_table_matches_jax():
    assert {k: vars(v) for k, v in pvqa.TASKS.items()} == \
        {k: vars(v) for k, v in jvqa.TASKS.items()}


PREDS = {
    "vqa_acc": [{"id": 0, "prediction": "Two dogs.", "answers": ["2 dogs"] * 3 + ["dogs"] * 7},
                {"id": 1, "prediction": "isnt it", "answers": ["isn't it"] * 10}],
    "anls": [{"id": 0, "prediction": "invoice 12", "answers": ["Invoice 12", "inv"]},
             {"id": 1, "prediction": "xyz", "answers": ["abcdef"]}],
    "em": [{"id": 0, "prediction": " Cat ", "answers": ["cat"]},
           {"id": 1, "prediction": "dog", "answers": ["cat"]}],
    "relaxed": [{"id": 0, "prediction": "10.4%", "answers": ["10"]},
                {"id": 1, "prediction": "0", "answers": ["0.0"]},
                {"id": 2, "prediction": "red", "answers": ["Red"]}],
    "pope": [{"id": i, "prediction": p, "label": l}
             for i, (p, l) in enumerate([("Yes, there is", "yes"), ("no", "yes"),
                                         ("yes", "no"), ("No.", "no")])],
    "cider": [{"id": 0, "prediction": "a dog runs on the grass",
               "references": ["a dog running on grass", "the dog runs"]},
              {"id": 1, "prediction": "two cats sleep",
               "references": ["two cats are sleeping", "cats asleep on a bed"]}],
    "exact": [{"id": 0, "prediction": "The answer is B", "label": "B",
               "options": {"A": "red", "B": "blue"}},
              {"id": 1, "prediction": "blue", "label": "B", "options": {"A": "red", "B": "blue"}},
              {"id": 2, "prediction": "Paris", "label": "paris"}],
}


@pytest.mark.parametrize("metric", sorted(PREDS))
def test_score_predictions_matches_jax(metric):
    got = pvqa.score_predictions(PREDS[metric], metric)
    assert got == jvqa.score_predictions(PREDS[metric], metric)
    assert 0.0 <= got <= 10.0
    with pytest.raises(ValueError):
        pvqa.score_predictions(PREDS[metric], "no-such-metric")


ANSWERS = ["Two", "two dogs.", "it's  well-lit", "isnt", "2.5", "none", "A man", "yes!",
           "Unanswerable", "the  (red) car", "wont", "3:00"]


def test_metrics_match_jax_over_a_table():
    for pred in ANSWERS:
        assert pmetrics.normalize_vqa_answer(pred) == jmetrics.normalize_vqa_answer(pred)
        for gts in (ANSWERS[:1], ANSWERS[:10], [pred] * 4 + ANSWERS[4:]):
            assert pmetrics.vqa_accuracy(pred, gts) == jmetrics.vqa_accuracy(pred, gts)
            assert pmetrics.anls(pred, gts) == jmetrics.anls(pred, gts)
            assert pmetrics.exact_match(pred, gts) == jmetrics.exact_match(pred, gts)
            assert pmetrics.relaxed_accuracy(pred, gts) == jmetrics.relaxed_accuracy(pred, gts)
    labels = ["yes", "no"] * 6
    assert pmetrics.pope_metrics(ANSWERS, labels) == jmetrics.pope_metrics(ANSWERS, labels)
    cands = {str(i): a for i, a in enumerate(ANSWERS)}
    refs = {str(i): [a, ANSWERS[(i + 1) % len(ANSWERS)]] for i, a in enumerate(ANSWERS)}
    assert pmetrics.cider_d(cands, refs) == jmetrics.cider_d(cands, refs)
    assert pmetrics._CONTRACTIONS == jmetrics._CONTRACTIONS and len(pmetrics._CONTRACTIONS) == 41


OPTIONS = {"A": "red", "B": "blue", "C": "green", "D": ""}


def test_mmbench_helpers_match_jax(tmp_path):
    for pred in ("A", "(b)", "c.", "a dog", "The answer is: (D)", "it is blue", "B: blue",
                 "red or green", "", "answer is c"):
        for opts in (None, OPTIONS):
            assert (pmmbench.extract_option_letter(pred, opts)
                    == jmmbench.extract_option_letter(pred, opts))
    assert (pmmbench.build_mmbench_prompt("Q?", OPTIONS, "a hint")
            == jmmbench.build_mmbench_prompt("Q?", OPTIONS, "a hint"))
    records = [{"group_id": g, "prediction": p, "answer": a, "options": OPTIONS,
                "question": "Q?", "index": i}
               for i, (g, p, a) in enumerate([(0, "A", "A"), (0, "B.", "A"), (1, "C", "C"),
                                               (1, "green", "C"), (2, "D", "B")])]
    assert pmmbench.circular_accuracy(records) == jmmbench.circular_accuracy(records) == 1 / 3
    pmmbench.export_results(records, str(tmp_path / "p.xlsx"))
    jmmbench.export_results(records, str(tmp_path / "j.xlsx"))
    outs = sorted(p.name for p in tmp_path.iterdir())
    assert len(outs) == 2 and outs[0].startswith("j.") and outs[1].startswith("p.")
    if outs[0].endswith(".tsv"):  # openpyxl absent: the TSV fallback, byte for byte
        assert (tmp_path / "p.tsv").read_text() == (tmp_path / "j.tsv").read_text()
