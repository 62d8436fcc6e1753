"""Evaluation: log-prob scoring of continuations and perplexity (``nlp``),
the VQA / captioning driver (``vqa``), its metrics (``metrics``) and the
MMBench helpers (``mmbench``)."""

from dreamllm_tpu_torch.eval import metrics, mmbench, nlp, vqa

__all__ = ["metrics", "mmbench", "nlp", "vqa"]
