"""Evaluation: log-prob scoring of continuations and perplexity."""
