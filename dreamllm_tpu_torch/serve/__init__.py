"""Serving: the continuous-batching decode engine."""
