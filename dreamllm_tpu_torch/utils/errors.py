"""Error taxonomy of the serving surface (a copy of
``dreamllm_tpu/utils/errors.py``; the port imports nothing of that package).

``ClientError`` marks a failure caused by invalid CLIENT-supplied input
(out-of-range sampling params, an empty prompt). A server maps it to 400
without a server-side stack trace; every other exception, plain
``ValueError`` from model-side bugs included, is a server fault.

It subclasses ``ValueError``, so library callers that validate inputs
directly (``engine.submit``) keep their documented ValueError contract.
"""

from __future__ import annotations


class ClientError(ValueError):
    """Invalid client-supplied input."""
