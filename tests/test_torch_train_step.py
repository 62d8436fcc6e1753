"""The training slice as a whole with float32 AdamW: three train steps of the
JAX package against the PyTorch port (``grad_accum`` 1 and 2), and the
non-finite skip. The bodies and their tolerances are in
``tests/_torch_train_step_cases.py``."""

from __future__ import annotations

import pytest

from tests._torch_train_step_cases import run_nonfinite_skip, run_three_train_steps


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_three_train_steps_match_jax(grad_accum):
    run_three_train_steps(False, grad_accum)


def test_nonfinite_gradient_skips_the_update():
    run_nonfinite_skip(False)
