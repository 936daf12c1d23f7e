"""The tests of ``tests/test_torch_train_parity.py`` (one train step of
the port against the JAX package's, tolerances stated there) on the two
configs with a front end: whisper-base (the encoder in full mode,
cross-attention) and internvl2-26b (the patch prefix's offset).  A file
of their own so that each runs on one xdist worker in about half the
time.
"""

import pytest

pytest.importorskip("torch")

from tests.test_torch_train_parity import (  # noqa: E402, F401 (the tests)
    compute_pair, one_thread, test_apply_updates_matches_jax,
    test_every_grad_leaf_matches_jax, test_loss_terms_match_jax,
    test_train_step_params_match_jax)


@pytest.fixture(scope="module", params=("whisper-base", "internvl2-26b"))
def pair(request):
    return compute_pair(request.param)
