"""The port's token stream and token-space characters against
``repro.data.lm``: the same key yields bit-identical batches."""

import jax
import numpy as np
import pytest
import torch

from repro.data import lm as RL
from repro_torch import random as R
from repro_torch.data import lm as L


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 2])
def test_hmm_stream_bit_identical(seed):
    want = list(RL.hmm_stream(jax.random.PRNGKey(seed),
                              RL.LMConfig(512, 24, 4), 3))
    got = list(L.hmm_stream(R.PRNGKey(seed), L.LMConfig(512, 24, 4), 3,
                            device="cpu"))
    assert len(got) == 3
    for a, b in zip(want, got):
        for k in ("tokens", "labels"):
            assert b[k].dtype == torch.int32 and b[k].shape == (4, 24)
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))


def test_hmm_stream_vocab_band_clamp():
    """A vocabulary narrower than two bands, as the reference clamps it."""
    want = next(RL.hmm_stream(jax.random.PRNGKey(5),
                              RL.LMConfig(40, 8, 3, n_states=8), 1))
    got = next(L.hmm_stream(R.PRNGKey(5), L.LMConfig(40, 8, 3, n_states=8),
                            1, device="cpu"))
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))


def test_token_characters_equal():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 6, (10, 5), dtype=np.int32)
    toks[3] = toks[1]
    for window in (8, 2):
        want = RL.token_characters(toks, window=window)
        assert L.token_characters(torch.tensor(toks), window=window) == want
        assert L.token_characters(toks, window=window) == want
