"""The port's synthetic LM token stream against the JAX package's.

``lm_token_stream`` draws from numpy's ``default_rng(seed)`` in both
packages, so its tokens and labels must agree bit for bit; the port
yields int32 tensors on the CPU.
"""
import numpy as np
import pytest
import torch

from repro.data.synthetic import lm_batch as ref_lm_batch
from repro.data.synthetic import lm_token_stream as ref_stream

from repro_torch.data.synthetic import lm_batch, lm_token_stream


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("vocab,batch,seq", [(512, 8, 32), (2048, 4, 128)])
def test_lm_token_stream_is_the_references_bit_for_bit(seed, vocab, batch,
                                                       seq):
    ours, ref = (lm_token_stream(vocab, batch, seq, seed=seed),
                 ref_stream(vocab, batch, seq, seed=seed))
    for _ in range(3):
        got, want = next(ours), next(ref)
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            assert got[key].device.type == "cpu"
            assert got[key].shape == (batch, seq)
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


def test_lm_batch_is_the_streams_first_and_labels_shift():
    got = lm_batch(512, 2, 16, seed=3)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(ref_lm_batch(512, 2, 16,
                                                          seed=3)["tokens"]))
    # labels are the tokens shifted by one position
    np.testing.assert_array_equal(got["tokens"][:, 1:].numpy(),
                                  got["labels"][:, :-1].numpy())
