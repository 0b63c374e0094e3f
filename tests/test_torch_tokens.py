"""Port parity, the synthetic token stream: the port's own copy of
``TokenStream`` yields the reference's batches bit for bit, and resumes
from a ``state_dict`` to the same stream."""
import numpy as np
import pytest

from repro.data import TokenStream as JTokenStream

from repro_torch.data import TokenStream


@pytest.mark.parametrize("vocab,batch,seq,seed", [(512, 4, 32, 0),
                                                  (128256, 2, 64, 3)])
def test_token_stream_equals_reference(vocab, batch, seq, seed):
    ours, ref = TokenStream(vocab, batch, seq, seed=seed), \
        JTokenStream(vocab, batch, seq, seed=seed)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert sorted(a) == sorted(b) == ["loss_mask", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert ours.state_dict() == ref.state_dict() == {"step": 3}


def test_token_stream_resumes_from_its_state():
    ours = TokenStream(512, 2, 16, seed=1, zipf_a=1.1, repeat_p=0.5)
    ref = JTokenStream(512, 2, 16, seed=1, zipf_a=1.1, repeat_p=0.5)
    for _ in range(5):
        next(ours)
    state = ours.state_dict()
    fresh = TokenStream(512, 2, 16, seed=1, zipf_a=1.1, repeat_p=0.5)
    fresh.load_state_dict(state)
    ref.load_state_dict(state)
    for _ in range(2):
        a, b, c = next(ours), next(fresh), next(ref)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["tokens"], c["tokens"])
    # the stream is Zipf with repetition: token 0 is the most frequent
    toks = next(ours)["tokens"]
    assert np.bincount(toks.ravel()).argmax() == 0
