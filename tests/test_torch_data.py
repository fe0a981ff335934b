"""The port's token stream (`repro_torch.data`) against the reference's.

Both are numpy only, so batches must equal the reference's bit for bit for
any (seed, step, host), in both kinds; the unigram entropy too.
"""
import numpy as np
import pytest

from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import TokenStream as JTokenStream  # noqa: E402
from repro.data import unigram_entropy as j_unigram_entropy  # noqa: E402
from repro_torch.data import DataConfig, TokenStream, unigram_entropy


@pytest.mark.parametrize("kind", ["ngram", "uniform"])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("n_hosts", [1, 2])
def test_batches_bit_identical_to_reference(kind, seed, n_hosts):
    cfg = dict(vocab=300, seq_len=24, global_batch=4, seed=seed, kind=kind)
    for host in range(n_hosts):
        ours = TokenStream(DataConfig(**cfg), host_id=host, n_hosts=n_hosts)
        ref = JTokenStream(JDataConfig(**cfg), host_id=host, n_hosts=n_hosts)
        assert ours.local_batch == ref.local_batch == 4 // n_hosts
        for step in (0, 1, 5, 123):
            a, b = ours.batch(step)["tokens"], ref.batch(step)["tokens"]
            assert a.dtype == b.dtype == np.int32
            assert a.shape == (4 // n_hosts, 25)
            np.testing.assert_array_equal(a, b)


def test_iteration_replays_steps_and_hosts_differ():
    cfg = DataConfig(vocab=300, seq_len=16, global_batch=4, seed=3)
    stream = TokenStream(cfg)
    it = iter(stream)
    for step in range(3):
        np.testing.assert_array_equal(next(it)["tokens"],
                                      stream.batch(step)["tokens"])
    h0 = TokenStream(cfg, host_id=0, n_hosts=2).batch(0)["tokens"]
    h1 = TokenStream(cfg, host_id=1, n_hosts=2).batch(0)["tokens"]
    assert not np.array_equal(h0, h1)
    with pytest.raises(ValueError):
        TokenStream(DataConfig(vocab=10, seq_len=4, global_batch=3),
                    n_hosts=2)


@pytest.mark.parametrize("vocab", [256, 49155])
def test_unigram_entropy_equals_reference(vocab):
    assert unigram_entropy(vocab) == j_unigram_entropy(vocab)
