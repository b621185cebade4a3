"""The port's HashingEncoder against the JAX package's: identical token ids,
identical table bytes, encodes within 1e-6 (XLA's and PyTorch's tanh and
sums differ by ulps)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import encoder as jax_encoder
from repro.data.synthetic import make_workload
from repro_torch import convert
from repro_torch.core import encoder as torch_encoder


def _texts(seed):
    wl = make_workload(num_entities=5, num_sessions=8, num_queries=12,
                       seed=seed)
    texts = [t.text for s in wl.sessions for t in s.turns]
    return texts + [q.text for q in wl.queries] + ["", "the a of", "x"]


@pytest.mark.parametrize("seed", [0, 7])
def test_token_ids_identical(seed):
    for text in _texts(seed):
        assert torch_encoder._tokenize(text) == jax_encoder._tokenize(text)


@pytest.mark.parametrize("dim,seed", [(256, 0), (64, 3)])
def test_table_bytes_identical(dim, seed):
    a = np.asarray(jax_encoder.HashingEncoder(dim=dim, seed=seed)._table)
    b = torch_encoder.HashingEncoder(dim=dim, seed=seed,
                                     device="cpu")._table.numpy()
    assert a.dtype == b.dtype == np.float32
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed,max_batch", [(0, 1024), (7, 1024), (7, 5)])
def test_encode_matches(seed, max_batch):
    texts = _texts(seed)
    a = jax_encoder.HashingEncoder(max_batch=max_batch)
    b = torch_encoder.HashingEncoder(max_batch=max_batch, device="cpu")
    ea, eb = a.encode(texts), b.encode(texts)
    assert eb.dtype == np.float32 and eb.shape == ea.shape
    np.testing.assert_allclose(eb, ea, atol=1e-6, rtol=0)
    assert (a.stats.calls, a.stats.tokens, a.stats.texts) == \
        (b.stats.calls, b.stats.tokens, b.stats.texts)


def test_sequential_and_single_encode_match():
    texts = _texts(3)[:6]
    a = jax_encoder.HashingEncoder()
    b = torch_encoder.HashingEncoder(device="cpu")
    np.testing.assert_allclose(b.encode(texts, sequential=True),
                               a.encode(texts, sequential=True), atol=1e-6)
    assert b.stats.sequential_calls == a.stats.sequential_calls == len(texts)
    np.testing.assert_allclose(b.encode_one(texts[0]), a.encode_one(texts[0]),
                               atol=1e-6)
    assert b.encode([]).shape == (0, 256)


def test_convert_carries_the_jax_table():
    jax_enc = jax_encoder.HashingEncoder(seed=0)
    carried = convert.hashing_encoder_from_numpy(np.asarray(jax_enc._table),
                                                 device="cpu")
    seeded = torch_encoder.HashingEncoder(seed=0, device="cpu")
    assert carried._table.numpy().tobytes() == seeded._table.numpy().tobytes()
    texts = _texts(0)[:20]
    np.testing.assert_array_equal(carried.encode(texts), seeded.encode(texts))


def test_convert_rejects_a_bad_table():
    with pytest.raises(ValueError):
        convert.hashing_encoder_from_numpy(np.zeros(8, np.float32),
                                           device="cpu")
    with pytest.raises(ValueError):
        convert.hashing_encoder_from_numpy(np.zeros((10, 4), np.float32),
                                           device="cpu")
