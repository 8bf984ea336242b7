"""The port's data pipeline against the JAX package's: the same batches,
bit for bit (both are NumPy; the port keeps its own copy)."""

import dataclasses

import numpy as np
import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.data import pipeline as jax_pipeline
from repro_torch.configs import ARCHS, reduced
from repro_torch.data import pipeline

ARCH_NAMES = ("smollm-360m", "gemma2-2b", "mamba2-130m", "zamba2-2.7b")


@pytest.mark.parametrize("seed,step,seq,batch,vocab", [
    (0, 0, 16, 2, 256), (0, 7, 33, 3, 4096), (3, 1, 128, 4, 32000),
    (11, 123, 64, 1, 100), (5, 2, 1024, 8, 49152)])
def test_synthetic_batch_bit_equal(seed, step, seq, batch, vocab):
    got = pipeline.synthetic_batch(
        pipeline.DataConfig(seed, seq, batch, vocab), step)
    want = jax_pipeline.synthetic_batch(
        jax_pipeline.DataConfig(seed, seq, batch, vocab), step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("seed,step", [(0, 0), (2, 5)])
def test_batch_for_model_bit_equal(arch, seed, step):
    cfg, jcfg = reduced(ARCHS[arch]), jax_reduced(JAX_ARCHS[arch])
    got = pipeline.batch_for_model(
        cfg, pipeline.DataConfig(seed=seed, seq_len=24, global_batch=2),
        step)
    want = jax_pipeline.batch_for_model(
        jcfg, jax_pipeline.DataConfig(seed=seed, seq_len=24,
                                      global_batch=2), step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_batch_for_model_embed_frontend_bit_equal():
    """The stub frontend's embeddings come from a second generator."""
    cfg = dataclasses.replace(reduced(ARCHS["smollm-360m"]), frontend="embed")
    jcfg = dataclasses.replace(jax_reduced(JAX_ARCHS["smollm-360m"]),
                               frontend="embed")
    got = pipeline.batch_for_model(cfg, pipeline.DataConfig(seq_len=8), 3)
    want = jax_pipeline.batch_for_model(
        jcfg, jax_pipeline.DataConfig(seq_len=8), 3)
    assert set(got) == {"embeds", "labels"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_stream_is_step_indexed():
    cfg = reduced(ARCHS["smollm-360m"])
    dcfg = pipeline.DataConfig(seq_len=8, global_batch=2)
    it = pipeline.stream(cfg, dcfg, start_step=4)
    for step in (4, 5, 6):
        b = next(it)
        np.testing.assert_array_equal(
            b["tokens"], pipeline.batch_for_model(cfg, dcfg, step)["tokens"])
