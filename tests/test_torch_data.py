"""The port's synthetic data pipeline against the reference's, on the CPU.

``synth_batch`` draws from the same numpy generator with the same seed
formula and order of calls, so each batch is held to the reference's byte
for byte: tokens and labels (int32), whisper's ``frames`` and internvl's
``embeds`` (float32), at several steps, seeds and host shards.
"""

import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.data import pipeline as ref_pipeline
from repro_torch.configs.base import get_config, reduced
from repro_torch.data import DataConfig, PrefetchIterator, synth_batch


def _same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key, val in got.items():
        ref = np.asarray(want[key])
        assert isinstance(val, torch.Tensor) and val.device.type == "cpu"
        arr = val.numpy()
        assert arr.dtype == ref.dtype and arr.shape == ref.shape, key
        assert arr.tobytes() == ref.tobytes(), key


@pytest.mark.parametrize("arch,keys", [
    ("qwen1.5-0.5b", {"tokens", "labels"}),
    ("whisper-large-v3", {"tokens", "labels", "frames"}),
    ("internvl2-76b", {"tokens", "labels", "embeds"})])
def test_synth_batch_is_the_references_byte_for_byte(arch, keys):
    """The published configs (vocabulary, decoder length, patch tokens)
    and the reduced ones, at steps 0, 1 and 37, two seeds, one host of
    one and each host of two."""
    n = 0
    for cfg, ref_cfg in ((get_config(arch), ref_get_config(arch)),
                         (reduced(get_config(arch)),
                          ref_reduced(ref_get_config(arch)))):
        for seed, hosts in ((0, 1), (5, 2)):
            for host in range(hosts):
                kw = dict(global_batch=4, seq_len=24, seed=seed,
                          host_index=host, host_count=hosts)
                for step in (0, 1, 37):
                    got = synth_batch(DataConfig(**kw), cfg, step)
                    assert set(got) == keys
                    _same(got, ref_pipeline.synth_batch(
                        ref_pipeline.DataConfig(**kw), ref_cfg, step))
                    n += 1
    assert n == 18


def test_prefetch_iterator_yields_in_order_from_start_step():
    cfg = reduced(get_config("qwen1.5-0.5b"))
    ref_cfg = ref_reduced(ref_get_config("qwen1.5-0.5b"))
    kw = dict(global_batch=2, seq_len=16, seed=3)
    for start in (0, 7):
        it = PrefetchIterator(DataConfig(**kw), cfg, start_step=start,
                              depth=2)
        try:
            got = [next(it) for _ in range(5)]
        finally:
            it.close()
        assert [s for s, _ in got] == list(range(start, start + 5))
        for step, batch in got:
            _same(batch, ref_pipeline.synth_batch(
                ref_pipeline.DataConfig(**kw), ref_cfg, step))
        assert not it._thread.is_alive()
