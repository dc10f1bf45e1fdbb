"""The port's data pipeline (``accelerate_tpu_torch/data_loader.py``,
``pipeline/prefetch.py``, the dataloader half of ``state.GradientState``)
against the JAX package's ``data_loader.py`` on the same torch datasets.

The JAX side runs at one data shard: ``prepare_data_loader`` is called
with no ``AcceleratorState`` built, so it finds no mesh, shards nothing and
keeps the batch size, as one GPU does.  Batches are compared by value,
exactly (both sides only reorder and move integers and floats).
"""

import math

import numpy as np
import pytest
import torch
from torch.utils.data import BatchSampler, DataLoader, IterableDataset, SequentialSampler

from accelerate_tpu import data_loader as jdl
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu_torch import data_loader as tdl
from accelerate_tpu_torch.state import GradientState


def _dataset(n):
    return [{"x": torch.tensor([float(i)]), "i": torch.tensor(i)} for i in range(n)]


def _loader(n, bs, shuffle=False, drop_last=False):
    return DataLoader(_dataset(n), batch_size=bs, shuffle=shuffle, drop_last=drop_last)


def _ids(batches):
    return [b["i"].tolist() for b in batches]


def _jax(dl, **kw):
    return jdl.prepare_data_loader(dl, put_on_device=False, **kw)


def _port(dl, **kw):
    kw.setdefault("device", "cpu")
    return tdl.prepare_data_loader(dl, **kw)


@pytest.mark.parametrize("seedable", [True, False], ids=["seedable", "generator"])
@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffle", "ordered"])
def test_batches_by_value_over_two_epochs(shuffle, seedable):
    kw = dict(use_seedable_sampler=seedable, data_seed=7)
    want = _jax(_loader(22, 4, shuffle), rng_types=["generator"], **kw)  # the JAX default
    got = _port(_loader(22, 4, shuffle), **kw)
    for _ in range(2):
        w, g = list(want), list(got)
        assert _ids(g) == _ids(w)
        for a, b in zip(g, w):
            assert torch.equal(a["x"], torch.as_tensor(np.asarray(b["x"])))
    if shuffle:
        assert sorted(sum(_ids(g), [])) == list(range(22))


def test_seedable_sampler_matches_jax_per_epoch():
    for epoch in (0, 1, 5):
        a = tdl.SeedableRandomSampler(list(range(50)), initial_seed=3)
        b = jdl.SeedableRandomSampler(list(range(50)), initial_seed=3)
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        assert list(a) == list(b)
        assert a.epoch == b.epoch == epoch + 1
    gen_a, gen_b = torch.Generator(), torch.Generator()
    a = tdl.SeedableRandomSampler(list(range(50)), initial_seed=3, generator=gen_a)
    b = jdl.SeedableRandomSampler(list(range(50)), initial_seed=3, generator=gen_b)
    assert list(a) == list(b)


@pytest.mark.parametrize("depth", [0, 1, 2])
@pytest.mark.parametrize("n", [16, 18])
def test_end_of_dataloader_both_iterations(n, depth):
    """The flag is True exactly while the last batch is in hand, on both
    iterations, read through the loader and through its GradientState, as
    the JAX loader (depth 0; the JAX prefetcher flips it the same way)."""
    gs = GradientState()
    got = tdl.DataLoaderShard(_loader(n, 4), device="cpu", prefetch_to_device=depth,
                              gradient_state=gs)
    want = jdl.DataLoaderShard(_loader(n, 4), put_on_device=False)
    jgs = JaxGradientState()
    for _ in range(2):
        seen, flags = [], []
        for _batch in got:
            seen.append((got.end_of_dataloader, gs.end_of_dataloader, gs.in_dataloader))
        for _batch in want:
            flags.append((want.end_of_dataloader, jgs.end_of_dataloader, jgs.in_dataloader))
        assert seen == flags
        assert [s[0] for s in seen] == [False] * (len(seen) - 1) + [True]
        assert not gs.in_dataloader and not gs.end_of_dataloader


@pytest.mark.parametrize("n,bs", [(72, 32), (64, 32), (10, 4)])
def test_remainder(n, bs):
    got = _port(_loader(n, bs))
    want = _jax(_loader(n, bs))
    rem = []
    for _ in got:
        rem.append(got.gradient_state.remainder)
    jrem = [JaxGradientState().remainder for _ in want]
    assert rem == jrem == [n % bs] * math.ceil(n / bs)
    assert got.remainder == want.remainder == n % bs


@pytest.mark.parametrize("depth", [0, 2])
def test_skip_first_batches(depth):
    got = tdl.skip_first_batches(_port(_loader(30, 4, shuffle=True), use_seedable_sampler=True,
                                       prefetch_to_device=depth), 3)
    want = jdl.skip_first_batches(_jax(_loader(30, 4, shuffle=True), use_seedable_sampler=True), 3)
    assert len(got) == len(want) == 5
    assert _ids(list(got)) == _ids(list(want))
    raw = tdl.skip_first_batches(DataLoader(list(range(16)), batch_size=4), 2)
    assert isinstance(raw, tdl.SkipDataLoader)
    assert [t.tolist() for t in raw] == [[8, 9, 10, 11], [12, 13, 14, 15]]
    skipped = tdl.SkipBatchSampler(BatchSampler(SequentialSampler(range(16)), 4, False), 2)
    assert list(skipped) == [[8, 9, 10, 11], [12, 13, 14, 15]]
    assert len(skipped) == 2 and skipped.total_length == 4


@pytest.mark.parametrize("depth", [0, 1, 2])
@pytest.mark.parametrize("taken", [1, 3, 7])
def test_midepoch_state_dict_roundtrip(taken, depth):
    """``state_dict`` counts only the batches the user has seen (never the
    lookahead or prefetched ones); a fresh loader restored from it yields
    the rest of that epoch, then full epochs, as the JAX loader does."""
    kw = dict(use_seedable_sampler=True, use_stateful_dataloader=True)
    got = _port(_loader(32, 4, shuffle=True), prefetch_to_device=depth, **kw)
    want = _jax(_loader(32, 4, shuffle=True), **kw)
    it, jit = iter(got), iter(want)
    for k in range(taken):
        assert next(it)["i"].tolist() == next(jit)["i"].tolist()
        assert got.state_dict() == want.state_dict() == {"batches_yielded": k + 1, "iteration": 0}
    sd = got.state_dict()
    rest = _ids(list(it))
    del it, jit

    again = _port(_loader(32, 4, shuffle=True), prefetch_to_device=depth, **kw)
    again.load_state_dict(sd)
    jagain = _jax(_loader(32, 4, shuffle=True), **kw)
    jagain.load_state_dict(sd)
    resumed = _ids(list(again))
    assert resumed == rest == _ids(list(jagain))
    assert len(list(again)) == 8  # the skip is consumed once


@pytest.mark.parametrize("depth", [0, 2])
def test_epoch_boundary_state_dict_roundtrip(depth):
    kw = dict(use_stateful_dataloader=True)
    got = _port(_loader(32, 4), prefetch_to_device=depth, **kw)
    want = _jax(_loader(32, 4), **kw)
    for _ in range(2):
        assert len(list(got)) == len(list(want)) == 8
    assert got.state_dict() == want.state_dict() == {"batches_yielded": 0, "iteration": 2}
    again = _port(_loader(32, 4), prefetch_to_device=depth, **kw)
    again.load_state_dict(got.state_dict())
    assert again.iteration == 2
    assert _ids(list(again))[0] == [0, 1, 2, 3] and len(list(again)) == 8


def test_set_epoch_reaches_samplers():
    sampler = tdl.SeedableRandomSampler(list(range(16)), initial_seed=3)
    dl = tdl.DataLoaderShard(DataLoader(_dataset(16), batch_size=4, sampler=sampler),
                             put_on_device=False)
    dl.set_epoch(3)
    assert sampler.epoch == 3 and dl.iteration == 3

    class EpochBatchSampler:
        def __init__(self, n, batch_size):
            self.n, self.batch_size, self.drop_last, self.epoch = n, batch_size, False, 0

        def set_epoch(self, epoch):
            self.epoch = epoch

        def __iter__(self):
            for i in range(0, self.n, self.batch_size):
                yield list(range(i, min(i + self.batch_size, self.n)))

        def __len__(self):
            return math.ceil(self.n / self.batch_size)

    bs = EpochBatchSampler(16, 4)
    dl = _port(DataLoader(_dataset(16), batch_sampler=bs))
    dl.set_epoch(1)
    assert bs.epoch == 1
    # A prepared seedable loader's sampler is the one under its batch
    # sampler, and every epoch reseeds it from the loader's epoch.
    dl = _port(_loader(16, 4, shuffle=True), use_seedable_sampler=True)
    assert isinstance(dl.sampler, tdl.SeedableRandomSampler)
    first = _ids(list(dl))
    dl.set_epoch(0)
    assert _ids(list(dl)) == first


@pytest.mark.parametrize("static", [False, True], ids=["short_tail", "static_tail"])
def test_static_shape_tail(static):
    got = _port(_loader(10, 4), static_shape_tail=static)
    want = _jax(_loader(10, 4), static_shape_tail=static)
    assert _ids(list(got)) == _ids(list(want))
    assert [len(b) for b in _ids(list(got))] == ([4, 4, 4] if static else [4, 4, 2])


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_same_batches_as_synchronous(depth):
    sync = _ids(list(_port(_loader(26, 4, shuffle=True), use_seedable_sampler=True)))
    pre = _port(_loader(26, 4, shuffle=True), use_seedable_sampler=True, prefetch_to_device=depth)
    flags = []
    got = []
    for b in pre:
        got.append(b["i"].tolist())
        flags.append(pre.end_of_dataloader)
    assert got == sync
    assert flags == [False] * 6 + [True]
    assert len(pre.prefetch_blocked_ms) == 7


class _Exploding(IterableDataset):
    def __iter__(self):
        for i in range(10):
            if i == 6:
                raise RuntimeError("bad sample 6")
            yield torch.tensor([i])


def _read_until_error(dl):
    seen = []
    with pytest.raises(RuntimeError, match="bad sample 6"):
        for b in dl:
            seen.append(np.asarray(b).reshape(-1).tolist())
    return seen


@pytest.mark.parametrize("depth", [1, 2])
def test_prefetch_worker_error_surfaces_at_its_batch(depth):
    """Fetching batch [6, 7] fails.  Batch [4, 5] waits on that fetch (its
    ``is_last`` needs it), so the error takes its place: where the
    synchronous loader and the JAX prefetcher raise too."""
    got = _read_until_error(_port(DataLoader(_Exploding(), batch_size=2),
                                  prefetch_to_device=depth))
    assert got == [[0, 1], [2, 3]]
    assert got == _read_until_error(_port(DataLoader(_Exploding(), batch_size=2)))
    assert got == _read_until_error(jdl.DataLoaderShard(
        DataLoader(_Exploding(), batch_size=2), put_on_device=False, prefetch_to_device=depth))


def test_prefetcher_rejects_depth_zero_and_reads_env(monkeypatch):
    from accelerate_tpu_torch.pipeline.prefetch import DevicePrefetcher, prefetch_depth_from_env

    with pytest.raises(ValueError):
        DevicePrefetcher(iter([]), lambda b: b, depth=0)
    monkeypatch.setenv("ACCELERATE_TPU_PREFETCH", "2")
    assert prefetch_depth_from_env() == 2
    monkeypatch.setenv("ACCELERATE_TPU_PREFETCH", "x")
    assert prefetch_depth_from_env() == 0


def test_abandoned_epoch_stops_the_worker():
    import threading

    dl = _port(_loader(64, 2), prefetch_to_device=2)
    it = iter(dl)
    next(it)
    it.close()
    assert not [t for t in threading.enumerate() if t.name == "atpu-torch-prefetch"]


def test_iterable_dataset_batches():
    class Stream(IterableDataset):
        def __iter__(self):
            return iter(torch.arange(11).float()[:, None])

    got = [b.reshape(-1).tolist() for b in _port(DataLoader(Stream(), batch_size=4))]
    want = [np.asarray(b).reshape(-1).tolist() for b in _jax(DataLoader(Stream(), batch_size=4))]
    assert got == want == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10]]


@pytest.mark.parametrize("shuffle", [False, True])
def test_unbatched_loader_passes_samples_through(shuffle):
    data = [torch.full((2, 3), float(i)) for i in range(5)]
    dl = _port(DataLoader(data, batch_size=None, shuffle=shuffle), use_seedable_sampler=True)
    got = list(dl)
    assert all(t.shape == (2, 3) for t in got) and dl.end_of_dataloader
    assert sorted(int(t[0, 0]) for t in got) == list(range(5))


def test_loader_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdl.prepare_data_loader(_loader(8, 4))
    dl = tdl.prepare_data_loader(_loader(8, 4), put_on_device=False)
    assert dl.device is None and len(list(dl)) == 2


def test_send_to_device_and_find_batch_size():
    from collections import namedtuple

    from accelerate_tpu_torch.utils.operations import find_batch_size, send_to_device

    Pair = namedtuple("Pair", "a b")
    batch = {"p": Pair(torch.zeros(3, 2), [torch.ones(3)]), "keep": torch.ones(1), "n": 4}
    out = send_to_device(batch, "cpu", skip_keys="keep")
    assert isinstance(out["p"], Pair) and out["keep"] is batch["keep"] and out["n"] == 4
    assert find_batch_size(batch) == 3
    with pytest.raises(TypeError):
        find_batch_size({"n": 4})


def _shards(n, bs, procs, split, drop, even, mod):
    out = []
    for p in range(procs):
        sampler = BatchSampler(SequentialSampler(range(n)), batch_size=bs, drop_last=drop)
        out.append(list(mod.BatchSamplerShard(sampler, num_processes=procs, process_index=p,
                                              split_batches=split, even_batches=even)))
    return out


@pytest.mark.parametrize("even", [True, False], ids=["even", "uneven"])
@pytest.mark.parametrize("drop", [False, True], ids=["keep", "drop"])
@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
@pytest.mark.parametrize("procs", [1, 2, 3])
@pytest.mark.parametrize("n", [12, 13, 17])
def test_batch_sampler_shard_matches_jax(n, procs, split, drop, even):
    bs = 6 if split else 4
    assert _shards(n, bs, procs, split, drop, even, tdl) == _shards(
        n, bs, procs, split, drop, even, jdl)
    for p in range(procs):
        sampler = BatchSampler(SequentialSampler(range(n)), batch_size=bs, drop_last=drop)
        assert len(tdl.BatchSamplerShard(sampler, procs, p, split, even)) == len(
            jdl.BatchSamplerShard(sampler, procs, p, split, even))


@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
@pytest.mark.parametrize("drop", [False, True], ids=["keep", "drop"])
@pytest.mark.parametrize("procs", [1, 2])
def test_iterable_dataset_shard_matches_jax(procs, drop, split):
    def shard(mod, p):
        return list(mod.IterableDatasetShard(list(range(23)), batch_size=4, drop_last=drop,
                                             num_processes=procs, process_index=p,
                                             split_batches=split))

    for p in range(procs):
        assert shard(tdl, p) == shard(jdl, p)
