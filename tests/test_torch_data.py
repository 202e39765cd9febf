"""The port's data pipeline against the JAX package's.

``DistributedSampler`` yields the JAX package's index stream and global
rank arithmetic, its shards covering the dataset (disjoint, or padded by
wrap-around).
``PrefetchIterator`` (twins of the prefetch tests of
tests/test_profiling_prefetch.py, on the CPU): order and values, the depth
bound, overlap with a slow source, source errors on the consumer, a latched
end, and ``close()``; both packages' iterators yield the same batches from
the same source.
"""

import itertools
import time

import numpy as np
import pytest
import torch

from torchft_tpu.data import DistributedSampler as JaxSampler
from torchft_tpu.data import PrefetchIterator as JaxPrefetch
from torchft_tpu_torch.data import DistributedSampler, PrefetchIterator


@pytest.mark.parametrize("size,groups,replicas,shuffle,drop_last", [
    (4096, 2, 1, True, False),
    (1000, 3, 2, True, False),
    (1001, 4, 1, False, False),
    (999, 2, 3, True, True),
])
def test_identical_index_streams(size, groups, replicas, shuffle,
                                 drop_last) -> None:
    for group, rank in itertools.product(range(groups), range(replicas)):
        kw = dict(replica_group=group, num_replica_groups=groups, rank=rank,
                  num_replicas=replicas, shuffle=shuffle, seed=1,
                  drop_last=drop_last)
        ours, theirs = DistributedSampler(size, **kw), JaxSampler(size, **kw)
        assert len(ours) == len(theirs)
        for epoch in range(3):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert list(ours) == list(theirs)


def test_state_dict_resumes_mid_epoch_like_reference() -> None:
    kw = dict(replica_group=1, num_replica_groups=2, seed=5)
    ours, theirs = DistributedSampler(200, **kw), JaxSampler(200, **kw)
    a, b = iter(ours), iter(theirs)
    head = [next(a) for _ in range(17)]
    assert head == [next(b) for _ in range(17)]
    assert ours.state_dict() == theirs.state_dict()
    resumed = DistributedSampler(200, **kw)
    resumed.load_state_dict(theirs.state_dict())
    assert list(resumed) == list(b)


def test_sampler_global_rank_arithmetic() -> None:
    kw = dict(dataset=100, replica_group=2, num_replica_groups=4, rank=1,
              num_replicas=3, shuffle=False)
    ours, theirs = DistributedSampler(**kw), JaxSampler(**kw)
    assert (ours.global_rank, ours.global_world_size) == (
        theirs.global_rank, theirs.global_world_size) == (1 + 3 * 2, 12)


@pytest.mark.parametrize("size,groups,replicas,per", [
    (24, 3, 2, 4), (10, 3, 1, 4)], ids=[
    "shards_disjoint_and_cover", "padding_when_not_divisible"])
def test_sampler_shards_cover_the_dataset(size, groups, replicas,
                                          per) -> None:
    # the shards of every group and rank cover the dataset; disjoint when
    # it divides, padded by wrap-around to ceil(size / shards) when not
    shards = []
    for group, rank in itertools.product(range(groups), range(replicas)):
        kw = dict(replica_group=group, num_replica_groups=groups, rank=rank,
                  num_replicas=replicas, shuffle=False)
        shard = list(DistributedSampler(size, **kw))
        assert shard == list(JaxSampler(size, **kw))
        assert len(shard) == per
        shards.extend(shard)
    assert set(shards) == set(range(size))
    if size % (groups * replicas) == 0:
        assert sorted(shards) == list(range(size))


# ------------------------------------------------------------- prefetch


def _batches(n):
    return [{"x": np.full((4,), i, np.float32),
             "pair": (torch.arange(3) + i, "tag")} for i in range(n)]


def test_prefetch_yields_all_batches_in_order_like_reference() -> None:
    ours = list(PrefetchIterator(iter(_batches(10)), depth=2, device="cpu"))
    theirs = list(JaxPrefetch(iter([{"x": b["x"]} for b in _batches(10)]),
                              depth=2))
    assert len(ours) == len(theirs) == 10
    for i, (b, r) in enumerate(zip(ours, theirs)):
        assert isinstance(b["x"], torch.Tensor)  # placed as a tensor
        np.testing.assert_array_equal(b["x"].numpy(), np.asarray(r["x"]))
        np.testing.assert_array_equal(b["x"].numpy(), np.full((4,), i))
        assert torch.equal(b["pair"][0], torch.arange(3) + i)
        assert b["pair"][1] == "tag"  # other values pass through


def test_prefetch_stays_at_most_depth_ahead() -> None:
    pulled = []

    def source():
        for i in range(20):
            pulled.append(i)
            yield np.full((2,), i)

    it = PrefetchIterator(source(), depth=2, device="cpu")
    time.sleep(0.3)
    # depth queued, plus one the worker holds while it waits for a slot
    assert len(pulled) <= 2 + 1
    assert [int(b[0]) for b in itertools.islice(it, 5)] == [0, 1, 2, 3, 4]
    time.sleep(0.3)
    assert len(pulled) <= 5 + 2 + 1
    it.close()


def test_prefetch_overlaps_source_latency() -> None:
    delay = 0.05

    def slow_source():
        for i in range(6):
            time.sleep(delay)
            yield np.full((2,), i)

    it = PrefetchIterator(slow_source(), depth=2, device="cpu")
    seen = [next(it)]
    t0 = time.perf_counter()
    for b in it:
        time.sleep(delay)  # the consumer's step
        seen.append(b)
    elapsed = time.perf_counter() - t0
    assert len(seen) == 6
    assert elapsed < 1.8 * 5 * delay, elapsed


def test_prefetch_propagates_source_error() -> None:
    def bad_source():
        yield np.zeros((2,))
        raise RuntimeError("dataset exploded")

    it = PrefetchIterator(bad_source(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="dataset exploded"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)  # the end is latched, no hang


def test_prefetch_close_unblocks_worker() -> None:
    it = PrefetchIterator((np.zeros((2,)) for _ in range(1000)), depth=1,
                          device="cpu")
    next(it)
    it.close()  # must not hang
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_exhausted_iterator_stays_stopped() -> None:
    it = PrefetchIterator(iter([np.zeros((2,))]), device="cpu")
    assert len(list(it)) == 1
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_defaults_to_the_card() -> None:
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PrefetchIterator(iter([]))
