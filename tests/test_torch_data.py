"""The port's DistributedSampler yields the JAX package's index stream."""

import itertools

import pytest

from torchft_tpu.data import DistributedSampler as JaxSampler
from torchft_tpu_torch.data import DistributedSampler


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
