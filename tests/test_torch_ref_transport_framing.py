"""The cases of tests/test_transport_framing.py over the port's framing:
the scatter-gather frame bytes against the reference's own packer
(``_pack_arrays``, which the port has no copy of: its frames are the
oracle here), the socket round trip, partial sends, every codec's
``encode_iovecs`` against ``encode_views``, and the star's bitwise
reduction, donation and read-only inputs, under the reference's names
and assertions (tests/test_torch_twin.py says how). The port names the
reference's ``_iov_join``, ``_iov_nbytes`` and ``_sendmsg_all``
``comm.wire``'s ``iov_join``, ``iov_nbytes`` and ``sendmsg_all``.

``test_bucket_plan_staging_arena_reuse`` is held below: the port's
``_BucketPlan`` takes tensors and DDP packs its staging itself.
"""

from concurrent.futures import Future

import ml_dtypes
import numpy as np
import pytest
import torch

from tests.test_torch_twin import reference_twin
from torchft_tpu.comm.transport import _unpack_arrays as RefUnpack
from torchft_tpu.ddp import _BucketPlan as RefBucketPlan
from torchft_tpu_torch.comm.context import Work
from torchft_tpu_torch.ddp import DistributedDataParallel

reference_twin(
    globals(), "test_transport_framing",
    renames={"_iov_join": "iov_join", "_iov_nbytes": "iov_nbytes",
             "_sendmsg_all": "sendmsg_all", "    _pack_arrays,\n": ""},
    prelude="from torchft_tpu.comm.transport import _pack_arrays\n",
    drop={"test_bucket_plan_staging_arena_reuse": "below"})


class _Recorder:
    """A wire of two that returns what it is given and records it."""

    metrics = None

    def __init__(self):
        self.seen = []

    def wait_quorum(self):
        pass

    def is_solo_wire(self):
        return False

    def errored(self):
        return None

    def allreduce_arrays(self, arrays, op=None, **kw):
        self.seen.append(list(arrays))
        fut = Future()
        fut.set_result(list(arrays))
        return Work(fut)


def test_bucket_plan_staging_arena_reuse() -> None:
    # the reference's leaves (f32, f32, int64; 16-byte buckets) through the
    # port's DDP twice: the same buckets as the reference's plan, every
    # bucket's staging the same buffer both rounds, holding the
    # reference's packed bytes; a changed dtype fails loudly
    leaves = [np.arange(6, dtype=np.float32).reshape(2, 3),
              np.arange(4, dtype=np.float32) * 2.0,
              np.arange(3, dtype=np.int64)]
    ref = RefBucketPlan(leaves, bucket_bytes=16)
    rec = _Recorder()
    ddp = DistributedDataParallel(rec, bucket_bytes=16, error_feedback=False,
                                  staging_arenas=1)
    for _ in range(2):
        grads = [torch.from_numpy(a.copy()) for a in leaves]
        out = ddp.average_gradients(grads)
        for got, want in zip(out, leaves):
            assert got.numpy().tobytes() == want.tobytes()
    assert ddp._plan.buckets == ref.buckets
    # one allreduce a bucket a round
    n = len(ref.buckets)
    assert [len(arrays) for arrays in rec.seen] == [1] * 2 * n
    first, second = ([a for arrays in rec.seen[r * n:(r + 1) * n]
                      for a in arrays] for r in (0, 1))
    assert [a.ctypes.data for a in first] == [a.ctypes.data for a in second]
    for k, bucket in enumerate(ref.buckets):
        packed = RefBucketPlan.pack_bucket([leaves[i] for i in bucket])
        assert second[k].dtype == packed.dtype
        assert second[k].tobytes() == packed.tobytes()
    with pytest.raises(ValueError, match="frozen"):
        ddp.average_gradients([torch.zeros(6, dtype=torch.float64),
                               torch.zeros(4), torch.zeros(3, dtype=torch.int64)])


def test_bf16_frame_bytes_match_reference() -> None:
    # the reference's sample carries a bfloat16 leaf: its frame, read
    # back by the reference's reader, is the port's bf16 host view
    a = np.random.default_rng(3).standard_normal(9).astype(ml_dtypes.bfloat16)
    frame = iov_join(_array_frame_iovecs([a]))
    assert frame == _pack_arrays([a])
    assert RefUnpack(frame)[0].tobytes() == a.tobytes()
