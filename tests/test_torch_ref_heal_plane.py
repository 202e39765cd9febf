"""The cases of tests/test_heal_plane.py over the port's heal plane, on
torch tensors, under the reference's names and assertions
(tests/test_torch_twin.py says how).

The reference builds its states with ``jax.numpy``; here ``jnp`` is a
shim that builds the same values as torch tensors (float32 and
bfloat16), what the port's trainers hand their checkpoint server, and
``np.asarray`` reads a tensor through the port's host view (a bfloat16
tensor as ml_dtypes' bfloat16, the reference's host dtype). Every
transport arm (the full stream, ``num_chunks=3``, a template, striping)
heals both dtypes bitwise.
"""

import threading

from tests.test_torch_twin import reference_twin

_SHIM = '''
import numpy as _np
import torch as _torch

from torchft_tpu_torch.ddp import _host_view


class _TorchNumpy:
    """``jax.numpy``'s constructors the suite calls, building tensors."""

    float32 = _torch.float32
    bfloat16 = _torch.bfloat16

    @staticmethod
    def asarray(x, dtype=None):
        t = _torch.as_tensor(_np.asarray(x))
        return t if dtype is None else t.to(dtype)

    @staticmethod
    def arange(n, dtype=None):
        return _torch.arange(n, dtype=dtype)

    @staticmethod
    def zeros(shape, dtype=None):
        return _torch.zeros(shape, dtype=dtype)

    @staticmethod
    def ones(shape, dtype=None):
        return _torch.ones(shape, dtype=dtype)


def _host(x):
    """A host array of ``x``: a tensor through the port's host view."""
    if isinstance(x, _torch.Tensor):
        return _host_view(x.detach().cpu().contiguous())
    return _np.asarray(x)
'''

reference_twin(
    globals(), "test_heal_plane", prelude=_SHIM,
    renames={"import jax.numpy as jnp": "jnp = _TorchNumpy",
             "jnp.asarray": "_TorchNumpy.asarray",
             "np.asarray": "_host",
             # the port's staged checkpoint keeps its per-leaf tasks, not
             # a future over all of them
             "donor._staged.all_staged.result(10.0)":
                 "donor._staged.finish_staging(10.0)",
             "staged.all_staged.done()": "all(s.done for s in staged.slots)",
             # the full stream is the reference's constructor default and
             # is asked for by name here (the port's default is chunked)
             'if mode == "full_stream":\n        healer = CheckpointServer('
             'timeout=10.0)':
                 'if mode == "full_stream":\n        healer = CheckpointServer('
                 'timeout=10.0, num_chunks=0)'},
    drop={
        # a jax mesh's sharded params (tests/test_integration_hsdp.py)
        "test_sharded_multi_donor_bitwise":
            "tests/test_torch_heal_plane.py of that name (ShardedTensor)",
        # the port's fetch_leaf returns a tensor (dtype torch.float32)
        "test_wire_bf16_opt_in_roundtrip":
            "tests/test_torch_heal_plane.py of that name, both paths",
        # the reference's _stage_hook seam; the port has none
        "test_lazy_staging_first_leaf_before_last_staged": "below",
    })


def test_lazy_staging_first_leaf_before_last_staged(monkeypatch) -> None:
    # the reference's case with its wedge moved from the reference's
    # _stage_hook to the port's staging copy: the background stager,
    # which stages in leaf order, blocks on leaf 0; a healer's fetch of
    # leaf 1 stages it on the request's thread and lands while the tree
    # is still staging; released, the stager drains the rest
    import numpy as np
    import torch

    import torchft_tpu_torch.checkpointing as cp

    gate = threading.Event()
    state = {"a": torch.zeros(64), "b": torch.arange(64, dtype=torch.float32),
             "c": torch.ones(64)}
    first = state["a"]
    staged_order = []
    to_host = cp.to_host

    def wedged(t):
        staged_order.append(next(k for k, v in state.items() if v is t))
        if t is first:
            gate.wait(10.0)
        return to_host(t)

    monkeypatch.setattr(cp, "to_host", wedged)
    donor = CheckpointServer(timeout=10.0)
    try:
        donor.send_checkpoint([], 2, state, 10.0)
        slots = donor._staged.slots
        assert not all(s.done for s in slots)
        got = fetch_leaf(donor.metadata(), 2, 1)  # priority bump
        np.testing.assert_array_equal(_host(got),
                                      np.arange(64, dtype=np.float32))
        assert not slots[0].done and slots[1].done
        assert "b" in staged_order
        gate.set()
        donor._staged.finish_staging(10.0)
        assert all(s.done for s in slots)
    finally:
        gate.set()
        donor.shutdown()
