"""Commit-gated optimizer wrapper.

Twin of ``OptimizerWrapper`` in ``torchft_tpu/optim.py``, in the reference
torchft shape over a ``torch.optim.Optimizer``: ``begin_step`` (alias
``zero_grad``) starts the quorum and clears the gradients; ``step()`` runs
``optimizer.step()`` only if the replica group commits, and returns whether
it did.

Torch updates in place, so a heal needs no re-read of state: the Manager
applies a fetched donor checkpoint through the user's ``load_state_dict``
inside ``should_commit`` (copying into the very parameters this optimizer
holds), and the committed update then lands on the healed state.
"""

from __future__ import annotations

import torch

__all__ = ["OptimizerWrapper"]


class OptimizerWrapper:
    """Gates ``optimizer.step()`` on the manager's two-phase commit."""

    def __init__(self, manager, optimizer: torch.optim.Optimizer) -> None:
        self.manager = manager
        self.optimizer = optimizer

    def begin_step(self, **kwargs) -> None:
        """Start the (async) quorum and clear the gradients — call before
        the forward pass."""
        self.manager.start_quorum(**kwargs)
        self.optimizer.zero_grad(set_to_none=False)

    zero_grad = begin_step

    def step(self) -> bool:
        """Apply the update iff the replica group commits this step."""
        if self.manager.should_commit():
            self.optimizer.step()
            return True
        return False

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict) -> None:
        self.optimizer.load_state_dict(state_dict)
