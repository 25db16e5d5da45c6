"""Periodic checkpointing with resume (orbax-backed).

An improvement over the reference, which only saves final weights
(BSON.@save at experiments/mnist_node.jl:277-278) and loses crashed runs:
here ``Checkpointer`` writes params + optimizer state + metadata every N
epochs and ``restore_latest`` resumes mid-training.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional, Tuple


class Checkpointer:
    def __init__(self, directory, max_to_keep: int = 3, save_every: int = 1):
        self.directory = Path(directory).absolute()
        self.save_every = save_every
        # Imported here, not at module level: orbax is an optional extra
        # and the training package must import without it.
        import orbax.checkpoint as ocp

        self._ocp = ocp
        self._mgr = ocp.CheckpointManager(
            self.directory,
            options=ocp.CheckpointManagerOptions(
                max_to_keep=max_to_keep, create=True
            ),
        )

    def maybe_save(self, step: int, params: Any, opt_state: Any = None,
                   extra: Optional[dict] = None) -> bool:
        if step % self.save_every != 0:
            return False
        self.save(step, params, opt_state, extra)
        return True

    def save(self, step: int, params: Any, opt_state: Any = None,
             extra: Optional[dict] = None) -> None:
        payload = {"params": params}
        if opt_state is not None:
            payload["opt_state"] = opt_state
        if extra:
            payload["extra"] = extra
        self._mgr.save(step, args=self._ocp.args.StandardSave(payload))
        self._mgr.wait_until_finished()

    def restore_latest(self, template: Any = None) -> Tuple[Optional[int], Any]:
        """Returns (step, payload) or (None, None) if no checkpoint."""
        step = self._mgr.latest_step()
        if step is None:
            return None, None
        if template is not None:
            payload = self._mgr.restore(
                step, args=self._ocp.args.StandardRestore(template)
            )
        else:
            payload = self._mgr.restore(step)
        return step, payload

    def close(self):
        self._mgr.close()
