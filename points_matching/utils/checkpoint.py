"""Checkpoint / resume (SURVEY.md §5: the reference's program state dies
with the process; here map state, poses and optimizer state persist via
Orbax with mesh-aware sharded save/restore).

The recovery story for accelerator jobs (gang-scheduled, not elastic): periodic
checkpoints + restart-from-checkpoint.  ``CheckpointManager`` wraps
``orbax.checkpoint`` with the two calls the pipelines need.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import jax


class CheckpointManager:
    """Thin Orbax wrapper for pytree state (SfM maps, BA states, configs).

    Save is async (Orbax's default); ``wait()`` or close() to flush.
    Restore is sharding-aware: pass ``template`` (a pytree of arrays OR
    ShapeDtypeStruct with shardings) to restore directly onto a mesh.
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        import orbax.checkpoint as ocp

        self._ocp = ocp
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._mgr = ocp.CheckpointManager(
            self.directory,
            options=ocp.CheckpointManagerOptions(
                max_to_keep=max_to_keep, create=True
            ),
        )

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        return self._mgr.save(
            step, args=self._ocp.args.StandardSave(state), force=force
        )

    def restore(self, step: Optional[int] = None, template: Any = None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        if template is not None:
            abstract = jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(
                    x.shape, x.dtype,
                    sharding=getattr(x, "sharding", None),
                )
                if hasattr(x, "shape")
                else x,
                template,
            )
            return self._mgr.restore(
                step, args=self._ocp.args.StandardRestore(abstract)
            )
        return self._mgr.restore(step)

    def latest_step(self) -> Optional[int]:
        return self._mgr.latest_step()

    def all_steps(self):
        return self._mgr.all_steps()

    def wait(self) -> None:
        self._mgr.wait_until_finished()

    def close(self) -> None:
        self._mgr.wait_until_finished()
        self._mgr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
